"""Projection layer: every matmul of the model goes through here, so the
MPDCompress policy can claim any of them (the port of
``repro.models.linear``, without the sharding metadata)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mpd
from repro_torch.core.policy import CompressionPolicy


@dataclasses.dataclass(frozen=True)
class Linear:
    spec: mpd.MPDLinearSpec

    @staticmethod
    def make(policy: CompressionPolicy, d_in: int, d_out: int, kind: str, *,
             use_bias: bool = False, seed_salt: int = 0, mask_override=None,
             skip_in_perm: bool = False,
             skip_out_perm: bool = False) -> "Linear":
        """Resolve the projection's mask from the policy. ``mask_override``
        and the skip flags carry the paper's Fig-3 permutation fusion:
        adjacent layers take masks whose permutations cancel, and the
        runtime gathers are skipped. A skip applies only in packed mode."""
        mask = (mask_override if mask_override is not None
                else policy.plan(d_in, d_out, kind, seed_salt=seed_salt))
        mode = policy.mode if mask is not None else "dense"
        return Linear(mpd.MPDLinearSpec(
            d_in, d_out, mask, mode=mode, use_bias=use_bias,
            skip_in_perm=skip_in_perm and mode == "packed",
            skip_out_perm=skip_out_perm and mode == "packed"))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        return mpd.init(generator, self.spec, dtype, device)

    def apply(self, params, x, *, activation=None, extra_bias=None,
              packed_input=False):
        """Forward with the bias/activation epilogue fused into the kernel
        call; quantized leaves route to the int8 kernels. ``extra_bias``
        joins the layer's bias in that epilogue; ``packed_input``: ``x`` is
        already in this layer's packed input order."""
        return mpd.apply(self.spec, params, x, activation=activation,
                         extra_bias=extra_bias, packed_input=packed_input)
