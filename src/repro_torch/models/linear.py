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
             use_bias: bool = False, seed_salt: int = 0) -> "Linear":
        """Resolve the projection's mask from the policy (the permutation
        fusion overrides of the reference come with the fused FFN route)."""
        mask = policy.plan(d_in, d_out, kind, seed_salt=seed_salt)
        mode = policy.mode if mask is not None else "dense"
        return Linear(mpd.MPDLinearSpec(d_in, d_out, mask, mode=mode,
                                        use_bias=use_bias))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        return mpd.init(generator, self.spec, dtype, device)

    def apply(self, params, x, *, activation=None):
        """Forward with the bias/activation epilogue fused into the kernel
        call; quantized leaves route to the int8 kernels."""
        return mpd.apply(self.spec, params, x, activation=activation)
