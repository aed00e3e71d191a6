"""Feed-forward blocks (the port of ``repro.models.ffn``, unfused route).

Gated (SwiGLU) and plain (GELU/ReLU) MLPs; every projection is an
MPD-compressible :class:`Linear`. SwiGLU order as the reference: ``up`` has
no activation, ``gate`` runs silu in its kernel epilogue, each is cast to
the dtype, then the two multiply in that dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policy import CompressionPolicy
from .linear import Linear


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"  # swiglu | gelu | relu
    use_bias: bool = False
    w_up: Linear = None
    w_gate: Linear = None
    w_down: Linear = None

    @staticmethod
    def make(policy: CompressionPolicy, d_model, d_ff, kind="swiglu",
             use_bias=False, seed_salt=0, fuse_perms=False) -> "FFNSpec":
        if fuse_perms:
            raise NotImplementedError("the fused FFN route (mpd_fuse) is not "
                                      "ported yet")
        gated = kind == "swiglu"
        return FFNSpec(
            d_model, d_ff, kind, use_bias,
            w_up=Linear.make(policy, d_model, d_ff, "mlp", use_bias=use_bias,
                             seed_salt=seed_salt * 3 + 0),
            w_gate=(Linear.make(policy, d_model, d_ff, "mlp",
                                use_bias=use_bias, seed_salt=seed_salt * 3 + 1)
                    if gated else None),
            w_down=Linear.make(policy, d_ff, d_model, "mlp", use_bias=use_bias,
                               seed_salt=seed_salt * 3 + 2),
        )

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        p = {"w_up": self.w_up.init(generator, dtype, device)}
        if self.w_gate is not None:
            p["w_gate"] = self.w_gate.init(generator, dtype, device)
        p["w_down"] = self.w_down.init(generator, dtype, device)
        return p

    def apply(self, params, x):
        if self.kind == "swiglu":
            h = self.w_up.apply(params["w_up"], x)
            g = self.w_gate.apply(params["w_gate"], x, activation="silu")
            h = g * h
        elif self.kind in ("gelu", "relu"):
            h = self.w_up.apply(params["w_up"], x, activation=self.kind)
        else:
            raise ValueError(self.kind)
        return self.w_down.apply(params["w_down"], h)
