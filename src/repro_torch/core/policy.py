"""Compression policy (copy of ``repro.core.policy``): which projections get
MPD masks and at what factor, resolved once per model into mask specs."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .mask import MaskSpec, divisible, make_mask_spec

# layer kinds the model zoo tags its projections with
KINDS = (
    "attn_qkv", "attn_out", "mlp", "moe_expert", "ssm_proj", "unembed", "head",
)


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Resolved per-kind compression factors (see ``repro.core.policy``)."""

    c: int = 1
    per_kind: Optional[Dict[str, int]] = None
    min_block: int = 8
    permuted: bool = True
    seed: int = 0
    mode: str = "packed"

    def factor(self, kind: str) -> int:
        if self.per_kind and kind in self.per_kind:
            return self.per_kind[kind]
        return self.c

    def plan(self, d_in: int, d_out: int, kind: str,
             seed_salt: int = 0) -> Optional[MaskSpec]:
        """Resolve one projection. Returns None => keep dense."""
        c = self.factor(kind)
        if c <= 1:
            return None
        nb = c
        while nb > 1:
            if (divisible(d_in, d_out, nb)
                    and d_in // nb >= self.min_block
                    and d_out // nb >= self.min_block):
                return make_mask_spec(
                    d_in, d_out, nb,
                    seed=self.seed * 1_000_003 + seed_salt,
                    permuted=self.permuted,
                )
            nb -= 1
        return None


DENSE = CompressionPolicy(c=1)


def uniform(c: int, min_block: int = 8, permuted: bool = True, seed: int = 0,
            mode: str = "packed") -> CompressionPolicy:
    """The paper's setting: one compression factor for every FC layer."""
    return CompressionPolicy(c=c, min_block=min_block, permuted=permuted,
                             seed=seed, mode=mode)
