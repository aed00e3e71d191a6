"""Symmetric per-output-channel quantization of packed block tensors (the
serving part of ``repro.kernels.quant``).

For ``wp: (..., nb, bi, bo)``: ``q`` int8 of the same shape in
``[-qmax, qmax]`` and ``scale (..., nb, bo)`` f32 with
``scale = amax/qmax`` over the block-input axis (all-zero columns get 1).
Rounding is half to even in both packages (``jnp.round``, ``torch.round``).
"""

from __future__ import annotations

from typing import Tuple

import torch

QMAX = {8: 127}            # int4 storage (qmax 7) is not ported yet


def quantize_blocks(wp: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wp (..., nb, bi, bo) -> (q int8, scale f32 (..., nb, bo))``."""
    qmax = QMAX[bits]
    w = wp.float()
    amax = w.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None, :]


def is_quantized(leaf) -> bool:
    """True for a param leaf produced by the quantize pass
    (``{"w_q", "w_scale", ...}`` instead of ``{"w", ...}``)."""
    return isinstance(leaf, dict) and "w_q" in leaf
