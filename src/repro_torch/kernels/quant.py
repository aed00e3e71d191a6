"""Symmetric per-output-channel quantization of packed block tensors (the
port of ``repro.kernels.quant``).

For ``wp: (..., nb, bi, bo)``: ``q`` int8 of the same shape in
``[-qmax, qmax]`` and ``scale (..., nb, bo)`` f32 with
``scale = amax/qmax`` over the block-input axis (all-zero columns get 1).
Rounding is half to even in both packages (``jnp.round``, ``torch.round``).

``bits=8`` is the execution format. ``bits=4`` (qmax 7) is a storage
format only: :func:`pack_int4` nibble-packs pairs of block-input rows into
one byte for an artifact, and :func:`unpack_int4` restores int8 once at
load time; the kernels never see nibbles.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

QMAX = {8: 127, 4: 7}
BITS = {"int8": 8, "int4": 4}


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


def quant_error(wp: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
                ) -> Dict[str, float]:
    """Round-trip error of one quantized leaf: ``max_abs`` (at most
    ``scale / 2`` per column) and ``rel_rms`` ``||w - dq|| / ||w||``."""
    w = wp.detach().float()
    err = w - dequantize_blocks(q, scale)
    return {"max_abs": float(err.abs().max()),
            "rel_rms": float(err.norm()) / (float(w.norm()) + 1e-30)}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int4-valued int8 ``(..., bi, bo)`` along the block-input
    axis into ``(..., ceil(bi/2), bo)`` uint8: row ``2k`` in the low nibble,
    row ``2k+1`` in the high nibble; an odd ``bi`` is zero-padded."""
    if q.shape[-2] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-2] + (1, q.shape[-1]))], -2)
    lo = q[..., 0::2, :].to(torch.uint8) & 0x0F
    hi = q[..., 1::2, :].to(torch.uint8) & 0x0F
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, bi: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``(..., ceil(bi/2), bo)`` uint8 ->
    ``(..., bi, bo)`` int8 with the nibbles sign-extended."""
    b = packed.to(torch.int16)
    # a nibble n in [0, 15] sign-extends to (n ^ 8) - 8 in [-8, 7]
    lo = ((b & 0x0F) ^ 8) - 8
    hi = (((b >> 4) & 0x0F) ^ 8) - 8
    inter = torch.stack([lo, hi], dim=-2)                # (..., k, 2, bo)
    flat = inter.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                         packed.shape[-1])
    return flat[..., :bi, :].to(torch.int8)


def is_quantized(leaf) -> bool:
    """True for a param leaf produced by the quantize pass
    (``{"w_q", "w_scale", ...}`` instead of ``{"w", ...}``)."""
    return isinstance(leaf, dict) and "w_q" in leaf
