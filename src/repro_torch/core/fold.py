"""Folding masked-dense weights into packed blocks, and the pack/unpack
gathers around the block-diagonal matmul (the port of ``repro.core.fold``).

Paper Eq. (2): ``W* = P_rowᵀ W̄ P_colᵀ`` is block diagonal because the mask is
a permutation of the block-diagonal base; :func:`fold` keeps only its
diagonal blocks, ``(nb, block_in, block_out)``, the layout of the bdmm
kernel.

Inference dataflow for ``y = x @ W̄`` with packed blocks ``Wp``::

    x'      = x[..., invert(p_in)]        # pack inputs
    y'[n]   = x'[n-th block] @ Wp[n]      # nb independent matmuls (bdmm)
    y       = y'[..., p_out]              # unpack outputs

Both gathers are ``index_select`` with an index tensor built once per mask
and device and kept in ``MaskSpec.index_cache``; so is the binary mask
itself (:func:`mask_tensor`), built on the device from the block ids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import permute
from .mask import MaskSpec, block_id_of


_PERMS = {
    "pack": lambda s: permute.invert(s.in_perm),     # x -> x'; W rows -> W*
    "unpack": lambda s: s.out_perm,                  # y' -> y; W* cols -> W
    "bias": lambda s: permute.invert(s.out_perm),    # bias -> packed order
    "rows": lambda s: s.in_perm,                     # W* rows -> W
}


def gather_index(spec: MaskSpec, which: str, device) -> Optional[torch.Tensor]:
    """Device index for ``which`` in ``("pack", "unpack", "bias")`` — or
    None when that permutation is the identity (no gather needed)."""
    key = (which, str(device))
    if key not in spec.index_cache:
        p = _PERMS[which](spec)
        spec.index_cache[key] = (
            None if permute.is_identity(p)
            else torch.as_tensor(p.astype(np.int64), device=device))
    return spec.index_cache[key]


def mask_tensor(spec: MaskSpec, device) -> torch.Tensor:
    """The binary mask ``M (d_in, d_out)`` as uint8 on ``device``, equal to
    :func:`repro_torch.core.mask.mask_dense`. Built there once per mask and
    device from the block ids (``M[i, j] = in_block[i] == out_block[j]``), so
    no step uploads a dense mask; the masked-dense layers of olmo-1b share
    ~170 MB of masks across all periods."""
    key = ("mask", str(device))
    if key not in spec.index_cache:
        in_block, out_block = block_id_of(spec)
        ib = torch.as_tensor(in_block, device=device)
        ob = torch.as_tensor(out_block, device=device)
        spec.index_cache[key] = (ib[:, None] == ob[None, :]).to(torch.uint8)
    return spec.index_cache[key]


def _take(w: torch.Tensor, idx: Optional[torch.Tensor], axis: int):
    return w if idx is None else w.index_select(axis, idx)


def fold(spec: MaskSpec, w_dense: torch.Tensor) -> torch.Tensor:
    """Fold a (masked-)dense ``(..., d_in, d_out)`` weight into packed blocks
    ``(..., nb, block_in, block_out)``: ``Wp[n] = W*[n-th diagonal block]``
    with ``W* = W̄[invert(p_in), :][:, invert(p_out)]``. Leading axes (stacked
    periods) fold independently; off-mask entries are dropped."""
    nb, bi, bo = spec.nb, spec.block_in, spec.block_out
    dev = w_dense.device
    w_star = _take(_take(w_dense, gather_index(spec, "pack", dev), -2),
                   gather_index(spec, "bias", dev), -1)
    lead = w_star.shape[:-2]
    w_star = w_star.reshape(*lead, nb, bi, nb, bo)
    # the diagonal (n, n) blocks: (..., bi, bo, nb) -> (..., nb, bi, bo)
    return torch.diagonal(w_star, dim1=-4, dim2=-2).movedim(-1, -3).contiguous()


def unfold(spec: MaskSpec, packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fold`: ``(..., nb, bi, bo)`` blocks -> masked-dense
    ``(..., d_in, d_out)``; ``unfold(spec, fold(spec, M∘W)) == M∘W``."""
    nb, bi, bo = spec.nb, spec.block_in, spec.block_out
    lead = packed.shape[:-3]
    w_star = packed.new_zeros((*lead, nb, bi, nb, bo))
    torch.diagonal(w_star, dim1=-4, dim2=-2).copy_(packed.movedim(-3, -1))
    w_star = w_star.reshape(*lead, spec.d_in, spec.d_out)
    dev = packed.device
    return _take(_take(w_star, gather_index(spec, "rows", dev), -2),
                 gather_index(spec, "unpack", dev), -1)


def fold_residual(spec: MaskSpec, w_dense) -> float:
    """Fraction of ``|W|`` mass off the mask (0 after faithful masked
    training). Computed in float32 on the weight's device."""
    w = torch.as_tensor(w_dense).float().abs()
    off = w * (1 - mask_tensor(spec, w.device).float())
    return float(off.sum()) / (float(w.sum()) + 1e-30)


def inter_layer_perm(prev: MaskSpec, nxt: MaskSpec) -> np.ndarray:
    """The one gather carrying layer ``prev``'s packed output into layer
    ``nxt``'s packed input: ``prev.out_perm[invert(nxt.in_perm)]`` (the
    identity for chains whose permutations cancel, paper Fig. 3)."""
    if prev.d_out != nxt.d_in:
        raise ValueError(f"inter_layer_perm: d_out {prev.d_out} != d_in "
                         f"{nxt.d_in}")
    return permute.compose(permute.invert(nxt.in_perm), prev.out_perm)


def pack_inputs(spec: MaskSpec, x: torch.Tensor, skip: bool = False):
    """``x -> x'`` gather (identity when the permutation was fused away)."""
    idx = None if skip else gather_index(spec, "pack", x.device)
    return x if idx is None else x.index_select(-1, idx)


def unpack_outputs(spec: MaskSpec, y: torch.Tensor, skip: bool = False):
    """``y' -> y`` gather (identity when fused into the next layer)."""
    idx = None if skip else gather_index(spec, "unpack", y.device)
    return y if idx is None else y.index_select(-1, idx)
