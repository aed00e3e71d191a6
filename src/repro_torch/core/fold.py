"""Pack/unpack gathers around the block-diagonal matmul (the serving half of
``repro.core.fold``).

Inference dataflow for ``y = x @ W̄`` with packed blocks ``Wp``::

    x'      = x[..., invert(p_in)]        # pack inputs
    y'[n]   = x'[n-th block] @ Wp[n]      # nb independent matmuls (bdmm)
    y       = y'[..., p_out]              # unpack outputs

Both gathers are ``index_select`` with an index tensor built once per mask
and device and kept in ``MaskSpec.index_cache``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import permute
from .mask import MaskSpec


_PERMS = {
    "pack": lambda s: permute.invert(s.in_perm),     # x -> x'
    "unpack": lambda s: s.out_perm,                  # y' -> y
    "bias": lambda s: permute.invert(s.out_perm),    # bias -> packed order
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


def pack_inputs(spec: MaskSpec, x: torch.Tensor, skip: bool = False):
    """``x -> x'`` gather (identity when the permutation was fused away)."""
    idx = None if skip else gather_index(spec, "pack", x.device)
    return x if idx is None else x.index_select(-1, idx)


def unpack_outputs(spec: MaskSpec, y: torch.Tensor, skip: bool = False):
    """``y' -> y`` gather (identity when fused into the next layer)."""
    idx = None if skip else gather_index(spec, "unpack", y.device)
    return y if idx is None else y.index_select(-1, idx)
