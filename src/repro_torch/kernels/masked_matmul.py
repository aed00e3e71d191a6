"""Masked matmul and its weight gradient (the port of
``repro.kernels.masked_matmul``), the paper-faithful training ops.

* :func:`masked_matmul` — ``y = act(x @ (M∘W) + b)``; with ``transpose_rhs``
  ``y = x @ (M∘W)ᵀ``, which is the input gradient ``dx = g @ (M∘W)ᵀ``.
* :func:`sddmm_masked` — ``dW = (xᵀ @ g) ∘ M``, the weight gradient; off-mask
  entries are exact zeros.

Both launch ``csrc/masked_matmul.cu`` on tensors of one CUDA device; the
mask is ``uint8`` in W's layout. :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions before they get here. ``launches``
counts kernel launches per kernel (the two orientations separately).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}

launches = {"masked_matmul": 0, "masked_matmul_t": 0, "sddmm_masked": 0}
_entries = {}


def _launcher(name: str):
    if name not in _entries:
        lib = _build.library("masked_matmul")
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "mm":
            fn = lib.masked_matmul_launch
            fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
        else:
            fn = lib.sddmm_masked_launch
            fn.argtypes = [P, P, P, P, I, I, I, I, P]
        fn.restype = I
        _entries[name] = (lib, fn)
    return _entries[name]


def _mask_bytes(name: str, mask: torch.Tensor) -> torch.Tensor:
    if mask.dtype != torch.uint8:
        raise ValueError(f"{name}: the mask must be uint8, got {mask.dtype}")
    return mask.contiguous()


def _rows(x: torch.Tensor) -> int:
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return m


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  activation: Optional[str] = None,
                  transpose_rhs: bool = False) -> torch.Tensor:
    """``act(x @ (mask∘w) + bias)``: ``x (..., K)``, ``w``/``mask`` ``(K, N)``,
    or ``(N, K)`` with ``transpose_rhs``; ``bias (N,)``. Output in x's dtype."""
    n, k = w.shape if transpose_rhs else w.shape[::-1]
    if x.shape[-1] != k or tuple(mask.shape) != tuple(w.shape):
        raise ValueError(f"masked_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, mask {tuple(mask.shape)}, "
                         f"transpose_rhs={transpose_rhs}")
    if activation not in ACT_CODES:
        raise ValueError(f"masked_matmul kernel: activation {activation!r} "
                         f"not in {sorted(a for a in ACT_CODES if a)} or None")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"masked_matmul kernel: x {x.dtype}, w {w.dtype}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"masked_matmul: bias {tuple(bias.shape)} != {(n,)}")
    lead = x.shape[:-1]
    m = _rows(x)
    x2 = x.reshape(m, k).contiguous()
    wc = w.contiguous()
    mk = _mask_bytes("masked_matmul", mask)
    b = None if bias is None else bias.float().contiguous()
    _build.require_cuda("masked_matmul", x2, wc, mk,
                        *(t for t in (b,) if t is not None))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, n)
    lib, fn = _launcher("mm")
    code = fn(x2.data_ptr(), wc.data_ptr(), mk.data_ptr(),
              b.data_ptr() if b is not None else None, y.data_ptr(), m, k, n,
              _build.DTYPE_CODES[x.dtype], int(transpose_rhs),
              ACT_CODES[activation], _build.stream_ptr(x.device))
    _build.check(lib, "masked_matmul", code)
    launches["masked_matmul_t" if transpose_rhs else "masked_matmul"] += 1
    return y.reshape(*lead, n)


def sddmm_masked(x: torch.Tensor, g: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """``(xᵀ @ g) ∘ mask``: ``x (..., d_in)``, ``g (..., d_out)`` with the
    same leading dims, ``mask (d_in, d_out)``; the token axis is reduced in
    f32 and off-mask entries are exact zeros. Output in x's dtype."""
    d_in, d_out = mask.shape
    if (x.shape[-1] != d_in or g.shape[-1] != d_out
            or x.shape[:-1] != g.shape[:-1]):
        raise ValueError(f"sddmm_masked: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, mask {tuple(mask.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype:
        raise ValueError(f"sddmm_masked kernel: x {x.dtype}, g {g.dtype}")
    m = _rows(x)
    x2 = x.reshape(m, d_in).contiguous()
    g2 = g.reshape(m, d_out).contiguous()
    mk = _mask_bytes("sddmm_masked", mask)
    _build.require_cuda("sddmm_masked", x2, g2, mk)
    if m == 0:
        return torch.zeros((d_in, d_out), dtype=x.dtype, device=x.device)
    dw = torch.empty((d_in, d_out), dtype=x.dtype, device=x.device)
    lib, fn = _launcher("sddmm")
    code = fn(x2.data_ptr(), g2.data_ptr(), mk.data_ptr(), dw.data_ptr(), m,
              d_in, d_out, _build.DTYPE_CODES[x.dtype],
              _build.stream_ptr(x.device))
    _build.check(lib, "sddmm_masked", code)
    launches["sddmm_masked"] += 1
    return dw
