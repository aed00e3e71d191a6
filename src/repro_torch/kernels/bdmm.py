"""Block-diagonal matmul (the port of ``repro.kernels.bdmm``).

``bdmm`` computes, for packed inputs ``x (..., nb*bi)`` and packed diagonal
blocks ``wp (nb, bi, bo)``::

    y[..., n*bo:(n+1)*bo] = act(x[..., n*bi:(n+1)*bi] @ wp[n] (* scale[n]) + b[n])

It launches ``csrc/bdmm.cu``: the decode-shaped grid for ``m <= 32`` rows,
the general grid above. Inputs must lie on one CUDA device;
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain version
before they get here. ``launches`` counts kernel launches per grid shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SMALL_M_MAX = 32                    # decode-shaped grid at or below this m
ACT_CODES = {None: 0, "silu": 1}    # activations the kernel epilogue runs

launches = {"bdmm": 0, "bdmm_decode": 0}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("bdmm")
        fn = lib.bdmm_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


def bdmm(x: torch.Tensor, wp: torch.Tensor, bias: Optional[torch.Tensor] = None,
         scale: Optional[torch.Tensor] = None, *,
         activation: Optional[str] = None) -> torch.Tensor:
    """Block-diagonal matmul ``(..., nb*bi) x (nb, bi, bo) -> (..., nb*bo)``.

    ``bias`` is packed ``(nb*bo,)``. An int8 ``wp`` needs ``scale (nb, bo)``
    (per-output-channel, applied in the epilogue)."""
    nb, bi, bo = wp.shape
    if x.shape[-1] != nb * bi:
        raise ValueError(f"bdmm: x {tuple(x.shape)} vs blocks {tuple(wp.shape)}")
    quant = wp.dtype == torch.int8
    if quant and scale is None:
        raise ValueError("bdmm: int8 blocks need a (nb, bo) scale")
    if scale is not None and tuple(scale.shape) != (nb, bo):
        raise ValueError(f"bdmm: scale {tuple(scale.shape)} != {(nb, bo)}")
    if activation not in ACT_CODES:
        raise ValueError(f"bdmm kernel: activation {activation!r} not in "
                         f"{sorted(k for k in ACT_CODES if k)} or None")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bdmm kernel: x dtype {x.dtype}")
    if not quant and wp.dtype != x.dtype:
        raise ValueError(f"bdmm kernel: blocks {wp.dtype} vs x {x.dtype}")
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    decode = m <= SMALL_M_MAX
    x2 = x.reshape(m, nb * bi).contiguous()
    wp = wp.contiguous()
    y = torch.empty((m, nb * bo), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, nb * bo)
    s = None if scale is None else scale.float().contiguous()
    b = None if bias is None else bias.float().reshape(nb * bo).contiguous()
    _build.require_cuda("bdmm", x2, wp, *(t for t in (s, b) if t is not None))
    lib, fn = _launcher()
    vec = int(bo % 4 == 0 and wp.data_ptr() % 16 == 0)
    code = fn(x2.data_ptr(), wp.data_ptr(), s.data_ptr() if s is not None else None,
              b.data_ptr() if b is not None else None, y.data_ptr(),
              m, nb, bi, bo, _build.DTYPE_CODES[x.dtype], int(quant),
              ACT_CODES[activation], int(decode), vec,
              _build.stream_ptr(x.device))
    _build.check(lib, "bdmm", code)
    launches["bdmm_decode" if decode else "bdmm"] += 1
    return y.reshape(*lead, nb * bo)
