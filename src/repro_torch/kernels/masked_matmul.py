"""Masked matmul and its weight gradient (the port of
``repro.kernels.masked_matmul``), the paper-faithful training ops.

* :func:`masked_matmul` — ``y = act(x @ (M∘W) + b)``; with ``transpose_rhs``
  ``y = x @ (M∘W)ᵀ``, which is the input gradient ``dx = g @ (M∘W)ᵀ``.
* :func:`sddmm_masked` — ``dW = (xᵀ @ g) ∘ M``, the weight gradient; off-mask
  entries are exact zeros. bf16 runs on a tensor-core body, f32 on the
  exact SIMT one.

Both launch ``csrc/masked_matmul.cu`` on tensors of one CUDA device; the
mask is ``uint8`` in W's layout. :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions before they get here. ``launches``
counts kernel launches per kernel (the two orientations separately);
``routes`` counts the masked matmul's launches by the body that ran them
(:func:`plan`), ``sddmm_routes`` the SDDMM's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
# the masked matmul's bodies (csrc/masked_matmul.cu Route)
ROUTES = {"simt_f32": 0, "tc": 1, "tc_small_m": 2}
# the SDDMM's bodies: the same codes, bf16 on tc, f32 on simt_f32
SDDMM_ROUTES = {"simt_f32": 0, "tc": 1}
SMALL_M_MAX = 64           # rows that take the small-m tensor-core route
TILE_K = 64                # K step of the tensor-core routes
# output tile (MMA M side, MMA N side) each route is built for: tokens x
# channels on tc, channels x tokens on tc_small_m, tokens x channels on SIMT
TILES = {"simt_f32": (128, 128), "tc": (256, 128), "tc_small_m": (64, 64)}
SMS = 132                  # the H100's streaming multiprocessors
MIN_SPLIT_STEPS = 4        # K steps a split keeps at least

launches = {"masked_matmul": 0, "masked_matmul_t": 0, "sddmm_masked": 0}
routes = {r: 0 for r in ROUTES}
sddmm_routes = {r: 0 for r in SDDMM_ROUTES}
_entries = {}


@dataclass(frozen=True)
class Plan:
    """How one masked matmul runs on the card: the body, its output tile,
    the grid, and the split of K over blocks (split ``s`` covers ``[s *
    k_chunk, min(K, (s + 1) * k_chunk))``)."""
    route: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]
    split: int
    k_chunk: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """The launch plan of ``masked_matmul`` for ``x (m, k)`` and an output
    of ``n`` channels. f32 takes the SIMT body; bf16 the tensor cores, with
    ``m <= SMALL_M_MAX`` rows on the small-m body, whose tiles and K split
    follow from ``(k, n)`` alone so that a row's result does not depend on
    ``m``. The small-m body splits K until every SM has a block and, where
    the split allows, two (two fit an SM), each split keeping at least
    ``MIN_SPLIT_STEPS`` K steps. ``transpose_rhs`` changes the layout of W,
    not the work, so both orientations share a plan."""
    if dtype == torch.float32:
        route = "simt_f32"
    elif dtype == torch.bfloat16:
        route = "tc_small_m" if m <= SMALL_M_MAX else "tc"
    else:
        raise ValueError(f"masked_matmul kernel: dtype {dtype}")
    tile = TILES[route]
    k_all = _cdiv(k, TILE_K) * TILE_K
    if route == "simt_f32":
        return Plan(route, tile, (_cdiv(n, tile[1]), _cdiv(m, tile[0]), 1),
                    1, k_all)
    if route == "tc":        # a 1-D grid, walked in groups of token tiles
        return Plan(route, tile, (_cdiv(n, tile[1]) * _cdiv(m, tile[0]), 1, 1),
                    1, k_all)
    tiles, steps = _cdiv(n, tile[0]), _cdiv(k, TILE_K)
    want = max(_cdiv(SMS, tiles), round(2 * SMS / tiles))
    split = max(1, min(want, steps // MIN_SPLIT_STEPS))
    k_chunk = _cdiv(steps, split) * TILE_K
    split = _cdiv(k, k_chunk)
    return Plan(route, tile, (tiles, 1, split), split, k_chunk)


_vec = _build.copy_width


def _launcher(name: str):
    if name not in _entries:
        lib = _build.library("masked_matmul")
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "mm":
            fn = lib.masked_matmul_launch
            fn.argtypes = [P, P, P, P, P, P] + [I] * 14 + [P]
        else:
            fn = lib.sddmm_masked_launch
            fn.argtypes = [P, P, P, P] + [I] * 8 + [P]
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
    p = plan(m, k, n, x.dtype)
    ws = (torch.empty((p.split, m, n), dtype=torch.float32, device=x.device)
          if p.split > 1 else None)
    w_row = k if transpose_rhs else n
    lib, fn = _launcher("mm")
    code = fn(x2.data_ptr(), wc.data_ptr(), mk.data_ptr(),
              b.data_ptr() if b is not None else None, y.data_ptr(),
              ws.data_ptr() if ws is not None else None, m, k, n,
              _build.DTYPE_CODES[x.dtype], int(transpose_rhs),
              ACT_CODES[activation], ROUTES[p.route], *p.tile, p.split,
              p.k_chunk, _vec(x2, k * x2.element_size()),
              _vec(wc, w_row * wc.element_size()), _vec(mk, w_row),
              _build.stream_ptr(x.device))
    _build.check(lib, "masked_matmul", code)
    launches["masked_matmul_t" if transpose_rhs else "masked_matmul"] += 1
    routes[p.route] += 1
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
    route = "tc" if x.dtype == torch.bfloat16 else "simt_f32"
    lib, fn = _launcher("sddmm")
    code = fn(x2.data_ptr(), g2.data_ptr(), mk.data_ptr(), dw.data_ptr(), m,
              d_in, d_out, _build.DTYPE_CODES[x.dtype], SDDMM_ROUTES[route],
              _vec(x2, d_in * x2.element_size()),
              _vec(g2, d_out * g2.element_size()), _vec(mk, d_out),
              _build.stream_ptr(x.device))
    _build.check(lib, "sddmm_masked", code)
    launches["sddmm_masked"] += 1
    sddmm_routes[route] += 1
    return dw
