"""Masked matmul and its weight gradient (the port of
``repro.kernels.masked_matmul``), the paper-faithful training ops.

* :func:`masked_matmul` — ``y = act(x @ (M∘W) + b)``; with ``transpose_rhs``
  ``y = x @ (M∘W)ᵀ``, which is the input gradient ``dx = g @ (M∘W)ᵀ``.
* :func:`sddmm_masked` — ``dW = (xᵀ @ g) ∘ M``, the weight gradient; off-mask
  entries are exact zeros. bf16 runs on a tensor-core body, f32 on the
  exact SIMT one at the tile :func:`sddmm_plan` picks.

Both launch ``csrc/masked_matmul.cu`` on tensors of one CUDA device; the
mask is ``uint8`` in W's layout. :mod:`repro_torch.kernels.ops`
sends CPU tensors to the plain versions before they get here. ``launches``
counts kernel launches per kernel (the two orientations separately);
``routes`` counts the masked matmul's launches by the body that ran them
(:func:`plan`), ``sddmm_routes`` the SDDMM's (:func:`sddmm_plan`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

ACT_CODES = _build.ACT_CODES       # activations the kernel epilogue runs
# the masked matmul's bodies (csrc/masked_matmul.cu Route)
ROUTES = {"simt_f32": 0, "tc": 1, "tc_small_m": 2, "simt_small_m": 3}
# the SDDMM's bodies (csrc/masked_matmul.cu SddmmRoute): bf16 on tc, f32 on
# the SIMT body at 128 x 128 (simt_f32) or at a smaller tile
SDDMM_ROUTES = {"simt_f32": 0, "tc": 1, "simt_small_tile": 2}
# the exact f32 bodies (FFMA on the CUDA cores) of each
F32_ROUTES = ("simt_small_m", "simt_f32")
SDDMM_F32_ROUTES = ("simt_small_tile", "simt_f32")
SMALL_M_MAX = 64           # rows that take the small-m routes
TILE_K = 64                # K step of the tensor-core routes
# output tile (MMA M side, MMA N side) each route is built for: tokens x
# channels on tc and simt_f32, channels x tokens on tc_small_m
TILES = {"simt_f32": (128, 128), "tc": (256, 128), "tc_small_m": (64, 64)}
# simt_small_m: (rows held, channels a block)
SIMT_SMALL_TILE = (64, 32)
# the f32 SDDMM's tiles (rows of dW, columns), the larger tried first; bf16
SDDMM_F32_TILES = ((128, 128), (64, 32))
SDDMM_TC_TILE = (256, 128)
SMS = 132                  # the H100's streaming multiprocessors
MIN_SPLIT_STEPS = 4        # K steps a tc_small_m split keeps at least
# blocks of an f32 K split (one cluster): up to 16 small-m blocks (four
# share an SM), 4 of simt_f32's (one an SM: clusters of 8 waited for whole
# free halves of a GPC, 0.0384 ms against 0.0222 at LeNet's 300 x 100, m =
# 2048, H100 80GB HBM3, 700 W)
CLUSTER_MAX = 16
SIMT_CLUSTER_MAX = {"simt_small_m": 16, "simt_f32": 4}
# K a split of an f32 body keeps at least (a forward K step of simt_f32,
# half a step of simt_small_m): at LeNet's K of 100 and 300 the deeper
# splits ran fastest (benchmarks/torch_masked_mm.py --mode f32_sweep)
SIMT_MIN_SPLIT_K = 16

launches = {"masked_matmul": 0, "masked_matmul_t": 0, "sddmm_masked": 0}
routes = {r: 0 for r in ROUTES}
sddmm_routes = {r: 0 for r in SDDMM_ROUTES}
_entries = {}


@dataclass(frozen=True)
class Plan:
    """How one masked matmul runs on the card: the body, its output tile,
    the grid, and the split of K over blocks (split ``s`` covers ``[s *
    k_chunk, min(K, (s + 1) * k_chunk))``; blockIdx.z on every body)."""
    route: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]
    split: int
    k_chunk: int


@dataclass(frozen=True)
class SddmmPlan:
    """How one SDDMM runs on the card: the body, its output tile (rows of
    dW, columns) and the grid."""
    route: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_chunk_of(k: int, split: int) -> Optional[int]:
    """The K range of each of ``split`` blocks of an f32 body: a whole
    multiple of 4 floats (16-byte copies); None where that leaves a block
    an empty range."""
    k_chunk = _cdiv(_cdiv(k, split), 4) * 4
    return k_chunk if _cdiv(k, k_chunk) == split else None


def _cluster_split(route: str, tiles: int, k: int) -> Tuple[int, int]:
    """``(split, k_chunk)`` of an f32 body's K over one cluster: doubled
    while ``tiles`` output tiles leave SMs idle, up to the route's
    ``SIMT_CLUSTER_MAX``, each split keeping ``SIMT_MIN_SPLIT_K`` of K, then
    halved until :func:`k_chunk_of` leaves no range empty."""
    split = 1
    while (split < SIMT_CLUSTER_MAX[route] and tiles * split < SMS
           and k // (2 * split) >= SIMT_MIN_SPLIT_K):
        split *= 2
    while k_chunk_of(k, split) is None:
        split //= 2
    return split, k_chunk_of(k, split)


def plan(m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """The launch plan of ``masked_matmul`` for ``x (m, k)`` and an output
    of ``n`` channels. ``m <= SMALL_M_MAX`` rows take a small-m body whose
    tiles and K split follow from ``(k, n)`` alone, so that a row's result
    does not depend on ``m``: bf16 ``tc_small_m`` (tensor cores; K split
    until every SM has a block and, where the split allows, two, each split
    keeping ``MIN_SPLIT_STEPS`` K steps), f32 ``simt_small_m`` (32 channels
    a block, K split over a cluster). More
    rows take the tiled bodies: bf16 ``tc``; f32 ``simt_f32``, whose K is
    split over a cluster where its tiles leave SMs idle. ``transpose_rhs``
    changes the layout of W, not the work, so both orientations share a
    plan."""
    if dtype == torch.float32:
        if m <= SMALL_M_MAX:
            tile = SIMT_SMALL_TILE
            tiles = _cdiv(n, tile[1])
            split, k_chunk = _cluster_split("simt_small_m", tiles, k)
            return Plan("simt_small_m", tile, (tiles, 1, split), split,
                        k_chunk)
        tile = TILES["simt_f32"]
        nt, mt = _cdiv(n, tile[1]), _cdiv(m, tile[0])
        split, k_chunk = _cluster_split("simt_f32", nt * mt, k)
        return Plan("simt_f32", tile, (nt, mt, split), split, k_chunk)
    if dtype != torch.bfloat16:
        raise ValueError(f"masked_matmul kernel: dtype {dtype}")
    route = "tc_small_m" if m <= SMALL_M_MAX else "tc"
    tile = TILES[route]
    k_all = _cdiv(k, TILE_K) * TILE_K
    if route == "tc":        # a 1-D grid, walked in groups of token tiles
        return Plan(route, tile, (_cdiv(n, tile[1]) * _cdiv(m, tile[0]), 1, 1),
                    1, k_all)
    tiles, steps = _cdiv(n, tile[0]), _cdiv(k, TILE_K)
    want = max(_cdiv(SMS, tiles), round(2 * SMS / tiles))
    split = max(1, min(want, steps // MIN_SPLIT_STEPS))
    k_chunk = _cdiv(steps, split) * TILE_K
    split = _cdiv(k, k_chunk)
    return Plan(route, tile, (tiles, 1, split), split, k_chunk)


def sddmm_plan(d_in: int, d_out: int, dtype: torch.dtype) -> SddmmPlan:
    """The launch plan of ``sddmm_masked`` for a ``(d_in, d_out)`` weight.
    bf16 takes the tensor-core body (256 x 128 tiles). f32 takes 128 x 128
    (``simt_f32``) where that grid covers the SMs, as at olmo-1b's widths,
    else 64 x 32 (``simt_small_tile``: 130 blocks at LeNet's 800 x 300,
    not 21). The token count does not enter."""
    if dtype == torch.bfloat16:
        tile = SDDMM_TC_TILE
        return SddmmPlan("tc", tile, (_cdiv(d_in, tile[0])
                                      * _cdiv(d_out, tile[1]), 1, 1))
    if dtype != torch.float32:
        raise ValueError(f"sddmm_masked kernel: dtype {dtype}")
    for tile in SDDMM_F32_TILES:
        grid = (_cdiv(d_out, tile[1]), _cdiv(d_in, tile[0]), 1)
        if grid[0] * grid[1] >= SMS:
            break
    route = "simt_f32" if tile == TILES["simt_f32"] else "simt_small_tile"
    return SddmmPlan(route, tile, grid)


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
            fn.argtypes = [P, P, P, P] + [I] * 10 + [P]
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
          if p.split > 1 and p.route == "tc_small_m" else None)
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
    p = sddmm_plan(d_in, d_out, x.dtype)
    lib, fn = _launcher("sddmm")
    code = fn(x2.data_ptr(), g2.data_ptr(), mk.data_ptr(), dw.data_ptr(), m,
              d_in, d_out, _build.DTYPE_CODES[x.dtype], SDDMM_ROUTES[p.route],
              *p.tile, _vec(x2, d_in * x2.element_size()),
              _vec(g2, d_out * g2.element_size()), _vec(mk, d_out),
              _build.stream_ptr(x.device))
    _build.check(lib, "sddmm_masked", code)
    launches["sddmm_masked"] += 1
    sddmm_routes[p.route] += 1
    return dw
