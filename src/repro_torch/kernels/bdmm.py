"""Block-diagonal matmul (the port of ``repro.kernels.bdmm``).

``bdmm`` computes, for packed inputs ``x (..., nb*bi)`` and packed diagonal
blocks ``wp (nb, bi, bo)``::

    y[..., n*bo:(n+1)*bo] = act(x[..., n*bi:(n+1)*bi] @ wp[n] (* scale[n]) + b[n])

and, with ``transpose=True``, ``y[..., n*bi:(n+1)*bi] = x[..., n*bo:(n+1)*bo]
@ wp[n]ᵀ`` (the input gradient, reading ``wp`` as stored). It launches one
of the bodies of ``csrc/bdmm.cu`` that :func:`plan` picks: for bf16 the
decode-shaped grid on mma.sync at ``m <= 32`` and the tensor-core bodies
above; for f32 (exact, FFMA) a small body (``decode_simt`` at ``m <= 32``,
``simt_small`` for narrow blocks and up to 64 rows) or the tiled one
(``simt_f32``). Inputs must lie on one CUDA device;
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain version
before they get here. ``launches`` counts kernel launches per grid shape,
``routes`` the launches by the body that ran them, ``transposed_routes``
the transposed launches among those and ``epilogues`` the launches by
activation and weight type.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from . import _build
from .masked_matmul import k_chunk_of

SMALL_M_MAX = 32                    # decode-shaped grid at or below this m
TILE_K = 64                         # K step of the tensor-core bodies
SMS = 132                           # the H100's streaming multiprocessors
DECODE_K_CHUNK = 256                # decode_tc: K rows a block holds in flight (4 stages)
DECODE_SPLIT_MAX = 8                # decode_tc: a K split is one cluster, at most 8 blocks
ACT_CODES = _build.ACT_CODES       # activations the kernel epilogue runs
# the bodies of csrc/bdmm.cu (Route)
ROUTES = {"decode_simt": 0, "simt_f32": 1, "tc": 2, "tc_small_m": 3,
          "decode_tc": 4, "simt_small": 5}
DECODE_ROUTES = ("decode_tc", "decode_simt")
# the exact f32 bodies (FFMA on the CUDA cores): decode_simt (the forward at
# m <= 32), simt_small (64-row tiles of 32 channels) and the tiled simt_f32
F32_ROUTES = ("decode_simt", "simt_small", "simt_f32")
# output tile each route is built for: (MMA M side, MMA N side) - tokens x
# channels on tc and the f32 bodies (decode_simt: every row, 32 channels),
# channels x tokens on tc_small_m; decode_tc's blocks own 64 channels of
# every row
TILES = {"decode_tc": (64, SMALL_M_MAX), "decode_simt": (32, SMALL_M_MAX),
         "simt_small": (64, 32), "simt_f32": (128, 128), "tc": (128, 128),
         "tc_small_m": (64, 64)}
# f32: the tiled body takes blocks of at least this many channels above 64
# rows; narrower blocks (LeNet's N of 1 to 75) would leave most of its
# 128-channel tile idle
SIMT_WIDE_N = 128
# f32 K split, one cluster: up to 16 small blocks (several share an SM), 4
# tiled ones (one an SM); each split keeps SIMT_MIN_SPLIT_K of K, and a
# small block holds at most SIMT_SMALL_K rows of K in flight (8 stages of
# 32: deeper ranges cycle through its ring)
SIMT_CLUSTER_MAX = {"simt_small": 16, "simt_f32": 4}
SIMT_MIN_SPLIT_K = 16
SIMT_SMALL_K = 256

launches = {"bdmm": 0, "bdmm_decode": 0}
# launches by epilogue: "<activation>/<int8 or fp>" ("none" without one)
epilogues = {f"{a or 'none'}/{w}": 0 for a in ACT_CODES
             for w in ("fp", "int8")}
routes = {r: 0 for r in ROUTES}
transposed_routes = {r: 0 for r in ROUTES}
_entry = None


@dataclass(frozen=True)
class Plan:
    """How one bdmm runs on the card: the body, its output tile, the grid
    ``(x, y, z)`` (see :func:`block_tiles` for what each block owns) and the
    split of K over blocks (split ``s`` covers ``[s * k_chunk, min(K, (s +
    1) * k_chunk))``; one cluster on decode_tc and the f32 bodies)."""
    route: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]
    split: int = 1
    k_chunk: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _f32_split(route: str, tiles: int, k: int) -> Tuple[int, int]:
    """``(split, k_chunk)`` of an f32 body's K over one cluster. The tiled
    body doubles the split while the doubled grid still fits the SMs in one
    wave, ``simt_small`` while its ``tiles`` blocks leave SMs idle, each
    split keeping ``SIMT_MIN_SPLIT_K`` of K; the small bodies then on
    until a block's range fits ``SIMT_SMALL_K``; all up to the
    body's ``SIMT_CLUSTER_MAX``, then halved until ``k_chunk_of`` leaves no
    range empty. ``decode_simt`` splits only past ``SIMT_SMALL_K``, from
    ``(k, n, nb)`` alone as the decode grid must: at LeNet's batch 1 a split
    of the few blocks ran slower than none (the cluster's launch and sum
    cost more than the parallel loads buy; ``benchmarks/torch_bdmm.py
    --mode f32_sweep``)."""
    tiled = route == "simt_f32"
    cap, split = SIMT_CLUSTER_MAX["simt_f32" if tiled else "simt_small"], 1
    while (route != "decode_simt" and split < cap
           and k // (2 * split) >= SIMT_MIN_SPLIT_K
           and (2 * tiles * split <= SMS if tiled else tiles * split < SMS)):
        split *= 2
    while not tiled and split < cap and _cdiv(k, split) > SIMT_SMALL_K:
        split *= 2
    while k_chunk_of(k, split) is None:
        split //= 2
    return split, k_chunk_of(k, split)


def _f32_plan(m: int, nb: int, k: int, n: int, transpose: bool) -> Plan:
    if not transpose and m <= SMALL_M_MAX:
        route = "decode_simt"
    elif m <= TILES["simt_small"][0] or n < SIMT_WIDE_N:
        route = "simt_small"
    else:
        route = "simt_f32"
    tok, ch = TILES["simt_f32" if route == "simt_f32" else "simt_small"]
    tiles = (_cdiv(n, ch), nb, _cdiv(m, tok))
    if route == "simt_small" and tiles[2] > 1:   # many row tiles: no split
        return Plan(route, TILES[route], tiles, 1, k_chunk_of(k, 1))
    split, k_chunk = _f32_split(route, tiles[0] * tiles[1] * tiles[2], k)
    return Plan(route, TILES[route], (tiles[0], nb, tiles[2] * split), split,
                k_chunk)


def plan(m: int, nb: int, k: int, n: int, dtype: torch.dtype,
         w_dtype: torch.dtype, transpose: bool = False, vec_x: int = 16,
         vec_w: int = 16) -> Plan:
    """The launch plan of a bdmm of ``m`` rows over ``nb`` blocks that each
    reduce ``k`` and give ``n`` channels (``k, n = bo, bi`` transposed).
    ``vec_x`` / ``vec_w``: the copy width of the rows of x and the blocks
    (:func:`_build.copy_width`); TMA needs 16. f32 stays exact (FFMA on the
    CUDA cores) on a small body - the forward at ``m <= SMALL_M_MAX`` on
    ``decode_simt``, else ``simt_small`` up to 64 rows and for blocks of
    fewer than ``SIMT_WIDE_N`` channels, in 64-row tiles (32 channels a
    block) - or on the tiled ``simt_f32`` (128 x 128 tiles), each with a K
    split over a cluster where its blocks leave SMs idle; ``simt_small``
    splits only a single 64-row tile (at LeNet's 2048 rows every split ran
    slower, ``benchmarks/torch_bdmm.py --mode f32_sweep``). Up to 64 rows
    the small body's plan depends on ``(nb, k, n)`` only, never on ``m``. bf16
    at ``m <= SMALL_M_MAX`` (forward) takes the decode grid on mma.sync, a
    block a tile of 64 channels over up to ``DECODE_K_CHUNK`` rows of K
    (deeper K is split over the blocks of one cluster), a plan that depends
    on ``(nb, k, n)`` only; above, bf16 blocks take the tiled tensor-core
    body where TMA can read x and the blocks (one persistent block an SM;
    it beat the small-m body at every m from 33 to 128), else - and every
    int8 block - the small-m one, which splits K when its tiles fill fewer
    than half the SMs, until two blocks an SM have work."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bdmm kernel: x dtype {dtype}")
    if w_dtype == torch.int8 and transpose:
        raise ValueError("bdmm kernel: int8 blocks run forward only")
    if dtype == torch.float32:
        return _f32_plan(m, nb, k, n, transpose)
    if not transpose and m <= SMALL_M_MAX:
        route = "decode_tc"
    elif w_dtype == torch.bfloat16 and vec_x == 16 and vec_w == 16:
        route = "tc"
    else:
        route = "tc_small_m"
    tile = TILES[route]
    k_all = _cdiv(k, TILE_K) * TILE_K
    steps = _cdiv(k, TILE_K)
    if route == "decode_tc":
        k_chunk = max(DECODE_K_CHUNK, _cdiv(steps, DECODE_SPLIT_MAX) * TILE_K)
        split = _cdiv(k, k_chunk)
        return Plan(route, tile, (_cdiv(n, tile[0]), nb, split), split, k_chunk)
    if route == "tc":
        tiles = _cdiv(n, tile[1]) * _cdiv(m, tile[0]) * nb
        return Plan(route, tile, (min(tiles, SMS), 1, 1), 1, k_all)
    tiles = _cdiv(n, tile[0]) * nb * _cdiv(m, tile[1])
    want = (1 if 2 * tiles >= SMS
            else max(_cdiv(SMS, tiles), round(2 * SMS / tiles)))
    k_chunk = _cdiv(steps, max(1, min(want, steps))) * TILE_K
    split = _cdiv(k, k_chunk)
    return Plan(route, tile, (_cdiv(n, tile[0]), nb, _cdiv(m, tile[1]) * split),
                split, k_chunk)


def block_tiles(p: Plan, m: int, nb: int, n: int, bx: int, by: int,
                bz: int) -> List[Tuple[int, int, int, int]]:
    """``(block n, first token, first channel, split)`` of every output tile
    that block ``(bx, by, bz)`` of plan ``p`` owns, as the kernel reads its
    ``blockIdx`` (the decode grids' blocks own every token, decode_tc's
    over K split ``bz``; tc's persistent blocks walk the tiles ``bx, bx +
    grid[0], ...``, channel tile fastest, then token tile, then block; the
    f32 bodies' ``bz`` is token tile * split + split)."""
    if p.route == "tc":
        nt, mt = _cdiv(n, p.tile[1]), _cdiv(m, p.tile[0])
        return [(i // nt // mt, i // nt % mt * p.tile[0], i % nt * p.tile[1], 0)
                for i in range(bx, nt * mt * nb, p.grid[0])]
    if p.route == "tc_small_m":
        tok_tiles = _cdiv(m, p.tile[1])
        return [(by, bz % tok_tiles * p.tile[1], bx * p.tile[0],
                 bz // tok_tiles)]
    if p.route == "decode_tc":
        return [(by, 0, bx * p.tile[0], bz)]
    return [(by, bz // p.split * p.tile[0], bx * p.tile[1], bz % p.split)]


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("bdmm")
        fn = lib.bdmm_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 14 + [P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


def bdmm(x: torch.Tensor, wp: torch.Tensor, bias: Optional[torch.Tensor] = None,
         scale: Optional[torch.Tensor] = None, *,
         activation: Optional[str] = None,
         transpose: bool = False) -> torch.Tensor:
    """Block-diagonal matmul ``(..., nb*bi) x (nb, bi, bo) -> (..., nb*bo)``,
    or with ``transpose`` ``(..., nb*bo) -> (..., nb*bi)`` through each
    ``wp[n]ᵀ``.

    ``bias`` is packed over the output channels. An int8 ``wp`` needs
    ``scale (nb, bo)`` (per-output-channel, applied in the epilogue) and
    runs forward only."""
    nb, bi, bo = wp.shape
    k, n = (bo, bi) if transpose else (bi, bo)
    if x.shape[-1] != nb * k:
        raise ValueError(f"bdmm: x {tuple(x.shape)} vs blocks {tuple(wp.shape)}"
                         f"{' transposed' if transpose else ''}")
    quant = wp.dtype == torch.int8
    if quant and scale is None:
        raise ValueError("bdmm: int8 blocks need a (nb, bo) scale")
    if scale is not None and tuple(scale.shape) != (nb, n):
        raise ValueError(f"bdmm: scale {tuple(scale.shape)} != {(nb, n)}")
    if activation not in ACT_CODES:
        raise ValueError(f"bdmm kernel: activation {activation!r} not in "
                         f"{sorted(k for k in ACT_CODES if k)} or None")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bdmm kernel: x dtype {x.dtype}")
    if not quant and wp.dtype != x.dtype:
        raise ValueError(f"bdmm kernel: blocks {wp.dtype} vs x {x.dtype}")
    if quant and transpose:
        raise ValueError("bdmm kernel: int8 blocks run forward only")
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, nb * k).contiguous()
    wp = wp.contiguous()
    y = torch.empty((m, nb * n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, nb * n)
    s = None if scale is None else scale.float().contiguous()
    b = None if bias is None else bias.float().reshape(nb * n).contiguous()
    _build.require_cuda("bdmm", x2, wp, *(t for t in (s, b) if t is not None))
    vec_x = _build.copy_width(x2, k * x2.element_size())
    vec_w = _build.copy_width(wp, wp.shape[2] * wp.element_size())
    p = plan(m, nb, k, n, x.dtype, wp.dtype, transpose, vec_x, vec_w)
    launch(p, x2, wp, s, b, y, activation, transpose)
    launches["bdmm_decode" if p.route in DECODE_ROUTES else "bdmm"] += 1
    epilogues[f"{activation or 'none'}/{'int8' if quant else 'fp'}"] += 1
    routes[p.route] += 1
    if transpose:
        transposed_routes[p.route] += 1
    return y.reshape(*lead, nb * n)


def launch(p: Plan, x2: torch.Tensor, wp: torch.Tensor,
           scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
           y: torch.Tensor, activation: Optional[str] = None,
           transpose: bool = False) -> None:
    """Launch plan ``p`` on ``x2 (m, nb*k)`` into ``y (m, nb*n)``, the
    operands as :func:`bdmm` prepares them (contiguous, on one card; the
    scale and bias f32). :func:`bdmm` passes the plan :func:`plan` picks;
    a benchmark or a test may pass another one the body is built for.
    Counts nothing."""
    m = x2.shape[0]
    nb, k, n = wp.shape[0], x2.shape[1] // wp.shape[0], y.shape[1] // wp.shape[0]
    ws = (torch.empty((p.split, m, nb * n), dtype=torch.float32,
                      device=x2.device)
          if p.split > 1 and p.route == "tc_small_m" else None)
    lib, fn = _launcher()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = fn(x2.data_ptr(), wp.data_ptr(), ptr(scale), ptr(bias), y.data_ptr(),
              ptr(ws), m, nb, k, n, _build.DTYPE_CODES[x2.dtype],
              int(wp.dtype == torch.int8), ACT_CODES[activation],
              ROUTES[p.route], int(transpose),
              _build.copy_width(x2, k * x2.element_size()),
              _build.copy_width(wp, wp.shape[2] * wp.element_size()),
              p.grid[0], p.split, p.k_chunk, _build.stream_ptr(x2.device))
    _build.check(lib, "bdmm", code)
