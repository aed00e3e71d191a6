"""Block-diagonal matmul (the port of ``repro.kernels.bdmm``).

``bdmm`` computes, for packed inputs ``x (..., nb*bi)`` and packed diagonal
blocks ``wp (nb, bi, bo)``::

    y[..., n*bo:(n+1)*bo] = act(x[..., n*bi:(n+1)*bi] @ wp[n] (* scale[n]) + b[n])

and, with ``transpose=True``, ``y[..., n*bi:(n+1)*bi] = x[..., n*bo:(n+1)*bo]
@ wp[n]ᵀ`` (the input gradient, reading ``wp`` as stored). It launches one
of the bodies of ``csrc/bdmm.cu`` that :func:`plan` picks: the decode-shaped
grid for ``m <= 32`` rows (mma.sync for bf16, SIMT for f32), the
tensor-core bodies for bf16 and the SIMT body for f32 above. Inputs must lie
on one CUDA device; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain version before they get here. ``launches`` counts kernel launches per
grid shape, ``routes`` the launches by the body that ran them and
``transposed_routes`` the transposed launches among those.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from . import _build

SMALL_M_MAX = 32                    # decode-shaped grid at or below this m
TILE_K = 64                         # K step of the tensor-core bodies
SMS = 132                           # the H100's streaming multiprocessors
DECODE_K_CHUNK = 256                # decode_tc: K rows a block holds in flight (4 stages)
DECODE_SPLIT_MAX = 8                # decode_tc: a K split is one cluster, at most 8 blocks
ACT_CODES = {None: 0, "silu": 1}    # activations the kernel epilogue runs
# the bodies of csrc/bdmm.cu (Route)
ROUTES = {"decode_simt": 0, "simt_f32": 1, "tc": 2, "tc_small_m": 3,
          "decode_tc": 4}
DECODE_ROUTES = ("decode_tc", "decode_simt")
# output tile each route is built for: (MMA M side, MMA N side) - tokens x
# channels on tc and SIMT, channels x tokens on tc_small_m; the decode
# grid's blocks own 64 (decode_tc) or 32 (decode_simt) channels of every
# row
TILES = {"decode_tc": (64, SMALL_M_MAX), "decode_simt": (32, SMALL_M_MAX),
         "simt_f32": (64, 64), "tc": (128, 128), "tc_small_m": (64, 64)}

launches = {"bdmm": 0, "bdmm_decode": 0}
routes = {r: 0 for r in ROUTES}
transposed_routes = {r: 0 for r in ROUTES}
_entry = None


@dataclass(frozen=True)
class Plan:
    """How one bdmm runs on the card: the body, its output tile, the grid
    ``(x, y, z)`` (see :func:`block_tiles` for what each block owns) and, on
    tc_small_m, the split of K over blocks (split ``s`` covers ``[s *
    k_chunk, min(K, (s + 1) * k_chunk))``)."""
    route: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]
    split: int = 1
    k_chunk: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, nb: int, k: int, n: int, dtype: torch.dtype,
         w_dtype: torch.dtype, transpose: bool = False, vec_x: int = 16,
         vec_w: int = 16) -> Plan:
    """The launch plan of a bdmm of ``m`` rows over ``nb`` blocks that each
    reduce ``k`` and give ``n`` channels (``k, n = bo, bi`` transposed).
    ``vec_x`` / ``vec_w``: the copy width of the rows of x and the blocks
    (:func:`_build.copy_width`); TMA needs 16. The forward at ``m <=
    SMALL_M_MAX`` takes the decode grid: bf16 on mma.sync, a block a tile of
    64 channels over up to ``DECODE_K_CHUNK`` rows of K (deeper K is split
    over the blocks of one cluster), a plan that depends on ``(nb, k, n)``
    only, never on ``m``; f32 on the exact SIMT decode body.
    Above, f32 takes the exact SIMT body; bf16 blocks take the tiled
    tensor-core body where TMA can read x and the blocks (one persistent
    block an SM; it beat the small-m body at every m from 33 to 128), else
    - and every int8 block - the small-m one, which splits K when its tiles
    fill fewer than half the SMs, until two blocks an SM have work."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bdmm kernel: x dtype {dtype}")
    if w_dtype == torch.int8 and transpose:
        raise ValueError("bdmm kernel: int8 blocks run forward only")
    if not transpose and m <= SMALL_M_MAX:
        route = "decode_tc" if dtype == torch.bfloat16 else "decode_simt"
    elif dtype == torch.float32:
        route = "simt_f32"
    elif w_dtype == torch.bfloat16 and vec_x == 16 and vec_w == 16:
        route = "tc"
    else:
        route = "tc_small_m"
    tile = TILES[route]
    k_all = _cdiv(k, TILE_K) * TILE_K
    if route == "decode_simt":
        return Plan(route, tile, (_cdiv(n, tile[0]), nb, 1), 1, k_all)
    steps = _cdiv(k, TILE_K)
    if route == "decode_tc":
        k_chunk = max(DECODE_K_CHUNK, _cdiv(steps, DECODE_SPLIT_MAX) * TILE_K)
        split = _cdiv(k, k_chunk)
        return Plan(route, tile, (_cdiv(n, tile[0]), nb, split), split, k_chunk)
    if route == "simt_f32":
        return Plan(route, tile, (_cdiv(n, tile[1]), nb, _cdiv(m, tile[0])),
                    1, k_all)
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
    ``blockIdx`` (the decode grid's blocks own every token, decode_tc's
    over K split ``bz``; tc's persistent blocks walk the tiles ``bx, bx +
    grid[0], ...``, channel tile fastest, then token tile, then block)."""
    if p.route == "tc":
        nt, mt = _cdiv(n, p.tile[1]), _cdiv(m, p.tile[0])
        return [(i // nt // mt, i // nt % mt * p.tile[0], i % nt * p.tile[1], 0)
                for i in range(bx, nt * mt * nb, p.grid[0])]
    if p.route == "tc_small_m":
        tok_tiles = _cdiv(m, p.tile[1])
        return [(by, bz % tok_tiles * p.tile[1], bx * p.tile[0],
                 bz // tok_tiles)]
    if p.route in DECODE_ROUTES:
        return [(by, 0, bx * p.tile[0], bz)]
    return [(by, bz * p.tile[0], bx * p.tile[1], 0)]


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("bdmm")
        fn = lib.bdmm_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 15 + [P]
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
    ws = (torch.empty((p.split, m, nb * n), dtype=torch.float32,
                      device=x.device)
          if p.split > 1 and p.route == "tc_small_m" else None)
    lib, fn = _launcher()
    vec = int(bo % 4 == 0 and wp.data_ptr() % 16 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = fn(x2.data_ptr(), wp.data_ptr(), ptr(s), ptr(b), y.data_ptr(),
              ptr(ws), m, nb, k, n, _build.DTYPE_CODES[x.dtype], int(quant),
              ACT_CODES[activation], ROUTES[p.route], int(transpose), vec,
              vec_x, vec_w, p.grid[0], p.split, p.k_chunk,
              _build.stream_ptr(x.device))
    _build.check(lib, "bdmm", code)
    launches["bdmm_decode" if p.route in DECODE_ROUTES else "bdmm"] += 1
    routes[p.route] += 1
    if transpose:
        transposed_routes[p.route] += 1
    return y.reshape(*lead, nb * n)
