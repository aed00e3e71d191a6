"""bdmm's launch plan (``kernels/bdmm.py::plan``), which picks the CUDA body
of the general grid, its tiles and its grid. It is plain Python, so it is
held here on the CPU at the shapes the card runs: the kernels themselves
are tested on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bdmm as tbdmm

# (nb, bi, bo) of olmo-1b's packed projections at mpd_c=8
OLMO = {"qkvo": (8, 256, 256), "up_gate": (8, 256, 1024),
        "down": (8, 1024, 256), "unembed": (8, 256, 6288)}
# (nb, k, n, transpose): the forward reduces bi into bo, dx bo into bi
CASES = [(nb, *((bo, bi) if t else (bi, bo)), t)
         for nb, bi, bo in OLMO.values() for t in (False, True)]
IDS = [f"{name}-{o}" for name in OLMO for o in ("fwd", "dx")]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("m", [33, 64, 65, 2048])
@pytest.mark.parametrize("nb,k,n,transpose", CASES, ids=IDS)
def test_olmo_shapes_take_the_named_route_and_tiles(nb, k, n, transpose, m):
    """bf16 blocks take the tiled body, 128 x 128 tiles (tokens x channels),
    one persistent block an SM at most; int8 blocks (the served prefill
    chunk) the small-m body with 64 x 64 tiles (channels x tokens), K split
    only where its tiles leave most SMs idle."""
    p = tbdmm.plan(m, nb, k, n, torch.bfloat16, torch.bfloat16, transpose)
    assert (p.route, p.tile, p.split) == ("tc", (128, 128), 1)
    tiles = _cdiv(n, 128) * _cdiv(m, 128) * nb
    assert p.grid == (min(tiles, tbdmm.SMS), 1, 1)
    if transpose:
        return
    q = tbdmm.plan(m, nb, k, n, torch.bfloat16, torch.int8)
    assert (q.route, q.tile) == ("tc_small_m", (64, 64))
    assert q.grid == (_cdiv(n, 64), nb, _cdiv(m, 64) * q.split)
    tiles = _cdiv(n, 64) * nb * _cdiv(m, 64)
    assert (q.split > 1) == (2 * tiles < tbdmm.SMS and k > 64)
    if q.split > 1:     # every SM has a block, or each split one step
        assert (q.grid[0] * q.grid[1] * q.grid[2] >= tbdmm.SMS
                or q.k_chunk == tbdmm.TILE_K)


@pytest.mark.parametrize("route_args", [
    (33, torch.bfloat16, torch.int8, False),
    (300, torch.bfloat16, torch.bfloat16, False),
    (300, torch.bfloat16, torch.bfloat16, True),
    (300, torch.bfloat16, torch.int8, False),
    (70, torch.float32, torch.float32, True),
    (5, torch.float32, torch.float32, False),
    (5, torch.bfloat16, torch.bfloat16, True),
    (5, torch.bfloat16, torch.bfloat16, False),
    (32, torch.bfloat16, torch.int8, False)],
    ids=["small_m", "tc", "tc-dx", "int8", "simt-dx", "decode", "tc-dx-m5",
         "decode_tc", "decode_tc-int8"])
@pytest.mark.parametrize("nb,k,n", [(3, 200, 136), (8, 256, 6288),
                                    (2, 100, 75), (8, 1024, 256)])
def test_grid_covers_every_tile_once(route_args, nb, k, n):
    """Every (block, token tile, channel tile, K split) of the output
    belongs to exactly one block of the grid, as the kernel reads its
    blockIdx, and every split has its blocks."""
    m, dt, wdt, transpose = route_args
    p = tbdmm.plan(m, nb, k, n, dt, wdt, transpose)
    owned = [t for bx in range(p.grid[0]) for by in range(p.grid[1])
             for bz in range(p.grid[2])
             for t in tbdmm.block_tiles(p, m, nb, n, bx, by, bz)]
    assert len(owned) == len(set(owned))
    assert {t[3] for t in owned} == set(range(p.split))
    owned = [t[:3] for t in owned if t[3] == 0]
    if p.route in tbdmm.DECODE_ROUTES:
        tok_step, ch_step = m, p.tile[0]
    elif p.route == "tc_small_m":
        tok_step, ch_step = p.tile[1], p.tile[0]
    else:
        tok_step, ch_step = p.tile
    want = {(b, t, c) for b in range(nb) for t in range(0, m, tok_step)
            for c in range(0, n, ch_step)}
    assert set(owned) == want


@pytest.mark.parametrize("k", [64, 100, 256, 1024, 6288])
@pytest.mark.parametrize("m,nb,n", [(64, 8, 256), (64, 8, 1024), (33, 3, 75),
                                    (128, 8, 256), (300, 8, 256)])
def test_split_covers_k_exactly_once(m, nb, n, k):
    """The small-m body's K ranges (int8 blocks) are whole 64-steps,
    non-empty, disjoint and cover [0, K)."""
    p = tbdmm.plan(m, nb, k, n, torch.bfloat16, torch.int8)
    assert p.route == "tc_small_m" and p.k_chunk % tbdmm.TILE_K == 0
    rs = [(s * p.k_chunk, min(k, (s + 1) * p.k_chunk)) for s in range(p.split)]
    assert rs[0][0] == 0 and rs[-1][1] == k
    assert all(a < b for a, b in rs)
    assert all(rs[i][1] == rs[i + 1][0] for i in range(len(rs) - 1))


@pytest.mark.parametrize("m", [1, 32, 33, 64, 2048])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("transpose", [False, True])
def test_f32_always_takes_simt(m, w_dtype, transpose):
    """f32 is the parity route of the exact phases: never the tensor cores
    (TF32 would not hold their tolerances); at m <= 32 the forward keeps
    the decode grid, the transposed form (dx) the SIMT body."""
    if w_dtype == torch.int8 and transpose:
        with pytest.raises(ValueError):
            tbdmm.plan(m, 8, 256, 1024, torch.float32, w_dtype, transpose)
        return
    p = tbdmm.plan(m, 8, 256, 1024, torch.float32, w_dtype, transpose)
    want = ("decode_simt" if m <= tbdmm.SMALL_M_MAX and not transpose
            else "simt_f32")
    assert p.route == want


@pytest.mark.parametrize("m", range(1, tbdmm.SMALL_M_MAX + 1, 7))
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.float32, torch.float32), (torch.float32, torch.int8)])
def test_small_m_forward_is_left_to_the_decode_grid(m, dtype, w_dtype):
    """At m <= 32 the forward takes the decode grid: bf16 the mma.sync body
    (64 channels a block; the unembed's 99 x 8 tiles fill the card without
    a K split), f32 the exact SIMT body (32 channels a block)."""
    p = tbdmm.plan(m, 8, 256, 6288, dtype, w_dtype)
    if dtype == torch.bfloat16:
        assert (p.route, p.grid, p.split) == ("decode_tc", (_cdiv(6288, 64), 8, 1), 1)
    else:
        assert (p.route, p.grid) == ("decode_simt", (_cdiv(6288, 32), 8, 1))
    assert tbdmm.plan(tbdmm.SMALL_M_MAX + 1, 8, 256, 6288, dtype,
                      w_dtype).route not in tbdmm.DECODE_ROUTES


# the decode grid's K split at olmo-1b's packed shapes: (split, k_chunk). A
# block holds up to 256 rows of K in flight (4 stages); only the down
# projection's 1024 rows are split, over the 4 blocks of one cluster
DECODE_SPLITS = {"qkvo": (1, 256), "up_gate": (1, 256), "down": (4, 256),
                 "unembed": (1, 256)}


@pytest.mark.parametrize("name", list(OLMO))
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.int8])
def test_decode_grid_splits_k_at_olmo_shapes(name, w_dtype):
    nb, bi, bo = OLMO[name]
    p = tbdmm.plan(4, nb, bi, bo, torch.bfloat16, w_dtype)
    assert (p.split, p.k_chunk) == DECODE_SPLITS[name]
    assert p.grid == (_cdiv(bo, 64), nb, p.split)


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nb,k,n", [(8, 256, 256), (8, 256, 1024),
                                    (8, 1024, 256), (8, 256, 6288),
                                    (3, 200, 136), (1, 8192, 64)])
def test_decode_plan_does_not_depend_on_m(nb, k, n, w_dtype):
    """Row r of an m-row call must be bit for bit row r of the same input
    cut to fewer rows (the speculative verify windows hold the decode steps
    to it): the decode grid's tiles, split and K ranges are the same for
    every m from 1 to 32."""
    plans = {tbdmm.plan(m, nb, k, n, torch.bfloat16, w_dtype)
             for m in range(1, tbdmm.SMALL_M_MAX + 1)}
    assert len(plans) == 1
    f32 = {tbdmm.plan(m, nb, k, n, torch.float32, w_dtype)
           for m in range(1, tbdmm.SMALL_M_MAX + 1)}
    assert len(f32) == 1


@pytest.mark.parametrize("k", [64, 100, 256, 1024, 6288])
@pytest.mark.parametrize("nb,n", [(8, 256), (8, 1024), (3, 75), (1, 64),
                                  (8, 6288)])
def test_decode_split_covers_k_exactly_once(nb, n, k):
    """The decode grid's K ranges are whole 64-row steps, at least 256 rows
    (or all of K), non-empty, disjoint and cover [0, K) in at most 8 splits
    (one cluster)."""
    p = tbdmm.plan(4, nb, k, n, torch.bfloat16, torch.int8)
    assert p.route == "decode_tc" and p.k_chunk % tbdmm.TILE_K == 0
    assert p.k_chunk >= min(k, tbdmm.DECODE_K_CHUNK)
    assert p.split <= tbdmm.DECODE_SPLIT_MAX     # a split is one cluster
    rs = [(s * p.k_chunk, min(k, (s + 1) * p.k_chunk)) for s in range(p.split)]
    assert rs[0][0] == 0 and rs[-1][1] == k
    assert all(a < b for a, b in rs)
    assert all(rs[i][1] == rs[i + 1][0] for i in range(len(rs) - 1))


@pytest.mark.parametrize("m", [64, 2048])
@pytest.mark.parametrize("vec_x,vec_w,route", [
    (16, 16, "tc"), (8, 16, "tc_small_m"), (16, 8, "tc_small_m"),
    (2, 1, "tc_small_m")])
def test_rows_tma_refuses_take_the_copying_body(vec_x, vec_w, route, m):
    """The tiled body loads and stores by TMA alone, which needs 16-byte
    rows; other rows take the small-m body, which copies with cp.async."""
    p = tbdmm.plan(m, 8, 256, 1024, torch.bfloat16, torch.bfloat16,
                   False, vec_x, vec_w)
    assert p.route == route


@pytest.mark.parametrize("ptr_off,k,es,want", [
    (0, 256, 2, 16), (0, 200, 2, 16), (0, 100, 2, 8), (0, 130, 2, 4),
    (0, 75, 2, 2), (0, 75, 1, 1), (0, 6288, 1, 16), (8, 256, 2, 8),
    (2, 256, 2, 2)])
def test_copy_width_follows_row_alignment(ptr_off, k, es, want):
    """The copy width of x's rows within a block (k values of es bytes, the
    rows nb * k apart) and of the blocks' rows: the widest piece that every
    row start is aligned to (16 lets TMA read them)."""
    buf = torch.zeros(8 * 4096 + 32, dtype=torch.uint8)
    t = buf[(-buf.data_ptr()) % 16 + ptr_off:]
    assert t.data_ptr() % 16 == ptr_off
    assert _build.copy_width(t, k * es) == want


def test_plan_rejects_int8_dx_and_other_dtypes():
    with pytest.raises(ValueError):
        tbdmm.plan(64, 8, 256, 256, torch.bfloat16, torch.int8, True)
    with pytest.raises(ValueError):
        tbdmm.plan(64, 8, 256, 256, torch.float16, torch.float16)


def test_plan_decides_nothing_about_the_card(monkeypatch):
    """The plan is arithmetic on shapes: it runs with CUDA absent and asks
    the runtime nothing."""
    def refuse(*a, **k):
        raise AssertionError("plan asked the CUDA runtime")
    for fn in ("is_available", "device_count", "get_device_properties",
               "current_device"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    for m in (1, 64, 129, 2048):
        tbdmm.plan(m, 8, 256, 1024, torch.bfloat16, torch.bfloat16)
        tbdmm.plan(m, 8, 1024, 256, torch.bfloat16, torch.bfloat16, True)
