"""bdmm's launch plan (``kernels/bdmm.py::plan``), which picks the CUDA body
of the general grid, its tiles and its grid. It is plain Python, so it is
held here on the CPU at the shapes the card runs: the kernels themselves
are tested on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bdmm as tbdmm
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

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
    the decode grid, up to 64 rows (and the transposed form at m <= 32)
    the small SIMT body, above it the tiled one for these wide blocks."""
    if w_dtype == torch.int8 and transpose:
        with pytest.raises(ValueError):
            tbdmm.plan(m, 8, 256, 1024, torch.float32, w_dtype, transpose)
        return
    p = tbdmm.plan(m, 8, 256, 1024, torch.float32, w_dtype, transpose)
    want = ("decode_simt" if m <= tbdmm.SMALL_M_MAX and not transpose
            else "simt_small" if m <= 64 else "simt_f32")
    assert p.route == want and p.route in tbdmm.F32_ROUTES


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


# ------------------------------------------------ f32 on the paper's path
# LeNet-300-100's packed blocks (nb, bi, bo) under uniform(c, min_block=1)
# (c = 16 takes c = 10's) and the speedup layer's blocks
LENET_BLOCKS = {10: [(10, 80, 30), (10, 30, 10), (10, 10, 1)],
                4: [(4, 200, 75), (4, 75, 25), (2, 50, 5)],
                8: [(5, 160, 60), (5, 60, 20), (5, 20, 2)]}
SPEEDUP = (8, 256, 256)
# (m, transpose) on the paper path: batch-1 inference, a training batch
# (forward and dx), the 2048-sample eval
ROLES = {"m1": (1, False), "m50": (50, False), "m50-dx": (50, True),
         "m2048": (2048, False)}
D, S, T = "decode_simt", "simt_small", "simt_f32"
# the plan's (route, K split) in each role, in ROLES' order: narrow blocks
# take the small body at every m, K split in a cluster at 33-64 rows where
# their few blocks leave SMs idle (the decode grid splits only K > 256, and
# many row tiles not at all); the speedup's wide blocks the tiled body at
# 2048
F32_PLANS = {
    (10, 80, 30): ((D, 1), (S, 4), (S, 1), (S, 1)),
    (10, 30, 10): ((D, 1), (S, 1), (S, 1), (S, 1)),
    (10, 10, 1): ((D, 1), (S, 1), (S, 1), (S, 1)),
    (4, 200, 75): ((D, 1), (S, 8), (S, 4), (S, 1)),
    (4, 75, 25): ((D, 1), (S, 4), (S, 1), (S, 1)),
    (2, 50, 5): ((D, 1), (S, 2), (S, 1), (S, 1)),
    (5, 160, 60): ((D, 1), (S, 8), (S, 2), (S, 1)),
    (5, 60, 20): ((D, 1), (S, 2), (S, 1), (S, 1)),
    (5, 20, 2): ((D, 1), (S, 1), (S, 1), (S, 1)),
    SPEEDUP: ((D, 1), (S, 4), (S, 4), (T, 1)),
}
# the speedup layer's own rows: (m, transpose) -> (route, split)
SPEEDUP_PLANS = {(512, False): (T, 2), (512, True): (T, 2), (2048, False): (T, 1)}
F32_EXPECT = {(blk, *ROLES[r]): want for blk, wants in F32_PLANS.items()
              for r, want in zip(ROLES, wants)}
F32_EXPECT.update({(SPEEDUP, m, t): want
                   for (m, t), want in SPEEDUP_PLANS.items()})
F32_CASES = list(F32_EXPECT)
F32_IDS = [f"{nb}x{bi}x{bo}-m{m}{'-dx' if t else ''}"
           for (nb, bi, bo), m, t in F32_CASES]


def _f32_plan(blk, m, transpose, w_dtype=torch.float32):
    nb, bi, bo = blk
    k, n = (bo, bi) if transpose else (bi, bo)
    return tbdmm.plan(m, nb, k, n, torch.float32, w_dtype, transpose), (nb, k, n)


def test_lenet_blocks_are_the_configs():
    """The table's blocks are LeNet300's packed plans at c = 10, 4, 8."""
    from repro_torch.configs.lenet300 import LeNet300
    from repro_torch.core.policy import uniform
    for c, blocks in LENET_BLOCKS.items():
        specs = LeNet300(policy=uniform(c, min_block=1)).specs
        assert [(s.mask.nb, s.mask.block_in, s.mask.block_out)
                for s in specs] == blocks


@pytest.mark.parametrize("blk,m,transpose", F32_CASES, ids=F32_IDS)
def test_f32_paper_shapes_take_the_named_plan(blk, m, transpose):
    """Each LeNet block and the speedup's blocks, in each role, take the
    body, tile, K split and cluster (the split's blocks along z) named
    above; the grid covers the channels, the blocks and the token tiles of
    every split."""
    p, (nb, k, n) = _f32_plan(blk, m, transpose)
    assert (p.route, p.split) == F32_EXPECT[(blk, m, transpose)]
    assert p.tile == tbdmm.TILES[p.route]
    tok, ch = p.tile
    assert p.grid == (_cdiv(n, ch), nb, _cdiv(m, tok) * p.split)
    body = "simt_f32" if p.route == "simt_f32" else "simt_small"
    assert p.split <= tbdmm.SIMT_CLUSTER_MAX[body] <= 16


@pytest.mark.parametrize("blk,m,transpose", F32_CASES, ids=F32_IDS)
def test_f32_grid_covers_every_tile_once(blk, m, transpose):
    """Every (block, token tile, channel tile, K split) of the output
    belongs to exactly one block of the f32 grid, as the kernels read
    their blockIdx."""
    p, (nb, k, n) = _f32_plan(blk, m, transpose)
    owned = [t for bx in range(p.grid[0]) for by in range(p.grid[1])
             for bz in range(p.grid[2])
             for t in tbdmm.block_tiles(p, m, nb, n, bx, by, bz)]
    assert len(owned) == len(set(owned))
    tok, ch = p.tile
    want = {(b, t, c, s) for b in range(nb) for t in range(0, m, tok)
            for c in range(0, n, ch) for s in range(p.split)}
    assert set(owned) == want


@pytest.mark.parametrize("k", [1, 5, 30, 80, 200, 256, 257, 1000, 1024,
                               4096, 6288, 8192])
@pytest.mark.parametrize("m,nb,n,transpose", [
    (1, 10, 30, False), (50, 10, 30, False), (50, 4, 200, True),
    (2048, 2, 5, False), (4, 8, 256, False), (64, 8, 1024, False),
    (512, 8, 256, False), (512, 8, 256, True), (2048, 8, 6288, False)])
def test_f32_split_covers_k_exactly_once(m, nb, n, transpose, k):
    """The f32 bodies' K ranges are multiples of 4 floats (16-byte copies),
    non-empty, disjoint and cover [0, K), in one cluster of at most 16
    blocks (4 on the tiled body); up to 64 rows a small block's range fits
    its ring of SIMT_SMALL_K rows unless the cluster is full (more rows
    take no split and cycle K through the ring)."""
    p = tbdmm.plan(m, nb, k, n, torch.float32, torch.float32, transpose)
    assert p.route in tbdmm.F32_ROUTES and p.k_chunk % 4 == 0
    body = "simt_f32" if p.route == "simt_f32" else "simt_small"
    assert 1 <= p.split <= tbdmm.SIMT_CLUSTER_MAX[body]
    rs = [(s * p.k_chunk, min(k, (s + 1) * p.k_chunk)) for s in range(p.split)]
    assert rs[0][0] == 0 and rs[-1][1] == k
    assert all(a < b for a, b in rs)
    assert all(rs[i][1] == rs[i + 1][0] for i in range(len(rs) - 1))
    if body == "simt_small" and m <= 64 and p.split < tbdmm.SIMT_CLUSTER_MAX[body]:
        assert p.k_chunk <= tbdmm.SIMT_SMALL_K
    if p.route == "simt_small" and m > 64:
        assert p.split == 1


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("blk", [b for bs in LENET_BLOCKS.values() for b in bs]
                         + list(OLMO.values()))
def test_decode_simt_plan_is_the_same_at_every_m(blk, w_dtype):
    """decode_simt's tile, grid and K split depend on (nb, K, N) alone: the
    same plan at every m <= 32, at LeNet's and olmo-1b's blocks, so row r
    of an m-row call is bit for bit row r of the same rows cut shorter."""
    plans = {_f32_plan(blk, m, False, w_dtype)[0]
             for m in range(1, tbdmm.SMALL_M_MAX + 1)}
    assert len(plans) == 1 and plans.pop().route == "decode_simt"
