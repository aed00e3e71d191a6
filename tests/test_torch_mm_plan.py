"""The masked matmul's launch plan (``kernels/masked_matmul.py::plan``),
which picks the CUDA body, its tiles and the split of K over blocks, and
the SDDMM's (``sddmm_plan``), which picks its tile. They are plain Python,
so they are held here on the CPU at the shapes the card runs (olmo-1b's
projections and LeNet-300-100's masked layers): the kernels themselves are
tested on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from repro_torch.kernels import masked_matmul as tmm
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

# (K, N) of every olmo-1b projection in both orientations: the forward takes
# (d_in, d_out), the transposed form (dx) (d_out, d_in)
OLMO = {"qkvo": (2048, 2048), "up_gate": (2048, 8192),
        "down": (8192, 2048), "unembed": (2048, 50304)}
CASES = [(k, n) for d_in, d_out in OLMO.values()
         for k, n in ((d_in, d_out), (d_out, d_in))]
IDS = [f"{name}-{o}" for name in OLMO for o in ("fwd", "t")]


def _ranges(p, k):
    return [(s * p.k_chunk, min(k, (s + 1) * p.k_chunk))
            for s in range(p.split)]


@pytest.mark.parametrize("k,n", CASES, ids=IDS)
def test_small_m_plan_is_one_plan_for_every_m(k, n):
    """Every m <= 64 gets the same plan: the tiles, the split and the grid
    follow from (K, N) alone, so a row's output is the same at every m."""
    plans = {tmm.plan(m, k, n, torch.bfloat16)
             for m in range(1, tmm.SMALL_M_MAX + 1)}
    assert len(plans) == 1
    assert plans.pop().route == "tc_small_m"


@pytest.mark.parametrize("k,n", CASES, ids=IDS)
def test_small_m_grid_fills_the_card(k, n):
    p = tmm.plan(4, k, n, torch.bfloat16)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    assert blocks >= tmm.SMS
    assert p.grid[0] * p.tile[0] >= n > (p.grid[0] - 1) * p.tile[0]


@pytest.mark.parametrize("k", [64, 136, 200, 2048, 2047, 8192, 50304])
@pytest.mark.parametrize("n", [45, 200, 2048, 8192])
def test_split_covers_k_exactly_once(k, n):
    """The K ranges of the splits are whole 64-steps, non-empty, disjoint
    and cover [0, K); each keeps MIN_SPLIT_STEPS steps unless K is short."""
    p = tmm.plan(20, k, n, torch.bfloat16)
    assert p.k_chunk % tmm.TILE_K == 0 and p.grid[2] == p.split
    rs = _ranges(p, k)
    assert rs[0][0] == 0 and rs[-1][1] == k
    assert all(a < b for a, b in rs)
    assert all(rs[i][1] == rs[i + 1][0] for i in range(len(rs) - 1))
    if p.split > 1:
        assert p.k_chunk >= tmm.MIN_SPLIT_STEPS * tmm.TILE_K


@pytest.mark.parametrize("m", [65, 100, 2048, 4096])
@pytest.mark.parametrize("k,n", CASES, ids=IDS)
def test_large_m_takes_the_tiled_route(k, n, m):
    p = tmm.plan(m, k, n, torch.bfloat16)
    assert p.route == "tc" and p.split == 1 and p.k_chunk >= k
    assert p.grid == ((-(-n // p.tile[1])) * (-(-m // p.tile[0])), 1, 1)


@pytest.mark.parametrize("m", [1, 4, 64, 65, 2048])
@pytest.mark.parametrize("k,n", [(2048, 8192), (8192, 2048)])
def test_f32_always_takes_simt(m, k, n):
    """f32 is the parity route of the exact phases: never the tensor
    cores (TF32 would not hold their tolerances), always one of the SIMT
    bodies, the small-m one exactly at m <= SMALL_M_MAX."""
    p = tmm.plan(m, k, n, torch.float32)
    assert p.route in tmm.F32_ROUTES and p.route not in ("tc", "tc_small_m")
    assert (p.route == "simt_small_m") == (m <= tmm.SMALL_M_MAX)
    assert tmm.sddmm_plan(k, n, torch.float32).route in tmm.SDDMM_F32_ROUTES


# (K, N) of LeNet-300-100's masked layers, forward (d_in, d_out) and
# transposed (d_out, d_in), and of olmo-1b's projections
LENET_KN = [(800, 300), (300, 100), (100, 10), (300, 800), (100, 300),
            (10, 100)]
F32_KN = LENET_KN + CASES
F32_IDS = [f"lenet-{k}x{n}" for k, n in LENET_KN] + IDS


@pytest.mark.parametrize("k,n", F32_KN, ids=F32_IDS)
def test_f32_small_m_plan_is_one_plan_for_every_m(k, n):
    """Every m <= 64 gets the same f32 plan: channel tile, K split and grid
    follow from (K, N) alone, so a row's output is the same at every m."""
    plans = {tmm.plan(m, k, n, torch.float32)
             for m in range(1, tmm.SMALL_M_MAX + 1)}
    assert len(plans) == 1
    p = plans.pop()
    assert p.route == "simt_small_m" and p.tile == tmm.SIMT_SMALL_TILE
    assert p.grid == (-(-n // p.tile[1]), 1, p.split)


@pytest.mark.parametrize("m", [1, 64, 65, 2048])
@pytest.mark.parametrize("k,n", F32_KN + [(75, 45), (136, 200), (50304, 64)])
def test_f32_split_covers_k_exactly_once(k, n, m):
    """An f32 K split is one cluster (at most the route's
    SIMT_CLUSTER_MAX blocks, within the CLUSTER_MAX that the kernel's
    reduction is built for): its ranges are whole multiples of 4 floats
    (16-byte copies), non-empty, disjoint and cover [0, K)."""
    p = tmm.plan(m, k, n, torch.float32)
    assert 1 <= p.split <= tmm.SIMT_CLUSTER_MAX[p.route] <= tmm.CLUSTER_MAX
    assert p.grid[2] == p.split and p.k_chunk % 4 == 0
    rs = _ranges(p, k)
    assert rs[0][0] == 0 and rs[-1][1] == k
    assert all(a < b for a, b in rs)
    assert all(rs[i][1] == rs[i + 1][0] for i in range(len(rs) - 1))


@pytest.mark.parametrize("m,transpose,blocks", [
    (1, False, 160), (50, False, 160), (50, True, 200), (2048, False, 192)])
def test_f32_grid_at_lenet_800x300(m, transpose, blocks):
    """LeNet's first layer fills the card: 32 channels a block and a K split
    of 16 for batch 1 and 50 (160 blocks, not 3), 200 for dx; the 2048-row
    eval splits K in 4 over its 48 tiles."""
    k, n = (300, 800) if transpose else (800, 300)
    p = tmm.plan(m, k, n, torch.float32)
    assert p.grid[0] * p.grid[1] * p.grid[2] >= blocks


@pytest.mark.parametrize("d_in,d_out", [(800, 300), (300, 100), (100, 10),
                                        (2048, 8192), (8192, 2048),
                                        (2048, 50304), (75, 45)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sddmm_plan_tiles_cover_the_weight_once(d_in, d_out, dtype):
    """The SDDMM's tiles cover (d_in, d_out) exactly once (no tile wholly
    past an edge); f32 keeps 128 x 128 where that fills the card and takes
    64 x 32 at LeNet's widths (130 blocks at 800 x 300, not 21)."""
    p = tmm.sddmm_plan(d_in, d_out, dtype)
    bm, bn = p.tile
    if dtype == torch.bfloat16:
        assert p.route == "tc"
        rows, cols = -(-d_in // bm), -(-d_out // bn)
        assert p.grid == (rows * cols, 1, 1)
    else:
        cols, rows = p.grid[0], p.grid[1]
        assert p.grid[2] == 1
        big = (-(-d_in // 128)) * (-(-d_out // 128)) >= tmm.SMS
        assert p.route == ("simt_f32" if big else "simt_small_tile")
        assert p.tile == ((128, 128) if big else (64, 32))
    assert rows * bm >= d_in > (rows - 1) * bm
    assert cols * bn >= d_out > (cols - 1) * bn
    if (d_in, d_out) == (800, 300) and dtype == torch.float32:
        assert rows * cols == 130


def test_plan_rejects_other_dtypes():
    with pytest.raises(ValueError):
        tmm.plan(4, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        tmm.sddmm_plan(64, 64, torch.float16)


def test_plan_decides_nothing_about_the_card(monkeypatch):
    """The plan is arithmetic on shapes: it runs with CUDA absent and asks
    the runtime nothing."""
    def refuse(*a, **k):
        raise AssertionError("plan asked the CUDA runtime")
    for fn in ("is_available", "device_count", "get_device_properties",
               "current_device"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    for m in (1, 64, 65):
        for dtype in (torch.bfloat16, torch.float32):
            tmm.plan(m, 2048, 8192, dtype)
    tmm.sddmm_plan(800, 300, torch.float32)


@pytest.mark.parametrize("ptr_off,row_bytes,want", [
    (0, 4096, 16), (0, 400, 16), (0, 1000, 8), (0, 260, 4), (0, 250, 2),
    (0, 75, 1), (8, 4096, 8), (2, 4096, 2)])
def test_copy_width_follows_row_alignment(ptr_off, row_bytes, want):
    """Each operand is copied with the widest piece every row start is
    aligned to; the mask rows of N = 200 or 1000 are 8-byte aligned."""
    buf = torch.zeros(4096 + 32, dtype=torch.uint8)
    t = buf[(-buf.data_ptr()) % 16 + ptr_off:]
    assert t.data_ptr() % 16 == ptr_off
    assert tmm._vec(t, row_bytes) == want
