"""The masked matmul's launch plan (``kernels/masked_matmul.py::plan``),
which picks the CUDA body, its tiles and the split of K over blocks. It is
plain Python, so it is held here on the CPU at the shapes the card runs:
the kernels themselves are tested on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from repro_torch.kernels import masked_matmul as tmm

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
    cores (TF32 would not hold their tolerances)."""
    p = tmm.plan(m, k, n, torch.float32)
    assert p.route == "simt_f32" and p.split == 1


def test_plan_rejects_other_dtypes():
    with pytest.raises(ValueError):
        tmm.plan(4, 64, 64, torch.float16)


def test_plan_decides_nothing_about_the_card(monkeypatch):
    """The plan is arithmetic on shapes: it runs with CUDA absent and asks
    the runtime nothing."""
    def refuse(*a, **k):
        raise AssertionError("plan asked the CUDA runtime")
    for fn in ("is_available", "device_count", "get_device_properties",
               "current_device"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    for m in (1, 64, 65):
        tmm.plan(m, 2048, 8192, torch.bfloat16)


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
