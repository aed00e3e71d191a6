"""The paged-attention kernels' launch plan and their split-KV arithmetic,
on the CPU (no GPU, no nvcc): which body runs, how the KV range is split
and how many blocks the grid has (``kernels/paged_attention.py::plan``);
and the plain mirror of the split blocks and of the combine kernel
(``kernels/ref.py``) held at float32 against the JAX package's Pallas
kernels in interpret mode, within the tolerance of
tests/test_torch_kernels.py (atol 2e-5, rtol 1e-5: the split and combine
differ from the one-pass online softmax by summation order only).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import paged_prefill as jpp
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL, RTOL = 2e-5, 1e-5
S = tpa.SPLIT_PAGES
LADDER = [1, 2, 4, 8, 16, 32, 64]          # the engine's table widths
SMS = 132                                   # the H100's SMs
BF16, F32 = torch.bfloat16, torch.float32


# ----------------------------------------------------------------- the plan
@pytest.mark.parametrize("P", [1, 3, 4, 5, 8, 34, 35, 64])
def test_splits_cover_the_table_once(P):
    ranges = tpa.split_ranges(P)
    pages = [p for a, b in ranges for p in range(a, b)]
    assert pages == list(range(P))
    assert all(0 < b - a <= S for a, b in ranges)


def test_split_boundaries_depend_on_the_split_size_alone():
    """Boundaries at multiples of S pages: a narrower table's splits are a
    prefix of a wider one's (P = 32's of P = 64's), and the plan's split
    count follows from P whatever the tokens, batch, heads or dtype."""
    for P in LADDER:
        assert [a for a, _ in tpa.split_ranges(P)] == list(range(0, P, S))
    for narrow, wide in zip(LADDER, LADDER[1:]):
        if narrow >= S:
            n = len(tpa.split_ranges(narrow))
            assert tpa.split_ranges(wide)[:n] == tpa.split_ranges(narrow)
    for P in LADDER + [34, 35]:
        counts = {tpa.plan(T, H, Kh, 128, P, 16, dt, B, prefill).splits
                  for T in (1, 2, 5, 64) for B in (1, 4, 7)
                  for H, Kh in ((16, 16), (16, 4)) for dt in (BF16, F32)
                  for prefill in (False, True)}
        assert counts == {-(-P // S)}


@pytest.mark.parametrize("name,args", [
    ("decode, P 34", (1, 16, 16, 128, 34, 16, BF16, 4, False)),
    ("decode, P 64", (1, 16, 16, 128, 64, 16, BF16, 4, False)),
    ("decode f32, P 34", (1, 16, 16, 128, 34, 16, F32, 4, False)),
    ("verify k=4, P 35", (5, 16, 16, 128, 35, 16, BF16, 4, False)),
    ("verify GQA 4:1, P 35", (5, 16, 4, 128, 35, 16, BF16, 4, False)),
    ("prefill at start 448, P 32", (64, 16, 16, 128, 32, 16, BF16, 1, True)),
])
def test_grid_fills_the_card_at_the_served_shapes(name, args):
    """olmo-1b's served calls (16 heads of 128, page 16, 4 slots, contexts
    of ~500 tokens, a 64-token chunk at start 448) launch at least one
    block for every SM."""
    p = tpa.plan(*args)
    assert p.blocks >= SMS, (name, p)
    assert p.grid == (p.splits * p.q_tiles, args[2], args[7])


@pytest.mark.parametrize("dtype,route", [(BF16, "split_tc"),
                                         (F32, "split_kv")])
def test_body_by_dtype(dtype, route):
    """bf16 decode, verify and prefill on the tensor-core body (a warp of 16
    rows a tile for decode and verify, two for prefill), f32 (the parity
    route) on the SIMT body; a bf16 tile the tensor cores cannot hold on
    the SIMT body."""
    for T, prefill in ((1, False), (5, False), (64, True)):
        for Kh in (16, 4):
            p = tpa.plan(T, 16, Kh, 128, 34, 16, dtype, B=4, prefill=prefill)
            assert p.route == route
    assert tpa.plan(5, 16, 16, 128, 35, 16, BF16, B=4).q_tile == 5
    assert tpa.plan(64, 16, 16, 128, 32, 16, BF16, prefill=True).q_tile == 32
    assert tpa.plan(16, 4, 4, 8, 8, 8, BF16, prefill=True).route == "split_kv"
    assert tpa.plan(16, 4, 4, 16, 8, 32, BF16, prefill=True).route == "split_kv"
    assert tpa.plan(1, 4, 4, 16, 8, 2, BF16).route == "split_kv"


def test_plan_rejects_what_no_body_takes():
    for args in [(1, 16, 16, 96, 8, 16, BF16),      # Dh not a power of two
                 (1, 16, 16, 256, 8, 16, BF16),     # Dh over 128
                 (1, 32, 1, 128, 8, 16, BF16),      # 32 heads a KV head
                 (1, 16, 3, 128, 8, 16, BF16),      # Kh not dividing H
                 (1, 16, 16, 128, 8, 16, torch.float16)]:
        with pytest.raises(ValueError):
            tpa.plan(*args)


# ------------------------------------------------------- the combine mirror
def _pool(B, T, H, Kh, Dh, ps, P, horizon, seed):
    """Pools with distinct pages per row, table entries past each row's
    depth on the null page. No NaN: the reference passes a stale NaN
    through as 0 * NaN, which the port keeps out (ROADMAP, queue C)."""
    rng = np.random.default_rng(seed)
    n_pages = B * P + 1
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    pool = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    for b in range(B):
        depth = int(horizon[b].max())
        n = -(-depth // ps)
        bt[b, :n] = pool[b * P:b * P + n]
    return q, kp, vp, bt


def _combined(q, kp, vp, bt, horizon, split_pages):
    t = torch.from_numpy
    m, l, acc = tref.paged_split_partials_ref(
        t(q), t(kp), t(vp), t(bt), t(horizon), split_pages)
    return tref.combine_splits_ref(m, l, acc)


DECODE = [  # (B, H, Kh, Dh, page_size, P, lengths)
    (4, 4, 4, 16, 8, 5, [1, 7, 8, 40]),
    (3, 8, 2, 32, 16, 4, [17, 33, 64]),      # GQA 4:1
    (4, 8, 4, 16, 4, 9, [15, 16, 17, 36]),   # GQA 2:1, across split edges
]


@functools.lru_cache(maxsize=None)
def _decode_case(i):
    B, H, Kh, Dh, ps, P, lengths = DECODE[i]
    ln = np.asarray(lengths, np.int32)
    q, kp, vp, bt = _pool(B, 1, H, Kh, Dh, ps, P, ln[:, None], seed=i)
    want = jpa.paged_attention(*(jnp.asarray(a) for a in (q[:, 0], kp, vp, bt, ln)),
                               interpret=True)
    return q, kp, vp, bt, ln, np.asarray(want)


@pytest.mark.parametrize("split_pages", [1, S])
@pytest.mark.parametrize("case", range(len(DECODE)))
def test_combined_splits_match_jax_decode(case, split_pages):
    q, kp, vp, bt, ln, want = _decode_case(case)
    got = _combined(q, kp, vp, bt, ln[:, None], split_pages)[:, 0]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


VERIFY = [  # (B, Tq, H, Kh, Dh, page_size, P, lengths)
    (4, 5, 4, 4, 16, 8, 6, [5, 16, 17, 44]),
    (3, 3, 8, 2, 32, 8, 6, [3, 9, 40]),       # GQA 4:1
    (2, 2, 4, 4, 16, 4, 9, [17, 33]),          # a split edge inside the window
]


@functools.lru_cache(maxsize=None)
def _verify_case(i):
    B, Tq, H, Kh, Dh, ps, P, lengths = VERIFY[i]
    ln = np.asarray(lengths, np.int32)
    horizon = ln[:, None] - (Tq - 1) + np.arange(Tq, dtype=np.int32)[None]
    q, kp, vp, bt = _pool(B, Tq, H, Kh, Dh, ps, P, horizon, seed=10 + i)
    want = jpa.paged_attention_verify(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, ln)), interpret=True)
    return q, kp, vp, bt, horizon, np.asarray(want)


@pytest.mark.parametrize("split_pages", [1, S])
@pytest.mark.parametrize("case", range(len(VERIFY)))
def test_combined_splits_match_jax_verify(case, split_pages):
    q, kp, vp, bt, horizon, want = _verify_case(case)
    got = _combined(q, kp, vp, bt, horizon, split_pages)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


PREFILL = [  # (H, Kh, Dh, page_size, P, Tc, start, chunk_len)
    (4, 4, 16, 8, 8, 16, 0, 16),
    (4, 4, 16, 8, 8, 16, 16, 11),      # start > 0, short final chunk
    (8, 2, 16, 4, 8, 8, 8, 5),         # GQA 4:1, padded
    (4, 4, 16, 4, 16, 16, 32, 16),     # 3 splits of 4 pages under the chunk
]


@functools.lru_cache(maxsize=None)
def _prefill_case(i):
    H, Kh, Dh, ps, P, Tc, start, clen = PREFILL[i]
    t = np.arange(Tc, dtype=np.int32)
    horizon = np.minimum(start + t + 1, start + clen)[None]
    q, kp, vp, bt = _pool(1, Tc, H, Kh, Dh, ps, P, horizon, seed=20 + i)
    want = jpp.paged_prefill_attention(
        *(jnp.asarray(a) for a in (q[0], kp, vp, bt[0])), start, clen,
        interpret=True)
    return q, kp, vp, bt, horizon, clen, np.asarray(want)


@pytest.mark.parametrize("split_pages", [1, S])
@pytest.mark.parametrize("case", range(len(PREFILL)))
def test_combined_splits_match_jax_prefill(case, split_pages):
    q, kp, vp, bt, horizon, clen, want = _prefill_case(case)
    got = _combined(q, kp, vp, bt, horizon, split_pages)[0]
    assert torch.isfinite(got).all()
    # padded tail rows are never read by the model
    np.testing.assert_allclose(got[:clen].numpy(), want[:clen], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("where", ["end", "front", "middle"])
def test_an_empty_split_leaves_the_combine_bitwise_unchanged(where):
    """The empty partial (m = -inf, l = 0, acc = 0) is what a block past a
    row's depth writes, and what a wider table adds: the combine must not
    move by a bit."""
    q, kp, vp, bt, horizon, _ = _verify_case(0)
    t = torch.from_numpy
    m, l, acc = tref.paged_split_partials_ref(t(q), t(kp), t(vp), t(bt),
                                              t(horizon), S)
    base = tref.combine_splits_ref(m, l, acc)
    at = {"end": m.shape[-1], "front": 0, "middle": 1}[where]
    e_m = torch.full_like(m[..., :1], float("-inf"))
    m2 = torch.cat([m[..., :at], e_m, m[..., at:]], dim=-1)
    l2 = torch.cat([l[..., :at], torch.zeros_like(e_m), l[..., at:]], dim=-1)
    acc2 = torch.cat([acc[..., :at, :], torch.zeros_like(acc[..., :1, :]),
                      acc[..., at:, :]], dim=-2)
    assert torch.equal(tref.combine_splits_ref(m2, l2, acc2), base)


def test_a_wider_table_adds_only_empty_splits():
    """The same rows with their table padded from 6 to 16 pages (null
    entries, NaN-poisoned): the extra splits' partials are exactly empty,
    and the combine over all of them equals the combine without them."""
    q, kp, vp, bt, horizon, _ = _verify_case(0)
    kp, vp = kp.copy(), vp.copy()
    kp[0] = vp[0] = np.nan
    wide = np.zeros((bt.shape[0], 16), np.int32)
    wide[:, :bt.shape[1]] = bt
    t = torch.from_numpy
    m, l, acc = tref.paged_split_partials_ref(t(q), t(kp), t(vp), t(wide),
                                              t(horizon), S)
    n = len(tpa.split_ranges(bt.shape[1]))
    assert m.shape[-1] == 4 and n == 2
    assert (m[..., n:] == float("-inf")).all()
    assert (l[..., n:] == 0).all() and (acc[..., n:, :] == 0).all()
    assert torch.isfinite(acc).all()
    assert torch.equal(tref.combine_splits_ref(m, l, acc),
                       tref.combine_splits_ref(m[..., :n], l[..., :n],
                                               acc[..., :n, :]))
