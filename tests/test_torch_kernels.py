"""Port parity, kernels: each plain PyTorch version against the JAX jnp
oracle and the JAX Pallas kernel in interpret mode, on the same numpy
inputs. The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py, which runs where there is a card.

Tolerance on the CPU: atol 2e-5, rtol 1e-5 at float32 (as
tests/test_paged_prefill.py holds the Pallas kernels) — the plain versions
repeat the reference's arithmetic, and the interpret-mode kernels differ
from it by accumulation order (online softmax, K tiling).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bdmm as jbdmm
from repro.kernels import paged_attention as jpa
from repro.kernels import paged_prefill as jpp
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro_torch.kernels import bdmm as tbdmm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL, RTOL = 2e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------- bdmm
def _bdmm_case(m, quant, seed, nb=4, bi=16, bo=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, nb * bi)).astype(np.float32)
    w = (rng.standard_normal((nb, bi, bo)) / np.sqrt(bi)).astype(np.float32)
    b = (0.1 * rng.standard_normal((nb * bo,))).astype(np.float32)
    if not quant:
        return x, w, None, b
    q, s = jquant.quantize_blocks(jnp.asarray(w))
    return x, np.asarray(q), np.asarray(s), b


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("small_m", [True, False])
@pytest.mark.parametrize("m", [1, 3, 8, 64])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_bdmm_plain_matches_jax(quant, m, small_m, act):
    """The plain bdmm (what ``ops`` runs on CPU tensors) against the jnp
    oracle and the Pallas kernel on both of its grids."""
    x, w, s, b = _bdmm_case(m, quant, seed=m * 7 + quant)
    if quant:
        got = ops.bdmm_quant(_t(x), _t(w), _t(s), _t(b), activation=act)
    else:
        got = ops.bdmm(_t(x), _t(w), _t(b), activation=act)
    got = got.numpy()
    if quant:
        want = jref.bdmm_quant_ref(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(s), jnp.asarray(b),
                                   activation=act)
    else:
        want = jref.bdmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             activation=act)
    kern = jbdmm.bdmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      None if s is None else jnp.asarray(s), activation=act,
                      interpret=True, small_m=small_m)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 32])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_bdmm_split_k_order_matches_jax_decode_kernel(quant, m, dtype):
    """The decode grid's order (``ref.bdmm_split_ref``: the K ranges of the
    plan's splits reduced in f32, added in split order, then scale, bias,
    silu and one cast) against the Pallas decode kernel in interpret mode
    (``small_m=True``, full K a step), at both dtypes, with the splits the
    bf16 plan gives: bi 600 splits into 256, 256 and 88 rows. Tolerance: at float32 ATOL / RTOL (the sums differ in order only);
    at bf16 one rounding step of the output (2^-7 relative), since both
    round the same f32 sum once."""
    x, w, s, b = _bdmm_case(m, quant, seed=11 + m, bi=600)
    nb, bi, bo = w.shape
    tdt = getattr(torch, dtype)
    plan = tbdmm.plan(m, nb, bi, bo, torch.bfloat16,
                      torch.int8 if quant else torch.bfloat16)
    assert plan.route == "decode_tc" and (plan.split, plan.k_chunk) == (3, 256)
    xt = _t(x).to(tdt)
    wt = _t(w) if quant else _t(w).to(tdt)
    got = tref.bdmm_split_ref(xt, wt, _t(b), None if s is None else _t(s),
                              "silu", plan.k_chunk)
    assert got.dtype == tdt
    xj = jnp.asarray(x, dtype=dtype)
    wj = jnp.asarray(w) if quant else jnp.asarray(w, dtype=dtype)
    kern = jbdmm.bdmm(xj, wj, jnp.asarray(b), None if s is None else jnp.asarray(s),
                      activation="silu", interpret=True, small_m=True)
    want = np.asarray(kern.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                   rtol=2 ** -7)


def test_bdmm_int8_epilogue_order():
    """int8 epilogue at bf16: raw int products accumulated in f32 (bf16 x
    int8 products are exact there), then scale, then bias, then silu, then
    one cast. Held against that order computed in float64 and rounded
    once: at most one bf16 rounding step apart."""
    x, q, s, b = _bdmm_case(5, True, seed=3)
    xb = _t(x).bfloat16()
    bb = _t(b).bfloat16()
    got = tref.bdmm_quant_ref(xb, _t(q), _t(s), bb, "silu")
    assert got.dtype == torch.bfloat16
    nb, bi, bo = q.shape
    acc = np.einsum("mnk,nko->mno", xb.double().numpy().reshape(5, nb, bi),
                    q.astype(np.float64))
    z = (acc * s + bb.double().numpy().reshape(nb, bo)).reshape(5, nb * bo)
    want = torch.from_numpy(z / (1 + np.exp(-z))).bfloat16()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=0, rtol=2 ** -7)


def test_bdmm_rejects_bad_inputs():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        tbdmm.bdmm(x, torch.zeros(4, 16, 8, dtype=torch.int8))   # no scale
    with pytest.raises(ValueError):
        tbdmm.bdmm(x, torch.zeros(4, 8, 8))                      # K mismatch
    with pytest.raises(ValueError):
        tbdmm.bdmm(x, torch.zeros(4, 16, 8))      # the kernel takes no CPU tensor


# ------------------------------------------------------------- paged decode
def _pool_case(B, H, Kh, Dh, ps, n_pages, P, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    lengths = rng.integers(1, P * ps + 1, size=(B,)).astype(np.int32)
    lengths[0] = 1
    # distinct pages across rows, so poisoning one row's tail never
    # touches another row's live K/V
    pool = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        bt[b, :n] = pool[b * P:b * P + n]
    return q, kp, vp, bt, lengths


DECODE_SHAPES = [  # (B, H, Kh, Dh, page_size, n_pages, P)
    (4, 4, 4, 16, 8, 24, 5),      # MHA (the smoke config's heads)
    (3, 8, 2, 32, 16, 20, 4),     # GQA 4:1
    (4, 8, 4, 16, 4, 40, 8),      # GQA 2:1, small pages
]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_paged_attention_plain_matches_jax(shape):
    q, kp, vp, bt, ln = _pool_case(*shape, seed=sum(shape))
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln)).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    np.testing.assert_allclose(got, np.asarray(jref.paged_attention_ref(*args)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_attention(*args, interpret=True)),
        atol=ATOL, rtol=RTOL)


def _poison_decode(kp, vp, bt, ln, ps):
    kp, vp = kp.copy(), vp.copy()
    kp[0] = vp[0] = np.nan                       # the null page
    for b, L in enumerate(ln):
        last = bt[b, (L - 1) // ps]
        kp[last, (L - 1) % ps + 1:] = np.nan     # past the length in the page
        vp[last, (L - 1) % ps + 1:] = np.nan
    return kp, vp


@pytest.mark.parametrize("shape", DECODE_SHAPES[:2])
def test_paged_attention_nan_past_length_stays_out(shape):
    """Stale or NaN K/V at or past each row's length (and in the null
    page) must not reach the sum, not even as 0 * NaN."""
    q, kp, vp, bt, ln = _pool_case(*shape, seed=5)
    clean = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    kpp, vpp = _poison_decode(kp, vp, bt, ln, shape[4])
    got = ops.paged_attention(_t(q), _t(kpp), _t(vpp), _t(bt), _t(ln))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, atol=0, rtol=0)


# ------------------------------------------------------------ paged prefill
PREFILL_SHAPES = [  # (H, Kh, Dh, page_size, n_pages, P, Tc, start, chunk_len)
    (4, 4, 16, 8, 24, 8, 16, 0, 16),      # smoke heads, first chunk
    (4, 4, 16, 8, 24, 8, 16, 16, 11),     # start > 0, short final chunk
    (8, 2, 16, 4, 32, 8, 8, 8, 5),        # GQA 4:1, start > 0, padded
    (6, 3, 8, 8, 24, 4, 16, 16, 16),      # GQA 2:1
]


def _prefill_case(H, Kh, Dh, ps, n_pages, P, Tc, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Tc, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    bt = rng.choice(np.arange(1, n_pages), size=P, replace=False).astype(np.int32)
    return q, kp, vp, bt


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_paged_prefill_plain_matches_jax(shape):
    H, Kh, Dh, ps, n_pages, P, Tc, start, clen = shape
    q, kp, vp, bt = _prefill_case(H, Kh, Dh, ps, n_pages, P, Tc, seed=H + Tc)
    got = ops.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), start,
                                      clen).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt)]
    want = jref.paged_prefill_attention_ref(*args, start, clen)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    kern = jpp.paged_prefill_attention(*args, start, clen, interpret=True)
    # padded tail rows are never read by the model
    np.testing.assert_allclose(got[:clen], np.asarray(kern)[:clen],
                               atol=ATOL, rtol=RTOL)


def test_paged_prefill_cold_pages_stay_out():
    """Pages past the depth (NaN-poisoned, like test_paged_prefill.py's
    cold pages) and positions past the depth in the last live page must
    not reach the output."""
    H, Kh, Dh, ps, n_pages, P, Tc, start, clen = 4, 2, 8, 4, 16, 8, 8, 4, 6
    q, kp, vp, bt = _prefill_case(H, Kh, Dh, ps, n_pages, P, Tc, seed=3)
    clean = ops.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), start,
                                        clen)
    depth = start + clen
    n_live = -(-depth // ps)
    kpp, vpp = kp.copy(), vp.copy()
    for arr in (kpp, vpp):
        arr[bt[n_live:]] = np.nan
        arr[bt[n_live - 1], (depth - 1) % ps + 1:] = np.nan
    got = ops.paged_prefill_attention(_t(q), _t(kpp), _t(vpp), _t(bt), start,
                                      clen)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, atol=0, rtol=0)


def test_q_tile_fits_the_block():
    """A block's query tile: the tokens whose rows (a token's g = H / Kh
    heads) fit the body's tile (tensor cores: 32 rows for a prefill chunk,
    16 for a decode step or a verify window; SIMT: 16), split evenly."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tpa.plan(64, 16, 16, 128, 32, 16, bf, prefill=True).q_tile == 32
    assert tpa.plan(64, 16, 4, 128, 32, 16, bf, prefill=True).q_tile == 8
    assert tpa.plan(64, 16, 16, 128, 32, 16, f32, prefill=True).q_tile == 16
    assert tpa.plan(48, 1, 1, 16, 8, 16, f32, prefill=True).q_tile == 16
    assert tpa.plan(5, 16, 4, 128, 35, 16, bf, B=4).q_tile == 3
    assert tpa.plan(5, 16, 4, 128, 35, 16, f32, B=4).q_tile == 3
    with pytest.raises(ValueError):
        tpa.plan(8, 64, 1, 128, 4, 16, bf, prefill=True)


# -------------------------------------------------------------------- routing
def test_ops_routes_cpu_tensors_to_plain():
    """A CPU tensor takes the plain version under either backend, and no
    kernel launch is counted."""
    x, w, _, b = _bdmm_case(4, False, seed=1)
    ops.reset_launch_counts()
    want = tref.bdmm_ref(_t(x), _t(w), _t(b), "silu")
    for backend in ops.BACKENDS:
        ops.set_backend(backend)
        try:
            got = ops.bdmm(_t(x), _t(w), _t(b), activation="silu")
        finally:
            ops.set_backend("cuda")
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert all(n == 0 for n in ops.launch_counts().values())
    with pytest.raises(ValueError):
        ops.set_backend("pallas")
    assert ops.get_backend() == "cuda"
