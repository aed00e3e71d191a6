"""Port parity, the Fig-3 fused FFN route: the plain fused MLP against the
JAX package's oracle and its Pallas kernel (interpret mode); perm-fused
masks and specs element for element; the post-hoc permutation-fusion
rewrite; the fold of a perm-fused model to packed (fp and int8) and its
logits; int4 nibble packing.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances at float32: the fused MLP max |port - jax| <= 2e-5 of max |jax|
(the same products summed in other orders); model logits atol 1e-5, rtol
1e-5 (as tests/test_torch_model.py). Masks, permutations, skip flags,
folded trees and int4 nibbles are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.core import export as jexport
from repro.core import mask as jmask
from repro.core.policy import CompressionPolicy as JPolicy
from repro.kernels import fused_ffn as jffn
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import ModelConfig as JModelConfig
from repro.models import build as jbuild
from repro.models.attention import AttentionSpec as JAttentionSpec
from repro.models.ffn import FFNSpec as JFFNSpec
from repro_torch import tree as tree_lib
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import mask as tmask
from repro_torch.core.policy import CompressionPolicy as TPolicy
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import ops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.models import ModelConfig as TModelConfig
from repro_torch.models import build as tbuild
from repro_torch.models.attention import AttentionSpec as TAttentionSpec
from repro_torch.models.ffn import FFNSpec as TFFNSpec
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

REL = 2e-5
ATOL = RTOL = 1e-5


def _relerr(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _ffn_inputs(seed, m, nb, bi, f, bo, gated, use_bias, quant=False):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    a = {"x": r(m, nb * bi), "w_up": r(nb, bi, f, sc=0.2),
         "w_down": r(nb, f, bo, sc=0.2),
         "w_gate": r(nb, bi, f, sc=0.2) if gated else None,
         "b_up": r(nb * f, sc=0.1) if use_bias else None,
         "b_gate": r(nb * f, sc=0.1) if use_bias and gated else None,
         "b_down": r(nb * bo, sc=0.1) if use_bias else None}
    if quant:
        for w, s in (("w_up", "s_up"), ("w_gate", "s_gate"),
                     ("w_down", "s_down")):
            if a[w] is not None:
                q, sc = jquant.quantize_blocks(a[w])
                a[w], a[s] = np.array(q), np.array(sc)
            else:
                a[s] = None
    return a


def _jax(a):
    return {k: None if v is None else jnp.asarray(v) for k, v in a.items()}


def _torch(a):
    return {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}


# ------------------------------------------------------------- fused MLP
@pytest.mark.parametrize("f", [40, 64])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("gated", [True, False])
def test_plain_fused_ffn_matches_jax_oracle_and_interpret_kernel(
        gated, use_bias, f):
    """f = 40 is no multiple of the interpret kernel's tile (bf = 8 pads
    nothing, so m = 13 pads the row tile instead)."""
    a = _ffn_inputs(0, 13, 4, 16, f, 12, gated, use_bias)
    act = "silu" if gated else "gelu"
    t = _torch(a)
    got = ops.fused_ffn(t["x"], t["w_up"], t["w_down"], w_gate=t["w_gate"],
                        b_up=t["b_up"], b_gate=t["b_gate"],
                        b_down=t["b_down"], activation=act).numpy()
    j = _jax(a)
    want = jref.fused_ffn_ref(j["x"], j["w_up"], j["w_down"],
                              w_gate=j["w_gate"], b_up=j["b_up"],
                              b_gate=j["b_gate"], b_down=j["b_down"],
                              activation=act)
    kern = jffn.fused_ffn(j["x"], j["w_up"], j["w_down"], j["w_gate"],
                          j["b_up"], j["b_gate"], j["b_down"], activation=act,
                          interpret=True, bm=8, bf=8)
    assert _relerr(got, want) < REL
    assert _relerr(got, kern) < REL


@pytest.mark.parametrize("gated", [True, False])
def test_plain_fused_ffn_int8_matches_jax(gated):
    """The int8 form: scales before the bias and the gate, s_down after the
    f-sum, against ``fused_ffn_quant_ref`` and the interpret kernel."""
    a = _ffn_inputs(1, 9, 4, 16, 24, 8, gated, True, quant=True)
    act = "silu" if gated else "relu"
    t, j = _torch(a), _jax(a)
    kw = lambda d: {k: d[k] for k in ("w_gate", "b_up", "b_gate", "b_down",
                                      "s_up", "s_gate", "s_down")}
    got = ops.fused_ffn_quant(t["x"], t["w_up"], t["w_down"], activation=act,
                              **kw(t)).numpy()
    want = jref.fused_ffn_quant_ref(j["x"], j["w_up"], j["w_down"],
                                    activation=act, **kw(j))
    kern = jffn.fused_ffn(j["x"], j["w_up"], j["w_down"], activation=act,
                          interpret=True, bm=8, bf=8, **kw(j))
    assert _relerr(got, want) < REL
    assert _relerr(got, kern) < REL


def test_fused_ffn_raises_under_grad_and_on_bad_inputs():
    """The int8 form is inference-only and raises under grad (the fp form
    has an autograd rule: tests/test_torch_fused_grad.py)."""
    a = _torch(_ffn_inputs(2, 4, 2, 8, 16, 8, True, False))
    q = _torch(_ffn_inputs(2, 4, 2, 8, 16, 8, True, False, quant=True))
    x = a["x"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="autograd"):
        ops.fused_ffn_quant(x, q["w_up"], q["w_down"], w_gate=q["w_gate"],
                            s_up=q["s_up"], s_gate=q["s_gate"],
                            s_down=q["s_down"])
    with pytest.raises(ValueError, match="b_gate"):
        ops.fused_ffn(a["x"], a["w_up"], a["w_down"], b_gate=a["w_up"][0, 0])
    with torch.no_grad():               # no grad is taken: the plain route
        ops.fused_ffn(x, a["w_up"], a["w_down"], w_gate=a["w_gate"])


def test_kernel_plan_fills_the_card_at_olmo_width():
    """(body, rows per block, f splits, f tiles per block) at olmo-1b's
    fused FFN (nb 8, f 1024, bo 256) on 132 SMs. bf16 x up to 64 rows (tc):
    16-token tiles, every f tile its own block (decode and one prefill
    chunk: 16 x 8 blocks a row tile). Above (tc_tall, bf16 or int8
    weights: the plan depends on x's dtype alone): 128-token tiles, the f
    split as wide as three quarters of the card allow, two-way where that
    fills it: none for a training batch (2048 rows: 16 x 8 blocks), 8 ways
    at 128 rows, 2 ways at the dense engine's 544-row admission (80
    blocks) and at 1024 rows (128 blocks). f32 up to 64 rows (simt_small):
    the smallest row tile that holds m, f split 16 ways (128 blocks) at
    decode, verify and one prefill chunk; above (simt_tall): 128-token
    tiles, the f split as wide as one wave allows (3 ways at 544 rows: 120
    blocks; none at 2048). The first f32 body's plan (simt_f32, forced
    only) is what it was."""
    bf16 = lambda m, f=1024: tuple(tffn.plan(m, 8, f, 256, 132))  # noqa: E731
    assert bf16(4) == bf16(64) == ("tc", 16, 16, 1)
    assert bf16(37, 1000) == ("tc", 16, 16, 1)
    assert bf16(2048) == ("tc_tall", 128, 1, 16)
    assert bf16(128) == bf16(65) == ("tc_tall", 128, 8, 2)
    assert bf16(512) == ("tc_tall", 128, 3, 6)
    assert bf16(544) == ("tc_tall", 128, 2, 8)
    assert bf16(1024) == ("tc_tall", 128, 2, 8)
    assert bf16(1536) == ("tc_tall", 128, 1, 16)
    # olmo-1b at mpd_c=4 (nb 4, f 2048, bo 512: two column chunks)
    assert tuple(tffn.plan(2048, 4, 2048, 512, 132)) == ("tc_tall", 128, 1, 32)
    assert tuple(tffn.plan(512, 4, 2048, 512, 132)) == ("tc_tall", 128, 3, 11)
    f32 = lambda m, f=1024, fit=None: tuple(tffn.plan(  # noqa: E731
        m, 8, f, 256, 132, torch.float32, fit))
    h100 = lambda route, split: H100_CLUSTERS[split]  # noqa: E731
    for fit in (None, h100):
        assert f32(4, fit=fit) == ("simt_small", 4, 8, 1)
        assert f32(20, fit=fit) == ("simt_small", 32, 8, 1)
        assert (f32(37, fit=fit) == f32(37, 1000, fit) == f32(64, fit=fit)
                == ("simt_small", 64, 8, 1))
        assert f32(65, fit=fit) == f32(128, fit=fit) == ("simt_tall", 128, 8, 2)
        assert f32(2048, fit=fit) == ("simt_tall", 128, 1, 16)
    # 40 cells: 3 ways fill one wave of ideal clusters, but on the H100 only
    # 39 clusters of 3 fit; 3 waves of 15 clusters of 8 cost least there
    assert f32(544) == ("simt_tall", 128, 3, 6)
    assert f32(544, fit=h100) == ("simt_tall", 128, 8, 2)
    assert {tffn.plan(m, 8, 1024, 256, 132, torch.float32).route
            for m in range(1, 4097, 7)} == set(tffn.F32_ROUTES)
    old = lambda m, f=1024: tuple(tffn.simt_f32_plan(m, 8, f, 256, 132))  # noqa: E731
    assert old(4) == ("simt_f32", 4, 16, 1)
    assert old(64) == ("simt_f32", 64, 16, 1)
    assert old(37, 1000) == ("simt_f32", 64, 16, 1)
    assert old(2048) == ("simt_f32", 64, 1, 16)
    p = tffn.simt_f32_plan(256, 8, 1024, 256, 132)
    assert p.split * p.fpb >= 16 and (p.split - 1) * p.fpb < 16


_F32 = torch.float32
# clusters of 1 ... 16 blocks of an f32 SIMT body (a block an SM) that an
# H100 80GB HBM3 runs at once (cudaOccupancyMaxActiveClusters)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
                 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


@pytest.mark.parametrize("nb,f,bo,dtype", [
    pytest.param(8, 1024, 256, torch.bfloat16, id="8-1024-256"),
    pytest.param(3, 200, 300, torch.bfloat16, id="3-200-300"),
    pytest.param(2, 130, 20, torch.bfloat16, id="2-130-20"),
    pytest.param(8, 1024, 256, _F32, id="f32-8-1024-256"),
    pytest.param(8, 1000, 300, _F32, id="f32-8-1000-300"),
    pytest.param(2, 130, 20, _F32, id="f32-2-130-20")])
def test_kernel_plan_does_not_depend_on_m_up_to_a_chunk(nb, f, bo, dtype):
    """A token's output must not change with the chunk it rides in: the
    plan's body, f splits and f tiles a block are the same for every m up
    to one prefill chunk (64 rows). bf16 (tc): the rows per block too. f32
    (simt_small): the rows per block follow m (4 ... 64), which changes
    only how many threads share a tile, never an output's fma chain; the
    card test holds those rows bit for bit."""
    if dtype == torch.bfloat16:
        plans = {tffn.plan(m, nb, f, bo, 132, dtype)
                 for m in range(1, tffn.SPLIT_M_MAX + 1)}
        assert plans == {("tc", tffn.TC_ROWS, -(-f // tffn.F_TILE), 1)}
        return
    n_ft = -(-f // tffn.SMALL_F_TILE)
    for fit in (None, lambda route, split: H100_CLUSTERS[split]):
        plans = {tffn.plan(m, nb, f, bo, 132, dtype, fit)
                 for m in range(1, tffn.SPLIT_M_MAX + 1)}
        (route, split, fpb), = {(p.route, p.split, p.fpb) for p in plans}
        assert route == "simt_small" and (split - 1) * fpb < n_ft <= split * fpb
        assert {p.rows for p in plans} == set(tffn.ROW_TILES)


@pytest.mark.parametrize("card", ["ideal", "h100"])
@pytest.mark.parametrize("m", [65, 200, 544, 2048, 4096])
@pytest.mark.parametrize("nb,f,bo", [(8, 1024, 256), (4, 2048, 512),
                                     (8, 1000, 300), (2, 130, 20)])
def test_f32_tall_plan_costs_the_fewest_waves(nb, f, bo, m, card):
    """Above 64 rows every f32 call takes simt_tall on 128-row tiles. Its f
    split is one portable cluster (at most ``TALL_CLUSTER_MAX``, within
    ``CLUSTER_MAX``) of blocks that each own at least one f tile, and no
    other split costs less in waves of clusters (as many as the card runs
    at once: every SM's block in one, or the H100's count) times f tiles a
    block; a grid of row tiles that fills the card alone takes no split."""
    n_sm, n_ft = 132, -(-f // tffn.F_TILE)
    fit = ((lambda route, s: n_sm // s) if card == "ideal"
           else (lambda route, s: H100_CLUSTERS[s]))
    p = tffn.plan(m, nb, f, bo, n_sm, torch.float32,
                  None if card == "ideal" else fit)
    cells = -(-m // tffn.TALL_ROWS) * nb * -(-bo // tffn.COLS_PER_BLOCK)
    assert (p.route, p.rows) == ("simt_tall", tffn.TALL_ROWS)
    assert 1 <= p.split <= tffn.TALL_CLUSTER_MAX <= tffn.CLUSTER_MAX
    assert (p.split - 1) * p.fpb < n_ft <= p.split * p.fpb
    cost = lambda s: -(-cells // fit("simt_tall", s)) * -(-n_ft // s)  # noqa: E731
    assert all(cost(p.split) <= cost(s)
               for s in range(1, min(n_ft, tffn.TALL_CLUSTER_MAX) + 1))
    if cells >= n_sm:
        assert p.split == 1


@pytest.mark.parametrize("m", [65, 300, 4096])
@pytest.mark.parametrize("nb,f,bo", [(8, 1024, 256), (4, 2048, 512),
                                     (3, 200, 300), (2, 130, 20)])
def test_tall_plan_keeps_one_wave_of_clusters(nb, f, bo, m):
    """Above 64 rows every bf16 call takes tc_tall on 128-row tiles. Its f
    split is one portable cluster (at most ``TALL_CLUSTER_MAX``, within
    ``CLUSTER_MAX``) of blocks that each own at least one f tile, and the
    grid stays within one wave of blocks (a block an SM); a grid of row
    tiles that fills the card alone takes no split. A split wider than
    two keeps a quarter of the card free."""
    n_sm, n_ft = 132, -(-f // tffn.F_TILE)
    p = tffn.plan(m, nb, f, bo, n_sm)
    cells = -(-m // tffn.TALL_ROWS) * nb * -(-bo // tffn.COLS_PER_BLOCK)
    assert (p.route, p.rows) == ("tc_tall", tffn.TALL_ROWS)
    assert 1 <= p.split <= tffn.TALL_CLUSTER_MAX <= tffn.CLUSTER_MAX
    assert p.split == 1 or cells * p.split <= n_sm
    assert p.split <= 2 or 4 * cells * p.split <= 3 * n_sm
    assert (p.split - 1) * p.fpb < n_ft <= p.split * p.fpb
    if cells >= n_sm:
        assert p.split == 1


@pytest.mark.parametrize("body,split", [("tc", 1), ("tc_tall", 1),
                                        ("tc_tall", 3)])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
def test_split_f_hi_lo_order_matches_jax_interpret_kernel(gated, quant, body,
                                                         split):
    """The tensor-core bodies' orders (``ref.fused_ffn_split_ref``: the
    hidden in f32 as a hi + lo pair of bf16; tc: its down product per 16 f
    channels added in warp order, the 64-channel f tiles in split order
    from zero; tc_tall: runs of f tiles, one a block, each summed from zero,
    the runs in rank order) against the Pallas kernel in interpret mode at
    float32 (h and the down product in f32). f = 200 leaves a partial last
    tile and warp. Tolerance, elementwise: 2^-15 (|h| @ |Wd| (* s_down)) +
    1e-5 |y| + 1e-6; hi + lo is within 2^-16 |h| of h, and the rest is
    summation order. One bf16 rounding of h (2^-8 |h|) would not pass."""
    a = _ffn_inputs(5, 9, 2, 40, 200, 24, gated, True, quant=quant)
    act = "silu" if gated else "gelu"
    t, j = _torch(a), _jax(a)
    keys = ("w_gate", "b_up", "b_gate", "b_down", "s_up", "s_gate", "s_down")
    got = tref.fused_ffn_split_ref(t["x"], t["w_up"], t["w_down"],
                                   activation=act, body=body, split=split,
                                   **{k: t.get(k) for k in keys})
    want = np.asarray(jffn.fused_ffn(j["x"], j["w_up"], j["w_down"],
                                     activation=act, interpret=True, bm=8,
                                     bf=8, **{k: j.get(k) for k in keys}))
    # |h| @ |Wd| (* s_down), with h from the plain route's own pieces
    nb, bi, f = a["w_up"].shape
    xb = t["x"].reshape(-1, nb, bi)
    proj = lambda w, s, b: (torch.einsum("mnk,nkf->mnf", xb, w.float())  # noqa: E731
                            * (1 if s is None else s)
                            + (0 if b is None else b.reshape(nb, f)))
    u = proj(t["w_up"], t.get("s_up"), t["b_up"])
    fn = tref.ACTIVATIONS[act]
    h = (fn(proj(t["w_gate"], t.get("s_gate"), t["b_gate"])) * u if gated
         else fn(u))
    mag = torch.einsum("mnf,nfo->mno", h.abs(), t["w_down"].float().abs())
    if quant:
        mag = mag * t["s_down"]
    mag = mag.reshape(want.shape).numpy()
    lim = 2.0 ** -15 * mag + 1e-5 * np.abs(want) + 1e-6
    assert (np.abs(got.numpy() - want) <= lim).all()
    once = torch.einsum("mnf,nfo->mno", h.bfloat16().float(),
                        t["w_down"].float())
    if quant:
        once = once * t["s_down"]
    once = (once.reshape(want.shape) + t["b_down"]).numpy()
    assert not (np.abs(once - want) <= lim).all()


# ------------------------------------------------------- masks and specs
def _same_mask(tm, jm):
    if jm is None:
        return tm is None
    return (tm.nb == jm.nb and tm.seed == jm.seed
            and np.array_equal(tm.in_perm, jm.in_perm)
            and np.array_equal(tm.out_perm, jm.out_perm))


def _same_linear(tl, jl):
    ts, js = tl.spec, jl.spec
    return (_same_mask(ts.mask, js.mask) and ts.mode == js.mode
            and ts.skip_in_perm == js.skip_in_perm
            and ts.skip_out_perm == js.skip_out_perm
            and ts.use_bias == js.use_bias)


@pytest.mark.parametrize("mode", ["packed", "masked_dense"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_fused_ffn_and_attention_specs_equal_reference(kind, mode):
    kw = dict(c=4, seed=3, mode=mode)
    tp, jp = TPolicy(**kw), JPolicy(**kw)
    tf = TFFNSpec.make(tp, 64, 256, kind, seed_salt=5, fuse_perms=True)
    jf = JFFNSpec.make(jp, 64, 256, kind, seed_salt=5, fuse_perms=True)
    for name in ("w_up", "w_gate", "w_down"):
        if getattr(jf, name) is None:
            assert getattr(tf, name) is None
        else:
            assert _same_linear(getattr(tf, name), getattr(jf, name)), name
    assert tf.fused_packed() == jf.fused_packed() == (mode == "packed")
    ta = TAttentionSpec.make(tp, 64, 4, 2, 16, seed_salt=2, fuse_perms=True)
    ja = JAttentionSpec.make(jp, 64, 4, 2, 16, seed_salt=2, fuse_perms=True)
    for name in ("wq", "wk", "wv", "wo"):
        assert _same_linear(getattr(ta, name), getattr(ja, name)), name
    assert ta.shared_pack == (mode == "packed")


def test_fused_ffn_falls_back_without_compression():
    """With nothing to compress (c = 1) ``fuse_perms`` builds the unfused,
    dense form, as the reference does."""
    tf = TFFNSpec.make(TPolicy(c=1), 64, 128, fuse_perms=True)
    jf = JFFNSpec.make(JPolicy(c=1), 64, 128, fuse_perms=True)
    for name in ("w_up", "w_gate", "w_down"):
        assert _same_linear(getattr(tf, name), getattr(jf, name)), name
    assert tf.w_up.spec.mode == "dense" and not tf.fused_packed()


@pytest.mark.parametrize("fuse", [True, False])
def test_chain_specs_equal_reference(fuse):
    dims = (32, 64, 48, 16)
    got = tmask.chain_specs(dims, 4, seed=7, fuse=fuse)
    want = jmask.chain_specs(dims, 4, seed=7, fuse=fuse)
    assert len(got) == len(want) == 3
    assert all(_same_mask(g, w) for g, w in zip(got, want))


# --------------------------------------------------------- fold and logits
def _md_pair(train_fuse, use_bias=False, dtype="float32"):
    """A masked-dense model in both packages with the same params (random
    per-index biases, so a wrong gate-bias re-index shows)."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=96, mpd_c=4, mpd_mode="masked_dense", mpd_fuse=train_fuse,
              use_bias=use_bias, dtype=dtype)
    jm, tm = jbuild(JModelConfig(**kw)), tbuild(TModelConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(42)
    jp = jax.tree.map(lambda x: x + (0.1 * rng.standard_normal(x.shape))
                      .astype(x.dtype) if x.ndim == 2 else x, jp)
    jp = jm.mask_projection(jax.tree.map(jnp.asarray, jp))
    jp = jax.tree.map(np.asarray, jp)
    return jm, jp, tm, params_from_numpy(tm, jp, device="cpu")


def _trees_equal(t_tree, j_tree):
    got = [(k, v.detach().numpy()) for k, v in tree_lib.leaves_with_paths(t_tree)]
    want = jax.tree.leaves(j_tree)
    return len(got) == len(want) and all(
        g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
        for (_, g), w in zip(got, want))


@pytest.mark.parametrize("train_fuse", [False, True])
def test_posthoc_perm_fusion_equals_reference(train_fuse):
    """``apply_perm_fusion`` on the folded packed model: the rewritten specs
    (a merged gather, or the identity when the masks were built aligned),
    the re-indexed gate bias and the logits equal the reference's."""
    jm, jp, tm, tp = _md_pair(train_fuse, use_bias=True)
    jpm, jpp = jm.to_packed(jp, fuse=True)
    tpm, tpp = tm.to_packed(tp, fuse=True)
    for tb, jb in zip(tpm.block_specs, jpm.block_specs):
        for name in ("w_up", "w_gate", "w_down"):
            assert _same_linear(getattr(tb["ffn"], name),
                                getattr(jb["ffn"], name)), name
        assert tb["ffn"].fused_packed() == jb["ffn"].fused_packed() == train_fuse
    assert _trees_equal(tpp, jpp)
    toks = np.random.default_rng(1).integers(0, 96, (2, 8))
    want = np.asarray(jpm.logits(jpp, jnp.asarray(toks)))
    got = tpm.logits(tpp, torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the rewrite changes the dataflow, not the function
    upm, upp = tm.to_packed(tp, fuse=False)
    np.testing.assert_allclose(upm.logits(upp, torch.as_tensor(toks)).numpy(),
                               got, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_fused_fold_and_logits_match_reference(quantize):
    """``to_packed(fuse=True)`` of an ``mpd_fuse`` model gives the
    reference's packed tree exactly, and its logits (the FFNs on the fused
    route) within 1e-5 at f32."""
    jm, jp, tm, tp = _md_pair(True)
    jpm, jpp = jm.to_packed(jp, fuse=True, quantize=quantize)
    tpm, tpp = tm.to_packed(tp, fuse=True, quantize=quantize)
    assert all(b["ffn"].fused_packed() for b in tpm.block_specs)
    assert _trees_equal(tpp, jpp)
    if quantize:
        assert tpm.quant_report["n_layers"] == jpm.quant_report["n_layers"]
        np.testing.assert_allclose(tpm.quant_report["max_rel_rms"],
                                   jpm.quant_report["max_rel_rms"], rtol=1e-5)
    toks = np.random.default_rng(2).integers(0, 96, (2, 12))
    want = np.asarray(jpm.logits(jpp, jnp.asarray(toks)))
    ops.reset_launch_counts()
    got = tpm.logits(tpp, torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # and the tree travels back to the reference unchanged
    back = params_to_numpy(tpp)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(jpp)))


def test_packed_fused_model_from_jax_params_matches_logits():
    """A packed ``mpd_fuse`` model built directly (no fold), params carried
    from a JAX init."""
    cfg = dict(mpd_fuse=True)
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True, **cfg))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, **cfg))
    jp = jm.init(jax.random.PRNGKey(3))
    jq, _ = jexport.quantize_packed(jm, jp)
    toks = np.random.default_rng(3).integers(0, 96, (1, 10))
    for tree in (jp, jq):
        tp = params_from_numpy(tm, jax.tree.map(np.asarray, tree), device="cpu")
        want = np.asarray(jm.logits(tree, jnp.asarray(toks)))
        got = tm.logits(tp, torch.as_tensor(toks)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------- int4
@pytest.mark.parametrize("bi", [6, 7])
def test_int4_nibbles_equal_reference(bi):
    rng = np.random.default_rng(bi)
    q = rng.integers(-8, 8, size=(3, bi, 5)).astype(np.int8)
    packed = tquant.pack_int4(torch.from_numpy(q))
    want = np.asarray(jquant.pack_int4(jnp.asarray(q)))
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), want)
    assert np.array_equal(tquant.unpack_int4(packed, bi).numpy(), q)
    assert np.array_equal(np.asarray(jquant.unpack_int4(jnp.asarray(want), bi)),
                          q)


def test_int4_quantize_matches_reference():
    jm, jp, tm, tp = _md_pair(True)
    jpm, jpp = jm.to_packed(jp, fuse=True, quantize="int4")
    tpm, tpp = tm.to_packed(tp, fuse=True, quantize="int4")
    assert _trees_equal(tpp, jpp)
    assert tpm.quant_report["bits"] == 4
    assert max(int(leaf["w_q"].abs().max()) for leaf in (
        tpp["blocks"][0]["ffn"]["w_up"], tpp["unembed"])) <= 7

