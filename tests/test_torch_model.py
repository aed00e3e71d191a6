"""Port parity, model: the JAX model's params (``init(PRNGKey(0))``, fp and
int8 through the JAX ``quantize_packed``) carried into the port with
``params_from_numpy``; paged ``prefill_chunk`` and ``decode_step`` must give
the same logits, page pools and ``pos`` counters.

Tolerance: atol 1e-5, rtol 1e-5 on logits of magnitude ~2 at float32 — the
two frameworks sum the same products in different orders (einsum, RoPE
``pow``/``sin`` implementations), ~1e-6 after two layers. The traps found
in the reference (population variance, half-split RoPE, the embedding
scale rounded to the config dtype, SwiGLU order) each have a case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.core import export as jexport
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.core import export as texport
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
PS, N_PAGES, N_SLOTS = 8, 12, 2


@functools.lru_cache(maxsize=None)
def _jax_model(gqa: bool):
    over = {"n_kv_heads": 2} if gqa else {}
    m = jbuild(jcommon.get_config("olmo-1b", smoke=True, **over))
    return m, m.init(jax.random.PRNGKey(0))


def _pair(gqa: bool, quant: bool):
    jm, jp = _jax_model(gqa)
    if quant:
        jp, _ = jexport.quantize_packed(jm, jp)
    over = {"n_kv_heads": 2} if gqa else {}
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, **over))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _close_caches(tc, jc):
    for t, j in zip(tc, jc):
        for k in ("kp", "vp"):
            _close(t[k], j[k])
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_chunked_prefill_then_decode_matches_jax(quant, gqa):
    """Two prefill chunks of one request (the second right-padded, start >
    0), a second request's single chunk, then decode steps with a live
    mask: logits, pools and pos agree after every call."""
    jm, jp, tm, tp = _pair(gqa, quant)
    jc = jm.init_paged_caches(N_SLOTS, N_PAGES, PS)
    tc = tm.init_paged_caches(N_SLOTS, N_PAGES, PS, device="cpu")
    rng = np.random.default_rng(0)
    prompt0 = rng.integers(0, 96, size=27).astype(np.int32)
    prompt1 = rng.integers(0, 96, size=9).astype(np.int32)
    bt = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 0, 0, 0]], np.int32)
    tc_ = 16
    for slot, prompt, pos in ((0, prompt0, 0), (0, prompt0, 16),
                              (1, prompt1, 0)):
        n = min(len(prompt) - pos, tc_)
        toks = np.zeros((1, tc_), np.int32)
        toks[0, :n] = prompt[pos:pos + n]
        final = pos + n >= len(prompt)
        width = 4 if slot == 0 else 2
        jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc,
                                  jnp.asarray(bt[slot, :width]), slot, pos, n,
                                  final=final)
        tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks).long(), tc,
                                  torch.from_numpy(bt[slot, :width]), slot,
                                  pos, n, final=final)
        if final:
            _close(tl, jl)
        else:
            assert tl is None and jl is None
        _close_caches(tc, jc)
    tokens = np.array([11, 42], np.int32)
    for live in ([True, True], [True, False], [False, True]):
        live = np.array(live)
        jl, jc = jm.decode_step(jp, jnp.asarray(tokens), jc,
                                block_tables=jnp.asarray(bt),
                                live=jnp.asarray(live))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tokens).long(), tc,
                                torch.from_numpy(bt), live=torch.from_numpy(live))
        _close(tl, jl)
        _close_caches(tc, jc)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_prefill_tail_past_table_goes_to_null_page():
    """A final chunk whose padded tail reaches past the block table writes
    that tail to the null page — never onto a clamped real page."""
    jm, jp, tm, tp = _pair(False, False)
    jc = jm.init_paged_caches(1, N_PAGES, PS)
    tc = tm.init_paged_caches(1, N_PAGES, PS, device="cpu")
    bt = np.array([3, 5, 7], np.int32)                 # table of 3 pages
    toks = np.arange(1, 17, dtype=np.int32)[None]      # chunk of 2 pages
    jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc, jnp.asarray(bt), 0,
                              16, 4)
    before = tc[0]["kp"][:, 5].clone()
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks).long(), tc,
                              torch.from_numpy(bt), 0, 16, 4)
    _close(tl, jl)
    _close_caches(tc, jc)
    torch.testing.assert_close(tc[0]["kp"][:, 5], before)   # page 1 untouched
    assert bool((tc[0]["kp"][:, 7] != 0).any())            # page 2 written


def test_convert_rejects_mismatched_tree():
    jm, jp, tm, _ = _pair(False, False)
    tree = jax.tree.map(np.asarray, jp)
    tree["unembed"]["w"] = tree["unembed"]["w"][:, :, :-1]
    with pytest.raises(ValueError):
        params_from_numpy(tm, tree, device="cpu")


def test_quantize_packed_matches_jax():
    """The port's quantize pass on converted fp params gives the same int8
    tree as the JAX pass."""
    jm, jp, tm, tp = _pair(False, False)
    jq, _ = jexport.quantize_packed(jm, jp)
    tq, report = texport.quantize_packed(tm, tp)
    assert report["n_layers"] == 8
    want = params_from_numpy(tm, jax.tree.map(np.asarray, jq), device="cpu")
    flat_t = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tq))
    flat_w = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), want))
    assert len(flat_t) == len(flat_w)
    for a, b in zip(flat_t, flat_w):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- the traps
def test_layernorm_population_variance():
    rng = np.random.default_rng(1)
    x = (5.0 + 3.0 * rng.standard_normal((4, 64))).astype(np.float32)
    want = np.asarray(jlayers.nonparametric_layernorm(jnp.asarray(x)))
    got = tlayers.nonparametric_layernorm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    ref = (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True)
                                                    + 1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert tlayers.nonparametric_layernorm(xb).dtype == torch.bfloat16


def test_rope_half_split_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 16)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = tlayers.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # bf16 input: the product promotes to f32, then one cast back
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jlayers.apply_rope(xb, jc, js)
    gb = tlayers.apply_rope(torch.from_numpy(x).bfloat16(), tc, ts)
    assert gb.dtype == torch.bfloat16 and wb.dtype == jnp.bfloat16
    np.testing.assert_allclose(gb.float().numpy(),
                               np.asarray(wb.astype(jnp.float32)),
                               atol=0, rtol=2 ** -8)


def test_embedding_scale_rounds_in_config_dtype():
    """olmo-1b's sqrt(2048) is not a bf16 number: the reference multiplies
    by it rounded to bf16 (a weak-typed scalar), so must the port."""
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, d_model=2048,
                                   n_heads=16, dtype="bfloat16"))
    rng = np.random.default_rng(3)
    table = rng.standard_normal((96, 2048)).astype(np.float32)
    ids = np.array([[1, 5, 95]], np.int32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    want = jlayers.embed({"table": jt}, jnp.asarray(ids)) * float(np.sqrt(2048))
    got = tm._embed_inputs(
        {"embed": {"table": torch.from_numpy(table).bfloat16()}},
        torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_swiglu_order():
    """up without activation, gate with silu in its epilogue, each cast to
    the dtype, then the product in that dtype (bf16 here)."""
    jm, jp, tm, tp = _pair(False, True)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    xb = x.bfloat16()
    ffn = tm.block_specs[0]["ffn"]
    p = {k: {kk: vv[0] for kk, vv in v.items()}
         for k, v in tp["blocks"][0]["ffn"].items()}
    got = ffn.apply(p, xb)
    up = ffn.w_up.apply(p["w_up"], xb)
    gate = ffn.w_gate.apply(p["w_gate"], xb, activation="silu")
    assert up.dtype == gate.dtype == torch.bfloat16
    want = ffn.w_down.apply(p["w_down"], gate * up)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # and at f32 the same block agrees with the JAX FFN
    jffn = jm.block_specs[0]["ffn"]
    jpf = jax.tree.map(lambda a: a[0], jp["blocks"][0]["ffn"])
    _close(ffn.apply(p, x), jffn.apply(jpf, jnp.asarray(x.numpy())))
