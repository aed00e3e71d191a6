"""Port parity, speculative decoding: the verify-window attention against
the JAX package's oracle and its Pallas kernel (interpret mode), the
target's ``verify_step``, the sampling distributions and the acceptance
rule fed the reference's own noise, and the spec engine's greedy streams
against the JAX spec engine's. The cases of ``tests/test_serve_spec.py``
then run on the port alone.

Inputs are drawn with numpy from a seed (params carried over with
``params_from_numpy``). Tolerances at float32: attention max |port - jax|
<= 1e-5 (the same sums in other orders; the interpret-mode kernel runs an
online softmax); logits atol/rtol 1e-5 (as tests/test_torch_model.py);
``policy_probs`` 1e-6. Tokens, acceptance counts and greedy streams are
held exactly; draft acceptance rates within 0.05 of the reference's (a
near-tie argmax can flip between the draft's one-query scoring and the
target's window scoring, which truncates a window and never changes a
greedy stream).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import sampling as jsampling
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, Request, RequestState
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.cache import PagedCache, publish_prefix_shared, share_trie
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ROOT = Path(__file__).resolve().parent.parent
ATTN_TOL = 1e-5
ATOL = RTOL = 1e-5
PROBS_TOL = 1e-6


# ------------------------------------------------------------ verify window
def _verify_inputs(seed, B, Tq, H, Kh, Dh, ps, P):
    """Ragged lengths (one at exactly Tq), table entries past each length
    on the null page, every value finite."""
    rng = np.random.default_rng(seed)
    n_pages = B * P + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lengths = rng.integers(Tq, P * ps + 1, size=B).astype(np.int32)
    lengths[0] = Tq
    pool = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    for b, L in enumerate(lengths):
        n = -(-int(L) // ps)
        bt[b, :n] = pool[b * P:b * P + n]
    return (f(B, Tq, H, Dh), f(n_pages, ps, Kh, Dh), f(n_pages, ps, Kh, Dh),
            bt, lengths)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("Tq", [1, 3, 5])
def test_verify_ref_matches_reference_and_interpret_kernel(Tq, g):
    a = _verify_inputs(10 * Tq + g, 3, Tq, 2 * g, 2, 16, 4, 5)
    got = tref.paged_attention_verify_ref(*map(torch.from_numpy, a)).numpy()
    routed = ops.paged_attention_verify(*map(torch.from_numpy, a)).numpy()
    want = np.asarray(jref.paged_attention_verify_ref(*map(jnp.asarray, a)))
    kern = np.asarray(jpa.paged_attention_verify(*map(jnp.asarray, a),
                                                 interpret=True))
    assert got.shape == want.shape == (3, Tq, 2 * g, 16)
    np.testing.assert_array_equal(routed, got)
    assert np.abs(got - want).max() <= ATTN_TOL
    assert np.abs(got - kern).max() <= ATTN_TOL


def test_verify_ref_one_query_is_decode_ref_and_keeps_nan_out():
    """With one query the window oracle is the decode oracle, value for
    value; a NaN past a row's depth never reaches the output."""
    q, kp, vp, bt, ln = map(torch.from_numpy,
                            _verify_inputs(3, 4, 1, 4, 2, 16, 4, 5))
    want = tref.paged_attention_ref(q[:, 0], kp, vp, bt, ln)
    assert torch.equal(tref.paged_attention_verify_ref(q, kp, vp, bt, ln)[:, 0],
                       want)
    q, kp, vp, bt, ln = map(torch.from_numpy,
                            _verify_inputs(4, 4, 3, 4, 2, 16, 4, 5))
    clean = tref.paged_attention_verify_ref(q, kp, vp, bt, ln)
    for b, L in enumerate(ln.tolist()):
        last = int(bt[b, (L - 1) // 4])
        kp[last, (L - 1) % 4 + 1:] = vp[last, (L - 1) % 4 + 1:] = float("nan")
    kp[0] = vp[0] = float("nan")
    assert torch.equal(tref.paged_attention_verify_ref(q, kp, vp, bt, ln),
                       clean)


# ------------------------------------------------------------- verify_step
@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prefilled(prompts, ps=8, P=6):
    """Both packages' paged caches with each row's prompt prefilled into its
    own pages; returns the caches and the block tables."""
    jm, jp, tm, tp = _models()
    B = len(prompts)
    n_pages = B * P + 1
    bt = np.zeros((B, P), np.int32)
    bt[:] = np.arange(1, n_pages).reshape(B, P)
    jc = jm.init_paged_caches(B, n_pages, ps)
    tc = tm.init_paged_caches(B, n_pages, ps, device="cpu")
    for b, prompt in enumerate(prompts):
        Tc = -(-len(prompt) // ps) * ps
        toks = np.zeros((1, Tc), np.int32)
        toks[0, :len(prompt)] = prompt
        _, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc, jnp.asarray(bt[b]),
                                 b, 0, len(prompt))
        tm.prefill_chunk(tp, torch.as_tensor(toks, dtype=torch.long), tc,
                         torch.as_tensor(bt[b]), b, 0, len(prompt))
    return jc, tc, bt


def test_verify_step_matches_reference_and_stepwise_decode():
    """``verify_step`` logits of a 4-token window equal the reference's,
    and ``[:, i]`` equals feeding the window one ``decode_step`` at a
    time; ``pos`` stays at the entry depth."""
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 96, size=n) for n in (5, 13, 9)]
    window = rng.integers(0, 96, size=(3, 4)).astype(np.int32)
    pos0 = np.array([len(p) for p in prompts], np.int32)
    jc, tc, bt = _prefilled(prompts)
    jc = jm.set_paged_pos(jc, jnp.asarray(pos0))
    want, _ = jm.verify_step(jp, jnp.asarray(window), jc, jnp.asarray(bt))
    tc = tm.set_paged_pos(tc, torch.as_tensor(pos0))
    btt = torch.as_tensor(bt)
    got, _ = tm.verify_step(tp, torch.as_tensor(window, dtype=torch.long), tc,
                            btt)
    assert got.shape == (3, 4, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert all(torch.equal(c["pos"], torch.as_tensor(pos0)[None].expand_as(
        c["pos"]).int()) for c in tc)
    # the same window one token at a time through the decode step
    _, tc2, _ = _prefilled(prompts)
    tc2 = tm.set_paged_pos(tc2, torch.as_tensor(pos0))
    for i in range(4):
        step, _ = tm.decode_step(tp, torch.as_tensor(window[:, i],
                                                     dtype=torch.long),
                                 tc2, btt)
        np.testing.assert_allclose(got[:, i].numpy(), step.numpy(),
                                   atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- sampling
def _policy(B):
    temps = np.array([0.0, 0.7, 1.3, 0.9, 0.0, 2.0][:B], np.float32)
    top_ks = np.array([0, 3, 0, 8, 5, 1][:B], np.int32)
    return temps, top_ks


def test_policy_probs_matches_reference():
    rng = np.random.default_rng(6)
    logits = (2 * rng.standard_normal((6, 5, 40))).astype(np.float32)
    temps, top_ks = _policy(6)
    tb = np.broadcast_to(temps[:, None], (6, 5))
    kb = np.broadcast_to(top_ks[:, None], (6, 5))
    want = np.asarray(jsampling.policy_probs(jnp.asarray(logits),
                                             jnp.asarray(tb), jnp.asarray(kb)))
    got = tsampling.policy_probs(torch.from_numpy(logits),
                                 torch.from_numpy(tb.copy()),
                                 torch.from_numpy(kb.copy()).long()).numpy()
    assert np.abs(got - want).max() <= PROBS_TOL


def _window_case(seed, B, k, V):
    """Target logits near the draft's, so some proposals are accepted and
    some rejected; the draft proposals drawn from q."""
    rng = np.random.default_rng(seed)
    temps, top_ks = _policy(B)
    draft_logits = (2 * rng.standard_normal((B, k, V))).astype(np.float32)
    temps, top_ks = temps.copy(), top_ks.copy()
    target = np.concatenate(
        [draft_logits, rng.standard_normal((B, 1, V)).astype(np.float32)], 1)
    target = target + (0.5 * rng.standard_normal(target.shape)).astype(
        np.float32)
    q = np.array(jsampling.policy_probs(
        jnp.asarray(draft_logits),
        jnp.asarray(np.broadcast_to(temps[:, None], (B, k))),
        jnp.asarray(np.broadcast_to(top_ks[:, None], (B, k)))))
    d = np.stack([[rng.choice(V, p=q[b, i] / q[b, i].sum()) for i in range(k)]
                  for b in range(B)]).astype(np.int32)
    d[0] = np.argmax(target[0, :k], -1)          # a greedy row accepting all
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed, seed + B))
    return target, d, q, temps, top_ks, keys


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spec_accept_with_reference_draws(seed):
    """The port's acceptance arithmetic, fed the reference's own noise
    (``fold_in(key, 1)`` uniforms, ``fold_in(key, 2)`` Gumbel), gives the
    reference's tokens and acceptance counts for greedy, sampled and top-k
    rows alike."""
    B, k, V = 6, 4, 40
    target, d, q, temps, top_ks, keys = _window_case(seed, B, k, V)
    want_out, want_n = jsampling.spec_accept(
        jnp.asarray(target), jnp.asarray(d), jnp.asarray(q),
        jnp.asarray(temps), jnp.asarray(top_ks), keys)
    u = np.array(jax.vmap(lambda kk: jax.random.uniform(
        jax.random.fold_in(kk, 1), (k,)))(keys))
    g = np.array(jax.vmap(lambda kk: jax.random.gumbel(
        jax.random.fold_in(kk, 2), (V,)))(keys))
    out, n = tsampling.accept_window(
        torch.from_numpy(target), torch.from_numpy(d).long(),
        torch.from_numpy(q), torch.from_numpy(temps),
        torch.from_numpy(top_ks).long(), torch.from_numpy(u),
        torch.from_numpy(g))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert int(n[0]) == k                          # the all-accepting row


def test_spec_accept_greedy_batch_takes_the_greedy_rule():
    """An all-greedy batch (no noise drawn) gives what the full rule gives."""
    B, k, V = 6, 4, 40
    target, d, q, _, _, _ = _window_case(9, B, k, V)
    zeros = torch.zeros(B)
    full = tsampling.accept_window(
        torch.from_numpy(target), torch.from_numpy(d).long(),
        torch.from_numpy(q), zeros, torch.zeros(B, dtype=torch.long),
        torch.zeros(B, k), torch.zeros(B, V))
    fast = tsampling.spec_accept(torch.from_numpy(target),
                                 torch.from_numpy(d).long(),
                                 torch.from_numpy(q), [0.0] * B, [0] * B,
                                 [None] * B)
    assert all(torch.equal(a, b) for a, b in zip(full, fast))


def test_sampled_spec_emits_target_distribution():
    """Fixed seeds: 4000 rows propose from a draft distribution q unlike the
    target's p, and the first emitted token follows p (chi-square with 7
    degrees of freedom below its 0.999 quantile, 24.32)."""
    V, k, B = 8, 2, 4000
    rng = np.random.default_rng(0)
    tl = torch.from_numpy(rng.standard_normal(V).astype(np.float32))
    dl = torch.from_numpy(rng.standard_normal(V).astype(np.float32))
    temps, ks = [1.0] * B, [0] * B
    gens = [tsampling.make_generator(i, "cpu") for i in range(B)]
    draft_toks, draft_q = [], []
    for _ in range(k):
        t, qd = tsampling.propose_token(dl.expand(B, V), temps, ks, gens)
        draft_toks.append(t)
        draft_q.append(qd)
    out, n = tsampling.spec_accept(tl.expand(B, k + 1, V),
                                   torch.stack(draft_toks, 1),
                                   torch.stack(draft_q, 1), temps, ks, gens)
    p = torch.softmax(tl, -1).numpy()
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    chi2 = float(((counts - B * p) ** 2 / (B * p)).sum())
    assert chi2 < 24.32, (chi2, counts, B * p)
    assert 0 < int((n == 0).sum()) < B             # some rows reject


# ----------------------------------------------------- the engine vs JAX
def _requests(req_cls, vocab, n, seed=0, max_prompt=20, max_gen=10):
    rng = np.random.default_rng(seed)
    return [req_cls(id=i, prompt=rng.integers(0, vocab,
                                              size=int(rng.integers(3, max_prompt))),
                    max_new_tokens=int(rng.integers(2, max_gen)))
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def _drafts():
    """Each draft in both packages: perfect (the target itself), int8 (the
    fused int8 fold of a masked_dense model: the intended deployment) and
    skewed (other weights: frequent rejection and rollback)."""
    jm, jp, tm, tp = _models()
    mcfg = dict(smoke=True, mpd_mode="masked_dense")
    jmd = jbuild(jcommon.get_config("olmo-1b", **mcfg))
    jpd = jmd.init(jax.random.PRNGKey(0))
    tmd = tbuild(tcommon.get_config("olmo-1b", **mcfg))
    tpd = params_from_numpy(tmd, jax.tree.map(np.asarray, jpd), device="cpu")
    j7 = jm.init(jax.random.PRNGKey(7))
    return {"perfect": ((jm, jp), (tm, tp)),
            "int8": (jmd.to_packed(jpd, fuse=True, quantize="int8"),
                     tmd.to_packed(tpd, fuse=True, quantize="int8")),
            "skewed": ((jm, j7), (tm, params_from_numpy(
                tm, jax.tree.map(np.asarray, j7), device="cpu")))}


SPEC_KW = dict(n_slots=2, max_len=64, page_size=8)


@functools.lru_cache(maxsize=None)
def _reference_base():
    jm, jp, _, _ = _models()
    return JEngine(jm, jp, paged=True, **SPEC_KW).run(
        _requests(JRequest, 96, 6, seed=1))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("draft", ["perfect", "int8", "skewed"])
def test_spec_engine_streams_reference_spec_engine(draft, k):
    """6 requests on 2 slots: the port's greedy spec streams equal the
    reference spec engine's and the non-spec streams, every request done,
    acceptance within 0.05 of the reference's (the perfect draft's is not
    1: both packages score the draft's tokens one query at a time and the
    target's as a window, and a near-tie argmax can flip between them; at
    k = 2 the reference itself reads 0.9)."""
    jm, jp, tm, tp = _models()
    jd, td = _drafts()[draft]
    jeng = JEngine(jm, jp, paged=True, spec_draft=jd, spec_k=k, **SPEC_KW)
    want = jeng.run(_requests(JRequest, 96, 6, seed=1))
    eng = Engine(tm, tp, spec_draft=td, spec_k=k, **SPEC_KW)
    got = eng.run(_requests(Request, 96, 6, seed=1))
    assert eng.spec_active and jeng.spec_active
    assert got == want == _reference_base()
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    assert s["n_done"] == 6
    assert abs(s["draft_acceptance_rate"]
               - js["draft_acceptance_rate"]) <= 0.05
    if draft == "perfect" and k == 4:           # the reference test's bar
        assert s["draft_acceptance_rate"] > 0.9
    if draft == "skewed":
        assert s["draft_acceptance_rate"] < 1.0


# -------------------------------------------------- the port's spec engine
def _port_run(reqs, draft="perfect", k=4, n_slots=2):
    _, _, tm, tp = _models()
    eng = Engine(tm, tp, spec_draft=_drafts()[draft][1], spec_k=k,
                 n_slots=n_slots, max_len=64, page_size=8)
    return eng.run(reqs), eng


def _conserved(cache):
    return (cache.reserved == 0 and (cache.block_tables == 0).all()
            and cache.pool.free_count + len(cache.trie)
            == cache.pool.n_pages - 1)


def test_spec_eos_inside_window():
    """EOS anywhere inside an accepted window stops the request there, as
    in the non-spec stream."""
    _, _, tm, tp = _models()
    base = Engine(tm, tp, **SPEC_KW).run(
        _requests(Request, 96, 4, seed=9, max_gen=12))
    eos = int(base[0][len(base[0]) // 2])
    reqs = _requests(Request, 96, 4, seed=9, max_gen=12)
    for r in reqs:
        r.eos_id = eos
    plain = Engine(tm, tp, **SPEC_KW).run(
        [Request(id=r.id, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                 eos_id=eos) for r in reqs])
    out, eng = _port_run(reqs)
    assert out == plain
    stopped = [r for r in reqs if len(out[r.id]) < r.max_new_tokens]
    assert stopped and all(out[r.id][-1] == eos for r in stopped)
    assert all(r.state == RequestState.DONE for r in reqs)


def test_spec_metrics_and_pool_conservation():
    out, eng = _port_run(_requests(Request, 96, 6, seed=1))
    s = eng.metrics.summary()
    assert 1.0 <= s["tokens_per_step_mean"] <= eng.spec_k + 1
    assert 0.0 <= s["draft_acceptance_rate"] <= 1.0
    for rm in eng.metrics.requests.values():
        assert rm.n_decode_steps >= 1 or rm.n_generated <= 1
        assert rm.n_draft_accepted <= rm.n_draft_proposed
        if rm.tokens_per_step is not None:
            assert rm.tokens_per_step <= eng.spec_k + 1
    assert _conserved(eng.cache) and _conserved(eng.draft_cache)
    # a non-spec engine counts one token a step and no proposals
    _, _, tm, tp = _models()
    plain = Engine(tm, tp, **SPEC_KW)
    plain.run(_requests(Request, 96, 3, seed=2))
    ps = plain.metrics.summary()
    assert ps["tokens_per_step_mean"] == pytest.approx(1.0)
    assert ps["draft_acceptance_rate"] == 0.0


def test_spec_shared_prefix_prefilled_once():
    """Two requests with the same 17-token prompt: the second's two full
    pages come from the shared trie, counted once and reused by both
    pools."""
    prompt = np.arange(17, dtype=np.int32) % 96
    reqs = [Request(id=i, prompt=prompt.copy(), max_new_tokens=3)
            for i in range(2)]
    out, eng = _port_run(reqs, n_slots=1)
    assert out[0] == out[1]
    assert eng.metrics.prefill_tokens_computed == len(prompt) + 1
    assert eng.n_prefill_tokens_skipped == 16
    trie = eng.cache.trie
    assert trie is eng.draft_cache.trie and len(trie) == 2
    assert all(isinstance(v, tuple) and len(v) == 2
               for v in trie.nodes.values())


def test_spec_rollback_restores_reservation():
    """With the skewed draft every step rejects; every page freed by a
    rollback goes back to the reservation and nothing leaks in either
    pool."""
    reqs = _requests(Request, 96, 5, seed=11, max_gen=12)
    out, eng = _port_run(reqs, draft="skewed")
    assert eng.metrics.summary()["draft_acceptance_rate"] < 1.0
    assert _conserved(eng.cache) and _conserved(eng.draft_cache)


def test_rollback_and_shared_trie_units():
    """``rollback`` releases the pages past the kept depth into the slot's
    reservation; a shared node is evictable only when both pools hold it
    for the trie alone; the slack widens table and reservation."""
    _, _, tm, _ = _models()
    caches = [PagedCache(tm, 1, 16, page_size=4, n_pages=12, device="cpu",
                         slack_tokens=3) for _ in range(2)]
    a, b = caches
    assert a.max_pages == 5                         # ceil((16 + 3) / 4)
    share_trie(caches)
    prompt = np.arange(9, dtype=np.int32)
    for c in caches:
        c.admit_request(0, prompt, 6)               # 3 prompt pages, 2 held
        assert c.reserved == 2
    publish_prefix_shared(caches, prompt, 0, 9)
    assert len(a.trie) == 2 and a.trie.evictable_count() == 0
    for t in range(9, 15):
        a.ensure_decode_page(0, t)
    assert a.reserved == 1
    assert a.rollback(0, 10) == 1 and a.reserved == 2
    assert (a.block_tables[0, 3:] == 0).all() and a.block_tables[0, 2] != 0
    for c in caches:
        c.free_slot(0)
    assert a.trie.evictable_count() == 1            # the leaf, in both pools
    assert a.trie.evict_one() is not None and len(a.trie) == 1
    assert a.pool.free_count == b.pool.free_count == 12 - 1 - 1


def test_spec_engine_refuses_bad_drafts():
    _, _, tm, tp = _models()
    with pytest.raises(ValueError, match="spec_k"):
        Engine(tm, tp, spec_draft=(tm, tp), spec_k=0, **SPEC_KW)
    other = tbuild(tcommon.get_config("olmo-1b", smoke=True, vocab=128))
    with pytest.raises(ValueError, match="vocab"):
        Engine(tm, tp, spec_draft=(other, other.init(0, device="cpu")),
               **SPEC_KW)


# ---------------------------------------------------------------- launcher
def test_spec_draft_requires_paged():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--paged"):
        serve.main(["--arch", "olmo-1b", "--smoke", "--spec-draft", "x",
                    "--device", "cpu"])


def test_launcher_serves_with_a_torch_written_draft(tmp_path):
    """``--spec-draft`` on a packed int8 artifact written by the port: every
    request served, and the spec line printed."""
    model = tbuild(tcommon.get_config("olmo-1b", smoke=True,
                                      mpd_mode="masked_dense"))
    tckpt.export_packed(str(tmp_path), 1, model, model.init(0, device="cpu"),
                        fuse=True, quantize="int8")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmo-1b", "--smoke", "--paged", "--page-size", "8", "--ckpt-dir",
         str(tmp_path), "--spec-draft", str(tmp_path), "--spec-k", "4",
         "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr
    assert "paged: 6/6 requests" in r.stderr
    assert "spec decode: k=4," in r.stderr and "draft acceptance" in r.stderr
