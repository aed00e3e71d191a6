"""Port parity, the GQA/rms/ln, MoE and recurrent configurations:
granite-8b, minitron-4b, command-r-plus-104b, qwen2-moe-a2.7b,
llama4-maverick-400b-a17b, rwkv6-3b and jamba-v0.1-52b, each against the
JAX package.

* ``full()`` and ``smoke()`` equal the reference's field for field;
* at smoke width, from the reference's params carried over with
  ``params_from_numpy``: ``logits`` and ``train_loss`` (the MoE aux term
  included) within 1e-5 at float32; two paged prefill chunks, decode steps
  under a live mask and (attention models) a verify window give the
  reference's logits, pools, ``pos`` and recurrent state; a right-padded
  dense ``prefill`` and decode steps from it give the reference's logits
  and caches;
* a dense prefill followed by decode steps equals the full-sequence
  ``logits`` on one pattern position; on llama4's two, the serving paths
  run each position over all periods first, as the reference's do, so the
  port is held to the reference's decode there, and the full-sequence
  trunk differs from both (checked, so a change of either order shows);
* the paged engine streams the JAX paged engine's greedy tokens for the
  granite, qwen2-moe and llama4 smokes, and for qwen2-moe at a capacity
  factor of 0.5, where decode steps drop routed choices while idle and
  mid-prefill rows route beside the live ones (a non-live row's depth,
  pending token and null-page reads must be the reference's);
* the paged and slot-dense engines stream the JAX engines' greedy tokens
  for the rwkv6 and jamba smokes too; a chunked prefill interleaved with
  another slot's decode leaves the recurrent state the reference's
  whole-prompt prefill gives (within 1e-6: the reference's own bitwise
  check of that traffic fails on XLA's rounding alone); a ``spec_draft``
  leaves a recurrent engine's speculation off.

The reference's model entry points run under ``jax.jit`` (one compile
each), its engines at a 32-token depth (few width rungs to compile).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, Request
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
ARCHS = ["granite-8b", "minitron-4b", "command-r-plus-104b",
         "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b", "rwkv6-3b",
         "jamba-v0.1-52b"]
RECURRENT = ["rwkv6-3b", "jamba-v0.1-52b"]
PS, N_PAGES, N_SLOTS = 8, 12, 2


def test_configs_equal_reference_field_for_field():
    """Every arch of the reference (the embed frontends' hubert-xlarge and
    qwen2-vl-72b among them), in its order; every field but ``remat``,
    which stays at the reference's default."""
    assert tcommon.ARCHS == jcommon.ARCHS
    for arch in jcommon.ARCHS:
        for smoke in (False, True):
            t = dataclasses.asdict(tcommon.get_config(arch, smoke=smoke))
            j = dataclasses.asdict(jcommon.get_config(arch, smoke=smoke))
            assert {k: j[k] for k in t} == t, (arch, smoke)
            assert {k: v for k, v in j.items() if k not in t} == \
                tckpt.FOREIGN_CONFIG_DEFAULTS, (arch, smoke)
    assert tckpt.FOREIGN_CONFIG_DEFAULTS == {"remat": "block"}


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's init of the arch's smoke config (under ``jax.jit``:
    one compile instead of one per op) and its numpy copy."""
    jm = jbuild(jcommon.get_config(arch, smoke=True))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _pair(arch, **over):
    """Both packages' models of the smoke config (``over`` changes no param
    shape) on the same params."""
    jp, numpy_params = _params(arch)
    jm = jbuild(jcommon.get_config(arch, smoke=True, **over))
    tm = tbuild(tcommon.get_config(arch, smoke=True, **over))
    return jm, jp, tm, params_from_numpy(tm, numpy_params, device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """The reference's entry points under ``jax.jit`` (one compile each
    instead of one per op)."""
    jm = _pair(arch)[0]

    def full(p, toks, labels):
        x, aux = jm.forward(p, toks)
        return (jm.unembed.apply(p["unembed"], x), aux,
                jm.train_loss(p, {"inputs": toks, "labels": labels}))
    return dict(full=jax.jit(full),
                chunk=jax.jit(jm.prefill_chunk, static_argnames=("final",)),
                decode=jax.jit(jm.decode_step),
                verify=jax.jit(jm.verify_step))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close_caches(tc, jc):
    """Every cache leaf: K/V and recurrent state within the tolerance,
    ``pos`` equal."""
    for t, j in zip(tc, jc):
        assert set(t) == set(j)
        for k in j:
            if k == "pos":
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
            else:
                _close(t[k], j[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_chunks_decode_and_verify_match_jax(arch):
    """Param counts; ``logits``, ``train_loss`` and the aux term; then two
    chunks of one request (the second right-padded, start > 0), a second
    request's chunk, decode steps under a live mask and (attention models)
    a verify window: logits, pools, pos and recurrent state after every
    call."""
    jm, jp, tm, tp = _pair(arch)
    assert tm.param_count() == jm.param_count()
    assert tm.active_matmul_params() == jm.active_matmul_params()
    jit = _jitted(arch)
    V = jm.cfg.vocab
    toks, labels = _tokens(V, (2, 16)), _tokens(V, (2, 16), seed=1)
    jl, jaux, jloss = jit["full"](jp, jnp.asarray(toks), jnp.asarray(labels))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        _close(tm.logits(tp, tt), jl)
        tloss = tm.train_loss(tp, {"inputs": tt,
                                   "labels": torch.from_numpy(labels).long()})
        taux = tm.forward(tp, tt)[1]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert (float(taux) > 0) == any(k.endswith("_moe")
                                    for k in jm.cfg.pattern)

    jc = jm.init_paged_caches(N_SLOTS, N_PAGES, PS)
    tc = tm.init_paged_caches(N_SLOTS, N_PAGES, PS, device="cpu")
    prompt0, prompt1 = _tokens(V, (27,), 2), _tokens(V, (9,), 3)
    bt = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 0, 0, 0]], np.int32)
    for slot, prompt, pos in ((0, prompt0, 0), (0, prompt0, 16),
                              (1, prompt1, 0)):
        n = min(len(prompt) - pos, 16)
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :n] = prompt[pos:pos + n]
        final = pos + n >= len(prompt)
        row = bt[slot, :4]
        jl, jc = jit["chunk"](jp, jnp.asarray(chunk), jc, jnp.asarray(row),
                              slot, pos, n, final=final)
        with torch.no_grad():
            tl, tc = tm.prefill_chunk(tp, torch.from_numpy(chunk).long(), tc,
                                      torch.from_numpy(row), slot, pos, n,
                                      final=final)
        if final:
            _close(tl, jl)
        _close_caches(tc, jc)
    tokens = np.array([11, 42], np.int32) % V
    for live in ([True, True], [True, False], [False, True]):
        live = np.array(live)
        jl, jc = jit["decode"](jp, jnp.asarray(tokens), jc,
                               block_tables=jnp.asarray(bt),
                               live=jnp.asarray(live))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tokens).long(), tc,
                                    torch.from_numpy(bt),
                                    live=torch.from_numpy(live))
        _close(tl, jl)
        _close_caches(tc, jc)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tm.spec_decode_supported == jm.spec_decode_supported
    if not tm.spec_decode_supported:
        return
    window = _tokens(V, (2, 3), 4)
    pos = np.array([29, 10], np.int32)
    jc = jm.set_paged_pos(jc, jnp.asarray(pos))
    jl, jc = jit["verify"](jp, jnp.asarray(window), jc, jnp.asarray(bt))
    with torch.no_grad():
        tc = tm.set_paged_pos(tc, torch.from_numpy(pos))
        tl, tc = tm.verify_step(tp, torch.from_numpy(window).long(), tc,
                                torch.from_numpy(bt))
    _close(tl, jl)
    _close_caches(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_against_forward(arch):
    """A token's MoE output depends on its call's batch once choices drop:
    the MoE smokes run here at a capacity no call of this test exceeds.
    (The serving paths are held to the reference's above, so this runs on
    the port alone.)"""
    cfg = tcommon.get_config(arch, smoke=True)
    if any(k.endswith("_moe") for k in cfg.pattern):
        cfg = dataclasses.replace(cfg, moe_capacity=16.0)
    tm = tbuild(cfg)
    tp = tm.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 12), 6)).long()
    with torch.no_grad():
        full = tm.logits(tp, toks)
        caches = tm.init_slot_caches(2, 16, device="cpu")
        lg, caches = tm.prefill(tp, toks[:, :8], caches)
        steps = [lg]
        for i in range(8, 11):
            lg, caches = tm.decode_step(tp, toks[:, i], caches)
            steps.append(lg)
    gap = float((torch.stack(steps, dim=1) - full[:, 7:11]).abs().max())
    if len(cfg.pattern) == 1 or tm.n_periods == 1:
        assert gap < ATOL
    else:
        # serving order A0 A1 M0 M1, training order A0 M0 A1 M1
        assert gap > 1e-3


def _prompts(vocab, seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 22))),
             int(rng.integers(3, 9))) for _ in range(n)]


ENGINE = dict(n_slots=4, max_len=32, page_size=8, prefill_chunk_tokens=16)


def _engines(arch, capacity):
    over = {"moe_capacity": capacity} if capacity else {}
    jm, jp, tm, tp = _pair(arch, **over)
    return JEngine(jm, jp, paged=True, **ENGINE), Engine(tm, tp, **ENGINE)


def _staggered(engine, req_cls, prompts):
    """One request, then two, then the rest: idle slots, mid-prefill rows
    and finished slots decode beside the live ones."""
    reqs = [req_cls(id=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(prompts)]
    engine.submit(reqs[0])
    engine.step()
    engine.step()
    for r in reqs[1:3]:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    for r in reqs[3:]:
        engine.submit(r)
    while engine.has_work():
        engine.step()
    return {r.id: list(r.generated) for r in reqs}


# llama4's top-1 routing over 8 experts drops at its own capacity (C = 1
# for 4 rows); qwen2-moe's top-4 needs the factor 0.5 to
STREAMS = [("granite-8b", 0), ("llama4-maverick-400b-a17b", 0),
           ("qwen2-moe-a2.7b", 0.5), ("rwkv6-3b", 0), ("jamba-v0.1-52b", 0)]


@pytest.mark.parametrize("arch,capacity", STREAMS)
def test_paged_engine_streams_equal_jax_engine(arch, capacity):
    jeng, teng = _engines(arch, capacity)
    prompts = _prompts(jeng.model.cfg.vocab, 1, 7)
    want = _staggered(jeng, JRequest, prompts)
    assert _staggered(teng, Request, prompts) == want
    assert teng.n_prefill_chunks == jeng.n_prefill_chunks
    if capacity:
        # the case drops routed choices at decode: C = 1 place an expert
        # for 4 rows x 4 choices over 8 experts
        ffn = teng.model.block_specs[0]["ffn"]
        assert ffn.capacity(ENGINE["n_slots"]) == 1


@pytest.mark.parametrize("arch", RECURRENT)
def test_dense_prefill_and_decode_match_jax(arch):
    """A right-padded dense ``prefill`` (the recurrent state frozen past
    each row's length) and decode steps from it: logits and every cache
    leaf, the reference's."""
    jm, jp, tm, tp = _pair(arch)
    V = jm.cfg.vocab
    toks = _tokens(V, (2, 12), 7)
    lengths = np.array([12, 7], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jm.init_caches(2, 16),
                                 jnp.asarray(lengths))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(),
                            tm.init_caches(2, 16, device="cpu"),
                            torch.from_numpy(lengths))
    _close(tl, jl)
    _close_caches(tc, jc)
    tokens = np.array([5, 17], np.int32)
    for _ in range(3):
        jl, jc = _jitted(arch)["decode"](jp, jnp.asarray(tokens), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tokens).long(), tc)
        _close(tl, jl)
        _close_caches(tc, jc)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", RECURRENT)
def test_dense_engine_streams_equal_jax_engine(arch):
    """The slot-dense engines (one bucketed batch-1 prefill an admission,
    every slot decoding, idle ones too) on the staggered traffic."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(jm.cfg.vocab, 3, 6)
    want = _staggered(JEngine(jm, jp, paged=False, **ENGINE), JRequest,
                      prompts)
    assert _staggered(Engine(tm, tp, paged=False, **ENGINE), Request,
                      prompts) == want


@pytest.mark.parametrize("arch", RECURRENT)
def test_chunked_prefill_beside_decode_keeps_the_reference_state(arch):
    """The reference's ``test_decode_freezes_mid_prefill_recurrent_state``
    traffic on the port's paged engine: a short request decodes while a
    long one prefills in 8-token chunks. After two of them the long
    request's state rows are the JAX engine's and the reference's
    whole-prompt prefill of its 16 tokens (within 1e-6, where the
    reference's own bitwise check fails on XLA's rounding); both streams
    are the JAX engine's; and a ``spec_draft`` leaves the engine's
    speculation off. An MoE layer's capacity counts the tokens of its call,
    so jamba runs at a factor where no choice drops: only then is a chunked
    prefill the whole prompt's."""
    cfg = tcommon.get_config(arch, smoke=True)
    over = ({"moe_capacity": float(cfg.moe_experts)} if cfg.moe_experts
            else {})
    jm, jp, tm, tp = _pair(arch, **over)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 96, size=5), rng.integers(0, 96, size=40)]
    kw = dict(n_slots=2, max_len=96, page_size=8, prefill_chunk_tokens=8)

    def run(engine, req_cls, check=None):
        short = req_cls(id=0, prompt=prompts[0], max_new_tokens=20)
        long_ = req_cls(id=1, prompt=prompts[1], max_new_tokens=4)
        engine.submit(short)
        engine.step()
        engine.step()
        engine.submit(long_)
        engine.step()
        engine.step()
        assert long_.state.value == "prefill" and long_.prefill_pos == 16
        if check is not None:
            check(engine, long_.slot)
        while engine.has_work():
            engine.step()
        return [list(short.generated), list(long_.generated)]

    _, whole = jax.jit(jm.prefill)(jp, jnp.asarray(prompts[1][:16])[None],
                                   jm.init_caches(1, 96))
    rows = {}

    def state_rows(engine, slot):
        rows[len(rows)] = [{k: np.array(c[k][:, slot]) for k in c}
                           for spec, c in zip(tm.block_specs,
                                              engine.cache.caches)
                           if spec["kind"] not in ("attn", "attn_moe")]
    want = run(JEngine(jm, jp, paged=True, **kw), JRequest, state_rows)
    assert run(Engine(tm, tp, **kw), Request, state_rows) == want
    wholes = [{k: np.asarray(w[k][:, 0]) for k in w}
              for spec, w in zip(jm.block_specs, whole)
              if spec["kind"] not in ("attn", "attn_moe")]
    for got, jax_engine, w in zip(rows[1], rows[0], wholes):
        for k in w:
            np.testing.assert_allclose(got[k], jax_engine[k], atol=1e-6,
                                       rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], w[k], atol=1e-6, rtol=1e-6,
                                       err_msg=k)
    spec = Engine(tm, tp, spec_draft=(tm, tp), spec_k=2, **kw)
    assert not spec.spec_active and spec.draft_cache is None
    assert not spec.cache.prefix_cache_enabled
    assert run(spec, Request) == want


def test_duplicate_page_writes_take_the_last_writer():
    """Every write to one destination carries the last writer's value (the
    paged K/V writes gather through this before their scatter)."""
    from repro_torch.models import attention as tattn
    dest = torch.tensor([3, 1, 3, 2, 1, 3])
    assert tattn._last_writes(dest).tolist() == [5, 4, 5, 3, 4, 5]
    assert tattn._last_writes(torch.arange(4)).tolist() == [0, 1, 2, 3]


class _Rerun:
    """A CPU stand-in for a captured graph: a replay calls the program
    again and writes its result into the outputs returned at capture."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        if isinstance(self.out, torch.Tensor):
            self.out.copy_(new)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_captured_moe_engine_serves_the_eager_streams(monkeypatch, spec):
    """Captures run their programs against the null page; an MoE layer
    routes the non-live rows that read it with the live ones, so every
    capture puts the null page back: after ``warmup()`` it is as an eager
    engine has it, and the dropping qwen2-moe smoke streams the eager
    engine's tokens (port alone, the capture path with a stand-in graph
    that re-runs the program)."""
    from repro_torch.serve import graphs
    monkeypatch.setattr(graphs, "_warm",
                        lambda fn, device, runs: [fn() for _ in range(runs)])
    monkeypatch.setattr(graphs, "_record",
                        lambda fn, device: (lambda out: (_Rerun(fn, out),
                                                         out))(fn()))
    cfg = tcommon.get_config("qwen2-moe-a2.7b", smoke=True, moe_capacity=0.5)
    tm = tbuild(cfg)
    tp = tm.init(0, device="cpu")
    kw = dict(ENGINE, **({"spec_draft": (tm, tp), "spec_k": 2} if spec
                         else {}))
    eager = Engine(tm, tp, graphs=False, **kw)
    eng = Engine(tm, tp, **kw)
    eng.use_graphs = True
    eng.warmup()
    assert eng.n_captures > 0
    pools = eng.cache.caches + (eng.draft_cache.caches if spec else [])
    assert all(not c[k][:, 0].any() for c in pools for k in ("kp", "vp"))
    prompts = _prompts(cfg.vocab, 2, 7)
    assert _staggered(eng, Request, prompts) == \
        _staggered(eager, Request, prompts)
    assert eng.runs == eager.runs


@pytest.mark.parametrize("arch", RECURRENT)
def test_captured_recurrent_engine_serves_the_eager_streams(monkeypatch,
                                                            arch):
    """A capture's warm-up chunk writes slot 0's state row and its decode
    runs every row: ``warmup()`` puts the state back (zeros, as an eager
    engine has it), and a captured engine streams the eager engine's
    tokens with the same program runs (port alone, the capture path with
    a stand-in graph that re-runs the program)."""
    from repro_torch.serve import graphs
    monkeypatch.setattr(graphs, "_warm",
                        lambda fn, device, runs: [fn() for _ in range(runs)])
    monkeypatch.setattr(graphs, "_record",
                        lambda fn, device: (lambda out: (_Rerun(fn, out),
                                                         out))(fn()))
    tm = tbuild(tcommon.get_config(arch, smoke=True))
    tp = tm.init(0, device="cpu")
    eager = Engine(tm, tp, graphs=False, **ENGINE)
    eng = Engine(tm, tp, **ENGINE)
    eng.use_graphs = True
    eng.warmup()
    assert eng.n_captures > 0
    state = [t for spec, c in zip(tm.block_specs, eng.cache.caches)
             if spec["kind"] not in ("attn", "attn_moe") for t in c.values()]
    assert state and all(not t.any() for t in state)
    prompts = _prompts(tm.cfg.vocab, 4, 7)
    assert _staggered(eng, Request, prompts) == \
        _staggered(eager, Request, prompts)
    assert eng.runs == eager.runs
