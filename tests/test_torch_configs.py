"""Port parity, the GQA/rms/ln and MoE configurations: granite-8b,
minitron-4b, command-r-plus-104b, qwen2-moe-a2.7b and
llama4-maverick-400b-a17b, each against the JAX package.

* ``full()`` and ``smoke()`` equal the reference's field for field;
* at smoke width, from the reference's params carried over with
  ``params_from_numpy``: ``logits`` and ``train_loss`` (the MoE aux term
  included) within 1e-5 at float32; two paged prefill chunks, decode steps
  under a live mask and a verify window give the reference's logits, pools
  and ``pos``;
* a dense prefill followed by decode steps equals the full-sequence
  ``logits`` on one pattern position; on llama4's two, the serving paths
  run each position over all periods first, as the reference's do, so the
  port is held to the reference's decode there, and the full-sequence
  trunk differs from both (checked, so a change of either order shows);
* the paged engine streams the JAX paged engine's greedy tokens for the
  granite, qwen2-moe and llama4 smokes, and for qwen2-moe at a capacity
  factor of 0.5, where decode steps drop routed choices while idle and
  mid-prefill rows route beside the live ones (a non-live row's depth,
  pending token and null-page reads must be the reference's).

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

ATOL = RTOL = 1e-5
ARCHS = ["granite-8b", "minitron-4b", "command-r-plus-104b",
         "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
PS, N_PAGES, N_SLOTS = 8, 12, 2


def test_configs_equal_reference_field_for_field():
    for arch in ARCHS:
        assert arch in tcommon.ARCHS
        for smoke in (False, True):
            t = dataclasses.asdict(tcommon.get_config(arch, smoke=smoke))
            j = dataclasses.asdict(jcommon.get_config(arch, smoke=smoke))
            assert {k: j[k] for k in t} == t, (arch, smoke)
            # the reference's other fields are the families not ported,
            # at their defaults
            assert {k: v for k, v in j.items() if k not in t} == \
                tckpt.FOREIGN_CONFIG_DEFAULTS, (arch, smoke)
    for arch in ("hubert-xlarge", "qwen2-vl-72b", "rwkv6-3b",
                 "jamba-v0.1-52b"):
        assert arch not in tcommon.ARCHS


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
    for t, j in zip(tc, jc):
        for k in ("kp", "vp"):
            _close(t[k], j[k])
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_chunks_decode_and_verify_match_jax(arch):
    """Param counts; ``logits``, ``train_loss`` and the aux term; then two
    chunks of one request (the second right-padded, start > 0), a second
    request's chunk, decode steps under a live mask and a verify window:
    logits, pools and pos after every call."""
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
    assert (float(taux) > 0) == ("attn_moe" in jm.cfg.pattern)

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
    if "attn_moe" in cfg.pattern:
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
    if len(cfg.pattern) == 1:
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
           ("qwen2-moe-a2.7b", 0.5)]


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
