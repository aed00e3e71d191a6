"""Port parity, slot-dense serving: the dense decode cache and the
full-prompt prefill against the JAX model, ``SlotCache`` against the
reference's write/reset contract, and the port's ``Engine(paged=False)``
against ``repro.serve.Engine(paged=False)`` on the same params (carried
over with ``params_from_numpy``) — fp and int8, through bucketed
admission, staggered arrivals, slot reuse after eviction and an EOS stop.
The same streams must equal the port's static lockstep greedy
(``launch.serve.static_decode``) and the port's paged engine.

The JAX engine compiles per bucket and per instance, so each engine is
built once per module and the cases run one after another on it.
Tolerances at float32: logits and caches against JAX atol/rtol 1e-5 (as
``tests/test_torch_graphs.py``); token streams, ``pos`` and launch counts:
exact.
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
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.launch.serve import make_requests as jmake_requests
from repro.serve import SlotCache as JSlotCache
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import make_requests, static_decode
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, Request, Scheduler, SlotCache
from repro_torch.serve import graphs
from repro_torch.serve.scheduler import make_buckets
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _models(quant: bool):
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    if quant:
        jp, _ = jexport.quantize_packed(jm, jp)
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _caches_close(tcaches, jcaches):
    for tc, jc in zip(tcaches, jcaches):
        assert set(tc) == set(jc)
        for k in tc:
            if k == "pos":
                np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            else:
                _close(tc[k], jc[k])


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("lengths", [None, [5, 8]], ids=["lockstep", "rows"])
def test_prefill_and_dense_decode_match_the_reference(lengths):
    """``prefill`` (with and without per-row lengths) and three dense decode
    steps, each row's K/V written at its own ``pos``: logits and caches
    within 1e-5, ``pos`` exact. ``max_len`` 10 after 8 prompt tokens makes
    the third step write past the end, where both packages clamp."""
    jm, jp, tm, tp = _models(False)
    toks = np.random.default_rng(0).integers(0, 96, size=(2, 8))
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    jlg, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_caches(2, 10),
                         lengths=jl)
    tlg, tc = tm.prefill(tp, torch.as_tensor(toks),
                         tm.init_caches(2, 10, device="cpu"), lengths=lengths)
    _close(tlg, jlg)
    _caches_close(tc, jc)
    n = tm.n_periods
    assert tc[0]["pos"].shape == ((n,) if lengths is None else (n, 2))
    nxt = np.array([3, 7])
    for _ in range(3):
        jlg, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tlg, tc = tm.decode_step(tp, torch.as_tensor(nxt), tc)
        _close(tlg, jlg)
        _caches_close(tc, jc)
        nxt = np.array(jnp.argmax(jlg, -1))


def test_slot_caches_and_axes():
    _, _, tm, _ = _models(False)
    jm = _models(False)[0]
    c = tm.init_slot_caches(3, 16, device="cpu")
    jc = jm.init_slot_caches(3, 16)
    for t, j in zip(c, jc):
        for k in t:
            assert tuple(t[k].shape) == j[k].shape
            assert t[k].dtype == (torch.int32 if k == "pos"
                                  else torch.float32)
    assert tm.slot_cache_axes() == jm.slot_cache_axes()


def test_slot_cache_write_and_reset():
    """``SlotCache``: the writeback lands in exactly the target slot's rows
    (``pos`` included) and equals the reference's; reset zeroes exactly
    that slot. A slot given as a device scalar writes the same."""
    jm, jp, tm, tp = _models(False)
    jsc = JSlotCache(jm, n_slots=3, max_len=16)
    sc = SlotCache(tm, n_slots=3, max_len=16, device="cpu")
    assert sc.kv_bytes == jsc.kv_bytes and sc.token_bytes == jsc.token_bytes
    toks = np.arange(8)[None] % 96
    _, jpc = jm.prefill(jp, jnp.asarray(toks), jm.init_caches(1, 16),
                        lengths=jnp.asarray([8], jnp.int32))
    _, pc = tm.prefill(tp, torch.as_tensor(toks),
                       tm.init_caches(1, 16, device="cpu"), lengths=[8])
    jsc.write_slot(jpc, 1)
    sc.write_slot(pc, 1)
    _caches_close(sc.caches, jsc.caches)
    for big, small in zip(sc.caches, pc):
        for k in big:
            assert torch.equal(big[k][:, 1], small[k][:, 0].to(big[k].dtype))
            assert not big[k][:, 0].any() and not big[k][:, 2].any()
    sc.reset_slot(1)
    assert not any(t.any() for c in sc.caches for t in c.values())
    sc._write_impl(sc.caches, pc, torch.tensor(2, dtype=torch.int32))
    for big, small in zip(sc.caches, pc):
        for k in big:
            assert torch.equal(big[k][:, 2], small[k][:, 0].to(big[k].dtype))
            assert not big[k][:, :2].any()


# --------------------------------------------------------------- engines
DENSE = dict(n_slots=2, max_len=48)


@functools.lru_cache(maxsize=None)
def _engines(quant: bool):
    """One JAX and one port dense engine per weights (the JAX one compiles
    once per bucket and instance)."""
    jm, jp, tm, tp = _models(quant)
    return JEngine(jm, jp, **DENSE), Engine(tm, tp, paged=False, **DENSE)


def _prompts(seed, n, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 96, size=int(rng.integers(lo, hi))),
             int(rng.integers(2, 10))) for _ in range(n)]


def _reqs(cls, prompts, eos=None):
    return [cls(id=i, prompt=p, max_new_tokens=g,
                **({} if eos is None or eos[i] is None else {"eos_id": eos[i]}))
            for i, (p, g) in enumerate(prompts)]


def _staggered(engine, reqs):
    engine.submit(reqs[0])
    for _ in range(3):
        engine.step()
    engine.submit(reqs[1])
    engine.step()
    engine.submit(reqs[2])
    while engine.has_work():
        engine.step()
    return {r.id: list(r.generated) for r in reqs}


def _static(quant, prompts):
    """The port's lockstep greedy of each prompt alone (batch 1)."""
    _, _, tm, tp = _models(quant)
    return {i: static_decode(tm, tp, torch.as_tensor(p)[None], g)["tokens"]
            [0].tolist() for i, (p, g) in enumerate(prompts)}


QUANT = pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])


@QUANT
def test_dense_engine_streams_equal_the_reference(quant):
    """6 requests on 2 slots (bucketed admission, slot reuse after
    eviction), then staggered arrivals, then an EOS stop taken from a
    request's own continuation: the port's streams are the JAX dense
    engine's, the port's static lockstep greedy and the port's paged
    engine's."""
    jeng, teng = _engines(quant)
    jm, _, tm, tp = _models(quant)
    prompts = _prompts(1, 6)
    want = jeng.run(_reqs(JRequest, prompts))
    assert teng.run(_reqs(Request, prompts)) == want
    assert want == _static(quant, prompts)
    paged = Engine(tm, tp, page_size=8, **DENSE)
    assert paged.run(_reqs(Request, prompts)) == want

    stag = _prompts(2, 3)
    assert _staggered(teng, _reqs(Request, stag)) \
        == _staggered(jeng, _reqs(JRequest, stag)) == _static(quant, stag)

    eos_prompts = _prompts(4, 2, hi=12)
    eos_prompts = [(p, 9) for p, _ in eos_prompts]
    full = _static(quant, eos_prompts)
    eos = [full[0][2], None]
    cut = full[0].index(eos[0]) + 1
    got = teng.run(_reqs(Request, eos_prompts, eos))
    assert got == jeng.run(_reqs(JRequest, eos_prompts, eos))
    assert got == {0: full[0][:cut], 1: full[1]}

    # the launchers' request stream (Poisson arrivals drawn, prompts from
    # SyntheticLM), every request submitted at once
    kw = dict(n_requests=6, rate=16.0, prompt_len=24, gen=8, seed=3)
    want = jeng.run(jmake_requests(jm.cfg, **kw))
    assert teng.run(make_requests(tm.cfg, **kw)) == want
    s = teng.metrics.summary()
    assert s["kv_bytes_reserved"] == teng.cache.kv_bytes > 0
    assert 0.0 < s["occupancy_mean"] <= 1.0


def test_dense_engine_programs_and_widths():
    """One admission run per request and one dense decode per step; no
    paged program runs; the dense engine has no width ladders and nothing
    to capture on the CPU; speculative decoding needs paged."""
    _, _, tm, tp = _models(False)
    eng = Engine(tm, tp, paged=False, **DENSE)
    out = eng.run(_reqs(Request, _prompts(7, 4)))
    # the first token of each request comes from its admission, every
    # other from a decode step of both slots
    decoded = sum(len(v) for v in out.values()) - eng.runs["admit"]
    assert eng.runs["admit"] == 4
    assert decoded / 2 <= eng.runs["decode_dense"] <= decoded
    assert not any(eng.runs[k] for k in ("decode", "chunk", "chunk_final"))
    assert eng.decode_widths() == eng.prefill_widths() == []
    eng.warmup()
    assert eng.n_captures == 0
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, tp, paged=False, spec_draft=(tm, tp), **DENSE)


def test_buckets_and_admission():
    """The dense engine's strict-bucket scheduler, as the reference's:
    powers of two up to ``max_len``, a prompt past the largest bucket or
    past ``max_len`` refused at submit."""
    assert make_buckets(16, 128) == (16, 32, 64, 128)
    assert make_buckets(16, 100) == (16, 32, 64, 100)
    s = Scheduler(n_slots=2, max_len=64, min_bucket=16)
    assert s.bucket_len(3) == 16 and s.bucket_len(17) == 32
    _, _, tm, tp = _models(False)
    eng = Engine(tm, tp, paged=False, n_slots=2, max_len=64, buckets=[16, 32])
    assert eng.scheduler.buckets == (16, 32)
    with pytest.raises(ValueError):
        eng.submit(Request(id=10, prompt=np.zeros(40, np.int32),
                           max_new_tokens=8))
    with pytest.raises(ValueError):
        eng.submit(Request(id=9, prompt=np.zeros(60, np.int32),
                           max_new_tokens=30))
    assert not eng.has_work()
    paged = Engine(tm, tp, n_slots=2, max_len=64, buckets=[16, 32])
    paged.submit(Request(id=11, prompt=np.zeros(40, np.int32),
                         max_new_tokens=8))      # paged: no bucket ceiling


# ------------------------------------------------------- captured logic
class _Rerun:
    """A CPU stand-in for a captured graph: a replay calls the program
    again and writes its result into the output returned at capture."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def test_captured_dense_engine_logic_on_the_cpu(monkeypatch):
    """The dense engine's capture path with the stand-in graph: ``warmup()``
    captures the decode and every bucket's admission, writing nothing a
    live request reads (every slot's ``pos``, the pending tokens and the
    live slots' K/V below their depth unchanged); serving then captures
    nothing new and streams the eager engine's tokens."""
    monkeypatch.setattr(graphs, "_warm",
                        lambda fn, device, runs: [fn() for _ in range(runs)])
    monkeypatch.setattr(graphs, "_record",
                        lambda fn, device: (lambda out: (_Rerun(fn, out),
                                                         out))(fn()))
    _, _, tm, tp = _models(False)
    eager = Engine(tm, tp, paged=False, graphs=False, **DENSE)
    eng = Engine(tm, tp, paged=False, **DENSE)
    eng.use_graphs = True
    reqs = _reqs(Request, [(p, 12) for p, _ in _prompts(5, 2)])
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                   # both slots live mid-decode
        eng.step()
    assert eng._live.all()
    depth = [len(r.prompt) + len(r.generated) - 1 for r in reqs]
    before = [t.clone() for c in eng.cache.caches for t in c.values()]
    tokens = eng._tokens.clone()
    with pytest.raises(RuntimeError, match="free slot"):
        eng.warmup()                     # the decode captured, no admission
    after = [t.clone() for c in eng.cache.caches for t in c.values()]
    assert torch.equal(eng._tokens, tokens)
    for a, b in zip(before, after):
        if a.dim() == 2:                 # pos
            assert torch.equal(a, b)
        else:
            for s, d in enumerate(depth):
                assert torch.equal(a[:, s, :d], b[:, s, :d])
    while eng.has_work():
        eng.step()
    want = eager.run(_reqs(Request, [(p, 12) for p, _ in _prompts(5, 2)]))
    assert {r.id: list(r.generated) for r in reqs} == want
    eng.warmup()
    assert eng.n_captures == 1 + len(eng.scheduler.buckets)
    n = eng.n_captures
    prompts = _prompts(9, 4)
    eager2 = Engine(tm, tp, paged=False, graphs=False, **DENSE)
    assert eng.run(_reqs(Request, prompts)) == eager2.run(
        _reqs(Request, prompts))
    assert eng.n_captures == n
