"""Port parity, resilience: the fault injector, the degradation ladder and
the retry policy of ``repro_torch.serve.resilience`` against the
reference's on the same schedules, seeds and pressure sequences, and the
engine's watchdog (quarantine and retry, the step-fault retry, deadlines,
the ladder's stages) against the JAX engine on the same params (carried
over with ``params_from_numpy``) and requests, at float32 — the cases of
``tests/test_serve_resilience.py``.

Tolerance: exact. Poison vectors, injection counts, withheld pages, ladder
stages and transitions, backoff steps and EWMAs equal the reference's;
greedy streams, every counter of the metrics summary (the host-clock
timings and the prefill's KV bytes read aside: the JAX engine's CPU route
is its dense gather), the engines' quarantine, failure and deadline
counts equal the JAX engine's, and every completed stream equals the
fault-free run's.

The reference's own chaos-with-spec schedule (``draft_logits`` at step 4,
``decode_logits`` at step 6) never fires: the perfect draft drains its
three requests in three steps, in both packages. The port is held to
inject what the reference injects there (nothing), and then to the JAX
engine on a schedule that fires at steps 1 and 2.
"""

import functools
import json
import math

import jax
import numpy as np
import pytest

import repro.serve as J
import repro_torch.serve as T
from repro.configs import common as jcommon
from repro.models import build as jbuild
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.models import build as tbuild
from repro_torch.serve.cache import NULL_PAGE

from test_torch_graphs import stub_capture  # noqa: F401 - a fixture

TIMED = ("_s", "tok_s", "slo_attainment", "prefill_kv_bytes_read")
PAGED = dict(n_slots=2, max_len=64, page_size=8)


@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _requests(pkg, n, seed, max_prompt=20, max_gen=10):
    """``tests/test_serve_paged.py::_requests`` for either package."""
    rng = np.random.default_rng(seed)
    return [pkg.Request(id=i,
                        prompt=rng.integers(0, 96, size=int(
                            rng.integers(3, max_prompt))),
                        max_new_tokens=int(rng.integers(2, max_gen)))
            for i in range(n)]


def _counters(summary):
    return {k: v for k, v in summary.items()
            if not any(k.endswith(t) for t in TIMED)}


def pool_conserved(cache):
    """After a drain the only holders left are trie nodes."""
    pool = cache.pool
    assert pool.free_count + pool.allocated_count == pool.n_pages - 1
    expect = np.zeros(pool.n_pages, np.int64)
    expect[NULL_PAGE] = 1
    for value in cache.trie.nodes.values():
        expect[cache._own_pid(value)] += 1
    assert (pool.ref == expect).all(), (pool.ref.tolist(), expect.tolist())


def _engines(kw, resilience=None, spec=False):
    """The JAX engine and the port's, each with its own package's
    resilience bundle ``resilience(pkg)`` (None: the inert default)."""
    jm, jp, tm, tp = _models()
    out = []
    for pkg, Eng, m, p, extra in ((J, J.Engine, jm, jp, dict(paged=True)),
                                  (T, T.Engine, tm, tp, {})):
        if not kw.get("paged", True):
            extra = {}
        kws = dict(extra, **kw)
        if spec:
            kws.update(spec_draft=(m, p), spec_k=3)
        if resilience is not None:
            kws["resilience"] = resilience(pkg)
        out.append(Eng(m, p, **kws))
    return out


def _run_both(kw, reqs, resilience=None, spec=False, drive=None):
    """Serve ``reqs(pkg)`` on both engines; streams, counters and the
    engines' fault counts must agree. Returns the port's engine and
    requests and the JAX engine."""
    res = []
    for pkg, eng in zip((J, T), _engines(kw, resilience, spec)):
        rs = reqs(pkg)
        if drive is None:
            eng.run(rs, max_steps=400)
        else:
            drive(eng, rs)
        res.append((eng, rs))
    (jeng, jreqs), (teng, treqs) = res
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    for k in ("n_quarantines", "n_fault_failures", "n_deadline_aborts",
              "n_preemptions", "step_count"):
        assert getattr(teng, k) == getattr(jeng, k), k
    assert _counters(teng.metrics.summary()) == \
        _counters(jeng.metrics.summary())
    ji, ti = jeng.resilience.injector, teng.resilience.injector
    if ti is not None:
        assert ti.counts == ji.counts
    return teng, treqs, jeng


@functools.lru_cache(maxsize=None)
def _fault_free(n, seed, kw_items=tuple(sorted(PAGED.items())), spec=False):
    _, _, tm, tp = _models()
    kw = dict(kw_items)
    if spec:
        kw.update(spec_draft=(tm, tp), spec_k=3)
    return T.Engine(tm, tp, **kw).run(_requests(T, n, seed))


# ------------------------------------------------------------- injector unit
def _random_schedule(pkg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(8):
        site = ("decode_logits", "draft_logits", "engine_step", "slow_step",
                "pool_exhaust")[int(rng.integers(5))]
        out.append(pkg.FaultSpec(
            site, step=int(rng.integers(0, 12)),
            n_steps=int(rng.integers(1, 4)),
            slot=int(rng.integers(0, 5)), value=float(("nan", "inf", "-inf")[
                int(rng.integers(3))]),
            duration_s=0.0,
            n_pages=None if rng.random() < 0.3 else int(rng.integers(1, 9))))
    return out


@pytest.mark.parametrize("schedule", ["storm", 0, 1, 2])
def test_injector_replays_the_reference(schedule):
    """Same schedule and seed: the same poison vectors, withheld pages,
    exception steps and counts as the reference's injector."""
    def mk(pkg):
        sched = (pkg.storm_schedule() if schedule == "storm"
                 else _random_schedule(pkg, schedule))
        return pkg.FaultInjector(sched, seed=7)
    a, b = mk(J), mk(T)
    for step in range(16):
        for site in ("decode_logits", "draft_logits"):
            va, vb = a.poison(site, step, 4), b.poison(site, step, 4)
            assert (va is None) == (vb is None)
            if va is not None:
                np.testing.assert_array_equal(va, vb)
        for _ in range(2):                  # consulted twice, fires once
            assert a.withheld_pages(step) == b.withheld_pages(step)
        assert a.slow(step) == b.slow(step)
        fired = []
        for inj, exc in ((a, J.InjectedFault), (b, T.InjectedFault)):
            try:
                inj.check("engine_step", step)
                fired.append(None)
            except exc as e:
                fired.append((e.site, e.step))
        assert fired[0] == fired[1]
    assert a.counts == b.counts and a.total_injected == b.total_injected
    if schedule == "storm":
        assert b.counts["decode_logits"] == 2 and b.counts["engine_step"] == 1
        assert b.counts["pool_exhaust"] == 3
        v3 = T.FaultInjector(T.storm_schedule()).poison("decode_logits", 3, 4)
        assert math.isnan(v3[0]) and v3[1] == 0.0


def test_parse_schedule_forms(tmp_path):
    js = json.dumps([{"site": "decode_logits", "step": 2, "slot": 1},
                     {"site": "pool_exhaust", "step": 4, "n_steps": 2}])
    f = tmp_path / "sched.json"
    f.write_text(js)
    for text in ("storm", js, f"@{f}"):
        got = [s.__dict__ for s in T.parse_schedule(text)]
        want = [s.__dict__ for s in J.parse_schedule(text)]
        assert json.dumps(got) == json.dumps(want)
    assert T.parse_schedule(js)[1].active(5)
    for bad in (json.dumps([{"site": "nope"}]),
                json.dumps({"site": "engine_step"}),
                json.dumps([{"site": "engine_step", "n_steps": 0}])):
        with pytest.raises(ValueError):
            T.parse_schedule(bad)


# --------------------------------------------------------------- ladder unit
def test_ladder_hysteresis():
    lad = T.DegradationLadder(enter=0.9, exit=0.5, up_steps=3, down_steps=4)
    lad.observe(1.0), lad.observe(1.0), lad.observe(0.2)
    assert lad.stage == 0
    lad.observe(1.0), lad.observe(1.0), lad.observe(0.7)
    assert lad.stage == 0
    for _ in range(3):
        lad.observe(0.95)
    assert lad.stage == 1 and lad.spec_disabled and not lad.flush_prefix
    for _ in range(3):
        lad.observe(1.0)
    assert lad.stage == 2 and lad.flush_prefix
    for _ in range(9):
        lad.observe(1.0)
    assert lad.stage == 3 and lad.shed_batch and lad.max_stage == 3
    for _ in range(3):
        lad.observe(0.1)
    lad.observe(0.7)
    assert lad.stage == 3
    for _ in range(4):
        lad.observe(0.1)
    assert lad.stage == 2
    assert [(o, n) for _, o, n in lad.transitions] == \
        [(0, 1), (1, 2), (2, 3), (3, 2)]
    with pytest.raises(ValueError):
        T.DegradationLadder(enter=0.5, exit=0.6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_trajectory_equals_reference(seed):
    """A random pressure sequence (high and low regimes, through the dead
    band) with pins and releases: the same stage
    after every observation and the same transitions, stage names and
    predicates as the reference's ladder."""
    rng = np.random.default_rng(seed)
    lads = [pkg.DegradationLadder(enter=0.8, exit=0.4, up_steps=2,
                                  down_steps=3) for pkg in (J, T)]
    moves = [[], []]
    for lad, mv in zip(lads, moves):
        lad.on_transition = lambda o, n, mv=mv: mv.append((o, n))
    high = False
    for step in range(300):
        if rng.random() < 0.15:              # switch regime
            high = not high
        x = float(rng.uniform(0.75, 1.0) if high else rng.uniform(0.0, 0.5))
        pin = rng.random() < 0.02
        stage = int(rng.integers(0, 4)) if rng.random() < 0.5 else None
        for lad in lads:
            if pin:
                lad.force(stage)
            lad.observe(x, step)
        a, b = lads
        assert (a.stage, a.max_stage, a.stage_name, a.spec_disabled,
                a.flush_prefix, a.shed_batch) == \
            (b.stage, b.max_stage, b.stage_name, b.spec_disabled,
             b.flush_prefix, b.shed_batch)
    assert lads[0].transitions == lads[1].transitions
    assert moves[0] == moves[1] and len(moves[1]) > 5
    assert T.STAGE_NAMES == J.STAGE_NAMES


def test_ladder_force_pins():
    lad = T.DegradationLadder()
    lad.force(1)
    assert lad.stage == 1 and lad.spec_disabled
    for _ in range(50):
        lad.observe(1.0)
    assert lad.stage == 1
    lad.force(None)
    for _ in range(3):
        lad.observe(1.0)
    assert lad.stage == 2


def test_backoff_pressure_and_ewma_equal_reference():
    """Backoff steps for every (seed, request, attempt), and the fault EWMA,
    pressure and step-time verdicts over a step sequence."""
    for seed in (0, 3, 11):
        a, b = J.Resilience(seed=seed), T.Resilience(seed=seed)
        for rid in range(6):
            for k in (1, 2, 3, 4):
                assert a.backoff_steps(rid, k) == b.backoff_steps(rid, k)
                lo = b.retry_backoff_steps * 2 ** (k - 1)
                assert lo <= b.backoff_steps(rid, k) <= lo + \
                    b.retry_backoff_steps
    rng = np.random.default_rng(4)
    a, b = J.Resilience(), T.Resilience()
    for step in range(60):
        dt = float(rng.exponential(0.01)) * (10 if step % 17 == 16 else 1)
        for res in (a, b):
            res.begin_step(step)
            if step % 5 == 0:
                res.note_fault()
        assert a.end_step(dt) == b.end_step(dt)
        util = float(rng.random())
        assert a.pressure(util) == b.pressure(util)
        assert a.fault_ewma == b.fault_ewma
    assert a.summary() == b.summary() and b.n_slow_flags > 0


# --------------------------------------------------------- chaos determinism
STORM = [("decode_logits", dict(step=3, slot=0)),
         ("engine_step", dict(step=5)),
         ("pool_exhaust", dict(step=7, n_steps=3)),
         ("slow_step", dict(step=4, duration_s=0.002))]


def _res(schedule, seed=0, ladder=True, **kw):
    def make(pkg):
        inj = pkg.FaultInjector([pkg.FaultSpec(site, **a)
                                 for site, a in schedule], seed=seed)
        return pkg.Resilience(injector=inj, ladder=(
            pkg.DegradationLadder() if ladder else None), **kw)
    return make


def test_chaos_storm_equals_jax_engine():
    """NaN logits, an engine-step exception, pool exhaustion and a slow
    step over 4 requests on 3 slots: the JAX engine's streams and counts,
    every stream the fault-free one, the page pool balanced."""
    kw = dict(n_slots=3, max_len=64, page_size=8)
    eng, reqs, _ = _run_both(kw, lambda pkg: _requests(pkg, 4, 11), _res(STORM))
    assert {r.id: list(r.generated) for r in reqs} == \
        _fault_free(4, 11, tuple(sorted(kw.items())))
    inj = eng.resilience.injector
    assert inj.counts["decode_logits"] >= 1 and inj.counts["engine_step"] == 1
    assert inj.counts["pool_exhaust"] == 3
    assert eng.n_quarantines >= 1
    assert eng.metrics.n_quarantines == eng.n_quarantines
    assert eng.metrics.n_step_faults == inj.counts["engine_step"]
    s = eng.metrics.summary()
    assert s["n_done"] == 4 and s["faults_injected_total"] == \
        inj.total_injected
    pool_conserved(eng.cache)


def test_chaos_with_spec_reference_schedule_fires_nothing():
    """The reference's chaos-with-spec schedule: the perfect draft drains
    the three requests in three steps, before steps 4 and 6, in both
    packages; nothing is injected and the streams are the fault-free
    spec ones."""
    sched = [("draft_logits", dict(step=4, slot=0)),
             ("decode_logits", dict(step=6, slot=1, value=float("inf")))]
    eng, reqs, _ = _run_both(PAGED, lambda pkg: _requests(pkg, 3, 12),
                          _res(sched, seed=1, ladder=False), spec=True)
    assert eng.step_count == 3
    assert eng.resilience.injector.total_injected == 0
    assert {r.id: list(r.generated) for r in reqs} == \
        _fault_free(3, 12, spec=True)


def test_chaos_with_spec_on_a_firing_schedule():
    """The draft poisoned at step 1 on slot 0 and the target's window at
    step 2 on slot 1, both while both slots decode (the run's own step
    log): the greedy draft's poisoned proposal is only rejected (its
    distribution is a finite one-hot), the target's non-finite window is
    quarantined and retried; the JAX engine's streams and counts, every
    stream the fault-free spec one, both pools balanced."""
    sched = [("draft_logits", dict(step=1, slot=0)),
             ("decode_logits", dict(step=2, slot=1, value=float("inf")))]
    eng, reqs, _ = _run_both(PAGED, lambda pkg: _requests(pkg, 3, 12),
                          _res(sched, seed=1, ladder=False), spec=True)
    inj = eng.resilience.injector
    assert inj.counts["draft_logits"] == 1 and inj.counts["decode_logits"] == 1
    assert eng.n_quarantines == 1 and reqs[1].n_fault_retries == 1
    assert {r.id: list(r.generated) for r in reqs} == \
        _fault_free(3, 12, spec=True)
    pool_conserved(eng.cache)
    pool_conserved(eng.draft_cache)


def test_poisoned_sampled_draft_is_quarantined():
    """A sampled row's poisoned draft gives a non-finite proposal
    distribution, which the watchdog quarantines (it must not leak through
    the residual draw), as in the JAX engine; the port's streams, drawn
    from each request's own generator, are its fault-free ones."""
    def reqs(pkg):
        out = _requests(pkg, 2, 18)
        for i, r in enumerate(out):
            r.max_new_tokens = 12
            r.sampling = pkg.SamplingParams(temperature=0.8, top_k=8,
                                            seed=100 + i)
        return out
    sched = [("draft_logits", dict(step=1, slot=0))]
    engines = _engines(PAGED, _res(sched, ladder=False), spec=True)
    for pkg, eng in zip((J, T), engines):
        rs = reqs(pkg)
        eng.run(rs, max_steps=400)
        assert eng.n_quarantines == 1 and rs[0].n_fault_retries == 1
        assert eng.resilience.injector.counts["draft_logits"] == 1
    _, _, tm, tp = _models()
    base = T.Engine(tm, tp, **PAGED, spec_draft=(tm, tp), spec_k=3).run(
        reqs(T))
    assert {r.id: list(r.generated) for r in rs} == base


def test_retries_exhausted_finish_reason_fault():
    """A slot poisoned at every step exhausts its retries and fails; the
    engine drains, pages balance, the failure is an abort."""
    kw = dict(n_slots=1, max_len=64, page_size=8)
    res = _res([("decode_logits", dict(step=0, n_steps=10_000, slot=0))],
               ladder=False, max_fault_retries=2, retry_backoff_steps=1)
    eng, reqs, _ = _run_both(kw, lambda pkg: _requests(pkg, 1, 5), res)
    req = reqs[0]
    assert not eng.has_work()
    assert req.finish_reason == "fault" and req.n_fault_retries == 2
    assert eng.n_fault_failures == 1
    rm = eng.metrics.requests[req.id]
    assert rm.aborted and rm.finish_reason == "fault"
    s = eng.metrics.summary()
    assert s["n_fault_failures"] == 1 and s["n_done"] == 0
    pool_conserved(eng.cache)


def test_persistent_step_fault_reraises_after_its_bound():
    """An engine-step fault at every step from step 1: the engine retries
    ``max_consecutive_step_faults`` times, then the fault surfaces from
    ``step()`` at the same step as in the JAX engine, every retry counted;
    nothing was emitted meanwhile."""
    kw = dict(n_slots=1, max_len=64, page_size=8)
    res = _res([("engine_step", dict(step=1, n_steps=10_000))], ladder=False,
               max_consecutive_step_faults=2)
    seen = []
    for pkg, eng in zip((J, T), _engines(kw, res)):
        req = _requests(pkg, 1, 19)[0]
        req.max_new_tokens = 8
        eng.submit(req)
        with pytest.raises(pkg.InjectedFault):
            for _ in range(20):
                eng.step()
        seen.append((eng.step_count, eng.metrics.n_step_faults,
                     list(req.generated)))
    assert seen[0] == seen[1] and seen[1][1] == 3


@pytest.mark.parametrize("mode", ["paged", "dense", "spec"])
def test_fault_after_the_replay_retries_exactly(mode, monkeypatch):
    """A fault raised once after the step's replay ran (in sampling, or in
    the speculative acceptance after the verify) is caught and the step
    retried: every replay starts from the host's depths (the retry sets
    ``pos`` back from the host and writes the same K/V again), every stream
    equals the fault-free run's, and one step fault is counted."""
    import repro_torch.serve.engine as engine_mod

    _, _, tm, tp = _models()
    kw = (dict(n_slots=2, max_len=64, paged=False) if mode == "dense"
          else dict(PAGED))
    spec = mode == "spec"
    eng = T.Engine(tm, tp, **kw, **(dict(spec_draft=(tm, tp), spec_k=3)
                                    if spec else {}))
    replay = {"paged": "decode", "dense": "decode_dense",
              "spec": "verify"}[mode]
    name = "spec_accept" if spec else "sample"
    run, real = eng._run, getattr(engine_mod.sampling_lib, name)
    state = {"replays": 0, "armed": False, "raised": 0}

    def counted_run(kind, width):
        if kind == replay:
            # the verify sets ``pos`` from ``_pos0`` itself
            pos = (eng._pos0[None] if spec
                   else eng.cache.caches[0]["pos"])
            for slot, req in eng.scheduler.running.items():
                if eng._live[slot]:
                    assert (pos[:, slot] == eng._kv_len(req)).all()
        out = run(kind, width)
        if kind == replay:
            state["replays"] += 1
            state["armed"] = state["replays"] == 3
        return out

    def faulty(*a, **k):
        if state["armed"]:
            state["armed"] = False
            state["raised"] += 1
            raise RuntimeError("fault after the replay")
        return real(*a, **k)
    eng._run = counted_run
    monkeypatch.setattr(engine_mod.sampling_lib, name, faulty)
    got = eng.run(_requests(T, 4, 21), max_steps=400)
    assert state["raised"] == 1 and eng.metrics.n_step_faults == 1
    assert eng.n_quarantines == 0
    assert got == _fault_free(4, 21, tuple(sorted(kw.items())), spec=spec)


def test_quarantine_on_the_slot_dense_engine():
    kw = dict(n_slots=2, max_len=64, paged=False)
    eng, reqs, _ = _run_both(kw, lambda pkg: _requests(pkg, 3, 13),
                          _res([("decode_logits", dict(step=2, slot=0))],
                               ladder=False))
    assert eng.n_quarantines >= 1
    assert {r.id: list(r.generated) for r in reqs} == \
        _fault_free(3, 13, tuple(sorted(kw.items())))


def test_quarantined_head_does_not_wedge_preemption():
    """An interactive head in retry backoff is skipped by admission and by
    preemption alike, or one step would evict and re-admit forever."""
    def reqs(pkg):
        return [pkg.Request(id=0, prompt=np.array([3, 1, 4, 1, 5, 9, 2, 6]),
                            max_new_tokens=8, priority="interactive"),
                pkg.Request(id=1, prompt=np.array([2, 7, 1, 8, 2, 8, 1, 8,
                                                   2, 8]),
                            max_new_tokens=8, priority="batch")]

    def storm(pkg):
        return pkg.Resilience(injector=pkg.FaultInjector(
            pkg.storm_schedule()))

    def drive(eng, rs):
        # a wedged admission loop preempts without end inside one step:
        # fail instead of hanging
        preempt, calls = eng._preempt, []

        def bounded(victim):
            calls.append(eng.step_count)
            assert calls.count(eng.step_count) < 16, "admission wedged"
            return preempt(victim)
        eng._preempt = bounded
        eng.run(rs, max_steps=200)
    kw = dict(n_slots=4, max_len=48, page_size=8, preemption=True)
    eng, rs, _ = _run_both(kw, reqs, storm, drive=drive)
    assert eng.n_quarantines >= 1
    alone = T.Engine(*_models()[2:], n_slots=1, max_len=48, page_size=8)
    assert {r.id: list(r.generated) for r in rs} == alone.run(reqs(T))
    pool_conserved(eng.cache)


def test_deadline_abort_frees_within_step():
    """An ``enforce_deadline`` request past its e2e SLO aborts on the next
    step (finish_reason="deadline"); a co-running request whose SLO is
    only tracked is untouched."""
    def drive(eng, reqs):
        now = [0.0]
        eng.metrics.clock = lambda: now[0]
        for r in reqs:
            r.max_new_tokens = 16
            r.e2e_slo_s = 0.5
        reqs[0].enforce_deadline = True
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        assert reqs[0].finish_reason is None
        now[0] = 1.0
        held = int((eng.cache.block_tables[reqs[0].slot] != NULL_PAGE).sum())
        assert held > 0
        eng.step()
        assert reqs[0].finish_reason == "deadline"
        assert reqs[0].slot is None
        while eng.has_work():
            eng.step()
    eng, reqs, _ = _run_both(PAGED, lambda pkg: _requests(pkg, 2, 14),
                          drive=drive)
    assert eng.n_deadline_aborts == 1 and reqs[1].finish_reason is None
    s = eng.metrics.summary()
    assert s["n_deadline_aborts"] == 1 and s["n_done"] == 1
    pool_conserved(eng.cache)


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_ladder_spec_suspend_resume_exact(captured, request):
    """The ladder forced to no_spec mid-run swaps in the plain paged decode
    for four steps of both live rows (``pos`` resynced to the accepted
    depth), releasing it resumes speculation before either request ends:
    the JAX engine's streams and counts, the fault-free streams. Captured
    (stand-in graph: a replay re-runs the program), ``warmup()`` already
    holds the plain decode, so nothing is captured while serving, and the
    streams and program runs are the eager engine's."""
    if captured:
        request.getfixturevalue("stub_capture")
    n_cap, plain = [], []

    def drive(eng, reqs):
        lad = eng.resilience.ladder
        port = isinstance(eng, T.Engine)
        if port:
            if captured and not n_cap:      # the first of the two engines
                eng.use_graphs = True
                eng.warmup()
                n_cap.append(eng.n_captures)
            step = eng._step_decode

            def counted():
                plain.append(int(eng._live.sum()))
                return step()
            eng._step_decode = counted
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        lad.force(1)
        assert eng.spec_suspended
        for _ in range(4):
            eng.step()
        lad.force(0), lad.force(None)
        assert not eng.spec_suspended
        assert all(r.state.value != "done" for r in reqs)
        while eng.has_work():
            eng.step()
        if len(n_cap) == 1:
            n_cap.append(eng.n_captures)

    def reqs(pkg):
        out = _requests(pkg, 2, 15)
        for r in out:
            r.max_new_tokens = 24
        return out
    def ladder(pkg):
        return pkg.Resilience(ladder=pkg.DegradationLadder())
    _, _, tm, tp = _models()
    if captured:
        engines = [T.Engine(tm, tp, **PAGED, spec_draft=(tm, tp), spec_k=3,
                            graphs=False, resilience=ladder(T))
                   for _ in range(2)]
        out = []
        for eng in engines:
            rs = reqs(T)
            drive(eng, rs)
            out.append({r.id: list(r.generated) for r in rs})
        assert out[0] == out[1] and n_cap[0] == n_cap[1] > 0
        assert engines[0].runs == engines[1].runs
        plain = plain[:4]
    else:
        eng, rs, _ = _run_both(PAGED, reqs, ladder, spec=True, drive=drive)
    base = T.Engine(tm, tp, **PAGED).run(reqs(T))
    assert {r.id: list(r.generated) for r in rs} == base
    assert eng.metrics.degradation_transitions == 2
    assert plain == [2, 2, 2, 2]          # every held-off step decoded both
    assert eng.metrics.summary()["draft_acceptance_rate"] > 0


def test_ladder_flush_prefix_stage_flushes_and_suspends_publish():
    def drive(eng, reqs):
        lad = eng.resilience.ladder
        eng.run(reqs)
        assert len(eng.cache.trie.nodes) > 0
        lad.force(2)
        assert len(eng.cache.trie.nodes) == 0
        assert not eng.cache.publish_enabled
        assert eng.metrics.degradation_stage == 2
        lad.force(0)
        assert eng.cache.publish_enabled
    eng, _, _ = _run_both(PAGED, lambda pkg: _requests(pkg, 2, 16),
                       lambda pkg: pkg.Resilience(
                           ladder=pkg.DegradationLadder()), drive=drive)
    assert eng.metrics.degradation_transitions == 2
    pool_conserved(eng.cache)
    assert eng.cache.pool.allocated_count == 0


# ----------------------------------------------------------- artifact checks
def test_artifact_corruption_raises_and_flips_the_reference_byte(tmp_path):
    """``corrupt_artifact`` flips the byte the reference's injector flips
    (same seed), and the port's ``load_packed`` refuses the artifact with
    ``ArtifactCorruptError``; the serve launcher stops with one line."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.launch import serve as launch

    cfg = tcommon.get_config("olmo-1b", smoke=True, mpd_mode="masked_dense")
    m = tbuild(cfg)
    d = str(tmp_path / "ck")
    ckpt_lib.export_packed(d, 0, m, m.init(0, device="cpu"), quantize="int8")
    model2, _ = ckpt_lib.load_packed(d, device="cpu")
    assert model2.cfg.mpd_mode == "packed"
    step_dir = next((tmp_path / "ck" / "packed").glob("step_*"))
    shard = sorted(step_dir.glob("*.npz"))[0]
    clean = shard.read_bytes()
    flipped = []
    for pkg in (J, T):
        shard.write_bytes(clean)
        inj = pkg.FaultInjector([pkg.FaultSpec("artifact_load", step=0)],
                                seed=4)
        assert inj.corrupt_artifact(str(step_dir)) == str(shard)
        assert inj.counts["artifact_load"] == 1
        flipped.append(shard.read_bytes())
    assert flipped[0] == flipped[1] != clean
    with pytest.raises(ckpt_lib.ArtifactCorruptError):
        ckpt_lib.load_packed(d, device="cpu")
    with pytest.raises(SystemExit, match="startup failed: "
                       "ArtifactCorruptError"):
        launch.main(["--arch", "olmo-1b", "--smoke", "--paged", "--ckpt-dir",
                     d, "--device", "cpu", "--requests", "1"])


# ----------------------------------------------------------------- telemetry
def test_prometheus_chaos_series():
    """The chaos, quarantine and ladder series, and every line of the
    exposition that no clock feeds, as the JAX engine's."""
    def drive(eng, reqs):
        for r in reqs:
            r.max_new_tokens = 12
        eng.run(reqs)
        eng.resilience.ladder.force(1)
    eng, _, jeng = _run_both(PAGED, lambda pkg: _requests(pkg, 2, 17),
                             _res([("decode_logits", dict(step=3, slot=0))]),
                             drive=drive)
    text = eng.metrics.prometheus(extra_gauges=eng.stats_gauges())
    assert 'repro_serve_faults_injected_total{site="decode_logits"} 1' in text
    assert f"repro_serve_quarantines_total {eng.n_quarantines}" in text
    assert eng.n_quarantines >= 1
    assert "repro_serve_degradation_stage 1" in text
    assert "repro_serve_degradation_transitions_total 1" in text
    assert "repro_serve_kv_pages_free" in text
    jtext = jeng.metrics.prometheus(extra_gauges=jeng.stats_gauges())

    def untimed(t):
        return [ln for ln in t.splitlines()
                if not any(k in ln for k in ("_seconds", "slo_attainment"))]
    assert untimed(text) == untimed(jtext)
