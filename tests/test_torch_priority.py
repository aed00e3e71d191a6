"""Port parity, priorities: priority-class admission, preemption by page
eviction and cancellation on the port's engine (the cases of
``tests/test_serve_priority.py``), each held to the JAX engine driven the
same way on the same params (carried over with ``params_from_numpy``) and
the same arrivals, at float32.

Tolerance: greedy streams, admission orders, preemption counts and the
metrics summary's counters must be identical (exact); the summary's
timings are the hosts' own clocks and are not compared, nor are the
prefill's KV bytes read (the JAX engine's CPU route is its dense gather).
Pool refcounts must
equal the refs implied by the block tables and the trie after every step.
The captured case runs the engine's capture logic with the stand-in graph
of ``tests/test_torch_graphs.py`` (a replay re-runs the program).
"""

import functools

import jax
import numpy as np
import pytest

from repro.configs import common as jcommon
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, Request, Scheduler
from repro_torch.serve.cache import NULL_PAGE

from test_torch_graphs import stub_capture  # noqa: F401 - a fixture

# summary keys that read a host clock, and the KV bytes the prefill
# attention read (the JAX engine's CPU route is the dense gather, which reads
# every laddered column; the port's plain route counts what its kernel reads)
TIMED = ("_s", "tok_s", "slo_attainment", "prefill_kv_bytes_read")


@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _counters(summary):
    return {k: v for k, v in summary.items()
            if not any(k.endswith(t) for t in TIMED)}


def check_refcounts(cache):
    """Pool refcounts equal the refs of the block tables and the trie;
    exactly the zero-ref pages are free."""
    expected = np.zeros(cache.pool.n_pages, np.int32)
    expected[NULL_PAGE] = 1
    for row in cache.block_tables:
        for pid in row[row != NULL_PAGE]:
            expected[pid] += 1
    for val in cache.trie.nodes.values():
        expected[cache._own_pid(val)] += 1
    np.testing.assert_array_equal(expected, cache.pool.ref)
    assert cache.pool.free_count == int((cache.pool.ref == 0).sum())


def _track_admissions(eng):
    order = []
    orig = eng.metrics.on_admit

    def on_admit(req_id):
        order.append(req_id)
        return orig(req_id)
    eng.metrics.on_admit = on_admit
    return order


def _both(kw, specs, drive):
    """Build the JAX engine and the port's with ``kw``, make the requests
    ``specs`` (``(id, prompt, max_new_tokens, priority)``) for each and run
    ``drive(engine, requests, is_port)`` on both. Returns per engine the
    requests, the admission order and the engine."""
    jm, jp, tm, tp = _models()
    out = []
    for eng, cls, port in ((JEngine(jm, jp, paged=True, **kw), JRequest,
                            False),
                           (Engine(tm, tp, **kw), Request, True)):
        reqs = [cls(id=i, prompt=p, max_new_tokens=g, priority=pr)
                for i, p, g, pr in specs]
        order = _track_admissions(eng)
        drive(eng, reqs, port)
        out.append((reqs, order, eng))
    (jreqs, jorder, jeng), (treqs, torder, teng) = out
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert torder == jorder
    assert teng.n_preemptions == jeng.n_preemptions
    assert _counters(teng.metrics.summary()) == \
        _counters(jeng.metrics.summary())
    return out[1]


def _drain(eng, reqs=(), check=None):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
        if check is not None:
            check(eng.cache)


def _prompts(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, size=size) for _ in range(n)]


# ------------------------------------------------------------ scheduler unit
def test_scheduler_fcfs_within_class_and_priority_order():
    s = Scheduler(n_slots=2, max_len=64, strict_buckets=False)
    for i, pr in enumerate(("batch", "batch", "interactive", "batch")):
        s.submit(Request(id=i, prompt=np.arange(1, 5), priority=pr))
    assert [r.id for r in s.waiting] == [2, 0, 1, 3]


def test_scheduler_preempt_requeues_at_original_position():
    s = Scheduler(n_slots=2, max_len=64, strict_buckets=False)
    reqs = [Request(id=i, prompt=np.arange(1, 5), priority="batch")
            for i in range(4)]
    for r in reqs:
        s.submit(r)
    s.admit()
    assert sorted(s.running) == [0, 1]
    s.preempt(reqs[1])
    assert [r.id for r in s.waiting] == [1, 2, 3]
    assert reqs[1].slot is None and reqs[1].n_preemptions == 1
    assert reqs[1].generated == [] and reqs[1].prefill_pos == 0
    with pytest.raises(ValueError, match="priority"):
        Request(id=0, prompt=np.arange(1, 5), priority="bulk")


# -------------------------------------------------------------- engine level
def test_equal_priority_fcfs_stable():
    """One class: admission follows submit order, nothing is preempted."""
    specs = [(i, p, 5, "interactive")
             for i, p in enumerate(_prompts(0, 5, 10))]
    reqs, order, eng = _both(dict(n_slots=2, max_len=64, page_size=8), specs,
                             lambda e, rs, port: _drain(e, rs))
    assert sorted(order[:2]) == [0, 1] and order == sorted(order)
    assert eng.n_preemptions == 0


def test_interactive_admits_before_queued_batch():
    """Without preemption an interactive arrival still admits ahead of
    older batch work as soon as the slot frees."""
    p = _prompts(1, 4, 8)
    specs = [(i, p[i], 4, "batch") for i in range(3)] + \
        [(9, p[3], 4, "interactive")]

    def drive(eng, reqs, port):
        for r in reqs[:3]:
            eng.submit(r)
        eng.step()
        _drain(eng, reqs[3:])
    reqs, order, eng = _both(dict(n_slots=1, max_len=64, page_size=8,
                                  preemption=False), specs, drive)
    assert order == [0, 9, 1, 2] and eng.n_preemptions == 0


def test_interactive_preempts_batch_and_resumes_identical():
    """Under page pressure an interactive arrival evicts the youngest batch
    slot; the victim resumes and every stream equals the JAX engine's and
    the request's uncontended stream. Refcounts hold after every step."""
    p = _prompts(2, 3, 16)
    specs = [(0, p[0], 8, "batch"), (1, p[1], 8, "batch"),
             (7, p[2][:8], 8, "interactive")]

    def drive(eng, reqs, port):
        check = check_refcounts if port else None
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(4):
            eng.step()
            if check:
                check(eng.cache)
        assert all(r.state.value == "decode" for r in reqs[:2])
        eng.submit(reqs[2])
        eng.step()
        assert eng.n_preemptions == 1 and reqs[1].slot is None
        assert reqs[1].state.value == "waiting"
        assert reqs[0].slot is not None and reqs[2].slot is not None
        _drain(eng, (), check)
    reqs, order, eng = _both(dict(n_slots=2, max_len=32, page_size=8,
                                  n_pages=8), specs, drive)
    assert reqs[1].n_preemptions == 1 and reqs[0].n_preemptions == 0
    s = eng.metrics.summary()
    assert s["n_preempted"] == 1
    assert s["interactive_n_done"] == 1 and s["batch_n_done"] == 2
    _, _, tm, tp = _models()
    alone = Engine(tm, tp, n_slots=1, max_len=32, page_size=8).run(
        [Request(id=i, prompt=q, max_new_tokens=8) for i, q, _, _ in specs])
    assert {r.id: list(r.generated) for r in reqs} == alone


def test_preemption_spares_trie_shared_pages():
    """The victim's trie-published prompt pages survive its eviction, and
    its re-prefill reuses them."""
    p = _prompts(3, 3, 17)
    specs = [(0, p[0], 7, "batch"), (1, p[1], 7, "batch"),
             (7, p[2], 7, "interactive")]
    held = {}

    def drive(eng, reqs, port):
        for r in reqs[:2]:
            eng.submit(r)
        while reqs[1].state.value != "decode":
            eng.step()
        trie = eng.cache.trie
        pages = {pid for key, val in trie.nodes.items()
                 for pid in trie._as_tuple(val)
                 if tuple(reqs[1].prompt[:len(key)]) == key}
        skipped0 = eng.n_prefill_tokens_skipped
        eng.submit(reqs[2])
        eng.step()
        assert reqs[1].n_preemptions == 1
        for pid in pages:
            assert eng.cache.pool.ref[pid] >= 1
            assert pid not in eng.cache.pool._free
        if port:
            check_refcounts(eng.cache)
            held.update(pages=pages, skipped0=skipped0)
        _drain(eng)
    reqs, _, eng = _both(dict(n_slots=2, max_len=32, page_size=8,
                              n_pages=9), specs, drive)
    assert len(held["pages"]) == 2
    assert reqs[1].n_matched == 16
    assert eng.n_prefill_tokens_skipped >= held["skipped0"] + 16


def test_cancel_running_and_waiting():
    """A decoding slot frees its pages at once, a waiting request leaves
    the queue; the survivor is unperturbed."""
    specs = [(i, p, 12, "interactive")
             for i, p in enumerate(_prompts(4, 3, 10))]

    def drive(eng, reqs, port):
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng.step()
        assert reqs[0].state.value == "decode"
        assert reqs[2].state.value == "waiting"
        eng.cancel(reqs[0])
        eng.cancel(reqs[2])
        if port:
            check_refcounts(eng.cache)
        assert reqs[0].state.value == reqs[2].state.value == "done"
        assert reqs[2] not in eng.scheduler.waiting
        _drain(eng)
    reqs, _, eng = _both(dict(n_slots=2, max_len=64, page_size=8), specs,
                         drive)
    check_refcounts(eng.cache)
    s = eng.metrics.summary()
    assert s["n_cancelled"] == 2 and s["n_done"] == 1


def test_mid_prefill_victim_restarts_at_another_chunk_boundary():
    """A batch request evicted half-way through its prefill chunks leaves
    the prefill queue. The interactive request that evicted it shares its
    first 25 tokens and publishes a third page of them, so the victim's
    re-prefill starts at token 24, not on its first chunking's boundaries
    (0, 16, 32); its stream is still the JAX engine's and its uncontended
    one."""
    a, b = _prompts(5, 2, 40)
    specs = [(0, a, 6, "batch"), (1, b, 6, "batch"),
             (5, b[:25].copy(), 6, "interactive")]
    kw = dict(n_slots=2, max_len=48, page_size=8, n_pages=13,
              prefill_chunk_tokens=16)

    def drive(eng, reqs, port):
        for r in reqs[:2]:
            eng.submit(r)
        while not (reqs[1].state.value == "prefill"
                   and 0 < reqs[1].prefill_pos < len(reqs[1].prompt)):
            eng.step()
        assert reqs[1].prefill_pos == 16
        eng.submit(reqs[2])
        eng.step()
        assert reqs[1].n_preemptions == 1
        assert reqs[1] not in eng._prefill_queue
        _drain(eng, (), check_refcounts if port else None)
    reqs, _, eng = _both(kw, specs, drive)
    assert reqs[1].n_matched == 24
    _, _, tm, tp = _models()
    alone = Engine(tm, tp, n_slots=1, max_len=48, page_size=8,
                   prefill_chunk_tokens=16).run(
        [Request(id=i, prompt=q, max_new_tokens=6) for i, q, _, _ in specs])
    assert {r.id: list(r.generated) for r in reqs} == alone


def test_captured_preemption_and_cancel_equal_eager(stub_capture):
    """The capture path (stand-in graph: a replay re-runs the program):
    after ``warmup()`` a preempting, cancelling run captures nothing more
    and streams the eager engine's tokens with the same program runs."""
    _, _, tm, tp = _models()
    kw = dict(n_slots=2, max_len=48, page_size=8, n_pages=11,
              prefill_chunk_tokens=16)
    p = _prompts(6, 4, 40)

    def serve(eng):
        reqs = [Request(id=0, prompt=p[0], max_new_tokens=6,
                        priority="batch"),
                Request(id=1, prompt=p[1], max_new_tokens=6,
                        priority="batch"),
                Request(id=2, prompt=p[2][:9], max_new_tokens=6),
                Request(id=3, prompt=p[3][:12], max_new_tokens=6)]
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        eng.submit(reqs[2])
        eng.submit(reqs[3])
        eng.step()
        eng.cancel(reqs[3])
        _drain(eng)
        return {r.id: list(r.generated) for r in reqs}, eng.n_preemptions

    eager = Engine(tm, tp, graphs=False, **kw)
    eng = Engine(tm, tp, **kw)
    eng.use_graphs = True
    eng.warmup()
    n = eng.n_captures
    got, want = serve(eng), serve(eager)
    assert got == want and got[1] >= 1
    assert eng.n_captures == n
    assert eng.runs == eager.runs
    check_refcounts(eng.cache)
