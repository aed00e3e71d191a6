"""Port parity, the replica router: ``repro_torch.serve.Router`` and the
engine's prefill-to-decode handoff against the JAX package's, on the CPU.

The non-mesh cases of the reference's router tests run on the port with
its smoke engines (olmo-1b smoke, 2 slots, max_len 64, page 8), each held
to the JAX package: every stream equals the JAX single engine's for the
same requests (one JAX engine, run once per request set in a module
fixture: a JAX engine compiles per instance), and on one set of arrivals
the port router's owner map and fleet summary counts equal a JAX
``Router``'s. The port's own cases: a sampled stream (temperature > 0)
through a disaggregated fleet equals the same request's stream on one
port engine (the handoff carries the request's generator state), a dead
decode replica drains a disaggregated fleet with every token counted
once, an adoption leaves the decode engine's pool rows bit-equal to the
prefill engine's, and a recurrent arch refuses disaggregation.
"""

import functools

import jax
import numpy as np
import pytest

from repro.configs import common as jcommon
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.models import build as tbuild
from repro_torch.serve import (Engine, Request, Router, RouterMetrics,
                               SamplingParams, ServeMetrics,
                               prefix_affinity_key)
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

SMOKE = dict(n_slots=2, max_len=64, paged=True, page_size=8)


@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _engine(**kw):
    _, _, tm, tp = _models()
    return Engine(tm, tp, **{**SMOKE, **kw})


def _jengine(**kw):
    jm, jp, _, _ = _models()
    return JEngine(jm, jp, **{**SMOKE, **kw})


def _requests(n, seed=0, max_prompt=20, max_gen=10, prefix=None, cls=Request,
              **req_kw):
    """The reference test's requests (the same draws), as ``cls``."""
    vocab = _models()[2].cfg.vocab
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, max_prompt)))
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        out.append(cls(id=i, prompt=prompt,
                       max_new_tokens=int(rng.integers(2, max_gen)), **req_kw))
    return out


def _prefix():
    return np.arange(24) % _models()[2].cfg.vocab     # 3 pages of prefix


# the request sets the cases serve, by name: _requests keyword arguments
SETS = {
    "short": dict(n=4, max_prompt=6),
    "single": dict(n=6, seed=1),
    "disagg": dict(n=6, seed=2),
    "affinity": dict(n=4, seed=3, max_prompt=8, prefix=True),
    "drain": dict(n=6, seed=4),
}


def _set(name, cls=Request, **req_kw):
    kw = dict(SETS[name])
    n = kw.pop("n")
    if kw.pop("prefix", False):
        kw["prefix"] = _prefix()
    return _requests(n, cls=cls, **kw, **req_kw)


def _run(engine, reqs):
    done = {}
    engine.done_cb = lambda r: done.setdefault(r.id, list(r.generated))
    for r in reqs:
        engine.submit(r)
    steps = 0
    while engine.has_work():
        assert engine.step() or not engine.has_work()
        steps += 1
        assert steps < 5000, "engine wedged"
    return done


@pytest.fixture(scope="module")
def want():
    """The JAX single engine's streams for every request set."""
    eng = _jengine()
    return {name: _run(eng, _set(name, cls=JRequest)) for name in SETS}


# ------------------------------------------------------- router dispatch

def test_router_least_loaded_round_robins_fresh_replicas(want):
    r = Router([_engine(), _engine()])
    # prompts shorter than a page carry no affinity key -> pure least-loaded
    reqs = _set("short")
    for q in reqs:
        r.submit(q)
    assert [r._owner[q.id] for q in reqs] == [0, 1, 0, 1]
    assert r.metrics.affinity_hit_rate == 0.0
    _run(r, [])          # drain
    assert {q.id: q.generated for q in reqs} == want["short"]


def test_router_prefix_affinity_overrides_load(want):
    r = Router([_engine(), _engine()])
    reqs = _set("affinity")
    done = _run(r, reqs)
    owners = {r._owner[q.id] for q in reqs}
    assert len(owners) == 1, "shared-prefix requests split across replicas"
    assert r.metrics.n_affinity_hits > 0
    assert done == want["affinity"]
    # the stuck-together replica really reused the prefix
    assert r.replicas[owners.pop()].n_prefill_tokens_skipped > 0


def test_router_matches_single_engine_tokens(want):
    got = _run(Router([_engine(), _engine()]), _set("single"))
    assert got == want["single"]


def _fleet_counts(router, reqs):
    s = router.metrics.summary()
    return ({q.id: router._owner[q.id] for q in reqs},
            {k: s[k] for k in ("n_requests", "n_done", "total_tokens",
                               "n_handoffs", "affinity_hit_rate",
                               "n_replicas", "n_replicas_live")},
            [(e.n_handoffs_out, e.n_handoffs_in) for e in router.replicas])


def test_router_disagg_handoff_token_identical(want):
    """The disaggregated fleet streams the JAX single engine's tokens, and
    its owner map, handoff counters and fleet summary counts are the JAX
    ``Router``'s on the same arrivals."""
    r = Router([_engine(), _engine()], disagg=True, n_prefill=1)
    reqs = _set("disagg")
    got = _run(r, reqs)
    assert got == want["disagg"]
    assert r.metrics.n_handoffs > 0
    assert r.replicas[0].n_handoffs_out == r.replicas[1].n_handoffs_in \
        == r.metrics.n_handoffs
    # fleet accounting stays exact across the migration: every request
    # counted done exactly once, token totals match the baseline
    s = r.metrics.summary()
    assert s["n_done"] == 6
    assert s["total_tokens"] == sum(len(t) for t in want["disagg"].values())
    jr = JRouter([_jengine(), _jengine()], disagg=True, n_prefill=1)
    jreqs = _set("disagg", cls=JRequest)
    assert _run(jr, jreqs) == got
    assert _fleet_counts(r, reqs) == _fleet_counts(jr, jreqs)


def test_router_disagg_rejects_unsuitable_engines():
    with pytest.raises(ValueError):
        Router([_engine(paged=False), _engine(paged=False)], disagg=True)
    with pytest.raises(ValueError):
        Router([_engine()], disagg=True)


def test_router_dead_replica_drains_to_survivor(want):
    reqs = _set("drain")
    r = Router([_engine(), _engine()])
    done = {}
    r.done_cb = lambda q: done.setdefault(q.id, list(q.generated))
    for q in reqs:
        r.submit(q)
    victims = [q.id for q in reqs if r._owner[q.id] == 0]
    assert victims, "least-loaded should have placed work on replica 0"
    r.replicas[0].step()                     # some in-flight progress
    orig_step = type(r.replicas[0]).step

    def boom(self):
        raise RuntimeError("injected replica death")

    r.replicas[0].step = boom.__get__(r.replicas[0])
    steps = 0
    while r.has_work():
        r.step()
        steps += 1
        assert steps < 5000, "router wedged after replica death"
    r.replicas[0].step = orig_step.__get__(r.replicas[0])
    assert r.live == [False, True]
    assert r.metrics.n_replica_deaths == 1
    assert r.metrics.n_drained >= len(victims)
    assert {q: done[q] for q in sorted(done)} == want["drain"]
    # drained requests now belong to the survivor
    assert all(r._owner[v] == 1 for v in victims)
    # merged metrics don't double-count regenerated tokens
    s = r.metrics.summary()
    assert s["total_tokens"] == sum(len(t) for t in want["drain"].values())


def test_router_last_replica_death_propagates():
    r = Router([_engine()])
    r.submit(_requests(1)[0])

    def boom(self):
        raise RuntimeError("injected replica death")

    r.replicas[0].step = boom.__get__(r.replicas[0])
    with pytest.raises(RuntimeError, match="injected replica death"):
        r.step()
    assert r.live == [False]


def test_router_cancel_routes_to_owner(want):
    r = Router([_engine(), _engine()])
    reqs = _set("short")[:2]
    for q in reqs:
        r.submit(q)
    r.cancel(reqs[0])
    assert r.replicas[0].metrics.n_cancelled == 1
    assert r.replicas[1].metrics.n_cancelled == 0
    _run(r, [])
    assert reqs[1].generated == want["short"][1]


# ------------------------------------------------------- metrics merging

def test_affinity_key_page_aligned_and_capped():
    p = np.arange(40, dtype=np.int32)
    assert prefix_affinity_key(p[:7], 8, 4) is None          # < one page
    assert prefix_affinity_key(p[:16], 8, 4) == \
        prefix_affinity_key(p[:23], 8, 4)                     # page-aligned
    assert prefix_affinity_key(p, 8, 2) == \
        prefix_affinity_key(p[:16], 8, 2)                     # capped
    q = p.copy()
    q[0] += 1
    assert prefix_affinity_key(p[:16], 8, 4) != \
        prefix_affinity_key(q[:16], 8, 4)


def test_router_metrics_one_scrape_per_family():
    a, b = ServeMetrics(clock=lambda: 1.0), ServeMetrics(clock=lambda: 2.0)
    a.on_submit(1, 4)
    a.on_token(1)
    a.on_done(1)
    b.on_submit(2, 4)
    rm = RouterMetrics([a, b])
    rm.on_reject()
    text = rm.prometheus({"repro_serve_slots_total": 4.0})
    # every family renders exactly one HELP/TYPE header...
    for fam in ("repro_serve_requests_total", "repro_serve_tokens_generated"
                "_total", "repro_serve_router_agg_tok_s"):
        assert text.count(f"# TYPE {fam} ") == 1, fam
    # ...with per-replica samples distinguished by label
    assert 'replica="0"' in text and 'replica="1"' in text
    assert "repro_serve_router_replica_occupancy" in text
    s = rm.summary()
    assert s["n_requests"] == 2 and s["n_rejected"] == 1
    assert s["n_replicas"] == 2


def test_router_metrics_clock_fans_out():
    a, b = ServeMetrics(), ServeMetrics()
    rm = RouterMetrics([a, b])
    fake = lambda: 42.0                                       # noqa: E731
    rm.clock = fake
    assert a.clock is fake and b.clock is fake


# --------------------------------------------------- the port's own cases

def test_disagg_sampled_stream_equals_one_engine(want):
    """temperature > 0: the prefill replica draws the first token from the
    request's generator, and the decode replica resumes that generator
    from the handoff's state, so the stream is the one a single port
    engine draws."""
    def reqs():
        out = _set("disagg")
        for q in out:
            q.sampling = SamplingParams(temperature=0.8, top_k=20,
                                        seed=100 + q.id)
        return out
    base = _run(_engine(), reqs())
    r = Router([_engine(), _engine()], disagg=True, n_prefill=1)
    got = _run(r, reqs())
    assert r.metrics.n_handoffs > 0
    assert got == base
    assert got != want["disagg"]        # the draws are not the greedy picks


def test_dead_decode_replica_drains_a_disaggregated_fleet(want):
    """A decode replica dies with adopted requests running: they regenerate
    from their prompts on the other decode replica, every stream is the JAX
    single engine's, and the fleet's token total counts each token once
    (the prefill replica's count of a regenerated first token rewinds
    too)."""
    r = Router([_engine(), _engine(), _engine()], disagg=True, n_prefill=1)
    victim = r.replicas[1]
    live_step, drained = victim.step, []

    def dying():
        running = list(victim.scheduler.running.values())
        if any(len(q.generated) > 1 for q in running):
            drained.extend(q.id for q in running)
            raise RuntimeError("injected replica death")
        return live_step()
    victim.step = dying
    got = _run(r, _set("disagg"))
    assert r.live == [True, False, True] and drained
    assert all(r._owner[i] == 2 for i in drained)
    assert got == want["disagg"]
    s = r.metrics.summary()
    assert s["n_done"] == 6 and s["n_drained"] >= len(drained)
    assert s["total_tokens"] == sum(len(t) for t in want["disagg"].values())


def test_handoff_adoption_copies_the_pool_rows_bit_for_bit():
    """``extract_handoff`` on the prefill engine, then the decode engine's
    admission of the request (``_admit_handoff``): every prompt page of
    every attention layer reads back bit-equal in the decode pool, the
    slot's depth is the prompt's, and the pending token is the first one
    the prefill engine sampled."""
    pre, dec = _engine(), _engine()
    # a running request holds decode pages, so the adopted pages land on
    # other ids than their source
    other = _set("short")[0]
    other.max_new_tokens = 8
    dec.submit(other)
    dec.step()
    src = {}
    real = pre.extract_handoff

    def extract(req):
        n = pre.cache.pages_for(len(req.prompt))
        src["ids"] = pre.cache.block_tables[req.slot][:n].copy()
        src["pages"] = [{k: c[k][:, src["ids"]].clone() for k in ("kp", "vp")}
                        for c in pre.cache.caches]
        return real(req)
    pre.extract_handoff = extract
    handed = []
    pre.handoff_cb = handed.append
    req = _requests(1, seed=5, max_prompt=30, max_gen=4)[0]
    req.prefill_only, req.max_new_tokens = True, 1
    _run(pre, [req])
    assert handed == [req] and req.handoff is not None
    first = req.handoff.first_token
    req.prefill_only, req.max_new_tokens = False, 3
    dec.submit(req)
    (q, slot), = dec.scheduler.admit(can_admit=lambda r: True, max_n=1)
    dec._admit_one_paged(q, slot)
    n = len(src["ids"])
    dst = dec.cache.block_tables[slot][:n]
    assert not np.array_equal(dst, src["ids"])
    for c, want_pages in zip(dec.cache.caches, src["pages"]):
        for k in ("kp", "vp"):
            assert c[k][:, dst].equal(want_pages[k])
        assert (c["pos"][:, slot] == len(req.prompt)).all()
    assert int(dec._tokens[slot]) == first and req.generated == [first]
    assert (pre.n_handoffs_out, dec.n_handoffs_in) == (1, 1)


def test_recurrent_arch_refuses_disagg():
    """rwkv6-3b keeps recurrent state a page cannot carry: no prefix cache,
    so a disaggregated fleet is refused (the reference's rule)."""
    m = tbuild(tcommon.get_config("rwkv6-3b", smoke=True))
    p = m.init(0, device="cpu")
    engines = [Engine(m, p, **SMOKE) for _ in range(2)]
    assert not engines[0].cache.prefix_cache_enabled
    with pytest.raises(ValueError, match="prefix_cache_enabled"):
        Router(engines, disagg=True)
    Router(engines)                     # replicas without roles serve it
