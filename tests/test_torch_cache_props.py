"""Property-based allocator invariants of the port's ``PagePool``,
``PrefixTrie`` and ``PagedCache`` (the cases of ``tests/test_cache_props.py``
on the port), with the resilience actions among the operations:
``preempt_slot`` (the watchdog's quarantine and the preemption),
``free_slot`` mid-flight (a deadline abort or a cancel) and ``flush_trie``
(the degradation ladder's flush_prefix stage), plus the ``pool_exhaust``
seam withholding pages from admission.

Random interleavings of admit, publish, decode-page materialisation,
speculative rollback, trie eviction and the actions above must keep, after
every operation: ``free_count + allocated_count == n_pages - 1``; every
page's refcount equal to the block-table entries naming it plus its trie
node; the reservation the sum of the slots'. Full teardown returns every
page. Every operation also runs on the reference's ``PagedCache`` (JAX)
in lockstep, and the port's block tables, refcounts, free lists,
reservations, trie keys and admission verdicts must equal it (exact).

``deadline=None``: the reference's property tests trip Hypothesis's
250 ms deadline when their first example compiles a cache under load.
"""

import functools

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import ModelConfig as JModelConfig
from repro.models import build as jbuild
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import FaultSpec as JFaultSpec
from repro.serve import cache as jcache
from repro_torch.models import build as tbuild
from repro_torch.models.model import ModelConfig
from repro_torch.serve import FaultInjector, FaultSpec
from repro_torch.serve.cache import (NULL_PAGE, PagedCache, PagePool,
                                     PrefixTrie, publish_prefix_shared,
                                     share_trie)

PAGE = 4
ALPHABET = 6          # tiny vocab so random prompts actually share prefixes
TINY = dict(name="tiny", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
            d_ff=64, vocab=32, mpd_c=4)


@functools.lru_cache(maxsize=None)
def _models():
    return tbuild(ModelConfig(**TINY)), jbuild(JModelConfig(**TINY))


def _mk(slack=0):
    tm, jm = _models()
    kw = dict(n_slots=3, max_len=24, page_size=PAGE, slack_tokens=slack)
    return (PagedCache(tm, device="cpu", **kw),
            jcache.PagedCache(jm, **kw))


def _check_invariants(caches, live):
    """``live``: slot -> (prompt, kv_len) of every active request (the same
    slots in every cache)."""
    for cache in caches:
        pool = cache.pool
        assert pool.free_count + pool.allocated_count == pool.n_pages - 1
        assert len(set(pool._free)) == len(pool._free), "double-free"
        assert all(pool.ref[p] == 0 for p in pool._free)
        expect = np.zeros(pool.n_pages, np.int64)
        expect[NULL_PAGE] = 1
        for slot in live:
            row = cache.block_tables[slot]
            for pid in row[row != NULL_PAGE]:
                expect[pid] += 1
        for value in cache.trie.nodes.values():
            expect[cache._own_pid(value)] += 1
        assert (pool.ref == expect).all(), \
            (pool.ref.tolist(), expect.tolist())
        assert cache.reserved == sum(cache._slot_reserved)
        assert cache.reserved >= 0


def _same(port, ref):
    """The port's caches hold what the reference's hold."""
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.block_tables, b.block_tables)
        np.testing.assert_array_equal(a.pool.ref, b.pool.ref)
        assert a.pool._free == b.pool._free
        assert (a.reserved, a._slot_reserved) == (b.reserved, b._slot_reserved)
        assert a.available() == b.available()
        assert a.publish_enabled == b.publish_enabled
    assert port[0].trie.nodes == ref[0].trie.nodes


def _run_ops(ops, pairs, slack):
    """Interpret a random op sequence on the port's caches and the
    reference's in lockstep (two of each behind a shared trie in the
    speculative layout)."""
    port = [p for p, _ in pairs]
    ref = [r for _, r in pairs]
    shared = len(pairs) > 1
    n_slots = port[0].n_slots
    live = {}                            # slot -> [prompt, kv_len, max_new]
    for i, seed in enumerate(ops):
        rng = np.random.default_rng(seed)
        op = int(rng.integers(11))
        for caches in (port, ref):
            caches[0].injector.step = i
        if op == 0 and len(live) < n_slots:                  # admit
            slot = next(s for s in range(n_slots) if s not in live)
            prompt = rng.integers(0, ALPHABET,
                                  int(rng.integers(2, 17))).astype(np.int32)
            max_new = int(rng.integers(1, 8))
            verdicts = [all(c.can_admit(len(prompt), max_new, prompt)
                            for c in caches) for caches in (port, ref)]
            assert verdicts[0] == verdicts[1]
            if verdicts[0]:
                matched = [c.admit_request(slot, prompt, max_new)
                           for c in port + ref]
                assert len(set(matched)) == 1, matched
                live[slot] = [prompt, len(prompt), max_new]
        elif op == 1 and live:                               # publish
            slot = int(rng.choice(sorted(live)))
            prompt = live[slot][0]
            for caches in (port, ref):
                if shared:
                    publish = (publish_prefix_shared if caches is port
                               else jcache.publish_prefix_shared)
                    publish(caches, prompt, slot, len(prompt))
                else:
                    caches[0].publish_prefix(prompt, slot, len(prompt))
        elif op == 2 and live:                               # decode page
            slot = int(rng.choice(sorted(live)))
            prompt, kv, max_new = live[slot]
            if kv < len(prompt) + max_new + slack:
                for c in port + ref:
                    c.ensure_decode_page(slot, kv)
                live[slot][1] = kv + 1
        elif op == 3 and live:                               # rollback
            slot = int(rng.choice(sorted(live)))
            prompt, kv, _ = live[slot]
            keep = int(rng.integers(len(prompt), kv + 1))
            for c in port + ref:
                c.rollback(slot, keep)
            live[slot][1] = keep
        elif op == 4:                                        # trie evict
            for caches in (port, ref):
                caches[0].trie.evict_one()
        elif op in (5, 7) and live:      # finish, or a deadline abort/cancel
            slot = int(rng.choice(sorted(live)))
            for c in port + ref:
                c.free_slot(slot)
            del live[slot]
        elif op == 6 and live:           # quarantine or preemption
            slot = int(rng.choice(sorted(live)))
            n = [c.preempt_slot(slot) for c in port + ref]
            assert len(set(n)) == 1, n
            del live[slot]
        elif op == 8:                    # the ladder's trie flush
            n = [caches[0].flush_trie() for caches in (port, ref)]
            assert n[0] == n[1]
        elif op == 9:                    # the ladder suspends / resumes
            flag = bool(rng.integers(2))
            for c in port + ref:
                c.publish_enabled = flag
        _check_invariants(port, live)
        _same(port, ref)

    for slot in list(live):
        for c in port + ref:
            c.free_slot(slot)
    while port[0].trie.evict_one() is not None:
        pass
    for c in port:
        assert c.pool.free_count == c.pool.n_pages - 1
        assert c.pool.allocated_count == 0
        assert c.reserved == 0


def _pressure(caches, pkg_spec, pkg_injector, seed):
    """A ``pool_exhaust`` schedule withholding a few pages in some ops."""
    rng = np.random.default_rng(seed)
    sched = [pkg_spec("pool_exhaust", step=int(rng.integers(0, 40)),
                      n_steps=int(rng.integers(1, 6)),
                      n_pages=int(rng.integers(1, 6))) for _ in range(3)]
    inj = pkg_injector(sched)
    for c in caches:
        c.injector = inj


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, 1 << 30), min_size=10, max_size=60),
       st.integers(0, 4))
def test_paged_cache_refcount_invariants(ops, slack):
    port, ref = _mk(slack)
    _pressure([port], FaultSpec, FaultInjector, ops[0])
    _pressure([ref], JFaultSpec, JFaultInjector, ops[0])
    _run_ops(ops, [(port, ref)], slack)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 1 << 30), min_size=10, max_size=60),
       st.integers(0, 4))
def test_shared_trie_refcount_invariants(ops, slack):
    """Two pools behind one trie (the speculative layout): joint nodes
    retain and release in both pools at once; a flush drains both."""
    (t, jt), (d, jd) = _mk(slack), _mk(slack)
    trie = share_trie([t, d])
    jcache.share_trie([jt, jd])
    assert trie is t.trie and trie is d.trie
    _pressure([t, d], FaultSpec, FaultInjector, ops[0])
    _pressure([jt, jd], JFaultSpec, JFaultInjector, ops[0])
    _run_ops(ops, [(t, jt), (d, jd)], slack)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 1 << 30), min_size=5, max_size=40))
def test_page_pool_alloc_release(ops):
    pool = PagePool(9)
    held = []
    for seed in ops:
        rng = np.random.default_rng(seed)
        op = int(rng.integers(3))
        if op == 0 and pool.free_count:
            held.append(pool.alloc())
        elif op == 1 and held:
            pid = held[int(rng.integers(len(held)))]
            pool.retain(pid)
            held.append(pid)
        elif op == 2 and held:
            pool.release(held.pop(int(rng.integers(len(held)))))
        assert pool.free_count + pool.allocated_count == pool.n_pages - 1
        for pid in set(held):
            assert pool.ref[pid] == held.count(pid)
    for pid in held:
        pool.release(pid)
    assert pool.free_count == pool.n_pages - 1


def test_preempt_keeps_trie_pages_and_flush_returns_them():
    """``preempt_slot`` drops only the slot's refs (its published pages
    stay with the trie, a re-admission matches them); with publishing
    suspended nothing new is published; ``flush_trie`` then returns every
    trie-only page."""
    port, _ = _mk()
    port.injector = None
    prompt = np.arange(1, 14, dtype=np.int32) % ALPHABET
    assert port.admit_request(0, prompt, 4) == 0
    port.publish_prefix(prompt, 0, len(prompt))
    assert len(port.trie) == 3
    assert port.preempt_slot(0) == 4
    assert port.pool.allocated_count == 3 and port.reserved == 0
    assert port.admit_request(1, prompt, 4) == 12
    port.free_slot(1)
    port.publish_enabled = False
    other = (np.arange(13, dtype=np.int32) + 3) % ALPHABET
    port.admit_request(2, other, 2)
    port.publish_prefix(other, 2, len(other))
    assert len(port.trie) == 3
    port.free_slot(2)
    assert port.flush_trie() == 3
    assert port.pool.allocated_count == 0 and len(port.trie) == 0


def test_shared_trie_unit():
    a, b = PagePool(4), PagePool(4)
    trie = PrefixTrie([a, b], 2)
    prompt = np.array([1, 2, 3, 4], np.int32)
    pa, pb = a.alloc(), b.alloc()
    assert trie.insert(prompt, 0, (pa, pb))
    assert a.ref[pa] == 2 and b.ref[pb] == 2
    a.release(pa), b.release(pb)
    assert trie.is_reclaimable((pa, pb))
    b.retain(pb)
    assert not trie.is_reclaimable((pa, pb))
    assert trie.evict_one() is None
    b.release(pb)
    assert trie.evict_one() == (pa, pb)
    assert a.free_count == a.n_pages - 1 and b.free_count == b.n_pages - 1
