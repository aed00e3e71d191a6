"""Port parity, serving: the port's paged engine and the JAX paged engine
(jnp route), on the same params (carried over with ``params_from_numpy``)
and the same explicit prompts, must emit identical greedy token streams —
fp and int8 — through staggered admission, slot and page reuse, pool
pressure, shared-prefix trie hits (prefill starting past page 0) and any
prefill chunk size. Allocator and trie units are checked on the port alone.

The JAX engine compiles per instance, so each engine configuration is built
once per module (``_engines``) and the cases run one after another on the
same pair of engines. Both engines see the same history of requests (the
prefix trie carries pages from one case to the next), so their streams must
still agree token for token. ``SHARED``'s pool holds 8 pages for 2 slots of
up to 8 pages each: two requests of 5 pages cannot run together.
"""

import functools

import jax
import numpy as np
import pytest

from repro.configs import common as jcommon
from repro.core import export as jexport
from repro.models import build as jbuild
from repro.launch.serve import make_requests as jmake_requests
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch.serve import make_requests
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, PagedCache, PagePool, PrefixTrie, Request
from repro_torch.serve.cache import NULL_PAGE
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse


@functools.lru_cache(maxsize=None)
def _models(quant: bool):
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    if quant:
        jp, _ = jexport.quantize_packed(jm, jp)
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompts(seed, n, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 96, size=int(rng.integers(lo, hi))),
             int(rng.integers(2, 10))) for _ in range(n)]


SHARED = dict(n_slots=2, max_len=64, page_size=8, n_pages=9,
              prefill_chunk_tokens=16)
CHUNK8 = dict(SHARED, prefill_chunk_tokens=8)
SINGLE = dict(n_slots=1, max_len=72, page_size=8, prefill_chunk_tokens=32)


@functools.lru_cache(maxsize=None)
def _engines(quant: bool, kw_items: tuple):
    """One JAX engine and one port engine per (weights, configuration)."""
    jm, jp, tm, tp = _models(quant)
    kw = dict(kw_items)
    return JEngine(jm, jp, paged=True, **kw), Engine(tm, tp, **kw)


def _run(engine, req_cls, prompts, drive=None):
    reqs = [req_cls(id=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(prompts)]
    if drive is None:
        return engine.run(reqs)
    drive(engine, reqs)
    return {r.id: list(r.generated) for r in reqs}


def _both(quant, prompts, drive=None, kw=SHARED):
    jeng, teng = _engines(quant, tuple(sorted(kw.items())))
    assert not (jeng.has_work() or teng.has_work())
    want = _run(jeng, JRequest, prompts, drive)
    got = _run(teng, Request, prompts, drive)
    assert got == want
    return jeng, teng


def _staggered(engine, reqs):
    engine.submit(reqs[0])
    for _ in range(3):
        engine.step()
    engine.submit(reqs[1])
    engine.step()
    engine.submit(reqs[2])
    while engine.has_work():
        engine.step()


QUANT = pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])


@QUANT
def test_staggered_admission(quant):
    _both(quant, _prompts(2, 3), drive=_staggered)


@QUANT
def test_slot_and_page_reuse(quant):
    """Fewer slots than requests: slots and pages are reused in turn."""
    _both(quant, _prompts(1, 6))


@QUANT
def test_single_slot_sequential_reuse(quant):
    _both(quant, _prompts(3, 3), kw=SINGLE)


@QUANT
def test_pool_pressure(quant):
    """Requests of 5 pages each in a pool of 8: the pool, not the 2 slots,
    forces serial admission of 4, and every page comes home."""
    rng = np.random.default_rng(4)
    prompts = [(rng.integers(0, 96, size=28), 6) for _ in range(4)]
    jeng, teng = _both(quant, prompts)
    assert teng.cache.pool.free_count + len(teng.cache.trie) \
        == teng.cache.n_pages - 1
    assert teng.cache.reserved == 0


@QUANT
def test_shared_prefix_trie_hits(quant):
    """A shared page-aligned prefix is prefilled once: later requests start
    prefill past page 0, skip the same tokens as the reference, and stream
    the same tokens."""
    rng = np.random.default_rng(8)
    sys_prompt = rng.integers(0, 96, size=24)
    prompts = [(np.concatenate([sys_prompt,
                                rng.integers(0, 96, size=7 + 5 * i)]), 5)
               for i in range(3)]

    def drive(engine, reqs):
        for r in reqs:                     # one at a time: the trie is warm
            engine.submit(r)
            while engine.has_work():
                engine.step()

    jeng, teng = _engines(quant, tuple(sorted(SHARED.items())))
    before = [(e.n_prefill_tokens_skipped, e.n_prefill_tokens)
              for e in (jeng, teng)]
    _both(quant, prompts, drive=drive)
    (j_skip, j_done), (t_skip, t_done) = [
        (e.n_prefill_tokens_skipped - s0, e.n_prefill_tokens - d0)
        for e, (s0, d0) in zip((jeng, teng), before)]
    assert t_skip == j_skip > 0
    assert t_done == j_done


@QUANT
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunk_size_does_not_change_streams(quant, chunk):
    """Chunk 8 and chunk 16 give the same streams as the reference (and so
    as each other), including prompts that are not a chunk multiple."""
    rng = np.random.default_rng(6)
    prompts = [(rng.integers(0, 96, size=n), 6) for n in (21, 37, 8)]
    _both(quant, prompts, kw=CHUNK8 if chunk == 8 else SHARED)


def test_final_chunk_tail_past_table_end():
    """max_len not a chunk multiple: the final chunk's padded tail reaches
    past the block table (and must land on the null page)."""
    rng = np.random.default_rng(12)
    _both(False, [(rng.integers(0, 96, size=70), 2)], kw=SINGLE)


# ---------------------------------------------------------- port-only units
def test_sampled_decode_runs_and_is_seeded():
    """Temperature/top-k rows draw from a per-request generator: the same
    seed gives the same stream whatever the batch around it."""
    from repro_torch.serve import SamplingParams
    _, _, tm, tp = _models(False)
    streams = []
    for n_others in (0, 2):
        reqs = [Request(id=0, prompt=np.arange(1, 12), max_new_tokens=6,
                        sampling=SamplingParams(temperature=0.8, top_k=8,
                                                seed=7))]
        reqs += [Request(id=1 + i, prompt=np.arange(20, 30 + i),
                         max_new_tokens=5) for i in range(n_others)]
        out = Engine(tm, tp, n_slots=3, max_len=64, page_size=8).run(reqs)
        assert all(0 <= t < 96 for v in out.values() for t in v)
        streams.append(out[0])
    assert streams[0] == streams[1]


def test_greedy_ties_take_the_first_index():
    import jax.numpy as jnp
    import torch
    from repro_torch.serve import sample
    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                       [-2.0, -1.0, -1.0, -1.5]], np.float32)
    got = sample(torch.from_numpy(logits), [0.0] * 3, [0] * 3, [None] * 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argmax(logits, axis=-1)))


@pytest.mark.parametrize("temp,top_k", [(0.7, 3), (1.3, 0)])
def test_sampled_distribution_matches_reference(temp, top_k):
    """Temperature / top-k draws are compared by distribution: the port's
    empirical frequencies over 4000 draws against the reference's
    ``policy_probs`` (within 0.035, ~4.5 standard errors at p = 0.5)."""
    import torch
    from repro.serve.sampling import policy_probs
    from repro_torch.serve.sampling import make_generator, sample_one
    logits = np.array([1.2, 0.3, -0.4, 2.0, 1.9, -3.0, 0.0, 0.8], np.float32)
    want = np.asarray(policy_probs(logits, np.float32(temp), np.int32(top_k)))
    gen = make_generator(123, "cpu")
    t = torch.from_numpy(logits)
    n = 4000
    counts = np.bincount([int(sample_one(t, temp, top_k, gen))
                          for _ in range(n)], minlength=len(logits))
    np.testing.assert_allclose(counts / n, want, atol=0.035)
    if top_k:
        assert counts[want == 0].sum() == 0          # outside the top k


def test_make_requests_semantics():
    cfg = tcommon.get_config("olmo-1b", smoke=True)
    reqs = make_requests(cfg, n_requests=8, rate=16.0, prompt_len=48, gen=32,
                         seed=0, shared_prefix=16)
    assert all(24 <= len(r.prompt) <= 48 for r in reqs)
    assert all(16 <= r.max_new_tokens <= 32 for r in reqs)
    assert all((r.prompt[:16] == reqs[0].prompt[:16]).all() for r in reqs)
    times = [r.arrival_time for r in reqs]
    assert times == sorted(times) and times[0] > 0
    again = make_requests(cfg, n_requests=8, rate=16.0, prompt_len=48, gen=32,
                          seed=0, shared_prefix=16)
    assert all((a.prompt == b.prompt).all() for a, b in zip(reqs, again))


@pytest.mark.parametrize("n_requests", [1, 4])
@pytest.mark.parametrize("shared_prefix", [0, 16])
def test_make_requests_equals_reference(shared_prefix, n_requests):
    """The port's request stream is the JAX launcher's, field for field:
    ids, prompt tokens (the first SyntheticLM batch of the seed), budgets,
    arrival times and sampling seeds."""
    cfg = tcommon.get_config("olmo-1b", smoke=True)
    kw = dict(n_requests=n_requests, rate=16.0, prompt_len=48, gen=16,
              seed=3, shared_prefix=shared_prefix)
    got = make_requests(cfg, **kw)
    want = jmake_requests(jcommon.get_config("olmo-1b", smoke=True), **kw)
    assert len(got) == len(want) == n_requests
    for a, b in zip(got, want):
        assert a.id == b.id
        np.testing.assert_array_equal(np.asarray(a.prompt),
                                      np.asarray(b.prompt))
        assert a.max_new_tokens == b.max_new_tokens
        assert a.arrival_time == b.arrival_time
        assert a.sampling.seed == b.sampling.seed
        assert a.sampling.temperature == b.sampling.temperature == 0.0


def test_transition_table_is_drawn_once_per_vocab_and_seed(monkeypatch):
    """A kept table equals a freshly drawn one, is drawn once for each
    (vocab, seed) whatever the stream's length and batch, and cannot be
    written through a stream."""
    monkeypatch.setattr(tpipeline, "_tables", tpipeline.collections.OrderedDict())
    monkeypatch.setattr(tpipeline, "TABLE_DRAWS", [])
    a = SyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=4)
    b = SyntheticLM(vocab=96, seq_len=48, global_batch=5, seed=4)
    c = SyntheticLM(vocab=97, seq_len=8, global_batch=2, seed=4)
    d = SyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=5)
    assert a._trans is b._trans
    assert [(r["vocab"], r["seed"]) for r in tpipeline.TABLE_DRAWS] == [
        (96, 4), (97, 4), (96, 5)]
    np.testing.assert_array_equal(a._trans, tpipeline.draw_table(96, 4))
    np.testing.assert_array_equal(c._trans, tpipeline.draw_table(97, 4))
    np.testing.assert_array_equal(d._trans, tpipeline.draw_table(96, 5))
    assert not a._trans.flags.writeable
    # past TABLES_KEPT the oldest table goes and is drawn again on demand
    SyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=4)
    assert len(tpipeline._tables) == tpipeline.TABLES_KEPT
    assert len(tpipeline.TABLE_DRAWS) == 4


def test_page_pool_refcounts():
    pool = PagePool(5)
    a, b = pool.alloc(), pool.alloc()
    assert NULL_PAGE not in (a, b) and a != b
    pool.retain(a)
    pool.release(a)
    assert pool.allocated_count == 2
    pool.release(a)
    pool.release(b)
    assert pool.free_count == 4 and pool.allocated_count == 0
    for _ in range(4):
        pool.alloc()
    with pytest.raises(RuntimeError):
        pool.alloc()


def test_prefix_trie_match_insert_evict():
    pool = PagePool(8)
    trie = PrefixTrie(pool, page_size=8)
    prompt = np.arange(20)
    p0, p1 = pool.alloc(), pool.alloc()
    trie.insert(prompt, 0, p0)
    trie.insert(prompt, 1, p1)
    assert trie.match(prompt, 2) == [p0, p1]
    other = prompt.copy()
    other[12] += 1
    assert trie.match(other, 2) == [p0]
    assert trie.evictable_count() == 0
    pool.release(p0)
    pool.release(p1)
    assert trie.reclaimable_count() == 2 and trie.evictable_count() == 1
    assert trie.evict_one() == p1                  # leaf first
    assert trie.evict_one() == p0
    assert trie.evict_one() is None


def test_paged_cache_reservation_accounting():
    _, _, tm, _ = _models(False)
    cache = PagedCache(tm, n_slots=2, max_len=64, page_size=8, n_pages=9,
                       device="cpu")
    prompt = np.arange(10, dtype=np.int32)
    assert cache.can_admit(10, 30, prompt=prompt)
    cache.admit_request(0, prompt, max_new_tokens=30)
    assert cache.pool.allocated_count == 2 and cache.reserved == 3
    assert not cache.can_admit(10, 30, prompt=prompt)
    assert cache.can_admit(10, 8, prompt=prompt)
    cache.ensure_decode_page(0, 16)
    assert cache.pool.allocated_count == 3 and cache.reserved == 2
    cache.free_slot(0)
    assert cache.pool.allocated_count == 0 and cache.reserved == 0
    assert (cache.block_tables[0] == NULL_PAGE).all()
