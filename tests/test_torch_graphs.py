"""Port parity, compiled serving steps: the engine's width ladders against
the JAX engine's, the prefill chunk with its slot, start and length as
device scalars (the form a captured chunk replays with) against the int
call and JAX's ``prefill_chunk``, the plain prefill attention with tensor
scalars against JAX's kernel in interpret mode, ``StepGraph``'s launch
tally, and the engine's capture logic on the CPU.

There is no CUDA graph on the CPU, so the capture is stubbed where a test
needs one: the stand-in replays by calling the program again and writing
its result into the output it returned at capture, as a replay rewrites a
graph's static outputs. The real captures are held on the card by
``tests/test_torch_cuda.py``.

Tolerances at float32: logits and K/V pools against JAX atol/rtol 1e-5 (as
``tests/test_torch_spec.py``), the attention 2e-5 / 1e-5 (as
``tests/test_torch_kernels.py``); the tensor-scalar call against the int
call, ``pos`` against JAX, token streams and launch counts: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.kernels import paged_prefill as jpp
from repro.kernels import ref as jref
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import bdmm as tbdmm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, Request
from repro_torch.serve import graphs
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
ATTN_ATOL, ATTN_RTOL = 2e-5, 1e-5


@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


ENGINES = {
    "shared": dict(n_slots=2, max_len=64, page_size=8, n_pages=9,
                   prefill_chunk_tokens=16),
    "single": dict(n_slots=1, max_len=72, page_size=8,
                   prefill_chunk_tokens=32),
    "spec": dict(n_slots=2, max_len=48, page_size=8, prefill_chunk_tokens=16,
                 spec_k=3),
}


def _engine_pair(name):
    jm, jp, tm, tp = _models()
    kw = dict(ENGINES[name])
    jkw, tkw = dict(kw), dict(kw)
    if name == "spec":
        jkw["spec_draft"], tkw["spec_draft"] = (jm, jp), (tm, tp)
    return JEngine(jm, jp, paged=True, **jkw), Engine(tm, tp, **tkw)


@pytest.mark.parametrize("name", list(ENGINES))
def test_width_ladders_match_the_reference(name):
    jeng, teng = _engine_pair(name)
    assert teng.decode_widths() == jeng.decode_widths()
    assert teng.prefill_widths() == jeng.prefill_widths()
    assert teng.prefill_widths()[0] > 1


# ------------------------------------------------ chunk scalars on device
PS, TC, P, SLOT = 8, 16, 6, 1


def _chunk_setup(prompt, start):
    """JAX caches and two port copies, with the chunk before ``start``
    (if any) prefilled into slot 1's pages by the int call."""
    jm, jp, tm, tp = _models()
    n_pages = 2 * P + 1
    row = np.arange(P + 1, 2 * P + 1, dtype=np.int32)
    jc = jm.init_paged_caches(2, n_pages, PS)
    tcs = [tm.init_paged_caches(2, n_pages, PS, device="cpu")
           for _ in range(2)]
    if start:
        toks = prompt[None, :start].astype(np.int32)
        _, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc, jnp.asarray(row),
                                 SLOT, 0, start, final=False)
        for tc in tcs:
            tm.prefill_chunk(tp, torch.as_tensor(toks, dtype=torch.long), tc,
                             torch.as_tensor(row), SLOT, 0, start,
                             final=False)
    return jc, tcs, row


@pytest.mark.parametrize("start,clen,final", [
    (0, 16, False), (0, 11, True), (16, 16, False), (16, 9, True)])
def test_prefill_chunk_takes_device_scalars(start, clen, final):
    """Device-tensor slot, start and chunk_len give the int call's logits,
    pools and ``pos`` exactly, and JAX's within 1e-5 (pos exactly)."""
    jm, jp, tm, tp = _models()
    prompt = np.random.default_rng(start + clen).integers(0, 96, size=32)
    jc, (tc_int, tc_dev), row = _chunk_setup(prompt, start)
    toks = np.zeros((1, TC), np.int32)
    toks[0, :clen] = prompt[start:start + clen]
    want, jc = jm.prefill_chunk(jp, jnp.asarray(toks), jc, jnp.asarray(row),
                                SLOT, start, clen, final=final)
    ttoks, trow = torch.as_tensor(toks, dtype=torch.long), torch.as_tensor(row)
    by_int, _ = tm.prefill_chunk(tp, ttoks, tc_int, trow, SLOT, start, clen,
                                 final=final)
    scalars = [torch.tensor(v, dtype=torch.int32)
               for v in (SLOT, start, clen)]
    by_dev, _ = tm.prefill_chunk(tp, ttoks, tc_dev, trow, *scalars,
                                 final=final)
    if final:
        assert torch.equal(by_dev, by_int)
        np.testing.assert_allclose(by_dev.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    else:
        assert by_dev is None and by_int is None
    for a, b, j in zip(tc_dev, tc_int, jc):
        for k in ("kp", "vp", "pos"):
            assert torch.equal(a[k], b[k]), k
        np.testing.assert_allclose(a["kp"].numpy(), np.asarray(j["kp"]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(a["vp"].numpy(), np.asarray(j["vp"]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(j["pos"]))
        assert int(a["pos"][0, SLOT]) == start + clen


@pytest.mark.parametrize("shape", [  # (H, Kh, Dh, ps, n_pages, P, Tc, start, len)
    (4, 4, 16, 8, 24, 8, 16, 16, 11),
    (8, 2, 16, 4, 32, 8, 8, 8, 5),
])
def test_plain_prefill_attention_with_tensor_scalars(shape):
    H, Kh, Dh, ps, n_pages, P, Tc, start, clen = shape
    rng = np.random.default_rng(H + Tc)
    q = rng.standard_normal((Tc, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    bt = rng.choice(np.arange(1, n_pages), size=P, replace=False).astype(
        np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt)]
    info = torch.tensor([start, clen], dtype=torch.int32)
    got = ops.paged_prefill_attention(*t, info[0], info[1])
    assert torch.equal(got, ops.paged_prefill_attention(*t, start, clen))
    args = [jnp.asarray(a) for a in (q, kp, vp, bt)]
    kern = jpp.paged_prefill_attention(*args, start, clen, interpret=True)
    np.testing.assert_allclose(got.numpy()[:clen], np.asarray(kern)[:clen],
                               atol=ATTN_ATOL, rtol=ATTN_RTOL)
    want = jref.paged_prefill_attention_ref(*args, start, clen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)


# ---------------------------------------------------------------- StepGraph
class _Rerun:
    """A CPU stand-in for a captured graph: a replay calls the program
    again and writes its result into the outputs returned at capture."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        if isinstance(self.out, torch.Tensor):
            self.out.copy_(new)


def _stub_record(fn, device):
    out = fn()
    return _Rerun(fn, out), out


@pytest.fixture
def stub_capture(monkeypatch):
    monkeypatch.setattr(graphs, "_warm",
                        lambda fn, device, runs: [fn() for _ in range(runs)])
    monkeypatch.setattr(graphs, "_record", _stub_record)


class _Still:
    """A replay that runs nothing on the host, as a graph's does."""

    def replay(self):
        pass


def test_step_graph_replays_add_the_capture_tally(stub_capture, monkeypatch):
    """The warm-up runs and the capture add nothing to the counts; every
    replay adds the capture's launches and routes once."""
    monkeypatch.setattr(graphs, "_record", lambda fn, device: (_Still(), fn()))
    calls = []

    def program():
        calls.append(1)
        tpa.launches["paged_attention"] += 1
        tpa.routes["split_tc"] += 1
        tbdmm.launches["bdmm_decode"] += 3
        tbdmm.routes["decode_tc"] += 3
        return torch.zeros(2)

    ops.reset_launch_counts()
    g = graphs.StepGraph("decode", 4, program, torch.device("cpu"))
    assert len(calls) == graphs.WARMUP_RUNS + 1
    assert not any(ops.launch_counts().values())
    assert not any(tpa.routes.values()) and not any(tbdmm.routes.values())
    for n in range(1, 4):
        assert g.replay() is g.output
        counts = ops.launch_counts()
        assert counts["paged_attention"] == n
        assert counts["bdmm_decode"] == 3 * n
        assert sum(counts.values()) == 4 * n
        assert tpa.routes["split_tc"] == n and tbdmm.routes["decode_tc"] == 3 * n
        assert sum(tbdmm.routes.values()) == 3 * n
    ops.reset_launch_counts()


def test_failed_capture_names_program_and_rung(stub_capture):
    def program():
        tpa.launches["paged_attention"] += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    ops.reset_launch_counts()
    with pytest.raises(graphs.GraphError, match="verify at width 8"):
        graphs.StepGraph("verify", 8, program, torch.device("cpu"))
    assert not any(ops.launch_counts().values())


# ------------------------------------------------------------------- engine
def test_graphs_true_on_the_cpu_raises():
    _, _, tm, tp = _models()
    with pytest.raises(ValueError, match="CUDA"):
        Engine(tm, tp, graphs=True, **ENGINES["shared"])
    eng = Engine(tm, tp, **ENGINES["shared"])
    assert not eng.use_graphs
    eng.warmup()                           # eager: nothing to capture
    assert eng.n_captures == 0


def _requests(seed, n=4):
    rng = np.random.default_rng(seed)
    return [Request(id=i, prompt=rng.integers(0, 96, size=int(
        rng.integers(5, 30))), max_new_tokens=int(rng.integers(2, 9)))
            for i in range(n)]


def _state(eng):
    caches = eng.cache.caches + (eng.draft_cache.caches if eng.spec_active
                                 else [])
    return [t.clone() for c in caches for t in c.values()] + [
        eng._tokens.clone()]


@pytest.mark.parametrize("name", ["shared", "spec"])
def test_cpu_engine_streams_are_the_reference_streams(name):
    """The CPU engine runs eagerly whether asked (graphs=False) or by
    default, and streams what the JAX engine streams; every program run is
    counted."""
    jeng, teng = _engine_pair(name)
    _, _, tm, tp = _models()
    kw = dict(ENGINES[name])
    if name == "spec":
        kw["spec_draft"] = (tm, tp)
    eager = Engine(tm, tp, graphs=False, **kw)
    reqs = lambda cls: [cls(id=r.id, prompt=r.prompt,  # noqa: E731
                            max_new_tokens=r.max_new_tokens)
                        for r in _requests(21)]
    from repro.serve import Request as JRequest
    want = jeng.run(reqs(JRequest))
    assert teng.run(reqs(Request)) == want == eager.run(reqs(Request))
    assert teng.n_captures == eager.n_captures == 0
    assert teng.runs == eager.runs
    chunks = teng.runs["chunk"] + teng.runs["chunk_final"]
    assert chunks == teng.n_prefill_chunks and teng.runs["chunk_final"] == 4
    if name == "spec":
        assert teng.runs["draft_chunk"] == chunks
        assert teng.runs["draft_decode"] == 3 * teng.runs["verify"] > 0
    else:
        assert teng.runs["decode"] > 0


@pytest.mark.parametrize("name", ["shared", "single", "spec"])
def test_captured_engine_logic_on_the_cpu(name, stub_capture):
    """The engine's capture path with the stand-in graph: ``warmup()``
    captures every program at every rung against null inputs, leaving every
    real page, ``pos`` and the pending tokens as they were; serving then
    captures nothing new and streams the eager engine's tokens with the
    same program runs."""
    _, _, tm, tp = _models()
    kw = dict(ENGINES[name])
    if name == "spec":
        kw["spec_draft"] = (tm, tp)
    eager = Engine(tm, tp, graphs=False, **kw)
    eng = Engine(tm, tp, **kw)
    eng.use_graphs = True
    # a first serve, so that pools, pos and tokens hold real values
    first = [eng.run(_requests(5, 2)), eager.run(_requests(5, 2))]
    assert first[0] == first[1]
    n0 = eng.n_captures
    before = _state(eng)
    eng.warmup()
    per_decode = 3 if name == "spec" else 1
    per_chunk = 3 if name == "spec" else 2
    assert eng.n_captures == (per_decode * len(eng.decode_widths())
                              + per_chunk * len(eng.prefill_widths()))
    assert n0 < eng.n_captures
    for a, b in zip(before, _state(eng)):
        if a.dim() == 5:                   # pools: all but the null page
            assert torch.equal(a[:, 1:], b[:, 1:])
        else:
            assert torch.equal(a, b)
    n1 = eng.n_captures
    assert eng.run(_requests(9)) == eager.run(_requests(9))
    assert eng.n_captures == n1
    assert eng.runs == eager.runs
