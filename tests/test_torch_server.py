"""Port parity, the HTTP/SSE frontend: ``repro_torch.serve.GenerateServer``
on the port's engine against ``repro.serve.GenerateServer`` on the JAX
engine (the cases of ``tests/test_serve_server.py`` and the server cases of
``tests/test_serve_resilience.py``), on 127.0.0.1 with ephemeral ports,
the params carried over with ``params_from_numpy``, at float32.

Tolerance: exact. With the engine stepped by hand (``auto_pump=False``) so
that both servers see the same order of events, every SSE event of every
stream equals the reference server's field for field, the timing fields
(``ttft_s``, ``e2e_s``) aside; streams served by the pump equal the
port's direct engine. Status lines, error payloads and the Prometheus
series are checked as the reference's tests check them. The example
client ``examples/torch_serve_http_client.py`` runs once against a CPU
server under a chaos schedule, verifying its streams against a direct
engine on the same packed export.
"""

import asyncio
import functools
import importlib.util
import json
import re
import threading
from pathlib import Path

import jax
import numpy as np

import repro.serve as J
import repro_torch.serve as T
from repro.configs import common as jcommon
from repro.models import build as jbuild
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.models import build as tbuild
from repro_torch.serve.cache import NULL_PAGE

from test_serve_server import _drive, _generate, _get, _parse_sse, _post
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ROOT = Path(__file__).resolve().parent.parent
PAGED = dict(max_len=64, page_size=8)
TIMING = ("ttft_s", "e2e_s")


@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _engine(pkg, n_slots=2, spec=False, **kw):
    jm, jp, tm, tp = _models()
    m, p = (jm, jp) if pkg is J else (tm, tp)
    extra = dict(paged=True) if pkg is J else {}
    if spec:
        extra.update(spec_draft=(m, p), spec_k=3)
    return pkg.Engine(m, p, n_slots=n_slots, **PAGED, **extra, **kw)


def _direct(prompts, n, n_slots=2):
    """The port's direct engine on the same prompts."""
    out = _engine(T, n_slots).run([T.Request(id=i, prompt=np.asarray(p),
                                             max_new_tokens=n)
                                   for i, p in enumerate(prompts)])
    return [out[i] for i in range(len(prompts))]


async def _events(port, spec):
    """One generate call, every SSE event ``(name, payload)``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(_post("/v1/generate", spec))
    await writer.drain()
    data = b""
    while True:
        chunk = await reader.read(65536)
        if not chunk:
            break
        data += chunk
    writer.close()
    return _parse_sse(data)


def _raw_post(port, path, body: bytes):
    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        data = b""
        while True:
            chunk = await reader.read(65536)
            if not chunk:
                break
            data += chunk
        writer.close()
        return data
    return go


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, size=int(n)).tolist() for n in sizes]


# ------------------------------------------------------------------ exactness
def test_sse_events_equal_the_reference_server():
    """Three clients (mixed priorities, SLOs) against 2 slots, the engine
    stepped by hand: the first two submitted, two steps, then the third
    (interactive) arrives and preempts the batch one. Every event of every
    stream, timing fields aside, is the reference server's; the tokens are
    the direct engine's."""
    prompts = _prompts(0, (9, 13, 7))
    specs = [{"prompt": prompts[i], "max_new_tokens": 6, "priority": pr,
              "ttft_slo_ms": 60_000, "e2e_slo_ms": 60_000}
             for i, pr in enumerate(("interactive", "batch", "interactive"))]

    def serve(pkg):
        engine = _engine(pkg)

        async def main():
            server = pkg.GenerateServer(engine, port=0, queue_limit=8,
                                        auto_pump=False)
            await server.start()
            tasks = []
            for i, spec in enumerate(specs):
                if i == 2:
                    for _ in range(2):
                        engine.step()
                        await asyncio.sleep(0.002)
                tasks.append(asyncio.create_task(_events(server.port, spec)))
                for _ in range(15_000):         # the submit lands, or fail
                    if len(engine.metrics.requests) > i:
                        break
                    await asyncio.sleep(0.002)
                assert len(engine.metrics.requests) > i
            await _drive(engine, server,
                         lambda: all(t.done() for t in tasks))
            await server.close()
            return [t.result() for t in tasks]
        return asyncio.run(main()), engine

    (want, jeng), (got, teng) = serve(J), serve(T)
    strip = [[(ev, {k: v for k, v in d.items() if k not in TIMING})
              for ev, d in stream] for stream in got]
    assert strip == [[(ev, {k: v for k, v in d.items() if k not in TIMING})
                      for ev, d in stream] for stream in want]
    assert teng.n_preemptions == jeng.n_preemptions == 1
    toks = [[d["token"] for ev, d in s if ev == "token"] for s in got]
    assert toks == _direct(prompts, 6)
    s = teng.metrics.summary()
    assert s["n_done"] == 3 and s["interactive_ttft_slo_attainment"] == 1.0


def test_sse_streams_with_the_pump_and_spec_draft():
    """Staggered clients served by the pump, with and without a perfect
    draft: every stream is the direct engine's."""
    prompts = _prompts(1, (10, 12, 7))
    want = _direct(prompts, 7)
    for spec in (False, True):
        engine = _engine(T, spec=spec)
        assert engine.spec_active == spec

        async def main():
            server = T.GenerateServer(engine, port=0, queue_limit=8)
            await server.start()

            async def delayed(i, prio, delay):
                await asyncio.sleep(delay)
                return await _generate(server.port, {
                    "prompt": prompts[i], "max_new_tokens": 7,
                    "priority": prio})
            out = await asyncio.gather(delayed(0, "interactive", 0.0),
                                       delayed(1, "batch", 0.02),
                                       delayed(2, "interactive", 0.04))
            await server.close()
            return out
        for i, (toks, done) in enumerate(asyncio.run(main())):
            assert toks == want[i], (spec, i)
            assert done["n_tokens"] == 7 and done["finish_reason"] == "length"


# --------------------------------------------------------------- backpressure
def test_backpressure_429_retry_after():
    engine = _engine(T, n_slots=1)

    async def main():
        server = T.GenerateServer(engine, port=0, queue_limit=1,
                                  auto_pump=False)
        await server.start()
        first = asyncio.create_task(_generate(server.port, {
            "prompt": [1, 2, 3, 4], "max_new_tokens": 4}))
        await _drive(engine, server, lambda: engine.scheduler.n_running >= 1)
        second = asyncio.create_task(_generate(server.port, {
            "prompt": [5, 6, 7, 8], "max_new_tokens": 4}))
        await _drive(engine, server,
                     lambda: len(engine.scheduler.waiting) >= 1)
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
        writer.write(_post("/v1/generate", {"prompt": [9, 9],
                                            "max_new_tokens": 2}))
        await writer.drain()
        data = await reader.read(65536)
        writer.close()
        head = data.split(b"\r\n\r\n", 1)[0].decode()
        assert head.startswith("HTTP/1.1 429"), head
        assert "Retry-After:" in head
        out = await asyncio.gather(
            _drive(engine, server, lambda: not engine.has_work()),
            first, second)
        await server.close()
        return out

    _, (t1, _), (t2, _) = asyncio.run(main())
    assert [t1, t2] == _direct([[1, 2, 3, 4], [5, 6, 7, 8]], 4)
    assert engine.metrics.summary()["n_rejected"] == 1


# --------------------------------------------------------------- cancellation
def test_disconnect_cancels_and_returns_pages():
    """A client that drops mid-stream cancels its request: its slot and
    private pages come back within a step; the other stream is
    unperturbed."""
    keep, drop = _prompts(2, (9, 11))
    engine = _engine(T)

    async def main():
        server = T.GenerateServer(engine, port=0, auto_pump=False)
        await server.start()
        keeper = asyncio.create_task(_generate(server.port, {
            "prompt": keep, "max_new_tokens": 10}))
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
        writer.write(_post("/v1/generate", {"prompt": drop,
                                            "max_new_tokens": 10}))
        await writer.drain()
        got = b""
        while b"event: token" not in got:
            if engine.has_work():
                engine.step()
            await asyncio.sleep(0.002)
            got += await asyncio.wait_for(reader.read(4096), 1)
        victim = next(r for r in engine.scheduler.running.values()
                      if list(r.prompt) == drop)
        assert int((engine.cache.block_tables[victim.slot]
                    != NULL_PAGE).sum()) > 0
        writer.close()
        await writer.wait_closed()
        await _drive(engine, server, lambda: victim.slot is None, limit=50)
        assert victim.id not in {r.id for r in
                                 engine.scheduler.running.values()}
        assert engine.metrics.n_cancelled == 1
        await asyncio.gather(
            _drive(engine, server, lambda: not engine.has_work()), keeper)
        await server.close()
        return keeper.result()

    toks, _ = asyncio.run(main())
    assert toks == _direct([keep], 10)[0]
    pool = engine.cache.pool
    assert pool.allocated_count == len(engine.cache.trie)
    assert (pool.ref[1:] <= 1).all()


# ------------------------------------------------------------- observability
PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-z_]+="[^"]*"'
                       r'(,[a-z_]+="[^"]*")*\})? -?[0-9.e+-]+$|^-?inf$')


def test_metrics_and_healthz_endpoints():
    """``/metrics`` is Prometheus text (every sample line parses, HELP and
    TYPE once per family) with the reference's series; ``/healthz``
    reports the engine; unknown routes 404, wrong methods 405."""
    engine = _engine(T)

    async def main():
        server = T.GenerateServer(engine, port=0)
        await server.start()
        toks, _ = await _generate(server.port, {
            "prompt": [3, 1, 4, 1, 5], "max_new_tokens": 4,
            "priority": "batch", "ttft_slo_ms": 60_000})
        out = [toks] + [await _get(server.port, path) for path in
                        ("/metrics", "/healthz", "/nope", "/v1/generate")]
        await server.close()
        return out

    toks, metrics, health, missing, bad = asyncio.run(main())
    assert len(toks) == 4
    assert "text/plain" in metrics.splitlines()[1]
    body = metrics.split("\r\n\r\n", 1)[1]
    families = [ln.split()[2] for ln in body.splitlines()
                if ln.startswith("# TYPE")]
    assert len(families) == len(set(families)) > 20
    for ln in body.splitlines():
        assert ln.startswith("# ") or PROM_LINE.match(ln), ln
    for series in ('repro_serve_requests_total{priority="batch"} 1',
                   'repro_serve_slo_attainment{priority="batch",slo="ttft"} 1',
                   "repro_serve_queue_depth", "repro_serve_preemptions_total",
                   "repro_serve_kv_pages_free",
                   "# TYPE repro_serve_ttft_seconds summary"):
        assert series in body, series
    info = json.loads(health.split("\r\n\r\n", 1)[1])
    assert info["n_slots"] == 2 and info["ok"] and info["paged"]
    assert missing.startswith("HTTP/1.1 404")
    assert bad.startswith("HTTP/1.1 405")


def test_bad_requests_400():
    """Malformed JSON, unknown fields, a non-object body, an unknown
    priority, an empty prompt and a budget past max_len: a structured 400
    each, nothing admitted, no traceback on the wire."""
    engine = T.Engine(*_models()[2:], n_slots=1, max_len=32, page_size=8)

    async def main():
        server = T.GenerateServer(engine, port=0, auto_pump=False)
        await server.start()
        outs = []
        for body in (b"{not json",
                     json.dumps({"prompt": [1, 2, 3],
                                 "max_new_tok": 4}).encode(),
                     json.dumps([1, 2]).encode(),
                     json.dumps({"prompt": [1, 2],
                                 "priority": "bulk"}).encode(),
                     json.dumps({"prompt": []}).encode(),
                     json.dumps({"prompt": [1, 2],
                                 "max_new_tokens": 99}).encode()):
            outs.append(await _raw_post(server.port, "/v1/generate",
                                        body)())
        await server.close()
        return outs

    outs = asyncio.run(main())
    for data in outs:
        head, body = data.split(b"\r\n\r\n", 1)
        assert head.startswith(b"HTTP/1.1 400"), head
        assert b"error" in body and b"Traceback" not in data
    assert b"max_new_tok" in outs[1]
    assert not engine.has_work()


# -------------------------------------------------------- server error paths
def test_midstream_engine_fault_is_a_structured_error():
    """A persistent engine fault mid-stream: an SSE ``error`` event
    (finish_reason engine_fault) instead of ``done``, ``/healthz`` not ok,
    503 for the next generate."""
    res = T.Resilience(
        injector=T.FaultInjector([T.FaultSpec("engine_step", step=1,
                                              n_steps=1000)]),
        max_consecutive_step_faults=0)
    engine = _engine(T, n_slots=1, resilience=res)

    async def main():
        server = T.GenerateServer(engine, port=0, queue_limit=4)
        await server.start()
        events = await _events(server.port, {"prompt": [3, 1, 4, 1, 5],
                                             "max_new_tokens": 8})
        raw = await _raw_post(server.port, "/v1/generate", json.dumps(
            {"prompt": [1, 2], "max_new_tokens": 2}).encode())()
        health = await _get(server.port, "/healthz")
        await server.close()
        return events, raw, health

    events, raw, health = asyncio.run(main())
    names = [ev for ev, _ in events]
    assert "done" not in names and names[-1] == "error"
    assert events[-1][1]["finish_reason"] == "engine_fault"
    assert names.count("token") < 8
    assert raw.split(b"\r\n")[0].startswith(b"HTTP/1.1 503")
    assert json.loads(health.split("\r\n\r\n", 1)[1])["ok"] is False
    assert engine.metrics.n_step_faults == 1


def test_sheds_batch_when_the_ladder_is_saturated():
    lad = T.DegradationLadder()
    engine = _engine(T, n_slots=1, resilience=T.Resilience(ladder=lad))
    lad.force(3)

    async def main():
        server = T.GenerateServer(engine, port=0, queue_limit=4)
        await server.start()
        shed = await _raw_post(server.port, "/v1/generate", json.dumps(
            {"prompt": [1, 2, 3], "max_new_tokens": 2,
             "priority": "batch"}).encode())()
        toks, done = await _generate(server.port, {
            "prompt": [1, 2, 3], "max_new_tokens": 2})
        await server.close()
        return shed, toks, done

    shed, toks, done = asyncio.run(main())
    assert shed.split(b"\r\n")[0].startswith(b"HTTP/1.1 503")
    assert b"retry-after" in shed.lower()
    assert engine.metrics.n_shed == 1
    assert len(toks) == 2 and done["finish_reason"] == "length"


def test_injected_500_is_structured():
    res = T.Resilience(
        injector=T.FaultInjector([T.FaultSpec("server_error", step=0)]))
    engine = _engine(T, n_slots=1, resilience=res)

    async def main():
        server = T.GenerateServer(engine, port=0, queue_limit=4,
                                  auto_pump=False)
        await server.start()
        raw = await _raw_post(server.port, "/v1/generate", json.dumps(
            {"prompt": [1, 2], "max_new_tokens": 2}).encode())()
        await server.close()
        return raw

    raw = asyncio.run(main())
    head, body = raw.split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.1 500")
    assert json.loads(body)["injected"] is True
    assert b"Traceback" not in raw
    assert res.injector.counts["server_error"] == 1


# ------------------------------------------------------------ example client
def test_example_client_against_a_cpu_server(tmp_path, capsys):
    """``examples/torch_serve_http_client.py`` against a server (in a thread)
    on a packed int8 export under a chaos schedule: its streams equal its
    own direct engine on the export, and ``/metrics`` carries the SLO,
    fault and quarantine series."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    cfg = tcommon.get_config("olmo-1b", smoke=True, mpd_mode="masked_dense")
    m = tbuild(cfg)
    d = str(tmp_path / "ck")
    ckpt_lib.export_packed(d, 0, m, m.init(0, device="cpu"), quantize="int8")
    model, params = ckpt_lib.load_packed(d, device="cpu")
    res = T.Resilience(injector=T.FaultInjector(
        [T.FaultSpec("decode_logits", step=2, slot=0)]),
        ladder=T.DegradationLadder())
    engine = T.Engine(model, params, n_slots=2, max_len=32, page_size=8,
                      resilience=res)
    loop = asyncio.new_event_loop()
    server = T.GenerateServer(engine, port=0)
    ready = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        ready.set()
        loop.run_forever()
    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    assert ready.wait(60)
    spec = importlib.util.spec_from_file_location(
        "torch_serve_http_client",
        ROOT / "examples" / "torch_serve_http_client.py")
    client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(client)
    try:
        rc = client.main(["--port", str(server.port), "--wait", "30",
                          "--max-new-tokens", "8", "--verify", "--ckpt-dir",
                          d, "--device", "cpu", "--check-metrics",
                          "--check-chaos-metrics"])
    finally:
        asyncio.run_coroutine_threadsafe(server.close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
    out = capsys.readouterr().out
    assert rc == 0 and out.rstrip().endswith("ok")
    assert "verify: 2 streams token-identical" in out
    assert engine.n_quarantines == 1
