"""Streaming HTTP/SSE frontend for the continuous-batching engine or a
replica :class:`~repro_torch.serve.router.Router` (copy of
``repro.serve.server`` on the port's engine).

A single-threaded asyncio server on stdlib ``asyncio`` streams — no HTTP
framework, no new dependencies. The engine and every connection handler
share one event loop: the pump task calls ``Engine.step()`` synchronously
(token callbacks fire inside the step and land on per-request queues), and
between steps the loop drains socket I/O. That single-threadedness is a
correctness feature — submits, cancels, and preemptions all happen between
steps, so no lock ever guards engine state.

Endpoints:

* ``POST /v1/generate`` — JSON body ``{"prompt": [token ids], ...}``,
  response is a Server-Sent-Events stream: one ``token`` event per
  generated token (``{"index": i, "token": id}``), then a final ``done``
  event with the finish reason and latency stats. Optional body fields:
  ``max_new_tokens``, ``priority`` ("interactive" | "batch"), ``eos_id``,
  ``temperature``, ``top_k``, ``seed``, ``ttft_slo_ms``, ``e2e_slo_ms``.
* ``GET /metrics`` — Prometheus text exposition (per-class latency
  quantiles, SLO attainment, queue depth, preemption/cancel counters).
* ``GET /healthz`` — liveness + engine config.

Backpressure: the waiting queue is bounded (``queue_limit``); when it is
full new generates are turned away with ``429`` + ``Retry-After`` instead
of queueing unboundedly. Cancellation: each streaming response watches its
connection for EOF — a client that disconnects mid-stream cancels its
request, and the pages return to the pool before the next engine step.
Preemption safety: a preempted request regenerates deterministically and
its token callback re-fires from index 0 — the per-stream dedup below
makes that invisible on the wire (the client sees a pause, never a
duplicate or a gap).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from typing import Dict, Optional, Tuple

import numpy as np

from .resilience import InjectedFault
from .scheduler import PRIORITIES, Request, RequestState
from .sampling import SamplingParams

log = logging.getLogger("repro_torch.serve.server")

_DONE = object()                    # stream sentinel
_FAULT = object()                   # stream sentinel: engine died under us

# every field a generate body may carry — anything else is a 400, not a
# silent ignore (a typo'd "max_new_token" must not quietly default)
_GENERATE_FIELDS = frozenset((
    "prompt", "max_new_tokens", "priority", "eos_id", "temperature",
    "top_k", "seed", "ttft_slo_ms", "e2e_slo_ms", "enforce_deadline"))


class _ClientGone(Exception):
    pass


@dataclasses.dataclass
class _Stream:
    """Server-side state of one in-flight generate call."""
    req: Request
    queue: asyncio.Queue
    next_index: int = 0             # tokens already forwarded to the queue


def _sse(event: str, payload: dict) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(payload)}\n\n"
            .encode("utf-8"))


def _response(status: str, body: bytes, content_type: str = "application/json",
              extra_headers: Tuple[str, ...] = ()) -> bytes:
    head = [f"HTTP/1.1 {status}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close",
            *extra_headers, "", ""]
    return "\r\n".join(head).encode("utf-8") + body


class GenerateServer:
    """One engine behind an asyncio HTTP/SSE frontend.

    ``port=0`` binds an ephemeral port (tests); the bound port is on
    ``self.port`` after :meth:`start`. ``auto_pump=False`` skips starting
    the engine loop — tests drive :meth:`Engine.step` themselves to pin
    down ordering.
    """

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 8000,
                 queue_limit: int = 64, retry_after_s: float = 1.0,
                 idle_sleep_s: float = 0.001, auto_pump: bool = True):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.engine = engine
        self.host = host
        self.port = port
        self.queue_limit = queue_limit
        self.retry_after_s = retry_after_s
        self.idle_sleep_s = idle_sleep_s
        self.auto_pump = auto_pump
        self._streams: Dict[int, _Stream] = {}
        self._next_id = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._closed = False
        self._engine_failed = False

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self.engine.token_cb = self._on_token
        self.engine.done_cb = self._on_done
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.auto_pump:
            self._pump_task = asyncio.create_task(self._pump())
        log.info("listening on http://%s:%d (queue_limit=%d, %s engine)",
                 self.host, self.port, self.queue_limit,
                 "paged" if self.engine.paged else "slot-dense")

    async def run_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        self._closed = True
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------ engine side
    async def _pump(self) -> None:
        """Step the engine whenever it has work; yield to the event loop
        between steps so connection handlers run. ``Engine.step`` blocks
        the loop for one device dispatch — acceptable because every
        engine-state mutation then happens between steps by construction."""
        while not self._closed:
            if self.engine.has_work():
                try:
                    self.engine.step()
                except Exception:   # noqa: BLE001 — last-resort containment
                    # the engine's own bounded retry already gave up: this
                    # is persistent. Every open stream gets a structured
                    # SSE error event (never a traceback on the wire), new
                    # generates get 503, /healthz reports not-ok.
                    log.exception("engine step failed persistently — "
                                  "aborting %d open streams",
                                  len(self._streams))
                    self._engine_failed = True
                    for stream in list(self._streams.values()):
                        stream.queue.put_nowait(_FAULT)
                    return
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(self.idle_sleep_s)

    def _on_token(self, req: Request, tok: int, index: int) -> None:
        """Engine token callback (fires synchronously inside step()). A
        preempted request regenerates from index 0 — indices below
        ``next_index`` were already forwarded and are dropped here."""
        stream = self._streams.get(req.id)
        if stream is None:
            return
        if index < stream.next_index:
            return
        stream.queue.put_nowait((index, tok))
        stream.next_index = index + 1

    def _on_done(self, req: Request) -> None:
        stream = self._streams.get(req.id)
        if stream is not None:
            stream.queue.put_nowait(_DONE)

    # -------------------------------------------------------------- requests
    def _parse_generate(self, body: bytes) -> Request:
        spec = json.loads(body.decode("utf-8"))
        if not isinstance(spec, dict):
            raise ValueError("generate body must be a JSON object")
        unknown = sorted(set(spec) - _GENERATE_FIELDS)
        if unknown:
            raise ValueError(f"unknown fields {unknown} "
                             f"(known: {sorted(_GENERATE_FIELDS)})")
        prompt = np.asarray(spec.get("prompt", ()), np.int32)
        priority = spec.get("priority", "interactive")
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(choose from {sorted(PRIORITIES)})")
        sampling = SamplingParams(
            temperature=float(spec.get("temperature", 0.0)),
            top_k=int(spec.get("top_k", 0)),
            seed=int(spec.get("seed", 0)))
        def _slo(key):
            return (float(spec[key]) / 1e3) if key in spec else None
        req = Request(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=int(spec.get("max_new_tokens", 16)),
            eos_id=int(spec.get("eos_id", -1)),
            sampling=sampling,
            priority=priority,
            ttft_slo_s=_slo("ttft_slo_ms"),
            e2e_slo_s=_slo("e2e_slo_ms"),
            enforce_deadline=bool(spec.get("enforce_deadline", False)))
        self._next_id += 1
        return req

    async def _handle_generate(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               body: bytes) -> None:
        if self._engine_failed:
            writer.write(_response(
                "503 Service Unavailable",
                json.dumps({"error": "engine failed"}).encode()))
            await writer.drain()
            return
        inj = self.engine.resilience.injector
        if inj is not None:
            try:
                # chaos site "server_error": prove the 500 path is
                # structured JSON, never a traceback on the wire
                inj.check("server_error", self.engine.step_count)
            except InjectedFault as e:
                writer.write(_response(
                    "500 Internal Server Error",
                    json.dumps({"error": str(e), "injected": True}).encode()))
                await writer.drain()
                return
        try:
            req = self._parse_generate(body)
            # degradation ladder stage 3: shed batch-class admissions so
            # interactive traffic keeps its slots under sustained pressure
            ladder = self.engine.resilience.ladder
            if (ladder is not None and ladder.shed_batch
                    and req.priority == "batch"):
                self.engine.metrics.on_shed()
                log.info("shedding batch request (degradation stage %d)",
                         ladder.stage)
                writer.write(_response(
                    "503 Service Unavailable",
                    json.dumps({"error": "shedding batch-class requests "
                                "(degraded)"}).encode(),
                    extra_headers=(
                        f"Retry-After: {max(int(self.retry_after_s), 1)}",)))
                await writer.drain()
                return
            # bounded admission queue: reject instead of queueing deep —
            # the scheduler's waiting list is the backlog being bounded
            if len(self.engine.scheduler.waiting) >= self.queue_limit:
                self.engine.metrics.on_reject()
                log.info("rejecting request (queue depth %d >= limit %d)",
                         len(self.engine.scheduler.waiting), self.queue_limit)
                writer.write(_response(
                    "429 Too Many Requests",
                    json.dumps({"error": "admission queue full"}).encode(),
                    extra_headers=(
                        f"Retry-After: {max(int(self.retry_after_s), 1)}",)))
                await writer.drain()
                return
            stream = _Stream(req=req, queue=asyncio.Queue())
            self._streams[req.id] = stream
            self.engine.submit(req)      # raises ValueError on bad budgets
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._streams.pop(getattr(locals().get("req"), "id", -1), None)
            writer.write(_response(
                "400 Bad Request", json.dumps({"error": str(e)}).encode()))
            await writer.drain()
            return

        log.info("request %d: %s, %d prompt tokens, max_new_tokens=%d",
                 req.id, req.priority, len(req.prompt), req.max_new_tokens)
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        writer.write(_sse("start", {"id": req.id, "priority": req.priority,
                                    "n_prompt": len(req.prompt)}))
        await writer.drain()

        # the client sends nothing after the body, so any read completing
        # (EOF or stray bytes) means the connection died client-side
        disconnect = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                getter = asyncio.ensure_future(stream.queue.get())
                done, _ = await asyncio.wait(
                    {getter, disconnect},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    raise _ClientGone
                item = getter.result()
                if item is _FAULT:
                    # engine died mid-stream: a structured error event,
                    # never a raw traceback in the SSE stream
                    writer.write(_sse("error", {
                        "id": req.id, "error": "engine fault",
                        "finish_reason": "engine_fault",
                        "n_tokens": len(req.generated)}))
                    await writer.drain()
                    return
                if item is _DONE:
                    m = self.engine.metrics.requests.get(req.id)
                    # the engine stamps finish_reason for resilience stops
                    # ("fault" / "deadline"); ordinary stops derive it
                    finish = req.finish_reason or \
                        ("eos" if (req.eos_id >= 0 and req.generated
                                   and req.generated[-1] == req.eos_id)
                         else "length")
                    writer.write(_sse("done", {
                        "id": req.id,
                        "finish_reason": finish,
                        "n_tokens": len(req.generated),
                        "ttft_s": m.ttft if m else None,
                        "e2e_s": m.e2e_latency if m else None,
                        "n_preemptions": req.n_preemptions,
                        "n_fault_retries": req.n_fault_retries}))
                    await writer.drain()
                    log.info("request %d done: %d tokens (%s)",
                             req.id, len(req.generated), finish)
                    return
                index, tok = item
                writer.write(_sse("token", {"index": index, "token": tok}))
                await writer.drain()
                if disconnect.done():
                    raise _ClientGone
        except (_ClientGone, ConnectionError, asyncio.CancelledError):
            if req.state != RequestState.DONE:
                self.engine.cancel(req)
            raise _ClientGone from None
        finally:
            disconnect.cancel()
            self._streams.pop(req.id, None)

    # ------------------------------------------------------------ connection
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """One HTTP request per connection (``Connection: close``) — which
        makes client-side EOF an unambiguous cancellation signal."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
            request_line, *header_lines = head.decode("latin-1").split("\r\n")
            method, target, _ = request_line.split(" ", 2)
            headers = {}
            for line in header_lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            body = b""
            if "content-length" in headers:
                body = await reader.readexactly(int(headers["content-length"]))

            if method == "POST" and target == "/v1/generate":
                await self._handle_generate(reader, writer, body)
            elif method == "GET" and target == "/metrics":
                # one method on the engine (or replica Router): the server
                # never peeks at engine internals, so a Router's fleet
                # gauges and a single Engine's slot gauges both just work
                gauges = self.engine.stats_gauges()
                text = self.engine.metrics.prometheus(extra_gauges=gauges)
                writer.write(_response(
                    "200 OK", text.encode("utf-8"),
                    content_type="text/plain; version=0.0.4"))
                await writer.drain()
            elif method == "GET" and target == "/healthz":
                ladder = self.engine.resilience.ladder
                info = {"ok": not self._engine_failed,
                        "paged": self.engine.paged,
                        "n_slots": self.engine.n_slots,
                        "max_len": self.engine.max_len,
                        "spec_active": self.engine.spec_active,
                        "queue_limit": self.queue_limit,
                        "degradation_stage":
                            ladder.stage if ladder is not None else 0}
                writer.write(_response("200 OK", json.dumps(info).encode()))
                await writer.drain()
            elif target in ("/v1/generate", "/metrics", "/healthz"):
                writer.write(_response(
                    "405 Method Not Allowed",
                    json.dumps({"error": f"{method} not allowed"}).encode()))
                await writer.drain()
            else:
                writer.write(_response(
                    "404 Not Found",
                    json.dumps({"error": f"no route {target}"}).encode()))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, _ClientGone,
                ValueError):
            pass                       # torn-down connection / garbage HTTP
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


def run(engine, *, host: str = "127.0.0.1", port: int = 8000,
        queue_limit: int = 64) -> None:
    """Blocking entry point: serve ``engine`` over HTTP until interrupted
    (what ``python -m repro_torch.launch.serve --http`` calls)."""
    server = GenerateServer(engine, host=host, port=port,
                            queue_limit=queue_limit)
    try:
        asyncio.run(server.run_forever())
    except KeyboardInterrupt:
        log.info("interrupted — shutting down")
