"""Data-parallel replica router (copy of ``repro.serve.router`` on the
port's engine): N independent engines behind one facade.

This module scales **throughput** by running N complete
:class:`~repro_torch.serve.engine.Engine` replicas, each with its own page
pool, prefix trie, scheduler, CUDA graphs and sampling state, behind a
single Engine-shaped facade (the launcher builds them on one model and
one set of weight tensors). ``GenerateServer`` and
the launch drivers talk to a :class:`Router` exactly as they would one
engine: ``submit`` / ``cancel`` / ``step`` / ``has_work`` / ``token_cb``
/ ``done_cb`` / ``metrics`` / ``stats_gauges`` all exist with the same
contracts, so the HTTP frontend is replica-count-agnostic.

Dispatch policy
---------------
Least-loaded by default (fewest waiting + running requests, lowest index
breaking ties), **overridden by prefix affinity**: the page-aligned head
of the prompt (capped at ``affinity_pages`` pages) is hashed, and a
prompt whose prefix hash was seen before routes to the replica that
served it last — that replica's prefix trie already holds those KV
pages, so admission skips the shared prefix instead of recomputing it.
Affinity beats load because recomputing a long prefix costs far more
than a slightly deeper queue.

Replica death and drain
-----------------------
``Engine.step`` already retries transient faults with bounded backoff;
an exception escaping it is *persistent*. The router quarantines that
replica (never stepped or dispatched to again), rewinds its in-flight
token counts (the fleet metrics merge then stays exact — see
:func:`~repro_torch.serve.metrics.merge_request_metrics`), and resubmits
every non-terminal request to the survivors in original arrival order.
Deterministic regeneration plus the server's index-dedup means clients
see a stall, not corruption. Only when the *last* replica dies does the
failure propagate to the frontend.

Prefill/decode disaggregation (``disagg=True``)
-----------------------------------------------
The first ``n_prefill`` replicas only prefill: a request runs there as
``prefill_only`` with a 1-token budget (so its worst-case decode pages
are never reserved on the prefill side), and at its first sampled token
the engine hands the router a :class:`~repro_torch.serve.engine.Handoff`
— block-table layout, gathered page contents and the request's sampling
generator state. The router restores the real token budget and
resubmits to a decode replica, where admission *adopts* the payload
(pages scattered into the local pool through the same ``admit_request``
reservation accounting as any prompt, so handoff can never deadlock the
pool) and decoding continues from token 1 with the generator resumed
where the prefill replica left it. Requires paged engines whose cache is
fully attention-backed (``prefix_cache_enabled``) and no speculative
decoding (the draft pool is not migrated).
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Callable, Dict, List, Optional

from .metrics import RouterMetrics
from .scheduler import Request, RequestState

log = logging.getLogger(__name__)


def prefix_affinity_key(prompt, page_size: int,
                        affinity_pages: int) -> Optional[bytes]:
    """Hash of the page-aligned prompt head, or None when the prompt is
    shorter than one page (nothing reusable lands in the trie). Capped at
    ``affinity_pages`` pages: beyond the cap, prompts sharing a long head
    still collide onto the same replica, which is the point."""
    n = (len(prompt) // page_size) * page_size
    n = min(n, affinity_pages * page_size)
    if n < page_size:
        return None
    return hashlib.blake2b(bytes(memoryview(prompt[:n])),
                           digest_size=8).digest()


class _RouterLadder:
    """Fleet view of the replicas' degradation ladders for the server's
    shed gate and ``/healthz``: ``stage`` is the worst (max) live stage,
    ``shed_batch`` only when *every* live replica is shedding — while one
    replica can still take batch traffic, the router keeps admitting."""

    def __init__(self, router: "Router"):
        self._router = router

    def _ladders(self):
        return [e.resilience.ladder
                for e, alive in zip(self._router.replicas, self._router.live)
                if alive and e.resilience.ladder is not None]

    @property
    def stage(self) -> int:
        return max((lad.stage for lad in self._ladders()), default=0)

    @property
    def shed_batch(self) -> bool:
        ladders = self._ladders()
        return bool(ladders) and all(lad.shed_batch for lad in ladders)


class _RouterResilience:
    """``engine.resilience`` stand-in: one injector (chaos tests install
    the same schedule on every replica; site checks hit replica 0's),
    and the fleet ladder view."""

    def __init__(self, router: "Router"):
        self._router = router
        self._ladder = _RouterLadder(router)

    @property
    def injector(self):
        return self._router.replicas[0].resilience.injector

    @property
    def ladder(self) -> Optional[_RouterLadder]:
        if not self._ladder._ladders():
            return None
        return self._ladder


class _SchedView:
    """``engine.scheduler`` stand-in — the server only measures backlog
    (``len(scheduler.waiting)``) for its bounded admission queue, so the
    view concatenates the live replicas' waiting lists."""

    def __init__(self, router: "Router"):
        self._router = router

    @property
    def waiting(self) -> list:
        out: list = []
        for e, alive in zip(self._router.replicas, self._router.live):
            if alive:
                out.extend(e.scheduler.waiting)
        return out


class Router:
    def __init__(self, engines: List, *, affinity_pages: int = 4,
                 disagg: bool = False, n_prefill: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        e0 = engines[0]
        for e in engines[1:]:
            if (e.paged, e.max_len) != (e0.paged, e0.max_len):
                raise ValueError("Router replicas must agree on paged mode "
                                 "and max_len")
        self.replicas = list(engines)
        self.live = [True] * len(engines)
        self.affinity_pages = affinity_pages
        self.disagg = disagg
        self.roles = ["both"] * len(engines)
        if disagg:
            if len(engines) < 2:
                raise ValueError("disagg needs >= 2 replicas (>=1 prefill, "
                                 ">=1 decode)")
            if not (1 <= n_prefill < len(engines)):
                raise ValueError(f"n_prefill must be in [1, {len(engines)}) "
                                 f"for disagg, got {n_prefill}")
            for e in engines:
                if not e.paged or e.spec_active \
                        or not e.cache.prefix_cache_enabled:
                    raise ValueError(
                        "disagg requires paged engines with fully "
                        "attention-backed caches (prefix_cache_enabled) and "
                        "no speculative draft — the handoff migrates every "
                        "cache leaf and exactly one sampling stream")
            self.roles = ["prefill"] * n_prefill + \
                ["decode"] * (len(engines) - n_prefill)
        self.metrics = RouterMetrics([e.metrics for e in engines],
                                     clock=clock)
        self.resilience = _RouterResilience(self)
        self.scheduler = _SchedView(self)
        self.busy_s = [0.0] * len(engines)  # in-step seconds, per replica
        self._owner: Dict[int, int] = {}    # req.id -> replica index
        self._affinity: Dict[bytes, int] = {}
        self._orig_max_new: Dict[int, int] = {}
        self._token_cb = None
        self._done_cb = None
        for i, e in enumerate(self.replicas):
            if self.roles[i] == "prefill":
                e.handoff_cb = self._on_handoff
            if disagg:
                # the engine's warmup captures the handoff ops of its role
                e.handoff_role = self.roles[i]

    # --------------------------------------------------- facade properties
    @property
    def paged(self) -> bool:
        return self.replicas[0].paged

    @property
    def max_len(self) -> int:
        return self.replicas[0].max_len

    @property
    def n_slots(self) -> int:
        return sum(e.n_slots for e, alive in zip(self.replicas, self.live)
                   if alive)

    @property
    def spec_active(self) -> bool:
        return any(e.spec_active for e in self.replicas)

    @property
    def step_count(self) -> int:
        return sum(e.step_count for e in self.replicas)

    @property
    def n_live(self) -> int:
        return sum(self.live)

    # streaming hooks fan out: each engine fires them synchronously inside
    # its own step(); the server's per-index dedup handles regeneration
    # after preemption, drain, or handoff exactly as for one engine
    @property
    def token_cb(self):
        return self._token_cb

    @token_cb.setter
    def token_cb(self, fn) -> None:
        self._token_cb = fn
        for e in self.replicas:
            e.token_cb = fn

    @property
    def done_cb(self):
        return self._done_cb

    @done_cb.setter
    def done_cb(self, fn) -> None:
        self._done_cb = fn
        for e in self.replicas:
            e.done_cb = fn

    def stats_gauges(self) -> Dict[str, float]:
        g: Dict[str, float] = {}
        for e, alive in zip(self.replicas, self.live):
            if not alive:
                continue
            for name, val in e.stats_gauges().items():
                g[name] = g.get(name, 0.0) + val
        g["repro_serve_router_replicas_total"] = float(len(self.replicas))
        return g

    # ------------------------------------------------------------ dispatch
    def _load(self, i: int) -> int:
        e = self.replicas[i]
        return len(e.scheduler.waiting) + len(e.scheduler.running)

    def _candidates(self, role: str) -> List[int]:
        """Live replica indices eligible for ``role`` ("prefill" admits new
        prompts, "decode" receives handoffs). Non-disagg replicas serve
        both. Disagg degrades gracefully: if every replica of a role died,
        the other side takes over (with handoff disabled — see submit)."""
        want = [i for i in range(len(self.replicas))
                if self.live[i] and self.roles[i] in ("both", role)]
        if want:
            return want
        return [i for i in range(len(self.replicas)) if self.live[i]]

    def _pick(self, req: Request, role: str) -> int:
        cands = self._candidates(role)
        if not cands:
            raise RuntimeError("no live replicas")
        key = None
        if self.paged:
            key = prefix_affinity_key(req.prompt,
                                      self.replicas[cands[0]].cache.page_size,
                                      self.affinity_pages)
        hit = False
        if key is not None and self._affinity.get(key) in cands:
            choice = self._affinity[key]
            # an affinity hit only counts when it overrode least-loaded
            hit = choice != min(cands, key=lambda i: (self._load(i), i))
        else:
            choice = min(cands, key=lambda i: (self._load(i), i))
        if key is not None:
            self._affinity[key] = choice
        self.metrics.on_dispatch(affinity_hit=hit)
        return choice

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            # validate against the REAL budget before any disagg clamp —
            # otherwise the prefill replica admits the 1-token version and
            # the decode-side resubmit blows up mid-handoff
            raise ValueError(
                f"request {req.id}: prompt({len(req.prompt)}) + "
                f"max_new_tokens({req.max_new_tokens}) > "
                f"max_len({self.max_len})")
        idx = self._pick(req, "prefill")
        if (self.disagg and self.roles[idx] == "prefill"
                and req.max_new_tokens > 1):
            # 1-token budget on the prefill side: admit_request then
            # reserves zero worst-case decode pages there — the decode
            # replica re-reserves under its own pool when it adopts
            self._orig_max_new[req.id] = req.max_new_tokens
            req.prefill_only = True
            req.max_new_tokens = 1
        self.replicas[idx].submit(req)
        self._owner[req.id] = idx

    def _on_handoff(self, req: Request) -> None:
        """Engine callback: ``req`` finished prefill + first token on a
        prefill replica and carries its ``Handoff`` payload. Fires inside
        that replica's step(); resubmitting to a *different* engine here
        is safe — only host-side queue state is touched."""
        req.prefill_only = False
        req.max_new_tokens = self._orig_max_new.pop(req.id,
                                                    req.max_new_tokens)
        if req.max_new_tokens <= len(req.generated):
            # budget already satisfied by the prefill token (shouldn't
            # happen: max_new==1 requests skip the handoff path)
            req.handoff = None
            if self._done_cb is not None:
                self._done_cb(req)
            return
        self.metrics.n_handoffs += 1
        idx = self._pick(req, "decode")
        self.replicas[idx].submit(req)
        self._owner[req.id] = idx

    def cancel(self, req: Request) -> None:
        idx = self._owner.get(req.id)
        if idx is not None and self.live[idx]:
            self.replicas[idx].cancel(req)

    # ----------------------------------------------------------- stepping
    def has_work(self) -> bool:
        return any(alive and e.has_work()
                   for e, alive in zip(self.replicas, self.live))

    def warmup(self) -> None:
        for e, alive in zip(self.replicas, self.live):
            if alive:
                e.warmup()

    def step(self) -> bool:
        """One pass over the live replicas, stepping each that has work.
        Single-threaded round-robin: replica steps serialize on the host,
        which keeps every engine-state mutation between steps exactly as
        the single-engine pump does. A replica whose step raises (its own
        bounded retry already gave up) is quarantined and drained."""
        did = False
        for i, e in enumerate(self.replicas):
            if not self.live[i] or not e.has_work():
                continue
            t0 = time.perf_counter()
            try:
                did = e.step() or did
            except Exception as err:     # noqa: BLE001 — replica fence
                self._kill_replica(i, err)
                did = True
            finally:
                self.busy_s[i] += time.perf_counter() - t0
        return did

    def _kill_replica(self, idx: int, err: Exception) -> None:
        """Quarantine replica ``idx`` and drain its queue back through the
        router. In-flight requests resubmit to survivors in original
        arrival order with a fresh arrival stamp (per-engine stamps are
        not comparable across replicas); their tokens regenerate
        deterministically and the stream dedups by index. The dead
        replica's token counts rewind (every replica's, for a request that
        regenerates from its prompt: an adopted one's first token was
        counted on its prefill replica) so the fleet metrics merge stays
        exact. Re-raises when no replica survives."""
        self.live[idx] = False
        self.metrics.n_replica_deaths += 1
        self.metrics.n_replicas_live = self.n_live
        dead = self.replicas[idx]
        if self.roles[idx] == "prefill":
            dead.handoff_cb = None
        stranded = sorted(
            (r for r in (list(dead.scheduler.waiting)
                         + list(dead.scheduler.running.values()))
             if r.state != RequestState.DONE),
            key=lambda r: (r.priority_rank, r.arrival_seq or 0))
        log.error("replica %d died (%s) — draining %d requests to %d "
                  "survivors", idx, err, len(stranded), self.n_live)
        if not any(self.live):
            raise err
        no_prefill = not any(self.live[i] and self.roles[i] != "decode"
                             for i in range(len(self.replicas)))
        for req in stranded:
            req.arrival_seq = None          # new engine, new stamp
            req.slot = None
            # the survivor regenerates them; without a payload it does so
            # from the prompt, the first token too, so a prefill replica's
            # count of an adopted request's first token rewinds as well
            for e in (self.replicas if req.handoff is None else [dead]):
                m = e.metrics.requests.get(req.id)
                if m is not None:
                    m.n_generated = 0
            if req.prefill_only and req.handoff is None and no_prefill:
                # last prefill replica died: survivors decode-role replicas
                # run the request end-to-end instead
                req.prefill_only = False
                req.max_new_tokens = self._orig_max_new.pop(
                    req.id, req.max_new_tokens)
            role = "decode" if (req.handoff is not None
                                or not req.prefill_only) and self.disagg \
                else "prefill"
            tgt = self._pick(req, role if self.disagg else "prefill")
            self.replicas[tgt].submit(req)
            self._owner[req.id] = tgt
            self.metrics.n_drained += 1
