"""Serving metrics (copy of ``repro.serve.metrics`` without the replica
router's ``RouterMetrics``): per-request TTFT / tok/s / SLO and engine
aggregates.

The engine reports events through :class:`ServeMetrics` with an injectable
clock (tests pass a fake; production uses ``time.perf_counter``). Nothing
here touches the device.

SLO observability: requests carry optional TTFT / end-to-end deadline
annotations and a priority class; :meth:`ServeMetrics.summary` reports
per-class latency percentiles and SLO *attainment* (fraction of finished
deadline-carrying requests that met their deadline), and
:meth:`ServeMetrics.prometheus` renders the same state in Prometheus text
exposition format for the HTTP server's ``/metrics`` endpoint.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

PRIORITY_CLASSES = ("interactive", "batch")


@dataclasses.dataclass
class RequestMetrics:
    id: int
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    n_prompt: int = 0
    n_generated: int = 0
    # speculative decoding: decode steps taken, draft tokens proposed, and
    # draft tokens accepted (non-spec decode counts a step per token with
    # zero proposals, so tokens_per_step degrades to 1.0 and acceptance
    # stays undefined)
    n_decode_steps: int = 0
    n_draft_proposed: int = 0
    n_draft_accepted: int = 0
    # priority / SLO observability
    priority: str = "interactive"
    ttft_slo_s: Optional[float] = None      # deadline, seconds from submit
    e2e_slo_s: Optional[float] = None
    n_preemptions: int = 0
    cancelled: bool = False
    # resilience: quarantine count and terminal reason ("fault" /
    # "deadline"); aborted requests are terminal but never count toward
    # done/latency stats (their timings describe the failure, not serving)
    n_quarantines: int = 0
    finish_reason: Optional[str] = None
    aborted: bool = False

    @property
    def tokens_per_step(self) -> Optional[float]:
        """Mean advance per decode step (1.0 without speculation; up to
        k+1 with it). The first token comes out of prefill, not a decode
        step, so it is excluded."""
        if self.n_decode_steps == 0:
            return None
        return max(self.n_generated - 1, 0) / self.n_decode_steps

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens the target accepted."""
        if self.n_draft_proposed == 0:
            return None
        return self.n_draft_accepted / self.n_draft_proposed

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def decode_tok_s(self) -> Optional[float]:
        """Per-request decode rate over its residency (first token -> done)."""
        if self.t_done is None or self.t_first_token is None:
            return None
        dt = self.t_done - self.t_first_token
        return (self.n_generated - 1) / dt if dt > 0 else float("inf")

    @property
    def queue_wait(self) -> Optional[float]:
        """Submit -> admission (slot + memory became available)."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def e2e_latency(self) -> Optional[float]:
        """Submit -> last token."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft_slo_met(self) -> Optional[bool]:
        """None when no deadline was annotated or no first token landed."""
        if self.ttft_slo_s is None or self.ttft is None:
            return None
        return self.ttft <= self.ttft_slo_s

    @property
    def e2e_slo_met(self) -> Optional[bool]:
        if self.e2e_slo_s is None or self.e2e_latency is None:
            return None
        return self.e2e_latency <= self.e2e_slo_s


class ServeMetrics:
    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.requests: Dict[int, RequestMetrics] = {}
        self.t_start: Optional[float] = None
        self.t_last: Optional[float] = None
        self._occupancy: List[float] = []     # live-slot fraction per step
        self.prefill_tokens_computed = 0      # excludes prefix-reused tokens
        self.prefill_kv_bytes_read = 0        # KV streamed by chunk attention
        self.kv_bytes_reserved = 0            # dense n_slots*max_len equiv
        self.kv_bytes_allocated_peak = 0
        self.kv_bytes_logical_peak = 0
        # priority / SLO observability
        self.queue_depth = 0
        self.queue_depth_peak = 0
        self.n_preemptions: Dict[str, int] = \
            {cls: 0 for cls in PRIORITY_CLASSES}
        self.n_cancelled = 0
        self.n_rejected = 0                   # server backpressure (429)
        # resilience observability
        self.faults_injected: Dict[str, int] = {}   # site -> count
        self.n_quarantines = 0
        self.n_fault_failures = 0             # retries exhausted -> "fault"
        self.n_deadline_aborts = 0
        self.n_shed = 0                       # 503s from the shed stage
        self.n_step_faults = 0                # engine-step exceptions caught
        self.degradation_stage = 0
        self.degradation_transitions = 0

    # ---------------------------------------------------------------- events
    def on_submit(self, req_id: int, n_prompt: int,
                  t: Optional[float] = None, priority: str = "interactive",
                  ttft_slo_s: Optional[float] = None,
                  e2e_slo_s: Optional[float] = None) -> None:
        t = self.clock() if t is None else t
        if self.t_start is None:
            self.t_start = t
        self.requests[req_id] = RequestMetrics(
            id=req_id, t_submit=t, n_prompt=n_prompt, priority=priority,
            ttft_slo_s=ttft_slo_s, e2e_slo_s=e2e_slo_s)

    def on_admit(self, req_id: int) -> None:
        self.requests[req_id].t_admit = self.clock()

    def on_token(self, req_id: int) -> None:
        m = self.requests[req_id]
        m.n_generated += 1
        if m.t_first_token is None:
            m.t_first_token = self.clock()

    def on_preempt(self, req_id: int) -> None:
        """A running request lost its slot and was requeued. Its generated
        tokens will be *regenerated* deterministically, so the token count
        rewinds (on_token fires again for each); t_first_token stays — the
        stream already delivered those tokens."""
        m = self.requests[req_id]
        m.n_preemptions += 1
        m.n_generated = 0
        self.n_preemptions[m.priority] = \
            self.n_preemptions.get(m.priority, 0) + 1

    def on_cancel(self, req_id: int) -> None:
        """Client abandoned the request (disconnect) — terminal, but not a
        completion: the request never counts toward done/SLO stats."""
        self.requests[req_id].cancelled = True
        self.n_cancelled += 1

    def on_reject(self) -> None:
        """Server turned a request away at admission (bounded queue full)."""
        self.n_rejected += 1

    # ------------------------------------------------------------ resilience
    def on_fault_injected(self, site: str) -> None:
        """The chaos injector fired at a named site."""
        self.faults_injected[site] = self.faults_injected.get(site, 0) + 1

    def on_quarantine(self, req_id: int) -> None:
        """Non-finite logits in this request's slot: pages freed, request
        requeued. Like a preemption, its tokens regenerate deterministically
        on retry, so the token count rewinds."""
        m = self.requests[req_id]
        m.n_quarantines += 1
        m.n_generated = 0
        self.n_quarantines += 1

    def on_abort(self, req_id: int, reason: str) -> None:
        """Terminal failure: retry budget exhausted ("fault") or hard
        deadline passed ("deadline"). Terminal but not a completion —
        excluded from done/latency stats, like a cancel."""
        m = self.requests[req_id]
        m.aborted = True
        m.finish_reason = reason
        if reason == "deadline":
            self.n_deadline_aborts += 1
        else:
            self.n_fault_failures += 1

    def on_shed(self) -> None:
        """503 from the shed_batch degradation stage."""
        self.n_shed += 1

    def on_step_fault(self) -> None:
        """An engine-step exception was caught; the step retries."""
        self.n_step_faults += 1

    def on_degradation(self, stage: int) -> None:
        """The degradation ladder moved to ``stage``."""
        self.degradation_stage = stage
        self.degradation_transitions += 1

    def on_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.queue_depth_peak = max(self.queue_depth_peak, depth)

    def on_decode_step(self, req_id: int, n_tokens: int,
                       n_proposed: int = 0, n_accepted: int = 0) -> None:
        """One decode step advanced ``req_id`` by ``n_tokens``. Spec mode
        also reports the draft window: ``n_proposed`` tokens offered,
        ``n_accepted`` of them taken (the +1 bonus token is in
        ``n_tokens`` but not in either draft counter)."""
        m = self.requests[req_id]
        m.n_decode_steps += 1
        m.n_draft_proposed += n_proposed
        m.n_draft_accepted += n_accepted

    def on_done(self, req_id: int) -> None:
        t = self.clock()
        self.requests[req_id].t_done = t
        self.t_last = t

    def on_step(self, n_live: int, n_slots: int) -> None:
        self._occupancy.append(n_live / max(n_slots, 1))

    def on_prefill_tokens(self, n: int) -> None:
        self.prefill_tokens_computed += n

    def on_prefill_kv_read(self, nbytes: int) -> None:
        """KV bytes one prefill chunk's attention streamed (all layers).
        With the flash prefill kernel this grows ∝ actual context depth;
        the dense gather path reads the full laddered block-table width
        per chunk, so the ratio between the two is the kernel's win."""
        self.prefill_kv_bytes_read += nbytes

    def on_kv(self, allocated_bytes: int, logical_bytes: int,
              reserved_bytes: int) -> None:
        """KV-memory snapshot for one step. ``allocated`` is what the cache
        actually holds (paged: pages in use; dense: the full reservation);
        ``logical`` is live-sequence depth × bytes/token — with prefix
        sharing it can exceed ``allocated``; ``reserved`` is the dense
        ``n_slots × max_len`` equivalent. Peaks are kept."""
        self.kv_bytes_reserved = reserved_bytes
        self.kv_bytes_allocated_peak = max(self.kv_bytes_allocated_peak,
                                           allocated_bytes)
        self.kv_bytes_logical_peak = max(self.kv_bytes_logical_peak,
                                         logical_bytes)

    # --------------------------------------------------------------- summary
    def summary(self) -> Dict[str, float]:
        done = [m for m in self.requests.values() if m.t_done is not None]
        ttfts = sorted(m.ttft for m in done if m.ttft is not None)
        waits = sorted(m.queue_wait for m in done if m.queue_wait is not None)
        e2es = sorted(m.e2e_latency for m in done
                      if m.e2e_latency is not None)
        tps = [m.tokens_per_step for m in done
               if m.tokens_per_step is not None]
        total_tokens = sum(m.n_generated for m in done)
        elapsed = ((self.t_last - self.t_start)
                   if done and self.t_start is not None else 0.0)

        def pct(xs, q):
            if not xs:
                return 0.0
            # nearest-rank: ceil(q*n)-1, clamped
            return xs[max(min(math.ceil(q * len(xs)) - 1, len(xs) - 1), 0)]

        per_class = {}
        for cls in PRIORITY_CLASSES:
            cdone = [m for m in done if m.priority == cls]
            cttft = sorted(m.ttft for m in cdone if m.ttft is not None)
            ce2e = sorted(m.e2e_latency for m in cdone
                          if m.e2e_latency is not None)
            per_class.update({
                f"{cls}_n_done": len(cdone),
                f"{cls}_ttft_p50_s": pct(cttft, 0.50),
                f"{cls}_ttft_p95_s": pct(cttft, 0.95),
                f"{cls}_e2e_p50_s": pct(ce2e, 0.50),
                f"{cls}_e2e_p95_s": pct(ce2e, 0.95),
                f"{cls}_ttft_slo_attainment": self.slo_attainment(cls, "ttft"),
                f"{cls}_e2e_slo_attainment": self.slo_attainment(cls, "e2e"),
            })

        return {
            "n_requests": len(self.requests),
            "n_done": len(done),
            "total_tokens": total_tokens,
            "elapsed_s": elapsed,
            "agg_tok_s": total_tokens / elapsed if elapsed > 0 else 0.0,
            "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "ttft_p50_s": pct(ttfts, 0.50),
            "ttft_p95_s": pct(ttfts, 0.95),
            "queue_wait_p50_s": pct(waits, 0.50),
            "queue_wait_p95_s": pct(waits, 0.95),
            "e2e_p50_s": pct(e2es, 0.50),
            "e2e_p95_s": pct(e2es, 0.95),
            "occupancy_mean": (sum(self._occupancy) / len(self._occupancy)
                               if self._occupancy else 0.0),
            "tokens_per_step_mean": (sum(tps) / len(tps) if tps else 0.0),
            "draft_acceptance_rate": (
                sum(m.n_draft_accepted for m in done)
                / max(sum(m.n_draft_proposed for m in done), 1)
                if any(m.n_draft_proposed for m in done) else 0.0),
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_kv_bytes_read": self.prefill_kv_bytes_read,
            "kv_bytes_reserved": self.kv_bytes_reserved,
            "kv_bytes_allocated_peak": self.kv_bytes_allocated_peak,
            "kv_bytes_logical_peak": self.kv_bytes_logical_peak,
            "n_preempted": sum(self.n_preemptions.values()),
            "n_cancelled": self.n_cancelled,
            "n_rejected": self.n_rejected,
            "queue_depth_peak": self.queue_depth_peak,
            "faults_injected_total": sum(self.faults_injected.values()),
            "n_quarantines": self.n_quarantines,
            "n_fault_failures": self.n_fault_failures,
            "n_deadline_aborts": self.n_deadline_aborts,
            "n_shed": self.n_shed,
            "n_step_faults": self.n_step_faults,
            "degradation_stage": self.degradation_stage,
            "degradation_transitions": self.degradation_transitions,
            **per_class,
        }

    def slo_attainment(self, priority: str, kind: str) -> float:
        """Fraction of *finished, deadline-carrying* requests of a class
        that met their deadline (``kind`` is "ttft" or "e2e"). 1.0 when no
        finished request of the class carries that deadline — a vacuous SLO
        is trivially attained, and the stable schema keeps dashboards and
        the bench JSON uniform whether or not deadlines are in use."""
        attr = "ttft_slo_met" if kind == "ttft" else "e2e_slo_met"
        verdicts = [getattr(m, attr) for m in self.requests.values()
                    if m.priority == priority and m.t_done is not None]
        verdicts = [v for v in verdicts if v is not None]
        if not verdicts:
            return 1.0
        return sum(verdicts) / len(verdicts)

    # ------------------------------------------------------------ prometheus
    def families(self, extra_gauges: Optional[Dict[str, float]] = None
                 ) -> List[tuple]:
        """The metric families behind :meth:`prometheus`, as
        ``(name, type, help, samples)`` tuples with ``samples`` a list of
        ``(labels_dict, value)`` pairs. The structured form exists so a
        fleet view (the reference's ``RouterMetrics``) can merge several
        replicas' families into
        ONE exposition (same family emitted once, samples labelled
        ``replica="i"``) — text concatenation would duplicate HELP/TYPE
        headers, which scrapers reject."""
        s = self.summary()
        out: List[tuple] = []

        def metric(name, mtype, help_, samples):
            out.append((name, mtype, help_, samples))

        by_cls = {cls: [m for m in self.requests.values()
                        if m.priority == cls] for cls in PRIORITY_CLASSES}
        metric("repro_serve_requests_total", "counter",
               "Requests submitted, by priority class.",
               [({"priority": c}, len(ms)) for c, ms in by_cls.items()])
        metric("repro_serve_requests_done_total", "counter",
               "Requests finished (EOS or token budget), by priority class.",
               [({"priority": c}, s[f"{c}_n_done"]) for c in PRIORITY_CLASSES])
        metric("repro_serve_tokens_generated_total", "counter",
               "Tokens streamed out across all finished requests.",
               [({}, s["total_tokens"])])
        metric("repro_serve_preemptions_total", "counter",
               "Requests preempted (pages evicted, requeued), by the "
               "preempted request's class.",
               [({"priority": c}, self.n_preemptions.get(c, 0))
                for c in PRIORITY_CLASSES])
        metric("repro_serve_cancelled_total", "counter",
               "Requests cancelled by client disconnect.",
               [({}, self.n_cancelled)])
        metric("repro_serve_rejected_total", "counter",
               "Requests rejected with 429 (admission queue full).",
               [({}, self.n_rejected)])
        metric("repro_serve_queue_depth", "gauge",
               "Current waiting-queue depth.", [({}, self.queue_depth)])
        metric("repro_serve_queue_depth_peak", "gauge",
               "Peak waiting-queue depth.", [({}, self.queue_depth_peak)])
        metric("repro_serve_slot_occupancy", "gauge",
               "Mean live-slot fraction per engine step.",
               [({}, s["occupancy_mean"])])
        metric("repro_serve_ttft_seconds", "summary",
               "Time to first token, by priority class.",
               [({"priority": c, "quantile": q}, s[f"{c}_ttft_p{p}_s"])
                for c in PRIORITY_CLASSES
                for q, p in (("0.5", 50), ("0.95", 95))])
        metric("repro_serve_e2e_seconds", "summary",
               "Submit-to-last-token latency, by priority class.",
               [({"priority": c, "quantile": q}, s[f"{c}_e2e_p{p}_s"])
                for c in PRIORITY_CLASSES
                for q, p in (("0.5", 50), ("0.95", 95))])
        metric("repro_serve_faults_injected_total", "counter",
               "Chaos-injector firings, by site.",
               [({"site": site}, n)
                for site, n in sorted(self.faults_injected.items())]
               or [({}, 0)])
        metric("repro_serve_quarantines_total", "counter",
               "Slots quarantined for non-finite logits (pages freed, "
               "request requeued).", [({}, self.n_quarantines)])
        metric("repro_serve_fault_failures_total", "counter",
               "Requests failed with finish_reason=fault (retry budget "
               "exhausted).", [({}, self.n_fault_failures)])
        metric("repro_serve_deadline_aborts_total", "counter",
               "Requests aborted past their enforced e2e deadline.",
               [({}, self.n_deadline_aborts)])
        metric("repro_serve_shed_total", "counter",
               "batch-class requests shed with 503 at the shed_batch "
               "degradation stage.", [({}, self.n_shed)])
        metric("repro_serve_step_faults_total", "counter",
               "Engine-step exceptions caught and retried.",
               [({}, self.n_step_faults)])
        metric("repro_serve_degradation_stage", "gauge",
               "Current degradation-ladder stage (0=normal 1=no_spec "
               "2=flush_prefix 3=shed_batch).",
               [({}, self.degradation_stage)])
        metric("repro_serve_degradation_transitions_total", "counter",
               "Degradation-ladder stage transitions.",
               [({}, self.degradation_transitions)])
        metric("repro_serve_slo_attainment", "gauge",
               "Fraction of finished deadline-carrying requests that met "
               "their deadline (1.0 when none carry one).",
               [({"priority": c, "slo": k}, s[f"{c}_{k}_slo_attainment"])
                for c in PRIORITY_CLASSES for k in ("ttft", "e2e")])
        for name, val in (extra_gauges or {}).items():
            metric(name, "gauge", "Engine gauge.", [({}, val)])
        return out

    def prometheus(self, extra_gauges: Optional[Dict[str, float]] = None
                   ) -> str:
        """Prometheus text exposition format (v0.0.4) for the ``/metrics``
        endpoint. Counters and gauges cover submissions, completions,
        tokens, preemptions, cancellations, rejections, queue depth, and
        per-class latency quantiles + SLO attainment."""
        return render_prometheus(self.families(extra_gauges))


def render_prometheus(families: List[tuple],
                      labels: Optional[Dict[str, str]] = None) -> str:
    """Render ``(name, type, help, samples)`` families to Prometheus text
    exposition format. Families with the same name are merged under one
    HELP/TYPE header (scrapers reject duplicates), in first-seen order;
    ``labels`` is merged into every sample — how a fleet exposition tags
    each replica's series with ``replica="i"`` while staying one scrape."""
    merged: Dict[str, tuple] = {}
    for name, mtype, help_, samples in families:
        if name not in merged:
            merged[name] = (mtype, help_, [])
        merged[name][2].extend(samples)
    lines: List[str] = []
    for name, (mtype, help_, samples) in merged.items():
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        for lab, value in samples:
            if labels:
                lab = {**lab, **labels}
            txt = ("{" + ",".join(f'{k}="{v}"' for k, v in lab.items()) + "}"
                   if lab else "")
            lines.append(f"{name}{txt} {value:g}")
    return "\n".join(lines) + "\n"


def merge_request_metrics(dst: RequestMetrics,
                          src: RequestMetrics) -> None:
    """Fold ``src`` (the same request's record on another replica) into
    ``dst`` in place. A request can have records on several replicas —
    disaggregation hands it from a prefill replica to a decode replica,
    and a dead replica's drain resubmits it elsewhere. Timings take the
    earliest submit/admit/first-token and the latest done (fleet TTFT is
    measured from the *original* submit); token and step counters sum —
    exact for handoffs because each replica counts disjoint tokens, and
    for drains because the drain rewinds the dead replica's count the way
    a preemption does (the survivor regenerates from scratch)."""
    dst.t_submit = min(dst.t_submit, src.t_submit)
    for f in ("t_admit", "t_first_token"):
        a, b = getattr(dst, f), getattr(src, f)
        if b is not None:
            setattr(dst, f, b if a is None else min(a, b))
    if src.t_done is not None:
        dst.t_done = (src.t_done if dst.t_done is None
                      else max(dst.t_done, src.t_done))
        dst.finish_reason = src.finish_reason
    dst.n_generated += src.n_generated
    dst.n_decode_steps += src.n_decode_steps
    dst.n_draft_proposed += src.n_draft_proposed
    dst.n_draft_accepted += src.n_draft_accepted
    dst.n_preemptions += src.n_preemptions
    dst.n_quarantines += src.n_quarantines
    dst.cancelled = dst.cancelled or src.cancelled
    dst.aborted = dst.aborted or src.aborted
