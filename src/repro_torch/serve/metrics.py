"""Serving metrics (the part of ``repro.serve.metrics`` the engine summary
reads): per-request TTFT and end-to-end latency, aggregate tok/s, slot
occupancy, prefill accounting, KV bytes and the speculative-decoding
counters (tokens per decode step, draft acceptance). The clock is
injectable; nothing here touches the device.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class RequestMetrics:
    id: int
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    n_prompt: int = 0
    n_generated: int = 0
    # decode steps taken, draft tokens proposed and accepted (a non-spec
    # step counts one token and no proposals)
    n_decode_steps: int = 0
    n_draft_proposed: int = 0
    n_draft_accepted: int = 0

    @property
    def tokens_per_step(self) -> Optional[float]:
        """Mean advance per decode step (1.0 without speculation, up to
        k+1 with it); the first token comes from prefill and is left out."""
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
    def queue_wait(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile, as the reference: ceil(q*n)-1, clamped."""
    if not xs:
        return 0.0
    return xs[max(min(math.ceil(q * len(xs)) - 1, len(xs) - 1), 0)]


class ServeMetrics:
    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.requests: Dict[int, RequestMetrics] = {}
        self.t_start: Optional[float] = None
        self.t_last: Optional[float] = None
        self._occupancy: List[float] = []
        self.prefill_tokens_computed = 0
        self.prefill_kv_bytes_read = 0
        self.kv_bytes_reserved = 0
        self.kv_bytes_allocated_peak = 0
        self.kv_bytes_logical_peak = 0
        self.queue_depth_peak = 0

    # ---------------------------------------------------------------- events
    def on_submit(self, req_id: int, n_prompt: int) -> None:
        t = self.clock()
        if self.t_start is None:
            self.t_start = t
        self.requests[req_id] = RequestMetrics(id=req_id, t_submit=t,
                                               n_prompt=n_prompt)

    def on_admit(self, req_id: int) -> None:
        self.requests[req_id].t_admit = self.clock()

    def on_token(self, req_id: int) -> None:
        m = self.requests[req_id]
        m.n_generated += 1
        if m.t_first_token is None:
            m.t_first_token = self.clock()

    def on_decode_step(self, req_id: int, n_tokens: int,
                       n_proposed: int = 0, n_accepted: int = 0) -> None:
        """One decode step advanced ``req_id`` by ``n_tokens``; a spec step
        also reports its draft window: ``n_proposed`` offered, ``n_accepted``
        taken (the bonus token is in ``n_tokens`` only)."""
        m = self.requests[req_id]
        m.n_decode_steps += 1
        m.n_draft_proposed += n_proposed
        m.n_draft_accepted += n_accepted

    def on_done(self, req_id: int) -> None:
        t = self.clock()
        self.requests[req_id].t_done = t
        self.t_last = t

    def on_queue_depth(self, depth: int) -> None:
        self.queue_depth_peak = max(self.queue_depth_peak, depth)

    def on_step(self, n_live: int, n_slots: int) -> None:
        self._occupancy.append(n_live / max(n_slots, 1))

    def on_prefill_tokens(self, n: int) -> None:
        self.prefill_tokens_computed += n

    def on_prefill_kv_read(self, nbytes: int) -> None:
        """KV bytes one prefill chunk's attention read (all layers)."""
        self.prefill_kv_bytes_read += nbytes

    def on_kv(self, allocated_bytes: int, logical_bytes: int,
              reserved_bytes: int) -> None:
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
        e2es = sorted(m.e2e_latency for m in done)
        total_tokens = sum(m.n_generated for m in done)
        elapsed = ((self.t_last - self.t_start)
                   if done and self.t_start is not None else 0.0)
        tps = [m.tokens_per_step for m in done
               if m.tokens_per_step is not None]
        proposed = sum(m.n_draft_proposed for m in done)
        return {
            "n_requests": len(self.requests),
            "n_done": len(done),
            "total_tokens": total_tokens,
            "elapsed_s": elapsed,
            "agg_tok_s": total_tokens / elapsed if elapsed > 0 else 0.0,
            "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "ttft_p50_s": _pct(ttfts, 0.50),
            "ttft_p95_s": _pct(ttfts, 0.95),
            "queue_wait_p50_s": _pct(waits, 0.50),
            "queue_wait_p95_s": _pct(waits, 0.95),
            "e2e_p50_s": _pct(e2es, 0.50),
            "e2e_p95_s": _pct(e2es, 0.95),
            "occupancy_mean": (sum(self._occupancy) / len(self._occupancy)
                               if self._occupancy else 0.0),
            "tokens_per_step_mean": sum(tps) / len(tps) if tps else 0.0,
            "draft_acceptance_rate": (
                sum(m.n_draft_accepted for m in done) / proposed
                if proposed else 0.0),
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_kv_bytes_read": self.prefill_kv_bytes_read,
            "kv_bytes_reserved": self.kv_bytes_reserved,
            "kv_bytes_allocated_peak": self.kv_bytes_allocated_peak,
            "kv_bytes_logical_peak": self.kv_bytes_logical_peak,
            "queue_depth_peak": self.queue_depth_peak,
        }
