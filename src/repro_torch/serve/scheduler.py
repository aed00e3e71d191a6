"""Request lifecycle + priority admission (copy of ``repro.serve.scheduler``).

A :class:`Request` moves WAITING -> PREFILL -> DECODE -> DONE. The
scheduler owns the waiting queue and the slot free-list; admission orders
by ``(priority class, arrival)`` — strictly FCFS *within* a class, and an
``interactive`` request always outranks a ``batch`` one regardless of
arrival order. ``arrival_seq`` is stamped once at first submit and
survives preemption, so a preempted request rejoins the queue at its
original position among its class. In the slot-dense engine prompts are
right-padded to a *bucket* length (powers of two between ``min_bucket``
and ``max_len``) so the jitted prefill compiles once per bucket, not once
per prompt length — the engine's jit-stable-shapes contract. The paged
engine (``strict_buckets=False``) replaces buckets with fixed-shape
prefill *chunks*: any prompt with ``prompt + max_new_tokens <= max_len``
is admittable (no largest-bucket rejection), and admission can
additionally be gated by a ``can_admit`` predicate (page-pool pressure) —
a blocked queue head blocks everyone behind it (the engine may then
preempt a lower-priority running slot to unblock it; see
``Engine._preempt_for_head``).
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .sampling import SamplingParams

# admission rank per priority class: lower admits first
PRIORITIES = {"interactive": 0, "batch": 1}


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class Request:
    """One generation request. ``eos_id < 0`` disables the EOS stop; the
    request then runs to ``max_new_tokens`` (which always caps it)."""
    id: int
    prompt: np.ndarray                      # (T,) int32 token ids
    max_new_tokens: int = 16
    eos_id: int = -1
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_time: Optional[float] = None    # None -> stamped at submit time
    # priority class: "interactive" admits ahead of "batch" and may preempt
    # it under page-pool pressure (paged engine)
    priority: str = "interactive"
    # SLO deadline annotations (seconds from submit); None = no deadline.
    # Purely observational: attainment is reported per class in
    # ServeMetrics, nothing is dropped for missing a deadline.
    ttft_slo_s: Optional[float] = None
    e2e_slo_s: Optional[float] = None
    # hard deadline: with enforce_deadline=True a request past its
    # ``e2e_slo_s`` is aborted (pages freed within one step,
    # finish_reason="deadline") instead of just missing attainment
    enforce_deadline: bool = False

    # runtime fields owned by the engine
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    # paged-engine prefill progress: tokens already in cache (trie-matched
    # prefix + completed chunks) / tokens skipped via prefix reuse
    prefill_pos: int = 0
    n_matched: int = 0
    # admission order stamp: assigned once at first submit, preserved by
    # preemption so a requeued request keeps its place within its class
    arrival_seq: Optional[int] = None
    n_preemptions: int = 0
    # resilience bookkeeping: why the request finished ("fault" /
    # "deadline"; None = ordinary EOS/length stop), quarantine retry
    # count, and the earliest engine step a quarantined request may
    # re-admit at (exponential backoff; survives resubmit)
    finish_reason: Optional[str] = None
    n_fault_retries: int = 0
    retry_at_step: int = 0
    # disaggregated serving (repro.serve.router): a prefill_only request
    # stops after its first sampled token and migrates — the engine fires
    # handoff_cb with ``handoff`` (an engine.Handoff payload) populated,
    # and the router resubmits it to a decode-role replica, where admission
    # adopts the payload instead of queueing prefill chunks. Both fields
    # survive Scheduler.submit's runtime-field reset (a requeued handoff
    # must still adopt, not re-prefill).
    prefill_only: bool = False
    handoff: Optional[object] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.id}: max_new_tokens must be >= 1")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"request {self.id}: unknown priority {self.priority!r} "
                f"(choose from {sorted(PRIORITIES)})")

    @property
    def priority_rank(self) -> int:
        return PRIORITIES[self.priority]


def make_buckets(min_bucket: int, max_len: int) -> Tuple[int, ...]:
    """Power-of-two prompt buckets in [min_bucket, max_len]."""
    buckets = []
    b = max(int(min_bucket), 1)
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


class Scheduler:
    """Priority queue + slot free-list. The engine calls :meth:`admit` once
    per step; the scheduler never touches device state. The waiting list is
    kept sorted by ``(priority rank, arrival_seq)`` — FCFS within a class,
    interactive ahead of batch across classes."""

    def __init__(self, n_slots: int, max_len: int, min_bucket: int = 16,
                 buckets: Optional[Sequence[int]] = None,
                 strict_buckets: bool = True):
        self.n_slots = n_slots
        self.max_len = max_len
        self.strict_buckets = strict_buckets
        self.buckets = tuple(sorted(buckets)) if buckets else \
            make_buckets(min_bucket, max_len)
        self.waiting: List[Request] = []
        self.free_slots: List[int] = list(range(n_slots))
        self.running: dict = {}             # slot -> Request
        self._arrival_seq = 0               # monotonic submit stamp

    # ------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        budget = len(req.prompt) + req.max_new_tokens
        if budget > self.max_len:
            raise ValueError(
                f"request {req.id}: prompt({len(req.prompt)}) + "
                f"max_new_tokens({req.max_new_tokens}) > max_len({self.max_len})")
        if self.strict_buckets and len(req.prompt) > self.buckets[-1]:
            # reject before a slot is consumed — failing later, mid-admission,
            # would leak the assigned slot and wedge the engine. The paged
            # engine (strict_buckets=False) has no bucket ceiling: long
            # prompts run as a sequence of fixed-shape chunks.
            raise ValueError(
                f"request {req.id}: prompt({len(req.prompt)}) exceeds the "
                f"largest prompt bucket ({self.buckets[-1]})")
        req.state = RequestState.WAITING
        req.slot = None
        req.generated = []          # reset runtime fields: resubmit == fresh
        req.prefill_pos = 0
        req.n_matched = 0
        req.finish_reason = None
        # n_fault_retries / retry_at_step survive: they meter the retry
        # budget across requeues, like arrival_seq meters queue position
        if req.arrival_seq is None:     # preemption requeues keep the stamp
            req.arrival_seq = self._arrival_seq
            self._arrival_seq += 1
        bisect.insort(self.waiting, req,
                      key=lambda r: (r.priority_rank, r.arrival_seq))

    def bucket_len(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def pad_prompt(self, req: Request) -> Tuple[np.ndarray, int]:
        """Right-pad the prompt to its bucket. Returns ((1, Tb) tokens,
        true length). Pad id 0 — padded positions are masked out by the
        length-aware prefill, the value never matters."""
        n = len(req.prompt)
        tb = self.bucket_len(n)
        padded = np.zeros((1, tb), np.int32)
        padded[0, :n] = req.prompt
        return padded, n

    def admit(self, can_admit: Optional[Callable[[Request], bool]] = None,
              max_n: Optional[int] = None,
              eligible: Optional[Callable[[Request], bool]] = None
              ) -> List[Tuple[Request, int]]:
        """Pop waiting requests into free slots (lowest slot first) in
        (priority, arrival) order. ``can_admit`` (paged engine: page-pool
        pressure) gates the queue head — a blocked head blocks everyone
        behind it, keeping admission order stable regardless of which
        slots freed when. The paged engine passes ``max_n=1`` and
        re-checks between admissions, since each admission consumes pages
        the predicate must see. ``eligible`` is different: an ineligible
        request (a quarantined one still in retry backoff) is *skipped*,
        not blocking — its delay is its own, FCFS holds among the
        eligible."""
        out = []
        self.free_slots.sort()
        i = 0
        while i < len(self.waiting) and self.free_slots:
            if max_n is not None and len(out) >= max_n:
                break
            req = self.waiting[i]
            if eligible is not None and not eligible(req):
                i += 1
                continue
            if can_admit is not None and not can_admit(req):
                break
            self.waiting.pop(i)
            slot = self.free_slots.pop(0)
            req.state = RequestState.PREFILL
            req.slot = slot
            self.running[slot] = req
            out.append((req, slot))
        return out

    def requeue(self, req: Request) -> int:
        """Pull a *running* request off its slot and requeue it at its
        original arrival position (``arrival_seq`` survives, runtime fields
        reset — the resubmit machinery re-prefills it from scratch; greedy
        and seeded-sampling regeneration are deterministic, so the final
        output is identical to an uncontended run). Returns the freed slot;
        the engine owns returning the slot's pages."""
        if req.slot is None:
            raise ValueError(f"request {req.id} is not running")
        slot = req.slot
        self.running.pop(slot, None)
        self.free_slots.append(slot)
        req.slot = None
        self.submit(req)
        return slot

    def preempt(self, req: Request) -> int:
        """Requeue + count: the preemption flavor of :meth:`requeue`
        (quarantine requeues use :meth:`requeue` directly and meter their
        own retry budget instead)."""
        req.n_preemptions += 1
        return self.requeue(req)

    def finish(self, req: Request) -> None:
        req.state = RequestState.DONE
        if req.slot is not None:
            self.running.pop(req.slot, None)
            self.free_slots.append(req.slot)
            req.slot = None
        else:
            # cancelling a never-admitted request must pull it out of the
            # waiting queue, or a later admit() would resurrect it
            try:
                self.waiting.remove(req)
            except ValueError:
                pass

    # --------------------------------------------------------------- queries
    @property
    def n_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)
