"""Continuous-batching engine (the port of ``repro.serve.engine``: the
slot-dense and the paged memory models).

Each :meth:`Engine.step` admits waiting requests into free slots, then runs
one batched decode of every slot, emits each live slot's token and
finishes requests at EOS or ``max_new_tokens``. The memory model is chosen
at construction:

* **paged** (``paged=True``, the port's default): admission only builds
  the block table (one request at a time while the page pool can hold it,
  reusing trie-cached prefix pages); prefill chunks run FCFS under the
  per-step token budget — fixed-shape, page-multiple chunks, each
  attending over a power-of-two ladder of block-table columns, the final
  one sampling the first token; the decode runs over an active block-table
  width that tracks the deepest live sequence (power-of-two ladder), the
  ``live`` mask keeping mid-prefill rows from writing.
* **slot-dense** (``paged=False``, the reference's default): every slot
  reserves ``max_len`` K/V rows (:class:`SlotCache`). Admission prefills
  one request, right-padded to its bucket (the strict-bucket
  :class:`Scheduler`; a prompt past the largest bucket is refused at
  submit), samples its first token and writes the batch-1 caches into its
  slot; the decode runs every slot, each at its own depth.

Speculative decoding (paged only; ``spec_draft=(model, params)``,
``spec_k``): a draft model with its own page pool mirrors every prefill
chunk, proposes ``spec_k`` tokens per step, and the target scores the
``(k+1)``-token window in one :meth:`Model.verify_step`; acceptance
advances each row by 1..k+1 tokens and both pools roll back to the
accepted depth. One token-keyed prefix trie serves both pools. Greedy spec
output is token for token the non-spec greedy output.

Where the reference compiles one program per rung of the width ladder (or
per prompt bucket), the port captures one CUDA graph (:mod:`.graphs`) per
(program, rung): the paged decode step, the draft's decode step, the
verify window, the prefill chunk (final and not) and the draft's mirror
chunk at each width; the dense admission at each bucket and the dense
decode at ``n_slots``. Each reads static input buffers the engine fills
before a replay (pending tokens, block tables, the live mask, accepted
depths, the chunk's or the prompt's tokens and its slot, start and length
as device scalars) and writes the caches in place. A graph is captured on
first use or by :meth:`Engine.warmup`, which captures them all, as the
reference's ``warmup`` compiles the paged ladder. Sampling stays eager
between replays, with each request's generator on the host side: a
speculative step is ``spec_k`` replays of the draft decode, each followed
by ``propose_token``, then one verify replay. ``graphs=False`` runs every
program eagerly (what ``jax.disable_jit`` is to the reference); engines on
the CPU always do.

Greedy output is token-for-token what the reference engine produces on the
same params and prompts, in both memory models. A model with mamba or rwkv
blocks keeps one state row a slot beside the pools: its prompts prefill
chunk by chunk (the paged engine; no prefix reuse) or at once (dense) and
its slots decode one token a step (no speculation); a freed slot keeps
its state, which a non-live row reads, until its next request's first
chunk, as in the reference.

The serving surface around the step, as the reference's: priority
admission with preemption by page eviction (paged; ``preemption``),
``cancel``, the ``token_cb`` / ``done_cb`` streaming hooks, and the
watchdog of :mod:`.resilience` (``resilience=``; a bare engine gets the
inert default). Every decode, verify and draft decode adds the injector's
per-slot logit poison (only in a step that schedules one) to the logits a
program returns, and a per-slot finite check rides the sampled tokens'
one copy to the host; a non-finite row is quarantined (pages freed, the
request requeued with backoff, after ``max_fault_retries`` failed with
``finish_reason="fault"``) while the other rows go on untouched. An
exception in a decode step is retried next step (the injected
``engine_step`` fault fires before the step writes anything; a recurrent
layer's state, which the decode program advances in place, is put back
from a copy taken just before it) and re-raised after
``max_consecutive_step_faults``. Deadlines abort
``enforce_deadline`` requests; the degradation ladder holds speculation
off (``spec_suspended``: the plain paged decode serves), flushes the
prefix trie and suspends publishing.

Disaggregated serving (:mod:`.router`, ``disagg=True``): a prefill-role
engine runs a ``prefill_only`` request to its first token, gathers the
prompt's pages out of every attention pool (:meth:`Engine.extract_handoff`)
and hands the :class:`Handoff` to the router's ``handoff_cb``; a
decode-role engine adopts it (:meth:`Engine._admit_handoff`): the usual
reservation-accounted admission, the pages scattered into its pools, the
slot armed with the first token and the request's generator state, so a
sampled stream goes on as it would on one engine. The gather and the
scatter are programs like the others ("gather", "adopt"), captured per
power-of-two page width by the warmup of an engine the router gave a role.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from . import sampling as sampling_lib
from .cache import (NULL_PAGE, PagedCache, SlotCache, publish_prefix_shared,
                    share_trie)
from .graphs import StepGraph
from .metrics import ServeMetrics
from .resilience import STAGE_NAMES, Resilience
from .scheduler import Request, RequestState, Scheduler

log = logging.getLogger("repro_torch.serve.engine")


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# the engine's programs (one graph each per width rung; the dense
# admission's rung is its prompt bucket, the dense decode's n_slots; the
# handoff's gather and adopt rungs are page widths)
PROGRAMS = ("decode", "draft_decode", "verify", "chunk", "chunk_final",
            "draft_chunk", "admit", "decode_dense", "gather", "adopt")


@dataclasses.dataclass
class Handoff:
    """Prefill-to-decode migration payload (disaggregated serving): the
    prompt's page contents per attention position (gathered before the
    prefill engine freed them, padded to a power-of-two ``width`` with
    null-page columns), the first sampled token, the prompt depth, and the
    state of the request's sampling generator after the first draw (None
    when greedy). Block tables stay per engine: the receiver builds its own
    through the usual admission."""
    prompt_len: int
    n_pages: int                 # real pages; <= width (pow-2 padded)
    width: int
    first_token: int
    # per block {"kp", "vp"} or None; out of the repr (tens of MB of K/V)
    pages: List[Optional[Dict[str, Any]]] = dataclasses.field(repr=False)
    gen_state: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                          repr=False)


class Engine:
    """Continuous-batching engine around one model and its params. The
    device is the params' device. ``paged`` picks the memory model (the
    port's default True; the reference's is False, and its launcher passes
    ``--paged`` through, as the port's does); ``min_bucket`` / ``buckets``
    set the dense engine's prompt buckets, ``page_size`` / ``n_pages`` /
    ``prefill_chunk_tokens`` the paged one's pool and chunks.
    ``spec_draft=(model, params)`` turns on speculative decoding (paged
    only) with ``spec_k`` proposals a step (the draft's params on the same
    device). ``graphs``: None captures the programs as CUDA graphs on a
    CUDA device and runs them eagerly on the CPU; True demands the graphs
    (a CPU device raises); False runs eagerly.

    ``preemption`` lets an interactive head evict a batch slot (paged
    only); ``resilience`` is the watchdog, injector and ladder bundle.

    ``runs`` counts each program's runs (eager calls and replays);
    with ``time_programs`` set, ``run_ms`` records each run's host ms on a
    synchronised clock. ``n_captures`` counts the graphs captured."""

    def __init__(self, model, params, *, n_slots: int = 8, max_len: int = 128,
                 min_bucket: int = 16, buckets: Optional[Sequence[int]] = None,
                 paged: bool = True, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 spec_draft=None, spec_k: int = 4,
                 graphs: Optional[bool] = None,
                 preemption: bool = True,
                 resilience: Optional[Resilience] = None):
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError(f"{cfg.name}: encoder-only arch has no decode step")
        if cfg.frontend != "token":
            raise ValueError(
                f"{cfg.name}: the engine serves token frontends only "
                "(embed-frontend archs have no incremental token stream)")
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        # mamba or rwkv blocks: state a decode step advances in place
        self.recurrent = not model.spec_decode_supported
        self.n_slots = n_slots
        self.max_len = max_len
        self.paged = paged
        self.metrics = ServeMetrics()
        self.step_count = 0
        # the watchdog is always on; the injector and the ladder act when
        # the caller's bundle has them
        self.resilience = (resilience if resilience is not None
                           else Resilience())
        if self.resilience.injector is not None:
            self.resilience.injector.on_inject = self.metrics.on_fault_injected
        if self.resilience.ladder is not None:
            self.resilience.ladder.on_transition = self._on_ladder_transition
        self.n_quarantines = 0
        self.n_fault_failures = 0
        self.n_deadline_aborts = 0
        if graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device; the params "
                             f"are on {self.device}")
        self.use_graphs = bool(graphs)

        self.spec_k = int(spec_k)
        self.spec_active = False
        self.draft_model = self.draft_params = None
        self.draft_cache: Optional[PagedCache] = None
        if spec_draft is not None:
            if not paged:
                raise ValueError("spec_draft requires paged=True (rollback "
                                 "is block-table truncation)")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            draft_model, draft_params = spec_draft
            if draft_model.cfg.vocab != cfg.vocab:
                raise ValueError(f"draft vocab {draft_model.cfg.vocab} != "
                                 f"target vocab {cfg.vocab}")
            if (model.spec_decode_supported
                    and draft_model.spec_decode_supported):
                self.spec_active = True
                self.draft_model, self.draft_params = spec_draft
            else:
                log.info("recurrent blocks cannot re-score a token window: "
                         "speculative decoding off, using the plain decode "
                         "loop")
        self.n_prefill_chunks = 0
        self.n_prefill_tokens = 0           # computed
        self.n_prefill_tokens_skipped = 0   # reused from the trie
        if paged:
            slack = self.spec_k if self.spec_active else 0
            self.cache = PagedCache(model, n_slots, max_len,
                                    page_size=page_size, n_pages=n_pages,
                                    device=self.device, slack_tokens=slack)
            self.cache.injector = self.resilience.injector
            if self.spec_active:
                self.draft_cache = PagedCache(
                    self.draft_model, n_slots, max_len, page_size=page_size,
                    n_pages=n_pages, device=self.device, slack_tokens=slack)
                self.draft_cache.injector = self.resilience.injector
                # one token-keyed trie: draft and target hit a prefix as a
                # unit
                share_trie([self.cache, self.draft_cache])
            # chunks replace buckets: no largest-bucket rejection
            self.scheduler = Scheduler(n_slots, max_len,
                                       strict_buckets=False)
            ps = self.cache.page_size
            if prefill_chunk_tokens is None:
                prefill_chunk_tokens = min(4 * ps, self.cache.max_pages * ps)
            if prefill_chunk_tokens % ps:
                raise ValueError(
                    f"prefill_chunk_tokens({prefill_chunk_tokens}) must be a "
                    f"multiple of page_size({ps})")
            self.chunk_tokens = prefill_chunk_tokens
            self._prefill_queue: Deque[Request] = collections.deque()
        else:
            self.scheduler = Scheduler(n_slots, max_len,
                                       min_bucket=min_bucket, buckets=buckets)
            self.cache = SlotCache(model, n_slots, max_len,
                                   device=self.device)

        # per-slot sampling state: the pending token lives on the device,
        # the policy on the host
        self._temps = [0.0] * n_slots
        self._top_ks = [0] * n_slots
        self._gens: List[Optional[torch.Generator]] = [None] * n_slots
        self._live = np.zeros((n_slots,), bool)
        self._live_sent: Optional[np.ndarray] = None

        # the programs' static inputs: filled in place before a run, never
        # rebound (a graph holds the addresses it was captured with);
        # per-width tables and rows are made on first use
        dev, B = self.device, n_slots
        self._tokens = torch.zeros((B,), dtype=torch.long, device=dev)
        self._live_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        if paged:
            self._chunk_toks = torch.zeros((1, self.chunk_tokens),
                                           dtype=torch.long, device=dev)
            # the chunk's slot, start and chunk_len, read as 0-d views
            self._chunk_info = torch.zeros((3,), dtype=torch.int32,
                                           device=dev)
        self._tables: Dict[Tuple[bool, int], torch.Tensor] = {}
        self._tables_fresh: Dict[bool, Set[int]] = {False: set(),
                                                    True: set()}
        self._rows: Dict[Tuple[bool, int], torch.Tensor] = {}
        if not paged:
            # the admitted prompt per bucket, its (slot, length) as 0-d
            # views, and the batch-1 caches its prefill fills
            self._prompts: Dict[int, torch.Tensor] = {}
            self._admit_info = torch.zeros((2,), dtype=torch.int32,
                                           device=dev)
            self._admit_caches = model.init_caches(1, max_len, device=dev)
        # each live slot's accepted depth, written before every decode
        self._pos0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        # the model's recurrent state and its copy from just before each
        # decode program: a fault in or after the program puts the state
        # back, so the retry advances it once
        self._state = model.recurrent_state(self.cache.caches)
        self._state_copy = [torch.empty_like(t) for t in self._state]
        if self.spec_active:
            self._draft_in = torch.zeros((B,), dtype=torch.long, device=dev)
            self._window = torch.zeros((B, self.spec_k + 1),
                                       dtype=torch.long, device=dev)

        self._graphs: Dict[Tuple[str, int], StepGraph] = {}
        self.n_captures = 0
        self.runs = {k: 0 for k in PROGRAMS}
        self.run_ms: Dict[str, List[float]] = {k: [] for k in PROGRAMS}
        self.time_programs = False

        # streaming hooks (the HTTP server wires them): token_cb fires for
        # every emitted token with its index in the request's output (a
        # preempted or quarantined request regenerates and fires again from
        # index 0, so consumers dedup by index); done_cb once at a stop or
        # a terminal failure, never for a cancel or a preemption
        self.token_cb: Optional[Callable[[Request, int, int], None]] = None
        self.done_cb: Optional[Callable[[Request], None]] = None
        # disaggregation (the router wires these): handoff_cb fires instead
        # of done_cb when a ``prefill_only`` request reaches its clamped
        # budget without EOS, ``req.handoff`` already extracted;
        # handoff_role ("prefill" or "decode") says which handoff programs
        # warmup captures
        self.handoff_cb: Optional[Callable[[Request], None]] = None
        self.handoff_role: Optional[str] = None
        self.n_handoffs_out = 0
        self.n_handoffs_in = 0
        if paged:
            # the handoff programs' static inputs: the page ids per width,
            # the adopted slot as a (1,) index and its depth, the payload
            # staged per width
            self._handoff_ids: Dict[int, torch.Tensor] = {}
            self._adopt_slot = torch.zeros((1,), dtype=torch.long,
                                           device=dev)
            self._adopt_pos = torch.zeros((1,), dtype=torch.int32,
                                          device=dev)
            self._adopt_pages: Dict[int, list] = {}
        # interactive-over-batch preemption evicts pages: paged only
        self.preemption = bool(preemption) and paged
        self.n_preemptions = 0

    # -------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)
        self.metrics.on_submit(req.id, len(req.prompt),
                               priority=req.priority,
                               ttft_slo_s=req.ttft_slo_s,
                               e2e_slo_s=req.e2e_slo_s)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def stats_gauges(self) -> Dict[str, float]:
        """Instantaneous engine gauges for the ``/metrics`` scrape."""
        g = {
            "repro_serve_slots_live": float(self._live.sum()),
            "repro_serve_slots_total": float(self.n_slots),
            "repro_serve_engine_steps_total": float(self.step_count),
        }
        if self.paged:
            g["repro_serve_kv_pages_allocated"] = float(
                self.cache.pool.allocated_count)
            g["repro_serve_kv_pages_free"] = float(self.cache.pool.free_count)
        return g

    def _vacate(self, req: Request, keep: bool = False) -> None:
        """Take ``req`` out of the prefill queue and free its slot, if it
        holds one: its page refs and reservation in every pool (``keep``:
        the request comes back, :meth:`PagedCache.preempt_slot`), its
        liveness and its sampling state (a freed slot reads greedy, as the
        reference's ``_clear_slot_impl``). The scheduler's bookkeeping is
        the caller's."""
        # found by identity first: a miss's ValueError would format the
        # request's repr, a handoff's page tensors and all
        if self.paged and any(r is req for r in self._prefill_queue):
            self._prefill_queue.remove(req)
        slot = req.slot
        if slot is None:
            return
        if self.paged:
            for c in (self.cache, self.draft_cache):
                if c is not None:
                    (c.preempt_slot if keep else c.free_slot)(slot)
        self._live[slot] = False
        self._temps[slot], self._top_ks[slot] = 0.0, 0
        self._gens[slot] = None

    def cancel(self, req: Request) -> None:
        """Abort a request (client disconnect): out of whichever stage it is
        in, its pages back to the pool at once. Safe between steps; a no-op
        once the request is DONE."""
        if req.state == RequestState.DONE:
            return
        self._vacate(req)
        self.scheduler.finish(req)
        self.metrics.on_cancel(req.id)
        log.info("request %d cancelled (%s, %d tokens streamed)",
                 req.id, req.priority, len(req.generated))

    # ----------------------------------------------------------- preemption
    def _preempt(self, victim: Request) -> None:
        """Evict ``victim`` from its slot: its non-shared pages go back to
        the pool (trie-shared prefix pages survive), the slot frees, and
        the request requeues at its original arrival position; it
        regenerates from its prompt on re-admission."""
        slot = victim.slot
        self._vacate(victim, keep=True)
        self.scheduler.preempt(victim)
        self.metrics.on_preempt(victim.id)
        self.n_preemptions += 1
        log.info("preempted request %d (%s, slot %d, %d tokens in) for a "
                 "higher-priority admission", victim.id, victim.priority,
                 slot, len(victim.generated))

    def _preempt_for_head(self) -> bool:
        """The queue head cannot admit: evict the lowest-priority running
        request (youngest first within its class) if it ranks strictly
        below the head. The head is the first *eligible* waiter: a
        quarantined request in backoff is skipped by admission, so
        evicting for it would make no progress. Returns True if a slot was
        evicted."""
        if not self.preemption or not self.scheduler.waiting:
            return False
        head = next((r for r in self.scheduler.waiting
                     if self._retry_eligible(r)), None)
        if head is None:
            return False
        victims = [r for r in self.scheduler.running.values()
                   if r.priority_rank > head.priority_rank]
        if not victims:
            return False
        self._preempt(max(victims,
                          key=lambda r: (r.priority_rank, r.arrival_seq)))
        return True

    # ------------------------------------------------------------ step logic
    def _admit_one(self, req: Request, slot: int) -> None:
        """Slot-dense admission, one program run: the prompt right-padded
        to its bucket is prefilled at batch 1 and its caches written into
        ``slot``; the first token is sampled from its logits."""
        padded, n = self.scheduler.pad_prompt(req)
        self.metrics.on_admit(req.id)
        bucket = padded.shape[1]
        self._put(self._prompt(bucket), padded)
        self._put(self._admit_info, np.array([slot, n], np.int32))
        logits = self._run("admit", bucket)
        self._live[slot] = True
        req.state = RequestState.DECODE
        self._emit(req, self._arm_slot(req, slot, logits[0]))

    def _admit_one_paged(self, req: Request, slot: int) -> None:
        """Bookkeeping only: the block table (reusing trie-matched prefix
        pages) and a place in the prefill queue. A request that carries a
        :class:`Handoff` adopts its pages instead."""
        self.metrics.on_admit(req.id)
        if req.handoff is not None:
            self._admit_handoff(req, slot)
            return
        matched = self.cache.admit_request(slot, req.prompt,
                                           req.max_new_tokens)
        if self.spec_active:
            # the shared trie matches the same prefix in both pools
            dmatched = self.draft_cache.admit_request(slot, req.prompt,
                                                      req.max_new_tokens)
            assert dmatched == matched, (dmatched, matched)
        req.prefill_pos = matched
        req.n_matched = matched
        self.n_prefill_tokens_skipped += matched
        self._prefill_queue.append(req)

    def _arm_slot(self, req: Request, slot: int, first_logits: torch.Tensor):
        """Sample the first token from the prompt's logits (the final
        chunk's, paged) and set the slot's sampling state (the reference's
        ``_set_slot_impl``)."""
        sp = req.sampling
        gen = (sampling_lib.make_generator(sp.seed, self.device)
               if sp.temperature > 0 else None)
        self._temps[slot], self._top_ks[slot] = sp.temperature, sp.top_k
        self._gens[slot] = gen
        tok = sampling_lib.sample_one(first_logits, sp.temperature, sp.top_k,
                                      gen)
        self._tokens[slot] = tok
        return int(tok)

    # ------------------------------------------------ disaggregated serving
    def extract_handoff(self, req: Request) -> Handoff:
        """Gather the prompt's page contents for a decode-role engine. Runs
        while the request still owns its block-table row and its generator
        (``_emit`` calls it before the stop path frees them)."""
        assert self.paged and req.slot is not None
        n_tok = len(req.prompt)
        n_pages = self.cache.pages_for(n_tok)
        width = min(_next_pow2(n_pages), self.cache.max_pages)
        ids = np.full((width,), NULL_PAGE, np.int64)
        ids[:n_pages] = self.cache.block_tables[req.slot][:n_pages]
        self._put(self._ids(width), ids)
        pages = self._run("gather", width)
        if self.use_graphs:
            # the graph's outputs are rewritten by its next replay
            pages = [None if p is None else {k: v.clone() for k, v in p.items()}
                     for p in pages]
        gen = self._gens[req.slot]
        self.n_handoffs_out += 1
        return Handoff(prompt_len=n_tok, n_pages=n_pages, width=width,
                       first_token=int(req.generated[0]), pages=pages,
                       gen_state=None if gen is None else gen.get_state())

    def _admit_handoff(self, req: Request, slot: int) -> None:
        """Adopt a prefilled request: the reservation-accounted admission
        builds the block table (``can_admit`` already cleared the worst-case
        page count, so a handoff cannot deadlock the pool), the payload is
        scattered into every prompt page (trie-matched ones too: they
        receive the bytes they hold, and one program per width serves
        every match), and the slot is armed with the first token and the
        generator resumed after its first draw. No token is emitted: index
        0 streamed from the prefill engine."""
        h: Handoff = req.handoff
        assert h.prompt_len == len(req.prompt)
        matched = self.cache.admit_request(slot, req.prompt,
                                           req.max_new_tokens)
        ids = np.full((h.width,), NULL_PAGE, np.int64)
        ids[:h.n_pages] = self.cache.block_tables[slot][:h.n_pages]
        self._put(self._ids(h.width), ids)
        for dst, src in zip(self._staged(h.width), h.pages):
            if dst is not None:
                for k in dst:
                    dst[k].copy_(src[k])
        self._adopt_slot.fill_(slot)
        self._adopt_pos.fill_(h.prompt_len)
        self._run("adopt", h.width)
        sp = req.sampling
        gen = None
        if h.gen_state is not None:
            gen = sampling_lib.make_generator(sp.seed, self.device)
            gen.set_state(h.gen_state)
        self._temps[slot], self._top_ks[slot] = sp.temperature, sp.top_k
        self._gens[slot] = gen
        self._tokens[slot] = h.first_token
        req.handoff = None
        req.prefill_pos = h.prompt_len
        req.n_matched = matched
        req.generated = [h.first_token]
        req.state = RequestState.DECODE
        self._live[slot] = True
        # adopted pages hold real K/V: later handoffs of the same prefix
        # adopt into cached pages
        self.cache.publish_prefix(req.prompt, slot, h.prompt_len)
        self.n_handoffs_in += 1

    def _prefill_chunks(self) -> bool:
        """Run prefill chunks FCFS under the per-step token budget (one
        chunk's worth); arm slots whose final chunk lands. Returns True if any
        chunk ran."""
        budget = self.chunk_tokens
        ran = False
        while budget > 0 and self._prefill_queue:
            req = self._prefill_queue[0]
            slot = req.slot
            pos = req.prefill_pos
            plen = len(req.prompt)
            tc = self.chunk_tokens
            n_real = min(plen - pos, tc)
            toks = np.zeros((1, tc), np.int64)
            toks[0, :n_real] = req.prompt[pos:pos + n_real]
            # the chunk attends over [0, pos + tc): only that many block-
            # table columns (power-of-two ladder, like decode)
            ctx_pages = min(_next_pow2(self.cache.pages_for(pos + tc)),
                            self.cache.max_pages)
            final = pos + n_real >= plen
            self._put(self._chunk_toks, toks)
            self._put(self._chunk_info, np.array([slot, pos, n_real],
                                                 np.int32))
            self._put(self._row(ctx_pages),
                      self.cache.block_tables[slot][:ctx_pages])
            logits = self._run("chunk_final" if final else "chunk",
                               ctx_pages)
            if self.spec_active:
                # the draft's mirror of the chunk into its own pool; its
                # logits are never sampled (the target samples), so no
                # unembed
                dc = self.draft_cache
                dctx = min(_next_pow2(dc.pages_for(pos + tc)), dc.max_pages)
                self._put(self._row(dctx, draft=True),
                          dc.block_tables[slot][:dctx])
                self._run("draft_chunk", dctx)
            # the kernel reads only the pages at or below the causal horizon
            pages_read = min(self.cache.pages_for(pos + n_real), ctx_pages)
            self.metrics.on_prefill_kv_read(
                int(pages_read * self.cache.page_size * self.cache.token_bytes))
            req.prefill_pos = pos + n_real
            self.n_prefill_chunks += 1
            self.n_prefill_tokens += n_real
            self.metrics.on_prefill_tokens(n_real)
            budget -= tc
            ran = True
            # the chunk's full prompt pages now hold real K/V -> shareable
            if self.spec_active:
                publish_prefix_shared([self.cache, self.draft_cache],
                                      req.prompt, slot, req.prefill_pos,
                                      from_tokens=pos)
            else:
                self.cache.publish_prefix(req.prompt, slot, req.prefill_pos,
                                          from_tokens=pos)
            if final:
                self._prefill_queue.popleft()
                self._live[slot] = True
                req.state = RequestState.DECODE
                self._emit(req, self._arm_slot(req, slot, logits[0]))
        return ran

    # ------------------------------------------------ programs and inputs
    @staticmethod
    def _put(buf: torch.Tensor, host: np.ndarray) -> None:
        """Copy host values into a static input buffer, in place (a small
        host-to-device copy the host does not wait for)."""
        buf.copy_(torch.from_numpy(np.ascontiguousarray(host)),
                  non_blocking=True)

    def _static(self, store: dict, key, shape,
                dtype=torch.int32) -> torch.Tensor:
        """The buffer ``store[key]``, made on first use."""
        buf = store.get(key)
        if buf is None:
            buf = store[key] = torch.zeros(shape, dtype=dtype,
                                           device=self.device)
        return buf

    def _prompt(self, bucket: int) -> torch.Tensor:
        """The static ``(1, bucket)`` prompt of a dense admission."""
        buf = self._prompts.get(bucket)
        if buf is None:
            buf = self._prompts[bucket] = torch.zeros(
                (1, bucket), dtype=torch.long, device=self.device)
        return buf

    def _row(self, width: int, draft: bool = False) -> torch.Tensor:
        """The static block-table row of a prefill chunk ``width`` wide."""
        return self._static(self._rows, (draft, width), (width,))

    def _ids(self, width: int) -> torch.Tensor:
        """The static page ids ``(width,)`` of a handoff's gather or adopt
        (int64: ``index_copy_`` takes no other)."""
        return self._static(self._handoff_ids, width, (width,), torch.long)

    def _staged(self, width: int) -> list:
        """The static payload an adoption ``width`` pages wide scatters:
        per block, ``{"kp", "vp"}`` of ``(n_periods, width, page_size, Kh,
        Dh)`` or None for a recurrent block."""
        buf = self._adopt_pages.get(width)
        if buf is None:
            buf = self._adopt_pages[width] = [
                {k: c[k].new_zeros((c[k].shape[0], width) + c[k].shape[2:])
                 for k in ("kp", "vp")} if "kp" in c else None
                for c in self.cache.caches]
        return buf

    def _live_mask_dev(self) -> torch.Tensor:
        """The static liveness mask, re-uploaded only on change."""
        if self._live_sent is None or not np.array_equal(self._live_sent,
                                                         self._live):
            self._put(self._live_dev, self._live)
            self._live_sent = self._live.copy()
        return self._live_dev

    def _block_tables_dev(self, width: int, draft: bool = False
                          ) -> torch.Tensor:
        """The static copy of the first ``width`` block-table columns of the
        target's pool (the draft's with ``draft``): one buffer per width,
        refilled only when the host table has changed since."""
        cache = self.draft_cache if draft else self.cache
        fresh = self._tables_fresh[draft]
        if cache.dirty:
            fresh.clear()
            cache.dirty = False
        buf = self._static(self._tables, (draft, width),
                           (self.n_slots, width))
        if width not in fresh:
            self._put(buf, cache.block_tables[:, :width])
            fresh.add(width)
        return buf

    def _program(self, kind: str, width: int):
        """Program ``kind`` at ``width`` as a function of the static
        inputs alone; returns its logits (None for a draft chunk)."""
        m, p, caches = self.model, self.params, self.cache.caches
        live = self._live_dev
        if kind == "decode_dense":
            return lambda: m.decode_step(p, self._tokens, caches)[0]
        if kind == "admit":
            prompt, scratch = self._prompt(width), self._admit_caches
            slot, n = self._admit_info.unbind(0)

            def admit():
                # the reference prefills into fresh zero caches
                for c in scratch:
                    for t in c.values():
                        t.zero_()
                logits, new = m.prefill(p, prompt, scratch,
                                        lengths=n.reshape(1))
                self.cache._write_impl(caches, new, slot)
                return logits
            return admit
        if kind == "decode":
            bt = self._block_tables_dev(width)
            return lambda: m.decode_step(p, self._tokens, caches, bt,
                                         live=live)[0]
        if kind == "gather":
            ids = self._ids(width)
            return lambda: [{k: c[k].index_select(1, ids)
                             for k in ("kp", "vp")} if "kp" in c else None
                            for c in caches]
        if kind == "adopt":
            ids, staged = self._ids(width), self._staged(width)
            slot, pos = self._adopt_slot, self._adopt_pos

            def adopt():
                for c, src in zip(caches, staged):
                    if src is not None:
                        c["kp"].index_copy_(1, ids, src["kp"])
                        c["vp"].index_copy_(1, ids, src["vp"])
                        c["pos"].index_copy_(
                            1, slot, pos.expand(c["pos"].shape[0], 1))
            return adopt
        slot, start, n = self._chunk_info.unbind(0)
        if kind in ("chunk", "chunk_final"):
            row = self._row(width)
            return lambda: m.prefill_chunk(
                p, self._chunk_toks, caches, row, slot, start, n,
                final=kind == "chunk_final")[0]
        dm, dp = self.draft_model, self.draft_params
        dcaches = self.draft_cache.caches
        if kind == "draft_decode":
            bt = self._block_tables_dev(width, draft=True)
            return lambda: dm.decode_step(dp, self._draft_in, dcaches, bt,
                                          live=live)[0]
        if kind == "draft_chunk":
            row = self._row(width, draft=True)
            return lambda: dm.prefill_chunk(dp, self._chunk_toks, dcaches,
                                            row, slot, start, n,
                                            final=False)[0]
        assert kind == "verify", kind
        bt = self._block_tables_dev(width)

        def verify():
            m.set_paged_pos(caches, self._pos0)
            return m.verify_step(p, self._window, caches, bt, live=live)[0]
        return verify

    def _null_inputs(self, kind: str, width: int):
        """The static inputs a capture of ``kind`` overwrites, and a function
        that sets them so its runs write nothing a live request reads:
        paged, every block-table entry the null page, no live row and a
        chunk of one token at slot 0; a dense admission, a prompt of one
        token into a free slot. The dense decode needs none: each row
        writes its K/V at its own depth and past it, positions the next
        decode writes before any reads them."""
        if kind == "decode_dense":
            return [], lambda: None
        if kind in ("gather", "adopt"):
            # every id the null page, slot 0's depth: put back afterwards
            inputs = [self._ids(width), self._adopt_slot]

            def null():
                for t in inputs:
                    t.zero_()
            return inputs, null
        if kind == "admit":
            free = np.flatnonzero(~self._live)
            if not free.size:
                raise RuntimeError("capturing the admission needs a free "
                                   "slot: warm up before serving")

            def null():
                self._admit_info.copy_(torch.tensor([free[0], 1],
                                                    dtype=torch.int32))
            return [self._admit_info], null
        draft = kind.startswith("draft")
        if "chunk" in kind:
            inputs = [self._row(width, draft)]
        else:
            inputs = [self._block_tables_dev(width, draft)]
        inputs += [self._live_dev, self._chunk_info]
        if self.spec_active:
            inputs.append(self._pos0)

        def null():
            for t in inputs:
                t.zero_()
            self._chunk_info[2] = 1
        return inputs, null

    def _capture_writes(self, kind: str) -> List[torch.Tensor]:
        """Views of the cache rows a capture's warm-up runs write under
        null inputs (call after the null inputs are set): the null page of
        every pool, paged; the admission's free slot, dense. Non-live rows
        read them (the null page, or a free slot's own rows), and an MoE
        layer routes those rows with the live ones, so a capture puts them
        back: a captured engine serves what an eager one does."""
        if self.paged:
            caches = self.cache.caches + (self.draft_cache.caches
                                          if self.spec_active else [])
            return [c[k][:, 0] for c in caches if "kp" in c
                    for k in ("kp", "vp")]
        if kind != "admit":
            return []
        slot = int(self._admit_info[0])
        return [c[k][:, slot] for c in self.cache.caches if "k" in c
                for k in ("k", "v")]

    def _graph(self, kind: str, width: int) -> StepGraph:
        """The captured graph of ``kind`` at ``width``; captured now if it
        is not yet. The capture runs against null inputs
        (:meth:`_null_inputs`) and puts back every static input, every
        cache's ``pos`` and the rows its runs wrote
        (:meth:`_capture_writes`) afterwards: the state of every request
        is untouched (a recurrent layer's state among it: the warm-up
        chunk writes slot 0's row)."""
        g = self._graphs.get((kind, width))
        if g is not None:
            return g
        fn = self._program(kind, width)
        inputs, null = self._null_inputs(kind, width)
        state = inputs + self.model.step_state(self.cache.caches)
        if self.spec_active:
            state += self.draft_model.step_state(self.draft_cache.caches)
        saved = [t.clone() for t in state]
        null()
        writes = self._capture_writes(kind)
        state += writes
        saved += [t.clone() for t in writes]
        try:
            with torch.no_grad():
                g = StepGraph(kind, width, fn, self.device)
        finally:
            for t, v in zip(state, saved):
                t.copy_(v)
        self._graphs[(kind, width)] = g
        self.n_captures += 1
        return g

    def _run(self, kind: str, width: int):
        """One run of program ``kind`` at ``width``: a replay of its graph
        (captured on first use) or an eager call."""
        if self.time_programs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.use_graphs:
            out = self._graph(kind, width).replay()
        else:
            with torch.no_grad():
                out = self._program(kind, width)()
        if self.time_programs:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.run_ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.runs[kind] += 1
        return out

    def decode_widths(self) -> List[int]:
        """The active block-table widths paged decode can run at (the
        power-of-two ladder, capped at ``max_pages``): one graph each of the
        decode step (and in spec mode of the draft decode and the verify
        window). None for the dense engine, as in the reference."""
        if not self.paged:
            return []
        out, w = [], 1
        while w < self.cache.max_pages:
            out.append(w)
            w *= 2
        out.append(self.cache.max_pages)
        return out

    def prefill_widths(self) -> List[int]:
        """The active block-table widths prefill chunks can run at: the
        decode ladder truncated below the first chunk's width (a chunk
        always attends over at least ``chunk_tokens`` of context, so the
        narrower rungs never occur): one graph per rung per ``final``
        variant (and in spec mode of the draft's mirror chunk). None for
        the dense engine."""
        if not self.paged:
            return []
        w_min = min(_next_pow2(self.cache.pages_for(self.chunk_tokens)),
                    self.cache.max_pages)
        return [w for w in self.decode_widths() if w >= w_min]

    def warmup(self) -> None:
        """Capture every program at every width rung, so that serving never
        pauses for a capture (the width grows with the deepest live
        sequence): the decode step, or in spec mode the draft decode, the
        verify window and the target's decode step, at every decode width;
        the prefill chunk, final and not (and the draft's mirror in spec
        mode), at every prefill width. Against the null page: no real page,
        ``pos`` or pending token changes. The dense engine captures its
        decode and the admission at every prompt bucket (the reference
        compiles those on first use). Nothing to do for an eager engine
        (``graphs=False``, the CPU)."""
        if not self.use_graphs:
            return
        if not self.paged:
            self._graph("decode_dense", self.n_slots)
            for b in self.scheduler.buckets:
                self._graph("admit", b)
            return
        kinds = (("draft_decode", "verify", "decode") if self.spec_active
                 else ("decode",))
        for w in self.decode_widths():
            for kind in kinds:
                self._graph(kind, w)
        chunks = ("chunk", "chunk_final") + (("draft_chunk",)
                                             if self.spec_active else ())
        for w in self.prefill_widths():
            for kind in chunks:
                self._graph(kind, w)
        # a router's roles: a prefill engine gathers, and adopts once the
        # decode side has died; a decode engine adopts
        handoff = {"prefill": ("gather", "adopt"),
                   "decode": ("adopt",)}.get(self.handoff_role, ())
        for w in self.decode_widths():
            for kind in handoff:
                self._graph(kind, w)

    def _emit(self, req: Request, tok: int) -> None:
        """Record one generated token; finish the request if it stops."""
        req.generated.append(tok)
        self.metrics.on_token(req.id)
        if self.token_cb is not None:
            self.token_cb(req, tok, len(req.generated) - 1)
        eos = req.eos_id >= 0 and tok == req.eos_id
        if not (eos or len(req.generated) >= req.max_new_tokens):
            return
        # disaggregation: a prefill_only request that reached its clamped
        # budget hands off (an EOS stop is a real completion), its payload
        # gathered while the slot still owns its pages and generator
        handing_off = (req.prefill_only and self.handoff_cb is not None
                       and self.paged and not eos)
        if handing_off:
            req.handoff = self.extract_handoff(req)
        self._vacate(req)
        self.scheduler.finish(req)
        if handing_off:
            self.handoff_cb(req)
            return
        self.metrics.on_done(req.id)
        if self.done_cb is not None:
            self.done_cb(req)

    def _kv_len(self, req: Request) -> int:
        """Cached KV depth of a live request: the prompt plus every
        generated token except the newest (written by the next decode)."""
        return len(req.prompt) + max(len(req.generated) - 1, 0)

    def _report_kv(self) -> None:
        logical = sum(self._kv_len(r) for r in self.scheduler.running.values()
                      if r.state == RequestState.DECODE)
        if self.paged:
            self.metrics.on_kv(self.cache.kv_bytes_allocated(),
                               int(logical * self.cache.token_bytes),
                               self.cache.dense_reserved_bytes)
        else:
            self.metrics.on_kv(self.cache.kv_bytes,
                               int(logical * self.cache.token_bytes),
                               self.cache.kv_bytes)

    # ----------------------------------------------------------- resilience
    def _poison(self, site: str) -> Optional[torch.Tensor]:
        """The injector's per-slot additive logit poison ``(n_slots,)`` for
        this step at ``site``, or None when nothing is scheduled (the
        logits then go on untouched: adding the reference's zeros changes
        nothing)."""
        inj = self.resilience.injector
        if inj is None:
            return None
        vec = inj.poison(site, inj.step, self.n_slots)
        return None if vec is None else torch.from_numpy(vec).to(self.device)

    def _retry_eligible(self, req: Request) -> bool:
        """Quarantined requests wait out their backoff; everyone else
        admits at once (the scheduler's skip predicate)."""
        return req.retry_at_step <= self.step_count

    def _fail_request(self, req: Request, reason: str) -> None:
        """Terminal failure: free everything the request holds within this
        step and surface ``finish_reason`` through ``done_cb``."""
        req.finish_reason = reason
        self._vacate(req)
        self.scheduler.finish(req)
        self.metrics.on_abort(req.id, reason)
        if self.done_cb is not None:
            self.done_cb(req)
        log.warning("request %d failed: finish_reason=%s (%d retries, "
                    "%d tokens streamed)", req.id, reason,
                    req.n_fault_retries, len(req.generated))

    def _enforce_deadlines(self) -> None:
        """Abort every ``enforce_deadline`` request past its e2e SLO, its
        pages freed within this step (finish_reason="deadline")."""
        now = self.metrics.clock()
        for req in (list(self.scheduler.running.values())
                    + list(self.scheduler.waiting)):
            if not req.enforce_deadline or req.e2e_slo_s is None:
                continue
            rm = self.metrics.requests.get(req.id)
            if rm is None or now - rm.t_submit <= req.e2e_slo_s:
                continue
            self.n_deadline_aborts += 1
            self._fail_request(req, "deadline")

    def _quarantine(self, req: Request) -> None:
        """Non-finite logits in this slot only: free its pages, requeue it
        at its arrival position after a backoff, and after
        ``max_fault_retries`` fail it (finish_reason="fault"). Every other
        slot is untouched: the rows are independent, so survivors stay
        what a fault-free run gives, and the request regenerates on
        retry."""
        res = self.resilience
        res.note_fault()
        self.n_quarantines += 1
        self.metrics.on_quarantine(req.id)
        if req.n_fault_retries >= res.max_fault_retries:
            self.n_fault_failures += 1
            self._fail_request(req, "fault")
            return
        req.n_fault_retries += 1
        req.retry_at_step = self.step_count + res.backoff_steps(
            req.id, req.n_fault_retries)
        slot = req.slot
        self._vacate(req, keep=True)
        self.scheduler.requeue(req)
        log.warning("quarantined request %d (slot %d, non-finite logits): "
                    "retry %d/%d no earlier than step %d", req.id, slot,
                    req.n_fault_retries, res.max_fault_retries,
                    req.retry_at_step)

    def _handle_step_fault(self, err: Exception) -> bool:
        """A decode step raised. The injected fault fires before the step
        writes anything; a fault after the replay leaves K/V the retry
        writes again, a ``pos`` the retry sets back from the host and a
        recurrent state the step has already put back from its copy, and
        the pending tokens change only last, so the next step re-runs the
        same work (a sampled row draws again from its generator), as the
        reference's retry does. Bounded: after
        ``max_consecutive_step_faults`` the fault is persistent and
        re-raised (a real CUDA error is sticky and ends there). Backoff is
        exponential with seeded jitter."""
        res = self.resilience
        res.note_fault()
        res.consecutive_step_faults += 1
        self.metrics.on_step_fault()
        if res.consecutive_step_faults > res.max_consecutive_step_faults:
            log.error("engine step faulted %d consecutive times: persistent "
                      "fault, giving up", res.consecutive_step_faults)
            raise err
        delay = min(0.001 * (2 ** (res.consecutive_step_faults - 1)), 0.05)
        rng = np.random.default_rng((res.seed, self.step_count))
        delay *= 1.0 + 0.25 * float(rng.random())
        log.warning("engine step fault (%s): retrying next step after "
                    "%.1fms backoff (%d/%d)", err, delay * 1e3,
                    res.consecutive_step_faults,
                    res.max_consecutive_step_faults)
        time.sleep(delay)
        return True

    def _on_ladder_transition(self, old: int, new: int) -> None:
        self.metrics.on_degradation(new)
        log.warning("degradation ladder: %s -> %s", STAGE_NAMES[old],
                    STAGE_NAMES[new])
        if not self.paged:
            return
        caches = [c for c in (self.cache, self.draft_cache) if c is not None]
        if new >= 2 and old < 2:        # entering flush_prefix
            n = self.cache.flush_trie()
            for c in caches:
                c.publish_enabled = False
            log.warning("flushed %d trie-only prefix nodes; prefix "
                        "publishing suspended", n)
        elif new < 2 and old >= 2:      # pressure cleared: re-enable
            for c in caches:
                c.publish_enabled = True
            log.warning("prefix publishing re-enabled")

    def _apply_ladder(self, page_blocked: bool) -> None:
        """Feed this step's pressure into the ladder: pool contention (1.0
        when admission was page-blocked or nothing is obtainable, else the
        committed fraction) or the fault-rate EWMA, the worse of the two."""
        res = self.resilience
        if res.ladder is None:
            return
        if self.paged:
            cap = max(self.cache.pool.n_pages - 1, 1)
            avail = self.cache.available()
            util = (1.0 if (page_blocked or avail <= 0)
                    else 1.0 - min(avail, cap) / cap)
        else:
            util = 1.0 if page_blocked else 0.0
        res.ladder.observe(res.pressure(util), self.step_count)

    @property
    def spec_suspended(self) -> bool:
        """True while the degradation ladder holds speculation off: the
        plain paged decode serves (draft K/V goes stale for the tokens
        generated meanwhile, which costs acceptance after resuming, never
        correctness)."""
        ladder = self.resilience.ladder
        return self.spec_active and ladder is not None and ladder.spec_disabled

    # ------------------------------------------------------------- the step
    def step(self) -> bool:
        """One engine iteration (deadlines; admit, with preemption; paged,
        prefill chunks; one decode or one speculative step) inside the
        resilience bracket (slow-step faults in ``begin_step``, the step-time
        monitor and the fault-rate decay in ``end_step``). Returns True if
        any work was done."""
        res = self.resilience
        t0 = time.perf_counter()
        res.begin_step(self.step_count)
        try:
            return self._step_inner()
        finally:
            res.end_step(time.perf_counter() - t0)

    def _step_inner(self) -> bool:
        self._enforce_deadlines()
        page_blocked = False
        if self.paged:
            def can(r):
                nonlocal page_blocked
                ok = self.cache.can_admit(len(r.prompt), r.max_new_tokens,
                                          prompt=r.prompt)
                if ok and self.spec_active:
                    ok = self.draft_cache.can_admit(
                        len(r.prompt), r.max_new_tokens, prompt=r.prompt)
                if not ok:
                    page_blocked = True     # pressure for the ladder
                return ok
            # one at a time (each admission takes pages the next probe must
            # see); a blocked head may evict a lower-priority slot, then
            # admission retries
            admitted = []
            while True:
                pairs = self.scheduler.admit(can_admit=can, max_n=1,
                                             eligible=self._retry_eligible)
                if pairs:
                    self._admit_one_paged(*pairs[0])
                    admitted += pairs
                elif not self._preempt_for_head():
                    break
            prefilled = self._prefill_chunks()
        else:
            admitted = self.scheduler.admit(eligible=self._retry_eligible)
            for req, slot in admitted:
                self._admit_one(req, slot)
            prefilled = False
        self.step_count += 1
        self.metrics.on_queue_depth(len(self.scheduler.waiting))
        self._apply_ladder(page_blocked)

        if not self._live.any():
            self.metrics.on_step(0, self.n_slots)
            self._report_kv()
            return bool(admitted) or prefilled
        if self.spec_active and not self.spec_suspended:
            return self._step_spec()
        return self._step_decode()

    def _step_decode(self) -> bool:
        """One batched decode of every live slot (dense: of every slot)."""
        res = self.resilience
        copied = False
        try:
            # the injected fault fires before the step writes anything
            if res.injector is not None:
                res.injector.check("engine_step")
            wpos = np.zeros((self.n_slots,), np.int32)
            needed = 1
            for slot in np.nonzero(self._live)[0]:
                req = self.scheduler.running.get(int(slot))
                if req is None:
                    continue
                wpos[slot] = self._kv_len(req)
                if self.paged:
                    # materialise this step's write pages; size the active
                    # width to the deepest live sequence
                    self.cache.ensure_decode_page(int(slot), int(wpos[slot]))
                    needed = max(needed, self.cache.pages_used(
                        int(slot), int(wpos[slot]) + 1))
            # ``pos`` from the host's depths before every replay: a retried
            # step may have advanced it before it raised, and a verify held
            # off mid-flight left it at the window's entry
            self._put(self._pos0, wpos)
            live = self._live_mask_dev()
            if self.spec_active:
                self.model.set_paged_pos(self.cache.caches, self._pos0)
            else:
                # a non-live row keeps the depth it had, as in the
                # reference (whose decode sets no depth here): it still
                # computes, and an MoE layer routes it with the live rows;
                # only attention layers have a depth
                for c in self.cache.caches:
                    if "pos" in c:
                        c["pos"].copy_(torch.where(live, self._pos0,
                                                   c["pos"]))
            # from here on a recurrent layer's state may advance in place:
            # keep what it was (one copy_ a leaf, outside the program)
            for keep, t in zip(self._state_copy, self._state):
                keep.copy_(t)
            copied = bool(self._state)
            if self.paged:
                width = min(_next_pow2(needed), self.cache.max_pages)
                self._block_tables_dev(width)
                logits = self._run("decode", width)
            else:
                logits = self._run("decode_dense", self.n_slots)
            poison = self._poison("decode_logits")
            if poison is not None:
                logits = logits + poison[:, None]
            ok = torch.isfinite(logits).all(dim=-1)
            self._tokens.copy_(sampling_lib.sample(logits, self._temps,
                                                   self._top_ks, self._gens))
        except Exception as e:          # noqa: BLE001 - bounded retry
            if copied:
                for keep, t in zip(self._state_copy, self._state):
                    t.copy_(keep)
            return self._handle_step_fault(e)
        res.consecutive_step_faults = 0
        # the tokens and the watchdog's verdict in one copy to the host
        host = torch.stack([self._tokens, ok.long()], dim=1).cpu().numpy()

        self.metrics.on_step(int(self._live.sum()), self.n_slots)
        self._report_kv()
        for slot in np.nonzero(self._live)[0]:
            req = self.scheduler.running.get(int(slot))
            if req is None:
                continue
            if not host[slot, 1]:
                self._quarantine(req)
                continue
            self.metrics.on_decode_step(req.id, 1)
            self._emit(req, int(host[slot, 0]))
        return True

    # ------------------------------------------------- speculative decoding
    def _propose(self, width: int, poison=None):
        """``spec_k`` draft decode steps from the accepted depth (the
        static ``_pos0``), the pending token first, so the draft pool ends
        holding K/V for window positions ``pos0 .. pos0+k-1``: ``spec_k``
        runs of the draft decode program, each followed by
        ``propose_token`` (on the logits plus the ``draft_logits`` poison,
        when one is given). Returns the proposals ``(B, k)`` and the
        distributions ``q (B, k, V)`` they were drawn from."""
        self.draft_model.set_paged_pos(self.draft_cache.caches, self._pos0)
        self._draft_in.copy_(self._tokens)
        seq_t, seq_q = [], []
        for _ in range(self.spec_k):
            logits = self._run("draft_decode", width)
            if poison is not None:
                logits = logits + poison[:, None]
            toks, q = sampling_lib.propose_token(logits, self._temps,
                                                 self._top_ks, self._gens)
            seq_t.append(toks)
            seq_q.append(q)
            self._draft_in.copy_(toks)
        return torch.stack(seq_t, dim=1), torch.stack(seq_q, dim=1)

    def _verify(self, width: int, draft_toks, draft_q, poison=None):
        """Score the window ``[pending, d_1 .. d_k]`` in one target pass
        (the verify program sets the accepted depth first), add the
        ``decode_logits`` poison when one is given, and accept. Returns
        ``(out (B, k+1), n_accepted (B,), ok (B,))``, ``ok`` the watchdog's
        verdict (finite target logits and finite draft distributions: a
        poisoned draft must not leak through the residual draw), and moves
        each live slot's pending token to ``out[n_accepted]``."""
        self._window[:, 0].copy_(self._tokens)
        self._window[:, 1:].copy_(draft_toks)
        logits = self._run("verify", width)
        if poison is not None:
            logits = logits + poison[:, None, None]
        ok = (torch.isfinite(logits).all(dim=-1).all(dim=-1)
              & torch.isfinite(draft_q).all(dim=-1).all(dim=-1))
        out, n_acc = sampling_lib.spec_accept(
            logits, draft_toks, draft_q, self._temps, self._top_ks,
            self._gens)
        new_tok = torch.gather(out, 1, n_acc[:, None])[:, 0]
        self._tokens.copy_(torch.where(self._live_dev, new_tok,
                                       self._tokens))
        return out, n_acc, ok

    def _step_spec(self) -> bool:
        """One speculative step: window pages in both pools, draft propose,
        target verify, then emit 1..k+1 tokens per live slot (stop checks
        inside the window) and roll both pools back to the accepted
        depth. A non-finite row is quarantined; an exception retries the
        step (propose and verify as a unit)."""
        k = self.spec_k
        res = self.resilience
        try:
            # the injected fault fires before the step writes anything
            if res.injector is not None:
                res.injector.check("engine_step")
            pos0 = np.zeros((self.n_slots,), np.int32)
            needed = 1
            for slot in np.nonzero(self._live)[0]:
                req = self.scheduler.running.get(int(slot))
                if req is None:
                    continue
                wpos = self._kv_len(req)
                pos0[slot] = wpos
                # the target writes window positions wpos .. wpos+k, the
                # draft wpos .. wpos+k-1, against the slack in the
                # reservation
                for t in range(k + 1):
                    self.cache.ensure_decode_page(int(slot), wpos + t)
                    if t < k:
                        self.draft_cache.ensure_decode_page(int(slot),
                                                            wpos + t)
                needed = max(needed, self.cache.pages_used(int(slot),
                                                           wpos + k + 1))
            width = min(_next_pow2(needed), self.cache.max_pages)
            self._live_mask_dev()
            self._put(self._pos0, pos0)
            self._block_tables_dev(width, draft=True)
            self._block_tables_dev(width)
            draft_toks, draft_q = self._propose(
                width, self._poison("draft_logits"))
            out, n_acc, ok = self._verify(width, draft_toks, draft_q,
                                          self._poison("decode_logits"))
        except Exception as e:          # noqa: BLE001 - bounded retry
            return self._handle_step_fault(e)
        res.consecutive_step_faults = 0
        # the window, its acceptance and the watchdog's verdict in one copy
        host = torch.cat([out, n_acc[:, None], ok[:, None].long()],
                         dim=1).cpu().numpy()

        self.metrics.on_step(int(self._live.sum()), self.n_slots)
        self._report_kv()
        for slot in np.nonzero(self._live)[0]:
            req = self.scheduler.running.get(int(slot))
            if req is None:
                continue
            if not host[slot, k + 2]:
                self._quarantine(req)
                continue
            n = int(host[slot, k + 1])
            self.metrics.on_decode_step(req.id, n + 1, n_proposed=k,
                                        n_accepted=n)
            for i in range(n + 1):
                self._emit(req, int(host[slot, i]))
                if req.state == RequestState.DONE:
                    break       # EOS or max inside the window: drop the rest
            if req.state != RequestState.DONE:
                # pages past the accepted depth hold rejected K/V
                keep = self._kv_len(req)
                self.cache.rollback(int(slot), keep)
                self.draft_cache.rollback(int(slot), keep)
        return True

    def run(self, requests: Sequence[Request],
            max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive already-arrived requests to completion; returns
        ``{request id: generated tokens}``."""
        for r in requests:
            self.submit(r)
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine failed to drain the queue within "
                                   f"{max_steps} steps")
        return {r.id: list(r.generated) for r in requests}
