"""Paged continuous-batching engine (the port of the paged path of
``repro.serve.engine``).

Each :meth:`Engine.step`:

1. admits waiting requests into free slots, one at a time, while the page
   pool can hold them (admission only builds the block table, reusing
   trie-cached prefix pages);
2. runs prefill chunks FCFS under the per-step token budget — fixed-shape,
   page-multiple chunks, each attending over a power-of-two ladder of
   block-table columns; the final chunk samples the request's first token;
3. runs one batched decode of every slot over an active block-table width
   that tracks the deepest live sequence (power-of-two ladder), with the
   ``live`` mask keeping mid-prefill rows from writing, then emits each
   live slot's token and finishes requests at EOS or ``max_new_tokens``.

Greedy output is token-for-token what the reference engine produces on the
same params and prompts. Not ported yet: the slot-dense engine, speculative
decoding, preemption, resilience/chaos, disaggregated handoff, ``warmup``
(PyTorch runs eagerly: there is nothing to compile ahead).
"""

from __future__ import annotations

import collections
import logging
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import sampling as sampling_lib
from .cache import PagedCache
from .metrics import ServeMetrics
from .scheduler import Request, RequestState, Scheduler

log = logging.getLogger("repro_torch.serve.engine")


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class Engine:
    """Paged continuous-batching engine around one model and its params.
    The device is the params' device."""

    def __init__(self, model, params, *, n_slots: int = 8, max_len: int = 128,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None):
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError(f"{cfg.name}: encoder-only arch has no decode step")
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.metrics = ServeMetrics()
        self.cache = PagedCache(model, n_slots, max_len, page_size=page_size,
                                n_pages=n_pages, device=self.device)
        self.scheduler = Scheduler(n_slots, max_len, strict_buckets=False)
        ps = self.cache.page_size
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = min(4 * ps, self.cache.max_pages * ps)
        if prefill_chunk_tokens % ps:
            raise ValueError(
                f"prefill_chunk_tokens({prefill_chunk_tokens}) must be a "
                f"multiple of page_size({ps})")
        self.chunk_tokens = prefill_chunk_tokens
        self._prefill_queue: Deque[Request] = collections.deque()
        self._bt_dev: Dict[int, torch.Tensor] = {}
        self.n_prefill_chunks = 0
        self.n_prefill_tokens = 0           # computed
        self.n_prefill_tokens_skipped = 0   # reused from the trie

        # per-slot sampling state: the pending token lives on the device,
        # the policy on the host
        self._tokens = torch.zeros((n_slots,), dtype=torch.long,
                                   device=self.device)
        self._temps = [0.0] * n_slots
        self._top_ks = [0] * n_slots
        self._gens: List[Optional[torch.Generator]] = [None] * n_slots
        self._live = np.zeros((n_slots,), bool)
        self._live_dev: Optional[tuple] = None

    # -------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)
        self.metrics.on_submit(req.id, len(req.prompt))

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # ------------------------------------------------------------ step logic
    def _admit_one(self, req: Request, slot: int) -> None:
        """Bookkeeping only: the block table (reusing trie-matched prefix
        pages) and a place in the prefill queue."""
        self.metrics.on_admit(req.id)
        matched = self.cache.admit_request(slot, req.prompt,
                                           req.max_new_tokens)
        req.prefill_pos = matched
        req.n_matched = matched
        self.n_prefill_tokens_skipped += matched
        self._prefill_queue.append(req)

    def _arm_slot(self, req: Request, slot: int, first_logits: torch.Tensor):
        """Sample the first token from the final chunk's logits and set the
        slot's sampling state."""
        sp = req.sampling
        gen = (sampling_lib.make_generator(sp.seed, self.device)
               if sp.temperature > 0 else None)
        self._temps[slot], self._top_ks[slot] = sp.temperature, sp.top_k
        self._gens[slot] = gen
        tok = sampling_lib.sample_one(first_logits, sp.temperature, sp.top_k,
                                      gen)
        self._tokens[slot] = tok
        return int(tok)

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
            bt_row = torch.as_tensor(self.cache.block_tables[slot][:ctx_pages],
                                     device=self.device)
            logits, _ = self.model.prefill_chunk(
                self.params, torch.as_tensor(toks, device=self.device),
                self.cache.caches, bt_row, slot, pos, n_real, final=final)
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
            self.cache.publish_prefix(req.prompt, slot, req.prefill_pos,
                                      from_tokens=pos)
            if final:
                self._prefill_queue.popleft()
                self._live[slot] = True
                req.state = RequestState.DECODE
                self._emit(req, self._arm_slot(req, slot, logits[0]))
        return ran

    def _live_mask_dev(self) -> torch.Tensor:
        """Device copy of the liveness mask, re-uploaded only on change."""
        if self._live_dev is None or not np.array_equal(self._live_dev[1],
                                                        self._live):
            self._live_dev = (torch.as_tensor(self._live, device=self.device),
                              self._live.copy())
        return self._live_dev[0]

    def _block_tables_dev(self, width: int) -> torch.Tensor:
        """Device copy of the first ``width`` block-table columns, cached
        per width until the host table changes."""
        if self.cache.dirty:
            self._bt_dev = {}
            self.cache.dirty = False
        if width not in self._bt_dev:
            self._bt_dev[width] = torch.as_tensor(
                np.ascontiguousarray(self.cache.block_tables[:, :width]),
                device=self.device)
        return self._bt_dev[width]

    def _emit(self, req: Request, tok: int) -> None:
        """Record one generated token; finish the request if it stops."""
        req.generated.append(tok)
        self.metrics.on_token(req.id)
        stop = (len(req.generated) >= req.max_new_tokens
                or (req.eos_id >= 0 and tok == req.eos_id))
        if stop:
            slot = req.slot
            self.scheduler.finish(req)
            self.metrics.on_done(req.id)
            self.cache.free_slot(slot)
            self._live[slot] = False
            self._temps[slot], self._top_ks[slot] = 0.0, 0
            self._gens[slot] = None

    def _kv_len(self, req: Request) -> int:
        """Cached KV depth of a live request: the prompt plus every
        generated token except the newest (written by the next decode)."""
        return len(req.prompt) + max(len(req.generated) - 1, 0)

    def _report_kv(self) -> None:
        logical = sum(self._kv_len(r) for r in self.scheduler.running.values()
                      if r.state == RequestState.DECODE)
        self.metrics.on_kv(self.cache.kv_bytes_allocated(),
                           int(logical * self.cache.token_bytes),
                           self.cache.dense_reserved_bytes)

    def step(self) -> bool:
        """One engine iteration (admit, prefill chunks, one decode).
        Returns True if any work was done."""
        admitted = []
        while True:
            pairs = self.scheduler.admit(
                can_admit=lambda r: self.cache.can_admit(
                    len(r.prompt), r.max_new_tokens, prompt=r.prompt),
                max_n=1)
            if not pairs:
                break
            self._admit_one(*pairs[0])
            admitted += pairs
        prefilled = self._prefill_chunks()
        self.metrics.on_queue_depth(len(self.scheduler.waiting))

        if not self._live.any():
            self.metrics.on_step(0, self.n_slots)
            self._report_kv()
            return bool(admitted) or prefilled

        # materialise this step's write pages; size the active width to the
        # deepest live sequence
        needed = 1
        for slot in np.nonzero(self._live)[0]:
            req = self.scheduler.running.get(int(slot))
            if req is None:
                continue
            wpos = self._kv_len(req)
            self.cache.ensure_decode_page(int(slot), wpos)
            needed = max(needed, self.cache.pages_used(int(slot), wpos + 1))
        width = min(_next_pow2(needed), self.cache.max_pages)
        logits, _ = self.model.decode_step(
            self.params, self._tokens, self.cache.caches,
            self._block_tables_dev(width), live=self._live_mask_dev())
        self._tokens = sampling_lib.sample(logits, self._temps, self._top_ks,
                                           self._gens)
        next_np = self._tokens.cpu().numpy()

        self.metrics.on_step(int(self._live.sum()), self.n_slots)
        self._report_kv()
        for slot in np.nonzero(self._live)[0]:
            req = self.scheduler.running.get(int(slot))
            if req is None:
                continue
            self._emit(req, int(next_np[slot]))
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
