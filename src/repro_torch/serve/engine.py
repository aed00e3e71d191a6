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

Speculative decoding (``spec_draft=(model, params)``, ``spec_k``): a draft
model with its own page pool mirrors every prefill chunk, proposes
``spec_k`` tokens per step, and the target scores the ``(k+1)``-token
window in one :meth:`Model.verify_step`; acceptance advances each row by
1..k+1 tokens and both pools roll back to the accepted depth. One
token-keyed prefix trie serves both pools. Greedy spec output is token for
token the non-spec greedy output.

Greedy output is token-for-token what the reference engine produces on the
same params and prompts. Not ported yet: the slot-dense engine,
preemption, resilience (the fault sites, the degradation ladder and with
it ``spec_suspended``), disaggregated handoff, ``warmup`` (PyTorch runs
eagerly: there is nothing to compile ahead).
"""

from __future__ import annotations

import collections
import logging
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import sampling as sampling_lib
from .cache import PagedCache, publish_prefix_shared, share_trie
from .metrics import ServeMetrics
from .scheduler import Request, RequestState, Scheduler

log = logging.getLogger("repro_torch.serve.engine")


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class Engine:
    """Paged continuous-batching engine around one model and its params.
    The device is the params' device. ``spec_draft=(model, params)`` turns
    on speculative decoding with ``spec_k`` proposals a step (the draft's
    params on the same device)."""

    def __init__(self, model, params, *, n_slots: int = 8, max_len: int = 128,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 spec_draft=None, spec_k: int = 4):
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError(f"{cfg.name}: encoder-only arch has no decode step")
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.metrics = ServeMetrics()

        self.spec_k = int(spec_k)
        self.spec_active = False
        self.draft_model = self.draft_params = None
        self.draft_cache: Optional[PagedCache] = None
        if spec_draft is not None:
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
        slack = self.spec_k if self.spec_active else 0
        self.cache = PagedCache(model, n_slots, max_len, page_size=page_size,
                                n_pages=n_pages, device=self.device,
                                slack_tokens=slack)
        if self.spec_active:
            self.draft_cache = PagedCache(
                self.draft_model, n_slots, max_len, page_size=page_size,
                n_pages=n_pages, device=self.device, slack_tokens=slack)
            # one token-keyed trie: draft and target hit a prefix as a unit
            share_trie([self.cache, self.draft_cache])
            self._dbt_dev: Dict[int, torch.Tensor] = {}
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
            toks_dev = torch.as_tensor(toks, device=self.device)
            logits, _ = self.model.prefill_chunk(
                self.params, toks_dev, self.cache.caches, bt_row, slot, pos,
                n_real, final=final)
            if self.spec_active:
                # the draft's mirror of the chunk into its own pool; its
                # logits are never sampled (the target samples), so no
                # unembed
                dc = self.draft_cache
                dctx = min(_next_pow2(dc.pages_for(pos + tc)), dc.max_pages)
                self.draft_model.prefill_chunk(
                    self.draft_params, toks_dev, dc.caches,
                    torch.as_tensor(dc.block_tables[slot][:dctx],
                                    device=self.device),
                    slot, pos, n_real, final=False)
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

    def _live_mask_dev(self) -> torch.Tensor:
        """Device copy of the liveness mask, re-uploaded only on change."""
        if self._live_dev is None or not np.array_equal(self._live_dev[1],
                                                        self._live):
            self._live_dev = (torch.as_tensor(self._live, device=self.device),
                              self._live.copy())
        return self._live_dev[0]

    def _block_tables_dev(self, width: int, draft: bool = False
                          ) -> torch.Tensor:
        """Device copy of the first ``width`` block-table columns of the
        target's pool (the draft's with ``draft``), cached per width until
        the host table changes."""
        cache, memo = ((self.draft_cache, self._dbt_dev) if draft
                       else (self.cache, self._bt_dev))
        if cache.dirty:
            memo.clear()
            cache.dirty = False
        if width not in memo:
            memo[width] = torch.as_tensor(
                np.ascontiguousarray(cache.block_tables[:, :width]),
                device=self.device)
        return memo[width]

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
            if self.spec_active:
                self.draft_cache.free_slot(slot)
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

    def _can_admit(self, r: Request) -> bool:
        """Whether the request's pages fit, in both pools in spec mode."""
        ok = self.cache.can_admit(len(r.prompt), r.max_new_tokens,
                                  prompt=r.prompt)
        if ok and self.spec_active:
            ok = self.draft_cache.can_admit(len(r.prompt), r.max_new_tokens,
                                            prompt=r.prompt)
        return ok

    def step(self) -> bool:
        """One engine iteration (admit, prefill chunks, one decode or one
        speculative step). Returns True if any work was done."""
        admitted = []
        while True:
            pairs = self.scheduler.admit(can_admit=self._can_admit, max_n=1)
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
        if self.spec_active:
            return self._step_spec()
        return self._step_decode()

    def _step_decode(self) -> bool:
        """One batched decode of every live slot."""
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
            self.metrics.on_decode_step(req.id, 1)
            self._emit(req, int(next_np[slot]))
        return True

    # ------------------------------------------------- speculative decoding
    def _propose(self, dbt, live, pos0):
        """``spec_k`` draft decode steps from the accepted depth ``pos0``,
        the pending token first, so the draft pool ends holding K/V for
        window positions ``pos0 .. pos0+k-1``. Returns the proposals ``(B,
        k)`` and the distributions ``q (B, k, V)`` they were drawn from."""
        dm = self.draft_model
        caches = dm.set_paged_pos(self.draft_cache.caches, pos0)
        toks, seq_t, seq_q = self._tokens, [], []
        for _ in range(self.spec_k):
            logits, _ = dm.decode_step(self.draft_params, toks, caches, dbt,
                                       live=live)
            toks, q = sampling_lib.propose_token(logits, self._temps,
                                                 self._top_ks, self._gens)
            seq_t.append(toks)
            seq_q.append(q)
        return torch.stack(seq_t, dim=1), torch.stack(seq_q, dim=1)

    def _verify(self, bt, live, pos0, draft_toks, draft_q):
        """Score the window ``[pending, d_1 .. d_k]`` in one target pass
        and accept. Returns ``(out (B, k+1), n_accepted (B,))`` and moves
        each live slot's pending token to ``out[n_accepted]``."""
        caches = self.model.set_paged_pos(self.cache.caches, pos0)
        window = torch.cat([self._tokens[:, None], draft_toks], dim=1)
        logits, _ = self.model.verify_step(self.params, window, caches, bt,
                                           live=live)
        out, n_acc = sampling_lib.spec_accept(
            logits, draft_toks, draft_q, self._temps, self._top_ks,
            self._gens)
        new_tok = torch.gather(out, 1, n_acc[:, None])[:, 0]
        self._tokens = torch.where(live, new_tok, self._tokens)
        return out, n_acc

    def _step_spec(self) -> bool:
        """One speculative step: window pages in both pools, draft propose,
        target verify, then emit 1..k+1 tokens per live slot (stop checks
        inside the window) and roll both pools back to the accepted
        depth."""
        k = self.spec_k
        pos0 = np.zeros((self.n_slots,), np.int32)
        needed = 1
        for slot in np.nonzero(self._live)[0]:
            req = self.scheduler.running.get(int(slot))
            if req is None:
                continue
            wpos = self._kv_len(req)
            pos0[slot] = wpos
            # the target writes window positions wpos .. wpos+k, the draft
            # wpos .. wpos+k-1, against the slack in the reservation
            for t in range(k + 1):
                self.cache.ensure_decode_page(int(slot), wpos + t)
                if t < k:
                    self.draft_cache.ensure_decode_page(int(slot), wpos + t)
            needed = max(needed, self.cache.pages_used(int(slot),
                                                       wpos + k + 1))
        width = min(_next_pow2(needed), self.cache.max_pages)
        live = self._live_mask_dev()
        pos0_dev = torch.as_tensor(pos0, device=self.device)
        draft_toks, draft_q = self._propose(
            self._block_tables_dev(width, draft=True), live, pos0_dev)
        out, n_acc = self._verify(self._block_tables_dev(width), live,
                                  pos0_dev, draft_toks, draft_q)
        host = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()

        self.metrics.on_step(int(self._live.sum()), self.n_slots)
        self._report_kv()
        for slot in np.nonzero(self._live)[0]:
            req = self.scheduler.running.get(int(slot))
            if req is None:
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
