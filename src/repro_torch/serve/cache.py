"""KV memory for the continuous-batching engine (the port of
``repro.serve.cache``: the slot-dense ``SlotCache``; ``PagePool``,
``PrefixTrie`` over one pool or several, ``PagedCache`` with the
speculative window's slack and ``rollback``, the resilience hooks
``preempt_slot``, ``flush_trie``, ``publish_enabled`` and the fault
injector's ``pool_exhaust`` seam, ``share_trie`` and
``publish_prefix_shared``).

``SlotCache``: every slot reserves ``max_len`` rows of K/V per layer up
front; admission writes a batch-1 prefill's caches into its slot. Paged:
attention K/V lives in a global pool of fixed-size pages per layer; each
request holds an ordered list of page ids (its block table); a host-side
free list hands pages out; a ref-counted prefix trie keyed on page-aligned
prompt chunks lets requests that share a prompt prefix reuse prefilled
pages. Cached pages are immutable — extending a shared prefix allocates
fresh pages. Page 0 is the reserved null page.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib

NULL_PAGE = 0


def _batch_axes(model) -> List[Dict[str, int]]:
    """Per leaf of the slot caches, the index of its slot (``"batch"``)
    axis."""
    return [{k: names.index("batch") for k, names in axes.items()}
            for axes in model.slot_cache_axes()]


def _slot_index(slot, device) -> torch.Tensor:
    """``slot`` (a host int or a 0-d tensor on the device) as a ``(1,)``
    int64 index on ``device``, with no host read."""
    return torch.as_tensor(slot, device=device).reshape(1).long()


def _attention(model, caches):
    """The caches of ``model``'s attention positions (a recurrent
    position's state is the same size under every memory model, so the
    byte accounting leaves it out, as the reference's does)."""
    return [c for spec, c in zip(model.block_specs, caches)
            if spec["kind"] in ("attn", "attn_moe")]


class SlotCache:
    """The slot-dense caches (:meth:`Model.init_slot_caches`) and their two
    maintenance ops, in place: write a batch-1 prefill's caches into one
    slot, zero one slot. ``kv_bytes`` is the attention layers' whole dense
    reservation, ``token_bytes`` its share of one slot row."""

    def __init__(self, model, n_slots: int, max_len: int, dtype=None,
                 device=None):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.caches = model.init_slot_caches(n_slots, max_len, dtype, device)
        self.kv_bytes = sum(c["k"].nbytes + c["v"].nbytes
                            for c in _attention(model, self.caches))
        self.token_bytes = self.kv_bytes / (n_slots * max_len)
        self._batch_ix = _batch_axes(model)

    def _write_impl(self, caches, new, slot):
        """Copy the batch-1 caches ``new`` into row ``slot`` of every leaf
        of ``caches``; ``slot`` may be a 0-d tensor on the device, so one
        captured program serves every slot. Returns ``caches``."""
        for big, small, bix in zip(caches, new, self._batch_ix):
            for k, b in bix.items():
                idx = _slot_index(slot, big[k].device)
                big[k].index_copy_(b, idx, small[k].to(big[k].dtype))
        return caches

    def _reset_impl(self, caches, slot):
        """Zero row ``slot`` of every leaf (admission overwrites a slot in
        full, so this is hygiene). Returns ``caches``."""
        for big, bix in zip(caches, self._batch_ix):
            for k, b in bix.items():
                big[k].index_fill_(b, _slot_index(slot, big[k].device), 0)
        return caches

    def write_slot(self, prefill_caches, slot: int) -> None:
        self._write_impl(self.caches, prefill_caches, slot)

    def reset_slot(self, slot: int) -> None:
        self._reset_impl(self.caches, slot)


class PagePool:
    """Host-side page allocator: a free list plus per-page refcounts. Page
    0 is the null page (never handed out); a page is free at refcount 0."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (null + 1), got {n_pages}")
        self.n_pages = n_pages
        self.ref = np.zeros(n_pages, np.int32)
        self.ref[NULL_PAGE] = 1                          # permanently pinned
        self._free = list(range(n_pages - 1, 0, -1))     # pop() -> lowest id

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        """Pages held by at least one owner (excluding null)."""
        return (self.n_pages - 1) - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted")
        pid = self._free.pop()
        assert self.ref[pid] == 0, pid
        self.ref[pid] = 1
        return pid

    def retain(self, pid: int) -> None:
        assert pid != NULL_PAGE and self.ref[pid] > 0, pid
        self.ref[pid] += 1

    def release(self, pid: int) -> None:
        assert pid != NULL_PAGE and self.ref[pid] > 0, pid
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free.append(pid)


class PrefixTrie:
    """Ref-counted prefix cache keyed on page-aligned prompt chunks.

    A node is a full page of prompt tokens keyed by the whole token prefix
    it completes; matching walks page by page and stops at the first miss,
    so eviction is leaf-first (LRU among nodes no other cached node
    extends). The trie holds one pool ref per node: a page whose only
    holder is the trie (ref == 1) is evictable.

    Shared mode (speculative decoding): built over a sequence of pools, a
    node holds a tuple of page ids, one per pool; draft and target hit and
    are evicted as a unit, and a node is evictable only when every pool's
    ref is the trie's alone. Built over one pool, node values are ints.
    """

    def __init__(self, pool, page_size: int):
        self.pools: Tuple[PagePool, ...] = (
            tuple(pool) if isinstance(pool, (list, tuple)) else (pool,))
        self.pool = self.pools[0]
        self.page_size = page_size
        self.nodes: Dict[Tuple[int, ...], Any] = {}
        self._tick = 0
        self._last_use: Dict[Tuple[int, ...], int] = {}
        self._n_children: Dict[Tuple[int, ...], int] = {}

    def __len__(self) -> int:
        return len(self.nodes)

    @staticmethod
    def _as_tuple(value) -> Tuple[int, ...]:
        return value if isinstance(value, tuple) else (value,)

    def is_reclaimable(self, value) -> bool:
        """Whether the trie is a node's only holder in every pool."""
        return all(pool.ref[pid] == 1
                   for pool, pid in zip(self.pools, self._as_tuple(value)))

    def match(self, prompt: np.ndarray, max_pages: int,
              touch: bool = True) -> List[Any]:
        """Node values of the longest cached page-aligned prefix (read-only;
        the caller takes refs). ``touch=False`` is the capacity probe and
        does not bump LRU recency."""
        ps = self.page_size
        toks = tuple(int(t) for t in prompt[: max_pages * ps])
        pages: List[Any] = []
        if touch:
            self._tick += 1
        for j in range(max_pages):
            key = toks[: (j + 1) * ps]
            if len(key) < (j + 1) * ps or key not in self.nodes:
                break
            pages.append(self.nodes[key])
            if touch:
                self._last_use[key] = self._tick
        return pages

    def insert(self, prompt: np.ndarray, page_index: int, pid) -> bool:
        """Cache page ``page_index`` of ``prompt`` (full and prefilled):
        ``pid`` an int, or a tuple of one page id per pool. Takes one ref
        per pool; no-op if already cached."""
        key = tuple(int(t) for t in prompt[: (page_index + 1) * self.page_size])
        if key in self.nodes:
            return False
        pids = self._as_tuple(pid)
        assert len(pids) == len(self.pools), (pids, len(self.pools))
        self.nodes[key] = pid
        parent = key[:-self.page_size]
        if parent in self.nodes:
            self._n_children[parent] = self._n_children.get(parent, 0) + 1
        for pool, p in zip(self.pools, pids):
            pool.retain(p)
        self._tick += 1
        self._last_use[key] = self._tick
        return True

    def evictable(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """(last_use, key) of trie-only leaves."""
        return [(self._last_use[key], key)
                for key, pid in self.nodes.items()
                if self.is_reclaimable(pid) and not self._n_children.get(key)]

    def evict_one(self):
        """Drop the LRU evictable leaf, freeing its page(s); returns the
        node value or None."""
        cands = self.evictable()
        if not cands:
            return None
        _, key = min(cands)
        pid = self.nodes.pop(key)
        self._last_use.pop(key, None)
        self._n_children.pop(key, None)
        parent = key[:-self.page_size]
        if parent in self._n_children:
            self._n_children[parent] -= 1
            if not self._n_children[parent]:
                del self._n_children[parent]
        for pool, p in zip(self.pools, self._as_tuple(pid)):
            pool.release(p)
        return pid

    def evictable_count(self) -> int:
        return len(self.evictable())

    def reclaimable_count(self) -> int:
        """Pages (per pool) cascading leaf eviction could hand back: every
        trie-only node (request refs are upward-closed along a chain)."""
        return int(sum(1 for pid in self.nodes.values()
                       if self.is_reclaimable(pid)))


class PagedCache:
    """Owns the device page pools, the host block tables, the allocator and
    the prefix trie. Admission reserves a request's worst-case page count
    (prompt + ``max_new_tokens`` + ``slack_tokens``); decode pages
    materialise lazily against that reservation, so an admitted request can
    always finish. ``slack_tokens``: speculative decoding writes a k-token
    window past the accepted depth, so a slot can need pages beyond prompt
    + ``max_new_tokens``; the slack widens the block table and every
    reservation by that much. Recurrent layers keep one pinned state row a
    slot beside the pools; with any of them the trie is off
    (``prefix_cache_enabled``: recurrent state cannot be rebuilt from a
    matched prefix), and the page accounting counts attention K/V only."""

    def __init__(self, model, n_slots: int, max_len: int, *,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 device=None, slack_tokens: int = 0):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.slack_tokens = slack_tokens
        self.max_pages = math.ceil((max_len + slack_tokens) / page_size)
        if n_pages is None:
            n_pages = n_slots * self.max_pages + 1     # dense-equivalent + null
        self.n_pages = n_pages
        self.caches = model.init_paged_caches(n_slots, n_pages, page_size,
                                              device=device)
        self.dtype = model.cfg.tdtype
        self.device = device_lib.resolve(device)
        self.pool = PagePool(n_pages)
        self.trie = PrefixTrie(self.pool, page_size)
        # this cache's place in a shared trie's node tuples (share_trie)
        self._trie_slot = 0
        self.block_tables = np.zeros((n_slots, self.max_pages), np.int32)
        self.dirty = True
        self.reserved = 0
        self._slot_reserved = [0] * n_slots
        self.prefix_cache_enabled = all(
            s["kind"] in ("attn", "attn_moe") for s in model.block_specs)
        self.page_bytes = sum((c["kp"].nbytes + c["vp"].nbytes) // n_pages
                              for c in _attention(model, self.caches))
        self.token_bytes = self.page_bytes / page_size
        self.dense_reserved_bytes = int(n_slots * max_len * self.token_bytes)
        # degradation ladder: at the flush_prefix stage the engine stops
        # publishing new prefixes (and has flushed the trie); misses just
        # recompute
        self.publish_enabled = True
        # fault-injection seam (site "pool_exhaust"): the injector withholds
        # pages from available() — admission pressure, never a failed
        # allocation, so the allocator's bookkeeping stays exact
        self.injector = None

    # ------------------------------------------------------------ accounting
    def kv_bytes_allocated(self) -> int:
        return self.pool.allocated_count * self.page_bytes

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def available(self) -> int:
        """Free pages plus trie pages reclaimable by cascading eviction,
        minus outstanding reservations (and the pages a ``pool_exhaust``
        fault withholds)."""
        avail = (self.pool.free_count + self.trie.reclaimable_count()
                 - self.reserved)
        if self.injector is not None:
            avail -= self.injector.withheld_pages()
        return avail

    # ------------------------------------------------------------- admission
    def _match_nodes(self, prompt: np.ndarray, touch: bool = True) -> List[Any]:
        """Trie node values (page ids, or per-pool tuples when shared) of
        the longest cached prefix (none while the trie is off)."""
        if not self.prefix_cache_enabled or len(prompt) <= self.page_size:
            return []
        # never the entire prompt: the last token's logits must be computed
        cap = (len(prompt) - 1) // self.page_size
        return self.trie.match(prompt, cap, touch=touch)

    def _own_pid(self, node_value) -> int:
        """This pool's page id in a trie node's value."""
        return (node_value[self._trie_slot] if isinstance(node_value, tuple)
                else node_value)

    def _match(self, prompt: np.ndarray, touch: bool = True) -> List[int]:
        """This pool's page ids of the longest cached prefix."""
        return [self._own_pid(v) for v in self._match_nodes(prompt, touch)]

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt: Optional[np.ndarray] = None) -> bool:
        matched = (self._match_nodes(prompt, touch=False)
                   if prompt is not None else [])
        total = self.pages_for(prompt_len + max_new_tokens + self.slack_tokens)
        # trie-only matched pages count as available but admission pins them
        pinned = sum(1 for v in matched if self.trie.is_reclaimable(v))
        return total - len(matched) + pinned <= self.available()

    def _alloc_page(self) -> int:
        if self.pool.free_count == 0 and self.trie.evict_one() is None:
            raise RuntimeError("page pool exhausted with nothing evictable — "
                               "admission reservation accounting is broken")
        return self.pool.alloc()

    def admit_request(self, slot: int, prompt: np.ndarray,
                      max_new_tokens: int) -> int:
        """Build the slot's block table from trie-matched prefix pages plus
        fresh prompt pages, and reserve the worst-case decode pages.
        Returns the number of prefix tokens whose prefill is skipped."""
        matched = self._match(prompt)
        for pid in matched:
            self.pool.retain(pid)
        n_prompt_pages = self.pages_for(len(prompt))
        row = self.block_tables[slot]
        row[:] = NULL_PAGE
        row[:len(matched)] = matched
        for j in range(len(matched), n_prompt_pages):
            row[j] = self._alloc_page()
        n_res = (self.pages_for(len(prompt) + max_new_tokens
                                + self.slack_tokens) - n_prompt_pages)
        self.reserved += n_res
        self._slot_reserved[slot] = n_res
        self.dirty = True
        return len(matched) * self.page_size

    # -------------------------------------------------------------- runtime
    def publish_prefix(self, prompt: np.ndarray, slot: int, upto_tokens: int,
                       from_tokens: int = 0) -> None:
        """Insert the slot's full, prefilled prompt pages in tokens
        ``[from_tokens, upto_tokens)`` into the trie (partial pages never:
        decode may still write into the last prompt page). Nothing while
        publishing is suspended (``publish_enabled``) or the trie is off
        (``prefix_cache_enabled``)."""
        if not self.prefix_cache_enabled or not self.publish_enabled:
            return
        assert len(self.trie.pools) == 1, \
            "shared trie: publish with publish_prefix_shared"
        n_full = min(upto_tokens, len(prompt)) // self.page_size
        row = self.block_tables[slot]
        for j in range(from_tokens // self.page_size, n_full):
            self.trie.insert(prompt, j, int(row[j]))

    def ensure_decode_page(self, slot: int, write_pos: int) -> None:
        """Materialise the page covering ``write_pos`` from the slot's
        reservation."""
        j = write_pos // self.page_size
        if self.block_tables[slot, j] == NULL_PAGE:
            self.block_tables[slot, j] = self._alloc_page()
            self.reserved -= 1
            self._slot_reserved[slot] -= 1
            self.dirty = True

    def pages_used(self, slot: int, kv_len: int) -> int:
        """Block-table width needed to cover ``kv_len`` cached tokens."""
        return min(self.pages_for(max(kv_len, 1)), self.max_pages)

    def rollback(self, slot: int, keep_tokens: int) -> int:
        """Truncate the slot's block table to the pages covering
        ``keep_tokens`` accepted tokens, releasing the pages past them (the
        rejection path of speculative decoding; the K/V written there is
        written over next step). Only private decode pages lie past the
        accepted depth, so every release frees a page, and it goes back to
        the slot's reservation. Returns the number of pages released."""
        keep_pages = self.pages_for(max(keep_tokens, 0))
        row = self.block_tables[slot]
        n = 0
        for j in range(keep_pages, self.max_pages):
            pid = int(row[j])
            if pid != NULL_PAGE:
                self.pool.release(pid)
                row[j] = NULL_PAGE
                n += 1
        if n:
            self.reserved += n
            self._slot_reserved[slot] += n
            self.dirty = True
        return n

    def free_slot(self, slot: int) -> None:
        """Release the slot's page refs (trie-cached pages persist) and its
        remaining reservation."""
        row = self.block_tables[slot]
        for pid in row[row != NULL_PAGE]:
            self.pool.release(int(pid))
        row[:] = NULL_PAGE
        self.reserved -= self._slot_reserved[slot]
        self._slot_reserved[slot] = 0
        self.dirty = True

    def flush_trie(self) -> int:
        """The degradation ladder's flush_prefix stage: cascade-evict every
        reclaimable trie node, its trie-only pages back to the free list(s)
        (a shared trie drains every pool). Pages a live request also holds
        keep its refs. Returns the number of nodes evicted."""
        n = 0
        while self.trie.evict_one() is not None:
            n += 1
        return n

    def preempt_slot(self, slot: int) -> int:
        """Evict a live slot whose request will come back (preemption,
        quarantine): drop its page refs and its reservation as
        :meth:`free_slot` does. Trie-shared pages survive (the trie holds
        its own ref), so the request's re-admission hits its published
        prefix. Returns the number of page refs dropped."""
        n = int((self.block_tables[slot] != NULL_PAGE).sum())
        self.free_slot(slot)
        return n


# --------------------------------------------------------------- shared trie
def share_trie(caches: List[PagedCache]) -> PrefixTrie:
    """Give ``caches`` one token-keyed trie whose nodes hold a page id per
    cache's pool (speculative decoding: draft and target hit a shared
    prefix, and lose it, as a unit, and a hit is counted once). Call before
    any admission."""
    ps = caches[0].page_size
    assert all(c.page_size == ps for c in caches), "page_size must match"
    trie = PrefixTrie([c.pool for c in caches], ps)
    for i, c in enumerate(caches):
        assert len(c.trie) == 0, "share_trie must run before any publish"
        c.trie = trie
        c._trie_slot = i
    return trie


def publish_prefix_shared(caches: List[PagedCache], prompt: np.ndarray,
                          slot: int, upto_tokens: int,
                          from_tokens: int = 0) -> None:
    """:meth:`PagedCache.publish_prefix` for a shared trie: insert the
    slot's full, prefilled prompt pages in tokens ``[from_tokens,
    upto_tokens)`` as joint nodes. Every cache must have prefilled that
    range into the same slot. Nothing while any cache has publishing
    suspended or its trie off."""
    if not all(c.prefix_cache_enabled and c.publish_enabled for c in caches):
        return
    trie = caches[0].trie
    assert all(c.trie is trie for c in caches), "caches must share one trie"
    ps = trie.page_size
    n_full = min(upto_tokens, len(prompt)) // ps
    for j in range(from_tokens // ps, n_full):
        trie.insert(prompt, j, tuple(int(c.block_tables[slot, j])
                                     for c in caches))
