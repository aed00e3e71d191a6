"""Attention (the port of ``repro.models.attention`` for the full-sequence
training path and both serving paths: ``AttentionSpec`` (RoPE, M-RoPE or
none), ``_cos_sin``, ``_qkv``,
``_attend``, ``attend_full``, ``apply_train``; the dense decode cache
``init_cache``, ``_update_rows`` and ``apply_decode``; ``init_paged_cache``,
``apply_decode_paged``, ``apply_verify_paged``, ``prefill_chunk_paged``).

Training attention is plain PyTorch, as the reference's is plain jnp: f32
softmax with ``-1e30`` causal masking, chunked over the query axis at
``q_chunk`` so the logits of one chunk are alive at a time.

Unlike the reference, whose arrays are immutable, the dense K/V, the page
pools and the ``pos`` counters are updated **in place** (``index_put_``);
the functions still return the cache so call sites read like the
reference. Dense decode attention is plain PyTorch, as the reference's is
plain jnp outside any Pallas body.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import fold as fold_lib
from repro_torch.core.mask import make_mask_spec
from repro_torch.core.policy import CompressionPolicy
from . import layers
from .linear import Linear


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    q_chunk: int = 128
    use_bias: bool = False
    wq: Linear = None
    wk: Linear = None
    wv: Linear = None
    wo: Linear = None

    @staticmethod
    def make(policy: CompressionPolicy, d_model, n_heads, n_kv_heads, head_dim,
             *, causal=True, rope="rope", rope_theta=1e4,
             mrope_sections=(16, 24, 24), q_chunk=128, use_bias=False,
             seed_salt=0, fuse_perms=False) -> "AttentionSpec":
        """``fuse_perms``: k and v take q's input permutation (each keeps its
        own output permutation: RoPE and the head split need natural output
        order), so :func:`_qkv` packs ``x`` once for all three."""
        if rope not in ("rope", "mrope", "none"):
            raise ValueError(f"rope={rope!r} not in rope | mrope | none")
        overrides = {}
        if fuse_perms:
            mq = policy.plan(d_model, n_heads * head_dim, "attn_qkv",
                             seed_salt=seed_salt * 4 + 0)
            if mq is not None:
                for name, salt in (("wk", 1), ("wv", 2)):
                    d_out = n_kv_heads * head_dim
                    m = policy.plan(d_model, d_out, "attn_qkv",
                                    seed_salt=seed_salt * 4 + salt)
                    if m is not None and m.nb == mq.nb:
                        overrides[name] = make_mask_spec(
                            d_model, d_out, m.nb, seed=m.seed,
                            in_perm=mq.in_perm, out_perm=m.out_perm)

        def mk(d_in, d_out, kind, salt, name=None):
            return Linear.make(policy, d_in, d_out, kind, use_bias=use_bias,
                               seed_salt=seed_salt * 4 + salt,
                               mask_override=overrides.get(name))
        return AttentionSpec(
            d_model, n_heads, n_kv_heads, head_dim, causal, rope, rope_theta,
            tuple(mrope_sections), q_chunk, use_bias,
            wq=mk(d_model, n_heads * head_dim, "attn_qkv", 0),
            wk=mk(d_model, n_kv_heads * head_dim, "attn_qkv", 1, "wk"),
            wv=mk(d_model, n_kv_heads * head_dim, "attn_qkv", 2, "wv"),
            wo=mk(n_heads * head_dim, d_model, "attn_out", 3),
        )

    @functools.cached_property
    def shared_pack(self) -> bool:
        """Whether q, k and v are packed projections with one input
        permutation, so one gather of ``x`` feeds all three."""
        specs = [getattr(self, n).spec for n in ("wq", "wk", "wv")]
        return all(s.mode == "packed" and s.mask is not None
                   and not s.skip_in_perm for s in specs) and all(
            np.array_equal(s.mask.in_perm, specs[0].mask.in_perm)
            for s in specs[1:])

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        return {n: getattr(self, n).init(generator, dtype, device)
                for n in ("wq", "wk", "wv", "wo")}


def _cos_sin(spec: AttentionSpec, positions):
    """cos/sin ``(B, T, head_dim/2)`` at ``positions``: ``(B, T)``, or
    ``(3, B, T)`` (temporal, height, width) for M-RoPE; ``(None, None)``
    without a rotary encoding."""
    if spec.rope == "mrope":
        return layers.mrope_cos_sin(positions, spec.head_dim,
                                    spec.mrope_sections, spec.rope_theta)
    if spec.rope == "rope":
        return layers.rope_cos_sin(positions, spec.head_dim, spec.rope_theta)
    return None, None


def text_positions(spec: AttentionSpec, positions):
    """``positions (B, T)`` as the encoding takes them: three identical
    rows ``(3, B, T)`` for M-RoPE (text only: t == h == w ids), as is
    otherwise."""
    if spec.rope == "mrope":
        return torch.stack([positions, positions, positions])
    return positions


def _qkv(spec: AttentionSpec, params, x, positions):
    B, T, _ = x.shape
    packed = spec.shared_pack
    if packed:
        x = fold_lib.pack_inputs(spec.wq.spec.mask, x)

    def proj(name):
        return getattr(spec, name).apply(params[name], x, packed_input=packed)
    q = proj("wq").reshape(B, T, spec.n_heads, spec.head_dim)
    k = proj("wk").reshape(B, T, spec.n_kv_heads, spec.head_dim)
    v = proj("wv").reshape(B, T, spec.n_kv_heads, spec.head_dim)
    cos, sin = _cos_sin(spec, positions)
    if cos is not None:
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    return q, k, v


def _attend(q, k, v, q_pos, causal: bool, kv_valid=None):
    """Attention of one query block against the full K/V: ``q (B, Tq, H,
    Dh)``, ``k``/``v`` ``(B, S, Kh, Dh)``, ``q_pos (Tq,)`` global positions,
    ``kv_valid (B, S)`` bool or None. Scores in f32, masked to ``-1e30``,
    ``p`` cast to V's dtype before PV; GQA by head groups."""
    B, Tq, H, Dh = q.shape
    S, Kh = k.shape[1], k.shape[2]
    q5 = q.reshape(B, Tq, Kh, H // Kh, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k).float() * Dh ** -0.5
    if causal:
        kv_pos = torch.arange(S, device=q.device)
        cmask = q_pos[:, None] >= kv_pos[None, :]
        logits = logits.masked_fill(~cmask, -1e30)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Tq, H, Dh)


def attend_full(spec: AttentionSpec, q, k, v):
    """Training attention over the whole sequence, chunked over the query
    axis at ``spec.q_chunk`` (one chunk when ``T`` is not a multiple)."""
    B, T, H, Dh = q.shape
    cq = spec.q_chunk
    pos = torch.arange(T, device=q.device)
    if T <= cq or T % cq:
        return _attend(q, k, v, pos, spec.causal)
    return torch.cat([_attend(q[:, i:i + cq], k, v, pos[i:i + cq],
                              spec.causal) for i in range(0, T, cq)], dim=1)


def apply_train(spec: AttentionSpec, params, x, positions=None):
    """Full-sequence attention (training). ``x: (B, T, D)``; ``positions``
    ``(B, T)`` (``(3, B, T)`` for M-RoPE), by default ``0..T-1`` on every
    row (M-RoPE: the same ids in all three rows)."""
    B, T, _ = x.shape
    if positions is None:
        positions = text_positions(
            spec, torch.arange(T, device=x.device)[None].expand(B, T))
    q, k, v = _qkv(spec, params, x, positions)
    o = attend_full(spec, q, k, v)
    return spec.wo.apply(params["wo"],
                         o.reshape(B, T, spec.n_heads * spec.head_dim))


def init_cache(spec: AttentionSpec, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """Dense decode cache: ``(batch, max_len, Kh, Dh)`` K/V and a scalar
    ``pos`` (every row at one depth; the slot caches make it ``(batch,)``)."""
    shape = (batch, max_len, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _update_rows(cache, new, pos):
    """Write ``new (B, 1, Kh, Dh)`` into ``cache (B, S, Kh, Dh)`` at the
    per-row position ``pos (B,)``, in place: one ``index_put_``. A position
    past the end clamps to ``S - 1``, as the reference's
    ``dynamic_update_slice`` does (a free slot keeps advancing)."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    cache.index_put_((rows, pos.clamp(0, S - 1).long()),
                     new[:, 0].to(cache.dtype))
    return cache


def apply_decode(spec: AttentionSpec, params, x, cache):
    """One decode step against the dense cache. ``x: (B, 1, D)``; ``cache``:
    ``{"k"/"v": (B, S, Kh, Dh), "pos"}`` with ``pos`` a scalar (lockstep:
    every row at one depth) or ``(B,)`` (slots: each row at its own).
    RoPE, the K/V write and the validity mask follow each row's ``pos``;
    attention reads the whole ``S`` under that mask. ``pos`` advances by 1
    on every row, in place."""
    B, T, _ = x.shape
    assert T == 1
    pos = cache["pos"]
    pos_b = pos if pos.dim() == 1 else pos.expand(B)
    q, k_new, v_new = _qkv(spec, params, x,
                           text_positions(spec, pos_b[:, None]))
    k = _update_rows(cache["k"], k_new, pos_b)
    v = _update_rows(cache["v"], v_new, pos_b)
    S = k.shape[1]
    kv_valid = torch.arange(S, device=x.device)[None, :] <= pos_b[:, None]
    o = _attend(q, k.to(q.dtype), v.to(q.dtype), None, False,
                kv_valid=kv_valid)
    y = spec.wo.apply(params["wo"],
                      o.reshape(B, 1, spec.n_heads * spec.head_dim))
    pos.add_(1)
    return y, cache


def init_paged_cache(spec: AttentionSpec, n_slots: int, n_pages: int,
                     page_size: int, dtype=torch.float32, device=None):
    """A global K/V page pool plus a per-slot ``pos``. Page 0 is the
    reserved null page: block-table entries past a request's depth point at
    it, so padded scatters always hit a valid pool index."""
    shape = (n_pages, page_size, spec.n_kv_heads, spec.head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device)}


def _last_writes(dest: torch.Tensor) -> torch.Tensor:
    """For each write ``i`` to ``dest (N,)``, the last write ``j >= i`` to the
    same destination. Gathering the written values through it gives every
    write to one destination the same value, the last one's, as the
    reference's scatter and a sequential ``index_put_`` leave it: a CUDA
    ``index_put_`` with duplicate indices keeps an arbitrary one. Non-live
    rows all write to the null page, which they also read, and an MoE layer
    routes them with the live rows, so its contents must not depend on
    which duplicate landed."""
    same = dest[:, None] == dest[None, :]
    order = torch.arange(dest.shape[0], device=dest.device)
    return torch.where(same, order[None, :], -1).amax(dim=1)


def apply_decode_paged(spec: AttentionSpec, params, x, cache, block_tables,
                       live=None):
    """One decode step against the paged KV pool. x: (B, 1, D).

    ``cache``: {"kp"/"vp": (n_pages, page_size, Kh, Dh), "pos": (B,)}. The
    new K/V is scattered at ``(page, offset)`` from each row's ``pos``, then
    attention runs through :func:`repro_torch.kernels.ops.paged_attention`.
    ``live`` (B,) bool masks the rows actually decoding; it is load-bearing:
    a non-live row (mid chunked prefill) holds a real block table, and its
    clipped page index could alias an already-prefilled shared page, so
    non-live rows scatter to the null page and their ``pos`` freezes.
    """
    from repro_torch.kernels import ops

    B, T, _ = x.shape
    assert T == 1
    kp, vp = cache["kp"], cache["vp"]
    page_size = kp.shape[1]
    P = block_tables.shape[1]
    pos = cache["pos"]
    q, k_new, v_new = _qkv(spec, params, x,
                           text_positions(spec, pos[:, None]))
    pidx = torch.clamp(pos // page_size, 0, P - 1).long()
    pages = torch.gather(block_tables, 1, pidx[:, None])[:, 0].long()
    if live is not None:
        pages = torch.where(live, pages, torch.zeros_like(pages))
    offs = (pos % page_size).long()
    last = _last_writes(pages * page_size + offs)
    kp.index_put_((pages, offs), k_new[last, 0].to(kp.dtype))
    vp.index_put_((pages, offs), v_new[last, 0].to(vp.dtype))
    o = ops.paged_attention(q[:, 0], kp, vp, block_tables, pos + 1)
    y = spec.wo.apply(params["wo"],
                      o.reshape(B, 1, spec.n_heads * spec.head_dim))
    pos.add_(1 if live is None else live.to(pos.dtype))
    return y, cache


def apply_verify_paged(spec: AttentionSpec, params, x, cache, block_tables,
                       live=None):
    """Speculative-verify window against the paged KV pool. x: (B, Tq, D).

    The window's ``Tq`` tokens sit at positions ``pos .. pos+Tq-1`` with
    ``pos = cache["pos"]`` the accepted depth the engine set
    (``Model.set_paged_pos``). Each token's K/V is scattered to its
    ``(page, offset)`` (non-live rows to the null page, as in
    :func:`apply_decode_paged`), then all ``Tq`` queries attend in one
    :func:`repro_torch.kernels.ops.paged_attention_verify` call, causal
    inside the window. ``pos`` is left **unchanged**: in spec mode the host
    owns the depth and rejected positions are simply written over next
    step.
    """
    from repro_torch.kernels import ops

    B, Tq, _ = x.shape
    kp, vp = cache["kp"], cache["vp"]
    page_size = kp.shape[1]
    P = block_tables.shape[1]
    pos = cache["pos"]
    pos_bt = pos[:, None] + torch.arange(Tq, device=x.device)[None, :]
    q, k_new, v_new = _qkv(spec, params, x, text_positions(spec, pos_bt))
    pidx = torch.clamp(pos_bt // page_size, 0, P - 1).long()
    pages = torch.gather(block_tables, 1, pidx).long()          # (B, Tq)
    if live is not None:
        pages = torch.where(live[:, None], pages, torch.zeros_like(pages))
    offs = (pos_bt % page_size).long()
    last = _last_writes((pages * page_size + offs).reshape(-1))
    kp.index_put_((pages, offs), k_new.flatten(0, 1)[last].reshape(
        k_new.shape).to(kp.dtype))
    vp.index_put_((pages, offs), v_new.flatten(0, 1)[last].reshape(
        v_new.shape).to(vp.dtype))
    o = ops.paged_attention_verify(q, kp, vp, block_tables, pos + Tq)
    y = spec.wo.apply(params["wo"],
                      o.reshape(B, Tq, spec.n_heads * spec.head_dim))
    return y, cache


def prefill_chunk_paged(spec: AttentionSpec, params, x, cache, bt_row,
                        slot, start, chunk_len):
    """One page-aligned prefill chunk of a single request (batch 1).

    ``x: (1, Tc, D)`` with ``Tc`` a page multiple and ``start`` page-aligned;
    ``chunk_len <= Tc`` real tokens. ``slot``, ``start`` and ``chunk_len``
    are host integers or 0-d integer tensors on x's device (as the
    reference takes device scalars): positions, page ids and the ``pos``
    write are computed from them on the device, with no host read, so a
    captured chunk replays at any slot, start and length. The chunk's K/V
    is scattered into its pages — a padded tail reaching past the table goes
    to the null page, not to a clamped index that would overwrite real K/V —
    then the chunk attends over the request's whole cached context through
    :func:`repro_torch.kernels.ops.paged_prefill_attention`.
    """
    from repro_torch.kernels import ops

    B, Tc, _ = x.shape
    assert B == 1
    kp, vp = cache["kp"], cache["vp"]
    page_size = kp.shape[1]
    P = bt_row.shape[0]
    assert Tc % page_size == 0, (Tc, page_size)
    n_chunk_pages = Tc // page_size
    dev = x.device
    positions = text_positions(
        spec, (start + torch.arange(Tc, device=dev))[None])
    q, k, v = _qkv(spec, params, x, positions)
    idx = start // page_size + torch.arange(n_chunk_pages, device=dev)
    page_ids = torch.where(idx < P, bt_row[torch.clamp(idx, 0, P - 1)].long(),
                           torch.zeros_like(idx))
    Kh, Dh = spec.n_kv_heads, spec.head_dim
    last = _last_writes(page_ids)           # pages past the table: null
    kp.index_put_((page_ids,), k[0].reshape(n_chunk_pages, page_size, Kh,
                                            Dh)[last].to(kp.dtype))
    vp.index_put_((page_ids,), v[0].reshape(n_chunk_pages, page_size, Kh,
                                            Dh)[last].to(vp.dtype))
    o = ops.paged_prefill_attention(q[0], kp, vp, bt_row, start, chunk_len)
    y = spec.wo.apply(params["wo"],
                      o.reshape(1, Tc, spec.n_heads * spec.head_dim))
    pos = cache["pos"]
    depth = start + chunk_len
    if torch.is_tensor(slot) or torch.is_tensor(depth):
        pos.index_put_((torch.as_tensor(slot, device=dev).reshape(1).long(),),
                       torch.as_tensor(depth, device=dev).reshape(1)
                       .to(pos.dtype))
    else:
        pos[slot] = depth
    return y, cache
