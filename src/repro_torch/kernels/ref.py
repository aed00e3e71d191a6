"""Plain PyTorch versions of the kernels (the port of ``repro.kernels.ref``).

They repeat the reference's arithmetic order step for step, so on the CPU
the port matches the JAX jnp route to float32 rounding; on the card they
are what each CUDA kernel is held against. ``ACTIVATIONS`` is the one
registry both the kernel epilogues and the model graph draw from.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30

ACTIVATIONS = {
    None: lambda x: x,
    "relu": torch.relu,
    # tanh approximation, as jax.nn.gelu's default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    # jax.nn.softplus: logaddexp(x, 0), not torch's threshold form
    "softplus": lambda x: torch.clamp_min(x, 0) + torch.log1p(
        torch.exp(-x.abs())),
    "sqrelu": lambda x: torch.square(torch.relu(x)),
}


def gated(activation: Optional[str]):
    """The gated hidden epilogue ``act(gate) * up`` of fused MLPs
    (``"silu"`` is SwiGLU), as a callable ``(gate, up) -> h``."""
    act = ACTIVATIONS[activation]
    return lambda g, u: act(g) * u


def bdmm_ref(x, wp, bias=None, activation: Optional[str] = None):
    """Block-diagonal matmul: ``(..., nb*bi) x (nb, bi, bo) -> (..., nb*bo)``.
    ``bias`` is packed ``(nb*bo,)``. Computed in the input dtype, like the
    reference einsum."""
    nb, bi, bo = wp.shape
    lead = x.shape[:-1]
    xb = x.reshape(*lead, nb, bi)
    y = torch.einsum("...nk,nko->...no", xb, wp).reshape(*lead, nb * bo)
    if bias is not None:
        y = y + bias
    return ACTIVATIONS[activation](y)


def bdmm_t_ref(g, wp):
    """The transposed-blocks form ``g @ blockdiag(wp)ᵀ``, ``(..., nb*bo) x
    (nb, bi, bo) -> (..., nb*bi)``: the input gradient of :func:`bdmm_ref`,
    as the reference's backward computes it."""
    return bdmm_ref(g, wp.transpose(1, 2).contiguous())


def masked_matmul_ref(x, w, mask, bias=None, activation: Optional[str] = None):
    """Paper-faithful masked matmul: ``act(x @ (mask ∘ w) + bias)``,
    ``x (..., d_in)``, ``w``/``mask`` ``(d_in, d_out)``; computed in the
    input dtype, like the reference's ``jnp.dot``."""
    y = x @ (w * mask.to(w.dtype))
    if bias is not None:
        y = y + bias
    return ACTIVATIONS[activation](y)


def masked_matmul_t_ref(g, w, mask):
    """The transposed form ``g @ (mask ∘ w)ᵀ``, ``w``/``mask`` ``(d_in,
    d_out)``: the input gradient, as the reference's jnp backward computes
    it."""
    return g @ (w * mask.to(w.dtype)).T


def matmul_masked_grad_ref(x, g, mask):
    """Weight gradient of the masked matmul: ``(xᵀ @ g) ∘ mask`` summed over
    every leading axis (an SDDMM: the output sampled by the mask). A
    multiply, as in the reference: a non-finite sum gives NaN off the mask,
    where the kernel writes an exact zero."""
    return torch.einsum("...i,...o->io", x, g) * mask.to(x.dtype)


def bdmm_quant_ref(x, wq, scale, bias=None, activation: Optional[str] = None):
    """Int8-weight block-diagonal matmul, in the kernel's order: raw
    int·x products accumulated in f32 (bf16·int8 products are exact in
    f32), then ``* scale`` per output channel, then bias, then activation,
    then the cast to the input dtype.

    ``wq: (nb, bi, bo)`` int8; ``scale: (nb, bo)`` f32."""
    nb, bi, bo = wq.shape
    lead = x.shape[:-1]
    xb = x.reshape(*lead, nb, bi).float()
    y = torch.einsum("...nk,nko->...no", xb, wq.float())
    y = y * scale
    if bias is not None:
        y = y + bias.reshape(nb, bo).float()
    y = ACTIVATIONS[activation](y).to(x.dtype)
    return y.reshape(*lead, nb * bo)


def fused_ffn_ref(x, w_up, w_down, w_gate=None, b_up=None, b_gate=None,
                  b_down=None, activation: Optional[str] = "silu"):
    """Block-diagonal fused MLP (the perm-fused packed FFN, hidden in block
    order): ``h = act(x@Wg + bg) * (x@Wu + bu)`` when gated, else
    ``h = act(x@Wu + bu)``; returns ``h @ Wd + bd``. ``x (..., nb*bi)``,
    ``w_up``/``w_gate (nb, bi, f)``, ``w_down (nb, f, bo)``, biases packed
    ``(nb*f,)`` / ``(nb*bo,)``. Each projection is a :func:`bdmm_ref` in the
    input dtype, as the reference composes it."""
    if w_gate is None and b_gate is not None:
        raise ValueError("fused_ffn_ref: b_gate given but w_gate is None")
    u = bdmm_ref(x, w_up, b_up)
    if w_gate is not None:
        h = gated(activation)(bdmm_ref(x, w_gate, b_gate), u)
    else:
        h = ACTIVATIONS[activation](u)
    return bdmm_ref(h, w_down, b_down)


def fused_ffn_quant_ref(x, w_up, w_down, w_gate=None, b_up=None, b_gate=None,
                        b_down=None, s_up=None, s_gate=None, s_down=None,
                        activation: Optional[str] = "silu"):
    """Int8-weight fused MLP: each projection is a :func:`bdmm_quant_ref`
    (raw product in f32, then its scale, then its bias, cast to the input
    dtype), so ``s_up``/``s_gate (nb, f)`` rescale before the hidden
    epilogue and ``s_down (nb, bo)`` comes after the f-sum."""
    if w_gate is None and (b_gate is not None or s_gate is not None):
        raise ValueError(
            "fused_ffn_quant_ref: gate bias/scale given but w_gate is None")
    u = bdmm_quant_ref(x, w_up, s_up, b_up)
    if w_gate is not None:
        h = gated(activation)(bdmm_quant_ref(x, w_gate, s_gate, b_gate), u)
    else:
        h = ACTIVATIONS[activation](u)
    return bdmm_quant_ref(h, w_down, s_down, b_down)


def bdmm_split_ref(x, wp, bias=None, scale=None,
                   activation: Optional[str] = None, k_chunk: int = 64):
    """The order of bdmm's decode grid (``decode_tc``), in plain PyTorch: the
    K range of each split (``k_chunk`` rows, from ``plan``) reduced in f32,
    the split partials added in the order s = 0, 1, ... from zero, then
    ``* scale``, ``+ bias``, the activation and one cast to x's dtype.
    ``wp (nb, bi, bo)`` in x's dtype or int8 (with ``scale (nb, bo)``)."""
    nb, bi, bo = wp.shape
    lead = x.shape[:-1]
    xb = x.reshape(-1, nb, bi).float()
    w = wp.float()
    y = torch.zeros(xb.shape[0], nb, bo, dtype=torch.float32, device=x.device)
    for k0 in range(0, bi, k_chunk):
        y = y + torch.einsum("mnk,nko->mno", xb[..., k0:k0 + k_chunk],
                             w[:, k0:k0 + k_chunk])
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float().reshape(nb, bo)
    y = ACTIVATIONS[activation](y).to(x.dtype)
    return y.reshape(*lead, nb * bo)


def hi_lo(h):
    """``h`` (f32) as the pair of bf16 values ``(hi, lo)`` the fused MLP's
    tensor-core body feeds its down product: ``hi`` = bf16(h), ``lo`` =
    bf16(h - hi), so ``hi + lo`` is within 2^-16 |h| of h."""
    hi = h.to(torch.bfloat16)
    return hi, (h - hi.float()).to(torch.bfloat16)


def fused_ffn_split_ref(x, w_up, w_down, w_gate=None, b_up=None, b_gate=None,
                        b_down=None, s_up=None, s_gate=None, s_down=None,
                        activation: Optional[str] = "silu", f_tile: int = 64,
                        f_warp: int = 16, body: str = "tc", split: int = 1):
    """The order of the fused MLP's tensor-core bodies, in plain PyTorch: u
    and g in f32, scale, bias and gate in f32, the hidden as a hi + lo pair
    of bf16 and its down product in f32, then ``* s_down``, ``+ b_down`` and
    one cast to x's dtype. ``body="tc"``: per f tile (one block of the
    split) and per ``f_warp`` channels of it (one warp), the warps' partials
    added in warp order, the tiles' in the order s = 0, 1, ... from zero.
    ``body="tc_tall"``: the f tiles cut into ``split`` runs of consecutive
    tiles (one block each), each run's tiles (hi, then lo) accumulated from
    zero in one sum, the runs' partials added in rank order from zero.
    Weights in x's dtype, or int8 with their scales."""
    nb, bi, f = w_up.shape
    bo = w_down.shape[2]
    lead = x.shape[:-1]
    xb = x.reshape(-1, nb, bi).float()

    def proj(w, s, b):
        z = torch.einsum("mnk,nkf->mnf", xb, w.float())
        if s is not None:
            z = z * s.float()
        if b is not None:
            z = z + b.float().reshape(nb, f)
        return z
    u = proj(w_up, s_up, b_up)
    act = ACTIVATIONS[activation]
    h = act(proj(w_gate, s_gate, b_gate)) * u if w_gate is not None else act(u)
    hi, lo = hi_lo(h)
    wd = w_down.float()
    down = lambda h, sl: torch.einsum("mnf,nfo->mno",  # noqa: E731
                                      h[..., sl].float(), wd[:, sl])
    y = torch.zeros(xb.shape[0], nb, bo, dtype=torch.float32, device=x.device)
    if body == "tc_tall":
        n_ft = -(-f // f_tile)
        fpb = -(-n_ft // split)
        for r0 in range(0, n_ft, fpb):
            part = torch.zeros_like(y)
            for t in range(r0, min(r0 + fpb, n_ft)):
                sl = slice(t * f_tile, min((t + 1) * f_tile, f))
                part = part + down(hi, sl)
                part = part + down(lo, sl)
            y = y + part
    else:
        for t0 in range(0, f, f_tile):
            tile = None
            for w0 in range(t0, min(t0 + f_tile, f), f_warp):
                sl = slice(w0, min(w0 + f_warp, f))
                part = down(hi, sl) + down(lo, sl)
                tile = part if tile is None else tile + part
            y = y + tile
    if s_down is not None:
        y = y * s_down.float()
    if b_down is not None:
        y = y + b_down.float().reshape(nb, bo)
    return y.to(x.dtype).reshape(*lead, nb * bo)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Paged-attention decode: gather each row's pages into a contiguous KV
    view and run the dense decode computation (f32 softmax, ``-1e30``
    masking, ``p`` cast to the V dtype before PV).

    ``q: (B, H, Dh)``; pools ``(n_pages, page_size, Kh, Dh)``;
    ``block_tables: (B, P)`` int32; ``lengths: (B,)``. Returns ``(B, H, Dh)``.
    """
    B, H, Dh = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    P = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, P * page_size, n_kv, Dh).to(q.dtype)
    v = v_pages[bt].reshape(B, P * page_size, n_kv, Dh).to(q.dtype)
    g = H // n_kv
    q5 = q.reshape(B, 1, n_kv, g, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k).float()
    logits = logits * Dh ** -0.5
    valid = (torch.arange(P * page_size, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    # masked columns have p == 0 exactly; zeroing their V as well keeps a
    # stale NaN out of the sum (0 * NaN) and changes no finite result
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), dtype=v.dtype,
                                                             device=v.device))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype), v)
    return o.reshape(B, 1, H, Dh)[:, 0]


def paged_attention_verify_ref(q, k_pages, v_pages, block_tables, lengths):
    """Paged-attention verify window (speculative decoding): ``Tq`` queries
    per row, query ``t`` at position ``lengths[b] - Tq + t`` attending to
    ``kv_pos < lengths[b] - (Tq-1) + t`` (the window's K/V already in the
    pool). The decode computation per query: f32 softmax, ``-1e30``
    masking, ``p`` cast to the V dtype before PV; with ``Tq == 1`` it is
    :func:`paged_attention_ref`.

    ``q: (B, Tq, H, Dh)``; ``lengths: (B,)`` the depth at the last query.
    Returns ``(B, Tq, H, Dh)``."""
    B, Tq, H, Dh = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    P = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, P * page_size, n_kv, Dh).to(q.dtype)
    v = v_pages[bt].reshape(B, P * page_size, n_kv, Dh).to(q.dtype)
    g = H // n_kv
    q5 = q.reshape(B, Tq, n_kv, g, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k).float()
    logits = logits * Dh ** -0.5
    dev = q.device
    lengths = lengths.to(dev)
    kv_pos = torch.arange(P * page_size, device=dev)
    per_q_len = lengths[:, None] - (Tq - 1 - torch.arange(Tq, device=dev))
    valid = kv_pos[None, None, :] < per_q_len[:, :, None]        # (B, Tq, S)
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), NEG_INF, device=dev))
    p = torch.softmax(logits, dim=-1)
    # positions past the row's depth: p == 0 and V zeroed (NaN-safe, as in
    # paged_attention_ref); inside the window V was just written
    live = kv_pos[None, :] < lengths[:, None]
    v = torch.where(live[:, :, None, None], v, torch.zeros((), dtype=v.dtype,
                                                           device=dev))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype), v)
    return o.reshape(B, Tq, H, Dh)


def paged_prefill_attention_ref(q, k_pages, v_pages, bt_row, start,
                                chunk_len):
    """Chunked-prefill attention for ONE request's chunk against its paged
    context: query ``t`` (global position ``start + t``) attends to
    ``kv_pos <= start + t`` and ``kv_pos < start + chunk_len``. ``start``
    and ``chunk_len`` are host integers or 0-d tensors on q's device (the
    masks are built on the device; nothing is read back).

    ``q: (Tc, H, Dh)``; ``bt_row: (P,)``. The chunk's own K/V must already
    be scattered into the pool. Returns ``(Tc, H, Dh)``; rows past
    ``chunk_len`` are padding the caller never reads."""
    Tc, H, Dh = q.shape
    _, page_size, n_kv, _ = k_pages.shape
    P = bt_row.shape[0]
    S = P * page_size
    bt = bt_row.long()
    k = k_pages[bt].reshape(1, S, n_kv, Dh).to(q.dtype)
    v = v_pages[bt].reshape(1, S, n_kv, Dh).to(q.dtype)
    g = H // n_kv
    q5 = q.reshape(1, Tc, n_kv, g, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5, k).float()
    logits = logits * Dh ** -0.5
    dev = q.device
    q_pos = start + torch.arange(Tc, device=dev)
    kv_pos = torch.arange(S, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    cmask = q_pos[:, None] >= kv_pos[None, :]
    logits = torch.where(cmask[None, None, None], logits, neg)
    kv_valid = kv_pos < start + chunk_len
    logits = torch.where(kv_valid[None, None, None, None, :], logits, neg)
    p = torch.softmax(logits, dim=-1)
    # positions past the depth: p == 0 and V zeroed (NaN-safe, see above)
    v = torch.where(kv_valid[None, :, None, None], v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(1, Tc, H, Dh)[0]


def paged_split_partials_ref(q, k_pages, v_pages, block_tables, horizon,
                             split_pages: int):
    """What the split-KV blocks write, in plain torch: for every query row
    and every split of ``split_pages`` pages (boundaries at multiples of
    ``split_pages`` pages from position 0), the split's running max ``m``,
    normaliser ``l`` and unnormalised output ``acc``, in f32, over the
    positions the query sees (``kv_pos < horizon``); ``p`` is cast to the V
    dtype before PV. A split the query sees nothing of gives the empty
    partial (``-inf``, 0, 0).

    ``q: (B, T, H, Dh)``; ``block_tables: (B, P)``; ``horizon: (B, T)``.
    Returns ``m, l (B, T, H, S)`` and ``acc (B, T, H, S, Dh)``."""
    B, T, H, Dh = q.shape
    _, ps, n_kv, _ = k_pages.shape
    P = block_tables.shape[1]
    n_s = -(-P // split_pages)
    sp = split_pages * ps
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, P * ps, n_kv, Dh).to(q.dtype)
    v = v_pages[bt].reshape(B, P * ps, n_kv, Dh).to(q.dtype)
    pad = n_s * sp - P * ps                          # the last split's tail
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    horizon = horizon.to(dev)
    kv_pos = torch.arange(n_s * sp, device=dev)
    valid = kv_pos[None, None, :] < horizon[:, :, None]           # (B, T, S)
    # positions past every query's horizon: V zeroed (NaN-safe, as above)
    live = kv_pos[None, :] < horizon.max(dim=1).values[:, None]
    v = torch.where(live[:, :, None, None], v,
                    torch.zeros((), dtype=v.dtype, device=dev))
    g = H // n_kv
    q5 = q.reshape(B, T, n_kv, g, Dh)
    s = torch.einsum("btkgd,bskd->btkgs", q5, k).float() * Dh ** -0.5
    neg = torch.full((), float("-inf"), device=dev)
    s = torch.where(valid[:, :, None, None], s, neg)
    s = s.reshape(B, T, n_kv, g, n_s, sp)
    m = s.amax(dim=-1)
    p = torch.where(s == neg, torch.zeros((), device=dev),
                    torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    acc = torch.einsum("btkgns,bnskd->btkgnd", p.to(v.dtype),
                       v.reshape(B, n_s, sp, n_kv, Dh)).float()
    return (m.reshape(B, T, H, n_s), l.reshape(B, T, H, n_s),
            acc.reshape(B, T, H, n_s, Dh))


def combine_splits_ref(m, l, acc, dtype=torch.float32):
    """The split-KV combine kernel in plain torch: ``M = max_s m_s``, then
    ``L = sum_s w_s l_s`` and ``O = sum_s w_s acc_s`` with ``w_s =
    exp(m_s - M)``, added in split order over the non-empty splits (an
    empty split, ``m_s = -inf``, is skipped), and one division ``O / L``
    cast to ``dtype``. ``m, l: (..., S)``; ``acc: (..., S, Dh)``."""
    M = m.amax(dim=-1)
    L = torch.zeros_like(M)
    O = torch.zeros_like(acc[..., 0, :])
    for s in range(m.shape[-1]):
        live = m[..., s] != float("-inf")
        w = torch.exp(torch.where(live, m[..., s] - M, torch.zeros_like(M)))
        L = torch.where(live, L + w * l[..., s], L)
        O = torch.where(live[..., None], O + w[..., None] * acc[..., s, :], O)
    return (O / L.clamp_min(1e-30)[..., None]).to(dtype)
