"""Kernel entry points with backend routing and autograd rules (the port of
``repro.kernels.ops`` for the serving and training paths).

* CPU tensors always take the plain PyTorch version.
* CUDA tensors launch the hand-written kernel, which raises on anything it
  cannot run (inputs on mixed devices included); it never falls back.
* ``set_backend("torch")`` forces the plain version on the card as well; it
  exists so that ``chip_smoke.py`` and the tests can hold the kernels
  against their plain versions on the same inputs. The default is
  ``"cuda"``.
* ``set_prefill_backend`` routes the paged prefill attention alone: None
  follows the global backend, ``"cuda"`` or ``"torch"`` overrides it (the
  serve launcher's ``--prefill-kernel``). It is read when a call is made,
  so a captured program keeps the route it was captured under.

``fused_ffn`` runs a perm-fused packed MLP as one kernel, under grad as
well: its autograd rule (the reference's ``custom_vjp``) saves x, the
weights and the biases, not the hidden, and its backward recomputes the
block-local pre-activations with bdmm launches, takes the (gated)
activation's vjp elementwise, and composes ``dh`` and ``dx`` from bdmm
launches with transposed blocks; the weight gradients are einsums, as in
the reference. ``fused_ffn_quant`` stays inference-only, as the
reference's, and raises under grad.

``bdmm`` and ``masked_matmul`` are differentiable, mirroring the
reference's custom VJPs with ``torch.autograd.Function``. Outside
differentiation the forward is one fused call (bias and activation in the
kernel epilogue). Under grad with an activation, the forward runs the
kernel without it, applies the activation outside and saves the
pre-activation ``z``, so the backward needs no recompute. The backward of
``masked_matmul`` is two more kernels, ``dx`` with the transposed
orientation and ``dW`` with ``sddmm_masked`` (off-mask entries exactly 0);
the mask gets no gradient. The backward of ``bdmm`` is a bdmm with
transposed blocks for ``dx`` (the kernel reads the blocks as stored) and an
einsum for ``dwp``, which the reference also computes outside any kernel.
The int8 and attention forms are inference-only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import bdmm as bdmm_kernel
from . import fused_ffn as ffn_kernel
from . import masked_matmul as mm_kernel
from . import paged_attention as paged_attn_kernel
from . import paged_prefill as paged_prefill_kernel
from . import ref

BACKENDS = ("cuda", "torch")
_BACKEND = "cuda"
_PREFILL_BACKEND: Optional[str] = None
_KERNEL_MODULES = (bdmm_kernel, ffn_kernel, mm_kernel, paged_attn_kernel,
                   paged_prefill_kernel)


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"backend {name!r} not in {BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def set_prefill_backend(name: Optional[str]) -> None:
    """Route the paged prefill attention: None follows the global backend,
    ``"cuda"`` or ``"torch"`` overrides it. CPU tensors take the plain
    version whatever is set."""
    global _PREFILL_BACKEND
    if name is not None and name not in BACKENDS:
        raise ValueError(f"prefill backend {name!r} not in {BACKENDS}")
    _PREFILL_BACKEND = name


def prefill_backend() -> str:
    return _PREFILL_BACKEND if _PREFILL_BACKEND is not None else _BACKEND


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    out: Dict[str, int] = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.launches)
    return out


def counters() -> Tuple[Dict[str, int], ...]:
    """Every counting dict the kernel wrappers add to: each kernel module's
    ``launches``, the tallies by route of bdmm (all launches, and the
    transposed ones), the fused MLP, the masked matmul, the SDDMM and the
    paged attention kernels, and bdmm's launches by epilogue. A captured
    CUDA graph (:mod:`repro_torch.serve.graphs`) adds its capture's share
    to them on every replay."""
    return (*(mod.launches for mod in _KERNEL_MODULES), bdmm_kernel.routes,
            bdmm_kernel.transposed_routes, ffn_kernel.routes,
            mm_kernel.routes, mm_kernel.sddmm_routes,
            paged_attn_kernel.routes, bdmm_kernel.epilogues)


def reset_launch_counts() -> None:
    """Zero every kernel's launch count (and the tallies by route of bdmm,
    its transposed launches, the fused MLP, the masked matmul, the SDDMM
    and the paged attention kernels, and bdmm's by epilogue)."""
    for counts in counters():
        for k in counts:
            counts[k] = 0


def _plain(*tensors) -> bool:
    """Whether a call takes the plain version: under the ``"torch"``
    backend, or when every tensor it was given lies on the CPU."""
    return _BACKEND == "torch" or all(
        t.device.type == "cpu" for t in tensors if t is not None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _act_bwd(activation: Optional[str], z, g):
    """The upstream cotangent composed with the activation's gradient at the
    pre-activation ``z``, by autograd through the registry entry, so the
    backward cannot drift from the forward's definition."""
    if activation is None:
        return g
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        return torch.autograd.grad(ref.ACTIVATIONS[activation](zz), zz, g)[0]


# ---------------------------------------------------------------------- bdmm
def _bdmm_raw(x, wp, bias, activation):
    if _plain(x, wp, bias):
        return ref.bdmm_ref(x, wp, bias, activation)
    return bdmm_kernel.bdmm(x, wp, bias, activation=activation)


def bdmm_t(g, wp):
    """``g @ blockdiag(wp)ᵀ``, ``(..., nb*bo) -> (..., nb*bi)``: the input
    gradient of :func:`bdmm` (the kernel's transposed-blocks orientation,
    reading ``wp`` as stored)."""
    if _plain(g, wp):
        return ref.bdmm_t_ref(g, wp)
    return bdmm_kernel.bdmm(g, wp, transpose=True)


class _Bdmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wp, bias, activation):
        z = _bdmm_raw(x, wp, bias, None)
        ctx.activation = activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, wp, z if activation is not None else None)
        return ref.ACTIVATIONS[activation](z)

    @staticmethod
    def backward(ctx, g):
        x, wp, z = ctx.saved_tensors
        nb, bi, bo = wp.shape
        lead = x.shape[:-1]
        g = _act_bwd(ctx.activation, z, g)
        dx = dwp = db = None
        if ctx.needs_input_grad[0]:
            # dx[:, n] = g[:, n] @ wp[n]^T: a bdmm with transposed blocks
            dx = bdmm_t(g, wp).reshape(*lead, nb * bi)
        if ctx.needs_input_grad[1]:
            dwp = torch.einsum("tnk,tno->nko", x.reshape(-1, nb, bi),
                               g.reshape(-1, nb, bo)).to(wp.dtype)
        if ctx.needs_input_grad[2]:
            db = g.reshape(-1, nb * bo).sum(0).to(ctx.bias_dtype)
        return dx, dwp, db, None


def bdmm(x, wp, bias=None, *, activation: Optional[str] = None):
    """Differentiable fused block-diagonal matmul
    ``act(x @ blockdiag(wp) + bias)``, ``(..., nb*bi) -> (..., nb*bo)``;
    ``bias`` packed ``(nb*bo,)``."""
    if not _needs_grad(x, wp, bias):
        return _bdmm_raw(x, wp, bias, activation)
    return _Bdmm.apply(x, wp, bias, activation)


def bdmm_quant(x, wq, scale, bias=None, *, activation: Optional[str] = None):
    """Int8-weight block-diagonal matmul; ``scale (nb, bo)`` per output
    channel, applied to the f32 accumulator before bias and activation."""
    if _plain(x, wq, scale, bias):
        return ref.bdmm_quant_ref(x, wq, scale, bias, activation)
    return bdmm_kernel.bdmm(x, wq, bias, scale, activation=activation)


# ------------------------------------------------------------- masked matmul
def _masked_matmul_raw(x, w, mask, bias, activation):
    if _plain(x, w, mask, bias):
        return ref.masked_matmul_ref(x, w, mask, bias, activation)
    return mm_kernel.masked_matmul(x, w, mask, bias, activation=activation)


def masked_matmul_t(g, w, mask):
    """``g @ (mask ∘ w)ᵀ`` for ``w``/``mask`` ``(d_in, d_out)``: the input
    gradient of :func:`masked_matmul` (the kernel's ``transpose_rhs``
    orientation)."""
    if _plain(g, w, mask):
        return ref.masked_matmul_t_ref(g, w, mask)
    return mm_kernel.masked_matmul(g, w, mask, transpose_rhs=True)


def sddmm_masked(x, g, mask):
    """``(xᵀ @ g) ∘ mask`` over every leading axis: the weight gradient of
    :func:`masked_matmul`, in x's dtype."""
    if _plain(x, g, mask):
        return ref.matmul_masked_grad_ref(x, g, mask)
    return mm_kernel.sddmm_masked(x, g, mask)


class _MaskedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mask, bias, activation):
        z = _masked_matmul_raw(x, w, mask, bias, None)
        ctx.activation = activation
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, w, mask,
                              z if activation is not None else None)
        return ref.ACTIVATIONS[activation](z)

    @staticmethod
    def backward(ctx, g):
        x, w, mask, z = ctx.saved_tensors
        g = _act_bwd(ctx.activation, z, g)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = masked_matmul_t(g, w, mask)
        if ctx.needs_input_grad[1]:
            dw = sddmm_masked(x, g, mask).to(w.dtype)
        if ctx.needs_input_grad[3]:
            db = g.reshape(-1, g.shape[-1]).sum(0).to(ctx.bias_dtype)
        return dx, dw, None, db, None


def masked_matmul(x, w, mask, bias=None, *, activation: Optional[str] = None):
    """Differentiable ``act(x @ (mask ∘ w) + bias)``: ``x (..., d_in)``,
    ``w (d_in, d_out)``, ``mask`` uint8 in w's layout (no gradient),
    ``bias (d_out,)``. Off-mask weight gradients are exact zeros."""
    if not _needs_grad(x, w, bias):
        return _masked_matmul_raw(x, w, mask, bias, activation)
    return _MaskedMatmul.apply(x, w, mask, bias, activation)


# ----------------------------------------------------------------- fused MLP
def _fused_ffn_raw(x, w_up, w_gate, w_down, b_up, b_gate, b_down, activation):
    if _plain(x, w_up, w_gate, w_down, b_up, b_gate, b_down):
        return ref.fused_ffn_ref(x, w_up, w_down, w_gate, b_up, b_gate,
                                 b_down, activation)
    return ffn_kernel.fused_ffn(x, w_up, w_down, w_gate, b_up, b_gate, b_down,
                                activation=activation)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_up, w_gate, w_down, b_up, b_gate, b_down,
                activation):
        ctx.activation = activation
        ctx.save_for_backward(x, w_up, w_gate, w_down, b_up, b_gate, b_down)
        return _fused_ffn_raw(x, w_up, w_gate, w_down, b_up, b_gate, b_down,
                              activation)

    @staticmethod
    def backward(ctx, g):
        """The reference's ``_fused_ffn_bwd``: recompute the (block-local)
        pre-activations, vjp through the hidden epilogue, then the
        per-block matmul gradients."""
        x, w_up, w_gate, w_down, b_up, b_gate, b_down = ctx.saved_tensors
        need = ctx.needs_input_grad
        nb, bi, f = w_up.shape
        bo = w_down.shape[2]
        lead = x.shape[:-1]
        gated = w_gate is not None
        with torch.enable_grad():
            z_u = _bdmm_raw(x, w_up, b_up, None).detach().requires_grad_(True)
            z = (z_u,)
            if gated:
                z_g = _bdmm_raw(x, w_gate, b_gate, None).detach()
                z = (z_g.requires_grad_(True), z_u)
                h = ref.gated(ctx.activation)(*z)
            else:
                h = ref.ACTIVATIONS[ctx.activation](z_u)
        dx = dw_up = dw_gate = dw_down = db_up = db_gate = db_down = None
        # down projection grads
        if need[3]:
            dw_down = torch.einsum("tnk,tno->nko", h.reshape(-1, nb, f),
                                   g.reshape(-1, nb, bo)).to(w_down.dtype)
        if need[6]:
            db_down = g.reshape(-1, nb * bo).sum(0).to(b_down.dtype)
        if not any(need[i] for i in (0, 1, 2, 4, 5)):
            return dx, dw_up, dw_gate, dw_down, db_up, db_gate, db_down, None
        # hidden epilogue grads -> up/gate pre-activation cotangents
        dh = bdmm_t(g, w_down)
        dz = torch.autograd.grad(h, z, dh)
        dz_g, dz_u = dz if gated else (None, dz[0])
        xb = x.reshape(-1, nb, bi)

        def proj_bwd(dz_, w, b, need_w, need_b):
            dw = (torch.einsum("tnk,tno->nko", xb, dz_.reshape(-1, nb, f))
                  .to(w.dtype) if need_w else None)
            db = dz_.reshape(-1, nb * f).sum(0).to(b.dtype) if need_b else None
            return dw, db

        dw_up, db_up = proj_bwd(dz_u, w_up, b_up, need[1], need[4])
        if need[0]:
            dx = bdmm_t(dz_u, w_up)
        if gated:
            dw_gate, db_gate = proj_bwd(dz_g, w_gate, b_gate, need[2], need[5])
            if need[0]:
                dx = dx + bdmm_t(dz_g, w_gate)
        if dx is not None:
            dx = dx.reshape(*lead, nb * bi)
        return dx, dw_up, dw_gate, dw_down, db_up, db_gate, db_down, None


def fused_ffn(x, w_up, w_down, *, w_gate=None, b_up=None, b_gate=None,
              b_down=None, activation: Optional[str] = "silu"):
    """Differentiable fused block-diagonal MLP, one kernel launch forward:
    ``(act(x@Wg+bg) * (x@Wu+bu)) @ Wd + bd`` when gated, else
    ``act(x@Wu+bu) @ Wd + bd``. ``x (..., nb*bi)``, ``w_up``/``w_gate (nb,
    bi, f)``, ``w_down (nb, f, bo)``, biases packed."""
    if w_gate is None and b_gate is not None:
        raise ValueError("fused_ffn: b_gate given but w_gate is None (the "
                         "plain form has no gate bias to apply)")
    tensors = (x, w_up, w_gate, w_down, b_up, b_gate, b_down)
    if not _needs_grad(*tensors):
        return _fused_ffn_raw(*tensors, activation)
    return _FusedFFN.apply(*tensors, activation)


def fused_ffn_quant(x, w_up, w_down, *, s_up, s_down, w_gate=None,
                    s_gate=None, b_up=None, b_gate=None, b_down=None,
                    activation: Optional[str] = "silu"):
    """Int8-weight fused block-diagonal MLP, one kernel launch; scales
    ``s_up``/``s_gate (nb, f)`` and ``s_down (nb, bo)``, biases in true
    scale. Inference only."""
    if w_gate is None and (b_gate is not None or s_gate is not None):
        raise ValueError("fused_ffn_quant: gate bias/scale given but w_gate "
                         "is None")
    tensors = (x, w_up, w_gate, w_down, s_up, s_gate, s_down, b_up, b_gate,
               b_down)
    if _needs_grad(*tensors):
        raise NotImplementedError(
            "fused_ffn_quant: int8 weights are a deployment artifact and are "
            "never trained through (no autograd rule, as in the reference)")
    if _plain(*tensors):
        return ref.fused_ffn_quant_ref(x, w_up, w_down, w_gate, b_up, b_gate,
                                       b_down, s_up, s_gate, s_down,
                                       activation)
    return ffn_kernel.fused_ffn(x, w_up, w_down, w_gate, b_up, b_gate, b_down,
                                s_up, s_gate, s_down, activation=activation)


# ------------------------------------------------------------------- serving
def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """One decode step of attention against the paged KV pool."""
    if _plain(q, k_pages, v_pages, block_tables, lengths):
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       lengths)
    return paged_attn_kernel.paged_attention(q, k_pages, v_pages,
                                             block_tables, lengths)


def paged_attention_verify(q, k_pages, v_pages, block_tables, lengths):
    """Speculative-verify attention: a ``(B, Tq, H, Dh)`` window of queries
    per row against the paged KV pool, causal inside the window
    (``lengths`` is the depth at the last window token)."""
    if _plain(q, k_pages, v_pages, block_tables, lengths):
        return ref.paged_attention_verify_ref(q, k_pages, v_pages,
                                              block_tables, lengths)
    return paged_attn_kernel.paged_attention_verify(q, k_pages, v_pages,
                                                    block_tables, lengths)


def paged_prefill_attention(q, k_pages, v_pages, bt_row, start, chunk_len):
    """Chunked-prefill attention for one request's ``(Tc, H, Dh)`` chunk
    against its paged context (chunk K/V already in the pool); ``start``
    and ``chunk_len`` host integers or 0-d tensors on q's device. Routed by
    :func:`prefill_backend`."""
    if prefill_backend() == "torch" or all(
            t.device.type == "cpu" for t in (q, k_pages, v_pages, bt_row)):
        return ref.paged_prefill_attention_ref(q, k_pages, v_pages, bt_row,
                                               start, chunk_len)
    return paged_prefill_kernel.paged_prefill_attention(
        q, k_pages, v_pages, bt_row, start, chunk_len)
