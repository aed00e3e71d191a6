"""Whole-model fold of masked-dense training into the packed deployment
form, the Fig-3 permutation-fusion rewrite and post-fold quantization (the
port of ``repro.core.export``).

:func:`fold_model` builds the packed twin of a ``masked_dense`` model (same
config and masks, packed parameterization), checks that every claimed
linear carries no weight mass off its mask, folds each stacked weight into
blocks (paper Eq. 2), optionally rewrites the FFN permutations so the
hidden stays in block order (:func:`apply_perm_fusion`) and optionally
quantizes the blocks (:func:`quantize_packed`, int8, or int4 for storage;
:func:`dequantize_packed` undoes it up to rounding).

An MoE block, as in the reference: its stacked expert weights ``(periods,
E, d_in, d_out)`` fold with the layer's one shared mask and stay raw fp
arrays (never quantized: the routed product is gather-bound, not
weight-stream-bound); its shared expert's linears fold and quantize like
any other; its router stays as trained; the perm-fusion rewrite skips its
FFN. A mamba or rwkv block's projections fold and quantize like an
attention block's; its raw leaves (the conv and its bias, ``A_log``, ``D``,
``dt_bias``; the mixes, ``w0``, the decay LoRA, ``u`` and ``ln_x``) stay
fp, and a mamba block's dense FFN takes the perm-fusion rewrite as an
attention block's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import quant as quant_lib
from . import fold as fold_lib
from . import permute
from .mask import MaskSpec

RESIDUAL_ATOL = 1e-6                 # the reference's default fold check


class FoldResidualError(ValueError):
    """A claimed linear carries weight mass off its mask: the weights were
    not trained with the masked-dense projection (Algorithm 1 line 14)."""


def _fold_stacked(mask_spec: MaskSpec, w: torch.Tensor,
                  path: str) -> torch.Tensor:
    """Fold a weight with any stacked leading axes into packed blocks,
    refusing one with off-mask mass above ``RESIDUAL_ATOL`` (the residual of
    :func:`fold.fold_residual`, which broadcasts the mask over the leading
    axes)."""
    res = fold_lib.fold_residual(mask_spec, w)
    if res > RESIDUAL_ATOL:
        raise FoldResidualError(
            f"{path}: fold residual {res:.3e} > {RESIDUAL_ATOL:.1e}: "
            "off-mask weight mass present; was this trained in masked_dense "
            "mode with the mask projection enabled?")
    return fold_lib.fold(mask_spec, w)


def fold_model(model, params, *, fuse: bool = False,
               quantize: Optional[str] = None) -> Tuple[Any, Dict[str, Any]]:
    """Fold a trained ``masked_dense`` model into its packed inference twin.
    Returns ``(packed_model, packed_params)``. ``fuse=True`` applies the
    Fig-3 permutation-fusion rewrite (:func:`apply_perm_fusion`); with
    ``quantize="int8"`` (or ``"int4"``) the blocks are quantized too and the
    round-trip report is set on ``packed_model.quant_report``."""
    from repro_torch.models import build

    cfg = model.cfg
    if cfg.mpd_mode != "masked_dense":
        raise ValueError(f"fold_model expects a masked_dense model, got "
                         f"mpd_mode={cfg.mpd_mode!r}")
    if quantize is not None and quantize not in quant_lib.BITS:
        raise ValueError(f"quantize={quantize!r} not in "
                         f"{sorted(quant_lib.BITS)} or None")
    model_pk = build(dataclasses.replace(cfg, mpd_mode="packed"))
    out = tree_lib.copy_tree(params)
    n_folded = 0
    # the packed twin's linears sit where the masked-dense ones do, with
    # the same masks
    for parent, key, lin, tag in iter_linear_leaves(model_pk, out):
        parent[key] = dict(parent[key], w=_fold_stacked(
            lin.spec.mask, parent[key]["w"], tag))
        n_folded += 1
    # MoE experts: one mask per layer, weights (periods, E, d_in, d_out)
    for bi_, (spec, pstack) in enumerate(zip(model_pk.block_specs,
                                             out["blocks"])):
        ffn = spec["ffn"]
        if not spec["kind"].endswith("_moe") or ffn.mode != "packed":
            continue
        for key, mask in ffn.expert_masks():
            if mask is not None:
                pstack["ffn"][key] = _fold_stacked(
                    mask, pstack["ffn"][key], f"blocks[{bi_}]/ffn/{key}")
                n_folded += 1
    if n_folded == 0:
        raise ValueError(f"fold_model: no compressed linears found "
                         f"(mpd_c={cfg.mpd_c}): nothing to fold")
    if fuse:
        out = apply_perm_fusion(model_pk, out)
    if quantize is not None:
        out, report = quantize_packed(model_pk, out,
                                      bits=quant_lib.BITS[quantize])
        model_pk.quant_report = report
    return model_pk, out


def iter_linear_leaves(model, params, mode: str = "packed", *,
                       moe_shared: bool = True
                       ) -> Iterator[Tuple[dict, str, Any, str]]:
    """Yield ``(parent, key, lin, tag)`` for every compressed linear of
    ``mode`` (mixer projections, FFN, the MoE shared expert unless
    ``moe_shared=False``, unembed) so passes can rewrite ``parent[key]``
    (the reference's ``_iter_packed_leaves``; without the shared expert,
    the walk of its ``mask_projection``). MoE routed experts are raw
    stacked arrays, not linears, and are not yielded."""
    for bi_, (spec, pstack) in enumerate(zip(model.block_specs,
                                             params["blocks"])):
        pairs = model.block_linears(spec)
        if moe_shared:
            pairs = pairs + model.moe_shared_linears(spec)
        for path, lin in pairs:
            if lin.spec.mode != mode or lin.spec.mask is None:
                continue
            node = pstack
            for k in path[:-1]:
                node = node[k]
            yield node, path[-1], lin, f"blocks[{bi_}]/" + "/".join(path)
    un = model.unembed
    if un.spec.mode == mode and un.spec.mask is not None:
        yield params, "unembed", un, "unembed"


def quantize_packed(model, params, *, bits: int = 8,
                    compute_report: bool = True
                    ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """Quantize every packed linear to int-``bits``: each ``{"w": (...,
    nb, bi, bo)}`` leaf becomes ``{"w_q" int8, "w_scale" (..., nb, bo)}``;
    biases stay fp. Returns ``(params, report)``; the report (the
    reference's: per layer ``max_abs`` and ``rel_rms`` round-trip error)
    is None without ``compute_report`` (a shape template on the meta
    device has no values)."""
    out = tree_lib.copy_tree(params)
    report: Optional[Dict[str, Any]] = (
        {"bits": bits, "layers": {}} if compute_report else None)
    n_q = 0
    for parent, key, _lin, tag in iter_linear_leaves(model, out):
        leaf = parent[key]
        if "w" not in leaf:
            continue                                # already quantized
        q, s = quant_lib.quantize_blocks(leaf["w"], bits=bits)
        new = {k: v for k, v in leaf.items() if k != "w"}
        new["w_q"], new["w_scale"] = q, s
        parent[key] = new
        n_q += 1
        if compute_report:
            report["layers"][tag] = quant_lib.quant_error(leaf["w"], q, s)
    if n_q == 0:
        raise ValueError("quantize_packed: no packed linears found")
    if compute_report:
        rms = [v["rel_rms"] for v in report["layers"].values()]
        report["n_layers"] = n_q
        report["max_rel_rms"] = max(rms)
        report["mean_rel_rms"] = float(np.mean(rms))
    return out, report


def dequantize_packed(model, params):
    """Inverse of :func:`quantize_packed` (up to rounding): every ``{"w_q",
    "w_scale"}`` leaf becomes an f32 ``{"w"}`` leaf again, so a quantized
    artifact runs through the fp kernels (the reference point of drift and
    equivalence checks)."""
    out = tree_lib.copy_tree(params)
    for parent, key, _lin, _tag in iter_linear_leaves(model, out):
        leaf = parent[key]
        if "w_q" in leaf:
            new = {k: v for k, v in leaf.items()
                   if k not in ("w_q", "w_scale")}
            new["w"] = quant_lib.dequantize_blocks(leaf["w_q"],
                                                   leaf["w_scale"])
            parent[key] = new
    return out


def map_quantized_leaves(model, params, fn):
    """Apply ``fn(w_q, lin) -> new_w_q`` to every quantized leaf (the int4
    nibble pack and unpack of an artifact ride through here)."""
    out = tree_lib.copy_tree(params)
    for parent, key, lin, _tag in iter_linear_leaves(model, out):
        leaf = parent[key]
        if "w_q" in leaf:
            parent[key] = dict(leaf, w_q=fn(leaf["w_q"], lin))
    return out


def apply_perm_fusion(model_pk, params: Optional[Dict[str, Any]] = None):
    """The Fig-3 permutation-cancellation rewrite, applied post hoc to a
    packed model: mutates ``model_pk.block_specs`` in place and returns
    ``params``.

    For every FFN whose up and down projections are packed with one block
    count, up (and gate) leave their outputs in up's packed order and
    down's input gather becomes the one merged permutation
    ``inter_layer_perm(up, down)``: the identity, skipped, when the masks
    were built aligned (``mpd_fuse`` training), which puts the FFN on the
    fused kernel; a lone gather otherwise. Weights are untouched. A gate
    with a bias gets its bias re-indexed into up's packed order, the only
    change to ``params``; it is skipped when ``params`` is None (a reload,
    whose stored bias is rewritten already).
    """
    for bi_, spec in enumerate(model_pk.block_specs):
        ffn = spec["ffn"]
        if ffn is None or spec["kind"].endswith("_moe"):
            continue              # no FFN (rwkv); MoE FFNs are not rewritten
        up, gate, down = ffn.w_up, ffn.w_gate, ffn.w_down
        su, sd = up.spec, down.spec
        if not (su.mode == "packed" and sd.mode == "packed"
                and su.mask is not None and sd.mask is not None
                and su.mask.nb == sd.mask.nb):
            continue
        if su.skip_out_perm and sd.skip_in_perm:
            continue                            # fused at build time already
        g = fold_lib.inter_layer_perm(su.mask, sd.mask)        # (d_ff,)
        new_down = dataclasses.replace(down, spec=dataclasses.replace(
            sd, mask=dataclasses.replace(sd.mask, in_perm=permute.invert(g),
                                         index_cache={}),
            skip_in_perm=bool(permute.is_identity(g))))
        new_up = dataclasses.replace(
            up, spec=dataclasses.replace(su, skip_out_perm=True))
        new_gate = gate
        if gate is not None:
            sg = gate.spec
            # the gate's output must land in up's packed order for the
            # elementwise product: unpack(gate) then pack(up) as one gather
            r = permute.compose(permute.invert(su.mask.out_perm),
                                sg.mask.out_perm)
            new_gate = dataclasses.replace(gate, spec=dataclasses.replace(
                sg, mask=dataclasses.replace(sg.mask, out_perm=r,
                                             index_cache={}),
                skip_out_perm=bool(permute.is_identity(r))))
            if sg.use_bias and params is not None:
                leaf = params["blocks"][bi_]["ffn"]["w_gate"]
                params["blocks"][bi_]["ffn"]["w_gate"] = dict(
                    leaf, b=permute.apply(permute.invert(su.mask.out_perm),
                                          leaf["b"]))
        spec["ffn"] = dataclasses.replace(ffn, w_up=new_up, w_gate=new_gate,
                                          w_down=new_down)
    return params
