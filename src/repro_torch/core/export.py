"""Whole-model fold of masked-dense training into the packed deployment
form, and post-fold int8 quantization (the port of ``repro.core.export``:
``fold_model``, ``quantize_packed`` and their helpers, for the attention
family; the Fig-3 permutation-fusion rewrite, ``fuse=True``, is not ported).

:func:`fold_model` builds the packed twin of a ``masked_dense`` model (same
config and masks, packed parameterization), checks that every claimed
linear carries no weight mass off its mask, folds each stacked weight into
blocks (paper Eq. 2) and optionally quantizes the blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import quant as quant_lib
from . import fold as fold_lib
from .mask import MaskSpec

QUANTIZE_BITS = {"int8": 8}          # int4 storage is not ported yet
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
    Returns ``(packed_model, packed_params)``; with ``quantize="int8"`` the
    blocks are quantized too and the round-trip report is set on
    ``packed_model.quant_report``."""
    from repro_torch.models import build

    cfg = model.cfg
    if cfg.mpd_mode != "masked_dense":
        raise ValueError(f"fold_model expects a masked_dense model, got "
                         f"mpd_mode={cfg.mpd_mode!r}")
    if fuse:
        raise NotImplementedError("fold_model(fuse=True), the Fig-3 "
                                  "permutation-fusion rewrite, is not ported")
    if quantize is not None and quantize not in QUANTIZE_BITS:
        raise ValueError(f"quantize={quantize!r} not in "
                         f"{sorted(QUANTIZE_BITS)} or None")
    model_pk = build(dataclasses.replace(cfg, mpd_mode="packed"))
    out = tree_lib.copy_tree(params)
    n_folded = 0
    # the packed twin's linears sit where the masked-dense ones do, with
    # the same masks
    for parent, key, lin, tag in iter_linear_leaves(model_pk, out):
        parent[key] = dict(parent[key], w=_fold_stacked(
            lin.spec.mask, parent[key]["w"], tag))
        n_folded += 1
    if n_folded == 0:
        raise ValueError(f"fold_model: no compressed linears found "
                         f"(mpd_c={cfg.mpd_c}): nothing to fold")
    if quantize is not None:
        out, report = quantize_packed(model_pk, out,
                                      bits=QUANTIZE_BITS[quantize])
        model_pk.quant_report = report
    return model_pk, out


def iter_linear_leaves(model, params, mode: str = "packed"
                       ) -> Iterator[Tuple[dict, str, Any, str]]:
    """Yield ``(parent, key, lin, tag)`` for every compressed linear of
    ``mode`` (mixer projections, FFN, unembed) so passes can rewrite
    ``parent[key]`` (the reference's ``_iter_packed_leaves``, and the walk
    of its ``mask_projection``)."""
    for bi_, (spec, pstack) in enumerate(zip(model.block_specs,
                                             params["blocks"])):
        for path, lin in model.block_linears(spec):
            if lin.spec.mode != mode or lin.spec.mask is None:
                continue
            node = pstack
            for k in path[:-1]:
                node = node[k]
            yield node, path[-1], lin, f"blocks[{bi_}]/" + "/".join(path)
    un = model.unembed
    if un.spec.mode == mode and un.spec.mask is not None:
        yield params, "unembed", un, "unembed"


def quantize_packed(model, params, *, bits: int = 8
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize every packed linear to int-``bits``: each ``{"w": (...,
    nb, bi, bo)}`` leaf becomes ``{"w_q" int8, "w_scale" (..., nb, bo)}``;
    biases stay fp. Returns ``(params, report)`` with the per-layer
    round-trip relative RMS error."""
    out = tree_lib.copy_tree(params)
    report: Dict[str, Any] = {"bits": bits, "layers": {}}
    for parent, key, _lin, tag in iter_linear_leaves(model, out):
        leaf = parent[key]
        if "w" not in leaf:
            continue                                # already quantized
        q, s = quant_lib.quantize_blocks(leaf["w"], bits=bits)
        new = {k: v for k, v in leaf.items() if k != "w"}
        new["w_q"], new["w_scale"] = q, s
        parent[key] = new
        w = leaf["w"].float()
        err = w - quant_lib.dequantize_blocks(q, s)
        report["layers"][tag] = float(err.norm() / (w.norm() + 1e-30))
    if not report["layers"]:
        raise ValueError("quantize_packed: no packed linears found")
    report["n_layers"] = len(report["layers"])
    report["max_rel_rms"] = max(report["layers"].values())
    return out, report
