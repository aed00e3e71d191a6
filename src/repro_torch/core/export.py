"""Post-fold int8 quantization of a packed model (the port of
``repro.core.export.quantize_packed`` and ``_iter_packed_leaves``)."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

from repro_torch.kernels import quant as quant_lib


def _copy_tree(tree):
    """Copy the dict/list structure; leaves are shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _iter_packed_leaves(model, params) -> Iterator[Tuple[dict, str, Any, str]]:
    """Yield ``(parent, key, lin, tag)`` for every packed linear (mixer
    projections, FFN, unembed) so passes can rewrite ``parent[key]``."""
    for bi_, (spec, pstack) in enumerate(zip(model.block_specs,
                                             params["blocks"])):
        for path, lin in model.block_linears(spec):
            if lin.spec.mode != "packed" or lin.spec.mask is None:
                continue
            node = pstack
            for k in path[:-1]:
                node = node[k]
            yield node, path[-1], lin, f"blocks[{bi_}]/" + "/".join(path)
    un = model.unembed
    if un.spec.mode == "packed" and un.spec.mask is not None:
        yield params, "unembed", un, "unembed"


def quantize_packed(model, params, *, bits: int = 8
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize every packed linear to int-``bits``: each ``{"w": (...,
    nb, bi, bo)}`` leaf becomes ``{"w_q" int8, "w_scale" (..., nb, bo)}``;
    biases stay fp. Returns ``(params, report)`` with the per-layer
    round-trip relative RMS error."""
    out = _copy_tree(params)
    report: Dict[str, Any] = {"bits": bits, "layers": {}}
    for parent, key, _lin, tag in _iter_packed_leaves(model, out):
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
