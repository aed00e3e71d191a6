"""Carry param trees between the reference and the port.

``params_from_numpy(model, tree)`` takes the JAX package's param tree as
numpy arrays (``jax.tree.map(np.asarray, params)``) — dense, masked-dense or
packed fp leaves, or quantized ``{"w_q", "w_scale"}`` leaves stacked
``(n_periods, nb, bi, bo)`` / ``(n_periods, nb, bo)``, of a plain or a
perm-fused model, or LeNet-300-100's list of three layers — and returns
the same tree of tensors on ``device``, checked against the shapes the port's model
expects. Both packages then compute the same function on the same weights.
``params_to_numpy`` is its inverse, so a tree trained by the port can go
back to the reference (bfloat16 leaves travel as float32, which holds them
exactly, and come back as bfloat16).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":        # ml_dtypes bf16: exact via f32
        return torch.from_numpy(arr.astype(np.float32)).to(device,
                                                           torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in tree_lib.leaves_with_paths(tree)}


def params_from_numpy(model, tree: Any, device=None):
    """Convert a reference param tree (numpy leaves) for ``model``: an LM
    of :func:`repro_torch.models.build`, or a ``LeNet300`` (a list of three
    per-layer dicts).

    Raises ``ValueError`` when the tree's structure or a leaf shape differs
    from a fresh init of the same model (quantized leaves are checked
    against the quantized form). A float32 leaf where the model holds
    bfloat16 is rounded to bfloat16: exact for the float32 leaves of
    :func:`params_to_numpy`."""
    dev = device_lib.resolve(device)
    out = _convert(tree, dev)
    # the expected structure, from an init on the meta device (shapes only)
    want = model.init(0, device="meta")
    if any("w_q" in leaf for leaf in _leaf_dicts(out)):
        from repro_torch.core.export import quantize_packed
        want = quantize_packed(model, want, compute_report=False)[0]
    got_shapes, want_shapes = _shapes(out), _shapes(want)
    if got_shapes != want_shapes:
        diff = sorted(set(got_shapes.items()) ^ set(want_shapes.items()))
        name = model.cfg.name if hasattr(model, "cfg") else repr(model)
        raise ValueError(f"param tree does not match {name}: {diff[:6]}")
    return tree_lib.map_leaves(
        lambda t, w: (t.to(torch.bfloat16) if t.dtype == torch.float32
                      and w.dtype == torch.bfloat16 else t), out, want)


def params_to_numpy(tree: Any):
    """The param tree as numpy arrays (bfloat16 leaves as float32, exact):
    the inverse of :func:`params_from_numpy`."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_lib.map_leaves(leaf, tree)


def _leaf_dicts(tree):
    if isinstance(tree, dict):
        if "w" in tree or "w_q" in tree:
            yield tree
        for v in tree.values():
            yield from _leaf_dicts(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaf_dicts(v)
