"""Gradient compression with error feedback (the port of
``repro.dist.compress``): symmetric int-k quantization of each gradient
leaf, the residual of each step folded into the next gradient, so the
running sum of compressed gradients tracks the true sum (the EF-SGD
guarantee).

``compress_with_ef`` returns the dequantized gradients, which the optimizer
consumes, so it is a drop-in stage between autograd and the optimizer; it
applies on one device too. :func:`wire_bytes` models what a data-parallel
all-reduce would move. Plain PyTorch on the gradients' device, as the
reference runs XLA and no kernel of its own; ``torch.round`` rounds half to
even like ``jnp.round``, so at f32 the results equal the reference's.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib


def quantize_leaf(g: torch.Tensor, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric uniform quantization to ``bits`` (round to nearest).
    Returns ``(q int8, scale f32 0-d)``; the dequantization error is at
    most ``scale / 2``."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits {bits} not in [1, 8]")
    # 127 for int8, 7 for int4; bits = 1 is sign-only {-1, 0, 1}
    levels = max((1 << (bits - 1)) - 1, 1)
    amax = g.abs().max()
    scale = torch.where(amax > 0, amax / levels, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -levels, levels).to(torch.int8)
    return q, scale.float()


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_ef_state(params) -> Any:
    """A zero f32 residual per leaf (residuals accumulate across steps)."""
    return tree_lib.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compress_with_ef(grads, ef_state, bits: int):
    """Quantize ``grads + ef`` leaf by leaf; the new residual is what the
    quantization lost. Returns ``(dequantized grads in each gradient's
    dtype, new ef_state)``."""
    def one(g, e):
        corrected = g.float() + e
        dq = dequantize_leaf(*quantize_leaf(corrected, bits))
        return dq.to(g.dtype), corrected - dq

    outs = [one(g, e) for g, e in zip(tree_lib.leaves(grads),
                                      tree_lib.leaves(ef_state))]
    return (tree_lib.unflatten(grads, (o[0] for o in outs)),
            tree_lib.unflatten(grads, (o[1] for o in outs)))


def wire_bytes(tree, bits: int) -> int:
    """Bytes a gradient all-reduce moves per replica: the int-k payload when
    compressing (scales excluded), f32 otherwise."""
    n = sum(int(leaf.numel()) for leaf in tree_lib.leaves(tree))
    if bits <= 0:
        return 4 * n
    return (n * bits + 7) // 8
