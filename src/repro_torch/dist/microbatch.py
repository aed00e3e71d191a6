"""Gradient accumulation over microbatches (the port of
``repro.dist.microbatch``).

A split must keep every microbatch divisible by the device count of the
mesh's batch axes (``ways``), or data parallelism would replicate the
step's compute. :func:`cap_microbatches` walks the requested count down to
the largest valid one, which is the smallest valid microbatch at least the
requested size. The port runs on one device, where ``ways`` is 1.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree as tree_lib


def batch_ways(mesh, rules) -> int:
    """The device count over the rule table's batch axes (1 with no
    mesh): ``mesh.shape`` maps axis names to sizes."""
    ways = 1
    if mesh is not None and rules:
        for a in rules.get("batch", ()) or ():
            ways *= mesh.shape[a]
    return ways


def cap_microbatches(B: int, n: int, ways: int) -> int:
    """The largest ``n' <= n`` with ``B % n' == 0`` and ``(B // n') % ways
    == 0``; 1 (no accumulation) when no split is valid."""
    while n > 1 and (B % n or (B // n) % ways):
        n -= 1
    return max(n, 1)


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: autograd is attached
    to detached views of the leaves, so no param holds a graph after."""
    live = [p.detach().requires_grad_(True) for p in tree_lib.leaves(params)]
    loss = loss_fn(tree_lib.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_lib.unflatten(params, grads)


def microbatched_value_and_grad(loss_fn: Callable, params, batch, n: int):
    """Mean loss and grads over ``n`` sequential microbatches (contiguous
    row slices of every batch leaf), accumulated in the reference's order
    and dtypes: ``acc + value / n`` from zeros, the loss in f32 and each
    gradient in its param's dtype. ``n`` is capped by
    :func:`cap_microbatches` on one device (``ways`` 1, with a warning);
    with no valid split this is the plain full-batch gradient."""
    B = next(iter(batch.values())).shape[0]
    capped = cap_microbatches(B, n, 1)
    if capped != n:
        warnings.warn(f"microbatch count capped {n} -> {capped}: batch {B} "
                      "must split evenly", stacklevel=2)
    n = capped
    if n <= 1:
        return value_and_grad(loss_fn, params, batch)
    mb = B // n
    dev = next(tree_lib.leaves(params)).device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = list(tree_lib.leaves(tree_lib.map_leaves(torch.zeros_like,
                                                     params)))
    for i in range(n):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l, g = value_and_grad(loss_fn, params, sub)
        loss = loss + l / n
        grads = [a + b / n for a, b in zip(grads, tree_lib.leaves(g))]
    return loss, tree_lib.unflatten(params, grads)
