"""Permutation algebra for MPDCompress (copy of ``repro.core.permute``).

A permutation over ``n`` indices is an ``int32`` array ``p`` of shape
``(n,)`` in *gather* convention::

    apply(p, x)[i] == x[p[i]]

Permutations are plain numpy arrays at build time (static model metadata);
:func:`apply` gathers a tensor along an axis with ``index_select``.
"""

from __future__ import annotations

import numpy as np
import torch

Array = np.ndarray


def identity(n: int) -> Array:
    return np.arange(n, dtype=np.int32)


def random_permutation(rng: np.random.Generator, n: int) -> Array:
    """Uniform random permutation of ``n`` indices."""
    return rng.permutation(n).astype(np.int32)


def invert(p: Array) -> Array:
    """Inverse permutation: ``apply(invert(p), apply(p, x)) == x``."""
    inv = np.empty_like(p)
    inv[p] = np.arange(p.shape[0], dtype=p.dtype)
    return inv


def compose(p: Array, q: Array) -> Array:
    """``apply(compose(p, q), x) == apply(p, apply(q, x))``."""
    return q[p]


def is_identity(p: Array) -> bool:
    return bool(np.all(p == np.arange(p.shape[0], dtype=p.dtype)))


def apply(p, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Gather ``x`` along ``axis`` by ``p`` (numpy array or index tensor).
    The serving path has no backward, so this is a plain gather."""
    if isinstance(p, np.ndarray):
        if is_identity(p):
            return x
        p = torch.as_tensor(p.astype(np.int64), device=x.device)
    return x.index_select(axis, p)

