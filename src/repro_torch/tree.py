"""Param trees: nested dicts and lists of tensors, walked in the reference's
order (``jax.tree`` sorts dict keys), so sums over leaves add up in the same
order in both packages."""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Tuple


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in the reference's flatten order: dict keys sorted,
    lists by index, ``None`` dropped, a path being the keys and indices
    joined by ``/`` (``blocks/0/ffn/w_up/w``), as
    ``repro.checkpoint`` names a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree``, dict keys sorted."""
    for _, leaf in leaves_with_paths(tree):
        yield leaf


def unflatten(like, new_leaves: Iterable[Any]):
    """A tree shaped like ``like`` holding ``new_leaves`` in
    :func:`leaves` order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return None if node is None else next(it)

    out = build(like)
    rest: List[Any] = list(it)
    if rest:
        raise ValueError(f"unflatten: {len(rest)} leaves left over")
    return out


def map_leaves(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    cols = [list(leaves(t)) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("map_leaves: trees differ in structure")
    return unflatten(tree, (fn(*xs) for xs in zip(*cols)))


def copy_tree(tree):
    """Copy the dict/list structure; leaves are shared."""
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [copy_tree(v) for v in tree]
    return tree
