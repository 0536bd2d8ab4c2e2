"""Nested-dict parameter trees in the JAX package's flatten order.

``jax.tree.flatten`` visits a dict's keys sorted and a tuple or list in
order; the optimizer, the train step and the checkpoints of this port walk
their trees the same way, so leaf ``i`` is the same tensor in both packages
(a checkpoint written by either restores in the other).
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves, dict keys sorted, tuples and lists in order; ``None``
    is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [] if tree is None else [tree]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # the caller's key order
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path, as ``[0]['seg0']['attn']['wq']``, in flatten order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree) for p in paths(t, f"{prefix}[{i}]")]
    return [] if tree is None else [prefix]

