"""Nested dict/list parameter trees, walked in the JAX package's order.

``jax.tree`` flattens a dict by its sorted keys and a list by index; the
port's optimizer sums the gradient norm in that order and its
checkpoints name leaves by that path, so both packages' files line up.
A leaf is anything that is not a dict, list or tuple.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_paths", "leaves", "map_tree", "unflatten"]


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """[(path, leaf)]: dict keys sorted, list and tuple items in order;
    a path is the tuple of keys and indices from the root."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, flat: list) -> Any:
    """A tree of ``like``'s structure holding ``flat``'s leaves, taken in
    the order ``leaves`` gives."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
