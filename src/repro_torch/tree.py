"""Nested dicts of tensors (the train state) walked in the reference's order.

The reference's trees are jax pytrees, and `jax.tree.flatten` visits a
dict's keys sorted.  The optimizer's global norm sums its leaves in that
order and the checkpoint names them by their key path, so the port walks
its nested dicts the same way.  A leaf is anything that is not a dict.

This is the one walker of the train state.  `models.api.flatten` walks a
param table in insertion order instead: that order is the init's draw
order, and nothing else depends on it.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)], dict keys sorted at every level."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_paths(tree[k], prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, items) -> dict:
    """`like`'s structure with its leaves replaced, in `leaves` order, by
    the items of `items`."""
    it = iter(items)

    def rebuild(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: rebuild(node[k]) for k in sorted(node)}
    return rebuild(like)


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`,
    rebuilt in `tree`'s structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}

