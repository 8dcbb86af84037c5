"""Nested dicts of tensors, the port's pytrees: one leaf order everywhere.

Leaves are visited with the keys sorted at every level, the order in which
the reference (jax) flattens a dict pytree, so two trees of one layout zip
leaf for leaf whatever order their dicts were built in.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["flatten", "leaves", "tree_map"]


def flatten(tree: dict, prefix: str = "") -> dict:
    """{``/``-joined path: leaf}, keys sorted at every level."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v
    return out


def leaves(tree: dict) -> list:
    """The leaves, in :func:`flatten`'s order."""
    return list(flatten(tree).values())


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn(leaf, *leaves of rest at the same path)`` over every leaf,
    keeping the structure (empty dicts too); ``fn`` is called in
    :func:`flatten`'s order."""
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) if isinstance(tree[k], dict)
            else fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
