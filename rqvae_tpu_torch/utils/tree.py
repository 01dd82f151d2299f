"""Nested-container helpers for parameter trees (dicts / lists / tuples)."""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping dict / list / tuple / NamedTuple
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in JAX's flatten order (dict keys sorted), so two trees of one
    structure line up whatever their dicts' key order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def tree_leaves_with_path(tree, prefix=()):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, sequences
    in order. ``path`` is a tuple of str keys / int indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_shapes(tree) -> list:
    """(path, shape) of every leaf in ``tree_leaves_with_path`` order: two
    trees of one structure and shapes give equal lists."""
    return [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(tree)]
