"""Nested-container helpers for parameter trees (dicts / lists / tuples)."""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping dict / list / tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
