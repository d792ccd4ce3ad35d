"""Nested-dict parameter trees (stands in for ``jax.tree`` in the port; no
reference module).

The port keeps the reference's parameter layout as nested dicts of
tensors.  :func:`tree_map` keeps the first tree's key order (the reference
sorts keys, so code that sums across leaves iterates in sorted order
itself, as ``kernels/ops.py`` does).
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the tree's own key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_items(tree, path=()) -> list:
    """(path, leaf) pairs in the tree's own key order; a path is the
    tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_items(v, path + (k,))]
    return [(path, tree)]


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` leaf by leaf, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)
