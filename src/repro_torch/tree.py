"""Nested-dict parameter trees: the part of ``jax.tree`` the training path
uses.

The port's parameters, gradients and optimizer moments are nested dicts of
tensors, as the JAX package's pytrees are. Leaves are visited in JAX's
order (each dict's keys sorted, depth first), and a leaf's path is its
keys joined by ``SEP``, the separator that
``repro.checkpoint.checkpointing.flatten_params`` writes.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

SEP = "::"


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, _prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _prefix + (str(k),))
                for k, v in tree.items()}
    return fn(SEP.join(_prefix), tree)


def tree_map(fn: Callable, tree, *rest):
    """``tree`` with each leaf replaced by ``fn(leaf, *leaves of rest at
    the same path)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's leaf order."""
    if not isinstance(tree, dict):
        return [("", tree)]
    out = []
    for k in sorted(tree):
        out += [(f"{k}{SEP}{p}" if p else str(k), leaf)
                for p, leaf in tree_items(tree[k])]
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]
