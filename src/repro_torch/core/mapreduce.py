"""Leaf-wise sums over nested statistics (port of the tree helpers of
`repro.core.mapreduce`).

A statistic is a tensor or a dict / tuple / list of statistics; these
helpers walk that structure directly instead of through a pytree library.
Dicts are walked in sorted key order, so two statistics built in different
insertion orders flatten alike.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves", "tree_sum", "tree_zeros_like"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over structurally equal trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The tensors of ``tree`` in a fixed order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_sum(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_zeros_like(a: Any) -> Any:
    return tree_map(torch.zeros_like, a)
