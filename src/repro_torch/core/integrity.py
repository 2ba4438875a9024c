"""Neumaier compensated accumulation (port of the helpers of
`repro.core.integrity`, reference lines 104-138)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .mapreduce import tree_map

__all__ = ["tree_neumaier_merge", "tree_neumaier_add"]


def _comp(a, b, t):
    # Neumaier's branch-free correction for t = a + b: whichever operand is
    # larger in magnitude, (larger - t) + smaller recovers the rounding
    # residue exactly (Neumaier 1974; exact 0 for integer dtypes).
    return torch.where(torch.abs(a) >= torch.abs(b), (a - t) + b, (b - t) + a)


def tree_neumaier_merge(stat_a: Any, err_a: Any, stat_b: Any, err_b: Any) -> Tuple[Any, Any]:
    """Compensated sum of two (stat, err) pairs, leaf-wise.  ``stat`` is the
    same float32 sum the plain monoid computes; ``err`` collects the summed
    companions plus this addition's own residue."""
    stat = tree_map(lambda a, b: a + b, stat_a, stat_b)
    err = tree_map(lambda a, b, t, ea, eb: ea + eb + _comp(a, b, t),
                   stat_a, stat_b, stat, err_a, err_b)
    return stat, err


def tree_neumaier_add(stat: Any, err: Any, delta: Any) -> Tuple[Any, Any]:
    """Compensated ``stat + delta`` for a fresh contribution (a chunk
    kernel's output, which has no companion of its own)."""
    new = tree_map(lambda s, v: s + v, stat, delta)
    new_err = tree_map(lambda s, v, t, e: e + _comp(s, v, t), stat, delta, new, err)
    return new, new_err
