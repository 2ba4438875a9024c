"""Data-plane integrity primitives: sentinel scan, lane health, Neumaier
accumulation (port of `repro.core.integrity`).

A tenant's state is only ever folded, never recomputed, so one non-finite
sample absorbed into it poisons every later answer.  :func:`sentinel_scan`
checks an arrival batch before ingest; :func:`lane_health` sweeps a
session's stacked lanes afterwards (`repro_torch.serving.rolling`).  The
Neumaier helpers are the monoid sum in compensated form.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .mapreduce import tree_leaves, tree_map

__all__ = ["SENTINEL_POLICIES", "sentinel_scan", "lane_health", "tree_neumaier_merge",
           "tree_neumaier_add"]

# What the serving gateway does with a chunk the sentinel finds non-finite.
SENTINEL_POLICIES = ("reject", "sanitize", "quarantine")


def sentinel_scan(batch: torch.Tensor) -> Tuple[np.ndarray, torch.Tensor]:
    """All-finite verdict and sanitized copy of one (k, c, d) arrival batch.

    Returns ``(verdict, clean)``: ``verdict`` a HOST (k,) bool array, True
    for each fully finite chunk (the call's one device-to-host copy), and
    ``clean`` the batch on its device with non-finite entries set to 0 --
    bit-identical to ``batch`` when every chunk is finite.
    """
    finite = torch.isfinite(batch)
    verdict = finite.reshape(finite.shape[0], -1).all(-1)
    clean = torch.where(finite, batch, 0.0)
    return verdict.cpu().numpy(), clean


def lane_health(lanes: Any) -> torch.Tensor:
    """(num_lanes, num_users) bool on the lanes' device: True where every
    element of every leaf of the stacked lane state is finite.  Every leaf
    of ``lanes`` (a `PartialState` or a tree of tensors) has leading
    ``(num_lanes, num_users)`` axes; integer leaves are always finite."""
    leaves = lanes.flatten() if dataclasses.is_dataclass(lanes) else tree_leaves(lanes)
    ok = None
    for leaf in leaves:
        fin = torch.isfinite(leaf)
        if leaf.ndim > 2:
            fin = fin.flatten(2).all(-1)
        ok = fin if ok is None else ok & fin
    return ok


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
