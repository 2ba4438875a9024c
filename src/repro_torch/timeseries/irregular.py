"""Irregular to regular alignment (port of `repro.timeseries.irregular`):
last observation carried forward, or linear interpolation, onto a regular
grid, with a vectorized ``searchsorted``."""
from __future__ import annotations

from typing import Literal

import torch

__all__ = ["regularize"]


def regularize(t: torch.Tensor, x: torch.Tensor, grid: torch.Tensor,
               method: Literal["locf", "linear"] = "locf") -> torch.Tensor:
    """Sample an irregular series onto a grid.

    Args:
      t: (n,) strictly increasing observation times.
      x: (n, d) observations ((n,) is promoted to (n, 1)).
      grid: (m,) query times within [t[0], t[-1]].
      method: "locf" or "linear".

    Returns (m, d).
    """
    if x.ndim == 1:
        x = x[:, None]
    last = t.shape[0] - 1
    idx = torch.clamp(torch.searchsorted(t, grid, right=True) - 1, 0, last)
    left = x[idx]
    if method == "locf":
        return left
    idx_next = torch.clamp(idx + 1, 0, last)
    t0, t1 = t[idx], t[idx_next]
    dt = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
    w = torch.clamp((grid - t0) / dt, 0.0, 1.0)
    return left + w[:, None] * (x[idx_next] - left)
