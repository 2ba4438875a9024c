"""Overlapping blocks -- the paper's core data structure (port of
`repro.core.overlap`).

A length-N, d-dimensional series is cut along time into P blocks of core
width ``block_size``; each block also carries a replicated halo of
``h_left`` past and ``h_right`` future samples.  Every order-(h_left,
h_right) weak-memory estimator is then a per-block map with one reduction
and no communication between blocks.

Representation: a ``(P, h_left + block_size + h_right, d)`` tensor plus a
validity mask.  Slots outside the series (before 0, at or after N) are
zero-filled and masked.  The index arrays are built with numpy on the host
and moved to the device once; the gather and the zero fill are one
``index_select`` and one ``where`` on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["OverlapSpec", "make_overlapping_blocks", "block_core", "core_mask",
           "center_global_index", "reconstruct", "num_blocks", "replication_overhead"]


@dataclasses.dataclass(frozen=True)
class OverlapSpec:
    """Static description of an overlapping block partitioning.

    Attributes:
      n: number of time steps in the series.
      block_size: core (owned, not replicated) steps per block.
      h_left: halo width into the past.
      h_right: halo width into the future (lags 0..H need h_right >= H).
    """

    n: int
    block_size: int
    h_left: int
    h_right: int

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")
        if self.n <= 0:
            raise ValueError(f"series length must be positive, got {self.n}")
        if self.h_left < 0 or self.h_right < 0:
            raise ValueError("halo widths must be non-negative")

    @property
    def num_blocks(self) -> int:
        return -(-self.n // self.block_size)

    @property
    def padded_width(self) -> int:
        return self.h_left + self.block_size + self.h_right

    @property
    def window(self) -> int:
        """Width of the widest kernel window this spec supports."""
        return self.h_left + 1 + self.h_right

    def global_indices(self) -> np.ndarray:
        """(P, padded_width) global time index of every padded slot (out of
        range where :meth:`slot_mask` is False)."""
        starts = np.arange(self.num_blocks) * self.block_size - self.h_left
        return starts[:, None] + np.arange(self.padded_width)[None, :]

    def slot_mask(self) -> np.ndarray:
        """(P, padded_width) bool: True where the slot holds real data."""
        idx = self.global_indices()
        return (idx >= 0) & (idx < self.n)


def num_blocks(n: int, block_size: int) -> int:
    return -(-n // block_size)


def replication_overhead(spec: OverlapSpec) -> float:
    """Extra storage paid for the halos: (P * padded_width) / N - 1."""
    return spec.num_blocks * spec.padded_width / spec.n - 1.0


def make_overlapping_blocks(x: torch.Tensor, spec: OverlapSpec,
                            block_range: Optional[Tuple[int, int]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the overlapping blocks of a contiguous (n, d) (or (n,)) series.

    Returns blocks (P, padded_width, d), zero outside the series, and the
    (P, padded_width) bool slot mask, both on ``x``'s device.  With
    ``block_range`` (lo, hi) only blocks lo..hi-1 are built (a mesh rank's
    shard of the block axis).
    """
    if x.ndim == 1:
        x = x[:, None]
    if x.shape[0] != spec.n:
        raise ValueError(f"series length {x.shape[0]} != spec.n {spec.n}")
    idx = spec.global_indices()
    if block_range is not None:
        idx = idx[block_range[0]: block_range[1]]
    mask = torch.from_numpy((idx >= 0) & (idx < spec.n)).to(x.device)
    flat = torch.from_numpy(np.clip(idx, 0, spec.n - 1).reshape(-1)).to(x.device)
    gathered = x.index_select(0, flat).view(idx.shape + (x.shape[1],))
    return torch.where(mask[..., None], gathered, 0.0), mask


def block_core(blocks: torch.Tensor, spec: OverlapSpec) -> torch.Tensor:
    """The owned (core) region of every block: (P, block_size, d), a view."""
    return blocks[:, spec.h_left: spec.h_left + spec.block_size, :]


def core_mask(spec: OverlapSpec) -> np.ndarray:
    """(P, block_size) bool: True where the core slot maps to a real sample
    (only the last block can hold tail padding)."""
    idx = spec.global_indices()[:, spec.h_left: spec.h_left + spec.block_size]
    return (idx >= 0) & (idx < spec.n)


def center_global_index(spec: OverlapSpec) -> np.ndarray:
    """(P, block_size) global time index of each core slot (clamped)."""
    return np.clip(spec.global_indices()[:, spec.h_left: spec.h_left + spec.block_size],
                   0, spec.n - 1)


def reconstruct(blocks: torch.Tensor, spec: OverlapSpec) -> torch.Tensor:
    """Inverse of :func:`make_overlapping_blocks`: the (n, d) series (the
    halos are pure replication, so the cores concatenated are exact)."""
    core = block_core(blocks, spec)
    return core.reshape(spec.num_blocks * spec.block_size, core.shape[-1])[: spec.n]
