"""TimeSeriesStore -- the overlapping block store (port of
`repro.timeseries.dataset`, one device).

The series is cut along time into blocks; construction replicates the halo
once at ingest (the paper's scheme), so every weak-memory estimator is then
a per-block map and one sum with no data motion.  A disjoint store
(``halo_mode="exchange"``) keeps the cores only and stitches the halos when
a view is asked for.  On one device the store is a (P, width, d) tensor;
the mesh placement (and the exchange collectives) arrive with the port's
distribution slice.

``append_rows`` grows the store in place: each new row is written into its
own block's core and into the right halos of the blocks before it, one
``index_put_`` per halo copy, with indices computed on the host from the
store's length (no device sync), and the capacity at least doubles when
it runs out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Literal

import numpy as np
import torch

from ..core.mapreduce import block_partials, tree_map
from ..core.overlap import OverlapSpec, make_overlapping_blocks, reconstruct
from ..core.overlap import replication_overhead as _replication_overhead

HaloMode = Literal["replicate", "exchange"]

__all__ = ["TimeSeriesStore"]

_MESH = ("mesh placement arrives with the port's distribution slice (ROADMAP Queue A "
         "item 7); on one device pass mesh=None")


def _scatter_rows(blocks: torch.Tensor, chunk: torch.Tensor, n0: int, B: int,
                  width: int) -> None:
    """Write ``chunk`` (global rows [n0, n0 + c)) into every padded slot
    that holds it, in place: row g lives in block j at slot g - j B for
    every j with j B <= g < j B + width (its core block and the right halos
    of up to ceil((width - B) / B) blocks before it).  One ``index_put_``
    per copy, over the rows that copy keeps (indices from the host)."""
    g = n0 + np.arange(chunk.shape[0])
    for k in range((width - 1) // B + 1):
        j = g // B - k
        slot = g - j * B
        keep = np.nonzero((j >= 0) & (slot < width))[0]
        if keep.size == 0:
            continue
        dev = blocks.device
        idx = (torch.from_numpy(j[keep]).to(dev), torch.from_numpy(slot[keep]).to(dev))
        rows = chunk if keep.size == chunk.shape[0] else chunk.index_select(
            0, torch.from_numpy(keep).to(dev))
        blocks.index_put_(idx, rows)


@dataclasses.dataclass
class TimeSeriesStore:
    """Overlapping time-series container on one device.

    Attributes:
      blocks: (capacity, width, d) -- padded blocks (replicate mode) or
        disjoint cores (exchange mode); ``capacity >= spec.num_blocks`` after
        :meth:`append_rows` grew it (the trailing blocks are zeros).
      spec: the overlap geometry.
      mesh / axis: where the block axis lives (None: one device).
      halo_mode: "replicate" (the paper's) or "exchange".
    """

    blocks: torch.Tensor
    spec: OverlapSpec
    mesh: Any = None
    axis: str = "data"
    halo_mode: HaloMode = "replicate"

    # -- construction ------------------------------------------------------
    @classmethod
    def from_series(cls, x, block_size: int, h_left: int, h_right: int, mesh=None,
                    axis: str = "data", halo_mode: HaloMode = "replicate",
                    device="cuda") -> "TimeSeriesStore":
        """Place a (n,) or (n, d) series (numpy or tensor) on ``device`` as
        overlapping blocks of core width ``block_size``."""
        from ..core.frame import as_series

        if mesh is not None:
            raise NotImplementedError(_MESH)
        x = as_series(x, device)
        spec = OverlapSpec(n=x.shape[0], block_size=block_size, h_left=h_left,
                           h_right=h_right)
        if halo_mode == "replicate":
            blocks, _ = make_overlapping_blocks(x, spec)
        elif halo_mode == "exchange":
            pad = spec.num_blocks * spec.block_size - spec.n
            blocks = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
                spec.num_blocks, spec.block_size, x.shape[1])
        else:
            raise ValueError(f"halo_mode must be 'replicate' or 'exchange', got {halo_mode!r}")
        return cls(blocks=blocks, spec=spec, mesh=None, axis=axis, halo_mode=halo_mode)

    # -- growth ------------------------------------------------------------
    def append_rows(self, chunk) -> None:
        """Absorb ``chunk`` new samples at the end of the stored series in
        place, so the store stays exactly ``from_series(concat(series,
        chunk), ...)``.  Replicate-mode stores with causal halos (``h_left
        == 0``) only.  When the rows overflow the capacity, it grows to at
        least twice itself with zero blocks (one copy of the store), so a
        steady append stream pays O(log n) copies."""
        from ..core.frame import as_series

        if self.mesh is not None:
            raise ValueError("append_rows is single-device only")
        if self.halo_mode != "replicate":
            raise ValueError("append_rows requires replicate-mode halos")
        if self.spec.h_left != 0:
            raise ValueError("append_rows requires causal halos (h_left == 0)")
        chunk = as_series(chunk, self.blocks.device).to(self.blocks.dtype)
        c = chunk.shape[0]
        if c == 0:
            return
        if chunk.shape[1] != self.blocks.shape[-1]:
            raise ValueError(f"chunk has d={chunk.shape[1]}, store has "
                             f"d={self.blocks.shape[-1]}")
        s = self.spec
        B, width = s.block_size, s.padded_width
        new_n = s.n + c
        need = -(-new_n // B)
        cap = self.blocks.shape[0]
        if need > cap:
            new_cap = max(need, 2 * cap)
            self.blocks = torch.cat([self.blocks, self.blocks.new_zeros(
                (new_cap - cap, width, self.blocks.shape[-1]))])
        _scatter_rows(self.blocks, chunk, s.n, B, width)
        self.spec = dataclasses.replace(s, n=new_n)

    # -- views -------------------------------------------------------------
    def padded_blocks_local(self, blocks_local: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(_MESH)

    def padded_blocks_single_host(self) -> torch.Tensor:
        """The (num_blocks, width, d) padded view: the growth capacity past
        ``spec.num_blocks`` sliced off (a view in replicate mode)."""
        k = self.spec.num_blocks
        if self.halo_mode == "replicate":
            return self.blocks if self.blocks.shape[0] == k else self.blocks[:k]
        flat = self.blocks.reshape(-1, self.blocks.shape[-1])[: self.spec.n]
        return make_overlapping_blocks(flat, self.spec)[0]

    # -- compute -----------------------------------------------------------
    def map_reduce(self, kernel: Callable[[torch.Tensor], Any]) -> Any:
        """A per-window weak-memory estimator over the store: the block
        partials and one sum over the block axis."""
        if self.mesh is not None:
            raise NotImplementedError(_MESH)
        partials = block_partials(kernel, self.padded_blocks_single_host(), self.spec)
        return tree_map(lambda leaf: leaf.sum(0), partials)

    def iter_chunks(self, chunk_size: int):
        """Contiguous (<= chunk_size, d) chunks of the series in time order
        (views of one gathered copy of the series)."""
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        x = self.to_series()
        for start in range(0, self.spec.n, chunk_size):
            yield x[start: min(start + chunk_size, self.spec.n)]

    def to_series(self) -> torch.Tensor:
        """The contiguous (n, d) series."""
        if self.halo_mode == "replicate":
            return reconstruct(self.padded_blocks_single_host(), self.spec)
        return self.blocks.reshape(-1, self.blocks.shape[-1])[: self.spec.n]

    @property
    def replication_overhead(self) -> float:
        return _replication_overhead(self.spec) if self.halo_mode == "replicate" else 0.0
