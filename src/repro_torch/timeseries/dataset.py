"""TimeSeriesStore -- the overlapping block store (port of
`repro.timeseries.dataset`).

The series is cut along time into blocks; construction replicates the halo
once at ingest (the paper's scheme), so every weak-memory estimator is then
a per-block map and one sum with no data motion.  A disjoint store
(``halo_mode="exchange"``) keeps the cores only and stitches the halos when
a view is asked for.  On one device the store is a (P, width, d) tensor.
On a mesh (`repro_torch.parallel`) the block axis is sharded: ``blocks`` is
a ``Shard(0)`` DTensor of the same global shape, each rank holding blocks
[r P / w, (r + 1) P / w); ``map_reduce`` reduces a rank's blocks locally and
merges the partials with ONE `psum_tree`, and exchange mode stitches the
halos with one neighbour exchange (`repro_torch.core.halo`).

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

from ..core.backend import resolve_device
from ..core.mapreduce import block_partials, tree_map
from ..core.overlap import OverlapSpec, make_overlapping_blocks, reconstruct
from ..core.overlap import replication_overhead as _replication_overhead

HaloMode = Literal["replicate", "exchange"]

__all__ = ["TimeSeriesStore"]

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
    """Overlapping time-series container on one device or a mesh.

    Attributes:
      blocks: (capacity, width, d) -- padded blocks (replicate mode) or
        disjoint cores (exchange mode); ``capacity >= spec.num_blocks`` after
        :meth:`append_rows` grew it (the trailing blocks are zeros).  On a
        mesh a ``Shard(0)`` DTensor of shape (num_blocks, width, d).
      spec: the overlap geometry.
      mesh / axis: where the block axis lives (None: one device; else a
        DeviceMesh and its dimension's name).
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
        overlapping blocks of core width ``block_size``.  With a ``mesh``
        every rank is given the whole series and keeps its own blocks only,
        on the mesh's device (``device`` must name its type); ``num_blocks``
        must divide over the mesh dimension ``axis``."""
        from ..core.frame import as_series
        from ..parallel.sharding import mesh_axis_size, mesh_device, mesh_rank

        if halo_mode not in ("replicate", "exchange"):
            raise ValueError(f"halo_mode must be 'replicate' or 'exchange', got {halo_mode!r}")
        if mesh is not None:
            if resolve_device(device).type != mesh.device_type:
                raise ValueError(f"the mesh lies on {mesh.device_type}, the store was asked "
                                 f"for {device}; pass device={mesh.device_type!r}")
            device = mesh_device(mesh)
        x = as_series(x, device)
        spec = OverlapSpec(n=x.shape[0], block_size=block_size, h_left=h_left,
                           h_right=h_right)
        lo, hi = 0, spec.num_blocks
        if mesh is not None:
            world = mesh_axis_size(mesh, (axis,))
            if spec.num_blocks % world != 0:
                raise ValueError(f"num_blocks={spec.num_blocks} must divide over mesh axis "
                                 f"{axis}={world}")
            per = spec.num_blocks // world
            lo = mesh_rank(mesh, axis) * per
            hi = lo + per
        if halo_mode == "replicate":
            blocks, _ = make_overlapping_blocks(x, spec, (lo, hi))
        else:
            B = spec.block_size
            cores = x[lo * B: min(hi * B, spec.n)]
            pad = (hi - lo) * B - cores.shape[0]
            blocks = torch.nn.functional.pad(cores, (0, 0, 0, pad)).reshape(
                hi - lo, B, x.shape[1])
        if mesh is not None:
            from torch.distributed.tensor import DTensor, Shard

            blocks = DTensor.from_local(blocks, mesh, [Shard(0)], run_check=False)
        return cls(blocks=blocks, spec=spec, mesh=mesh, axis=axis, halo_mode=halo_mode)

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
            raise ValueError("append_rows is single-device only (a mesh store is re-placed "
                             "by the next full traversal)")
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
        """A rank's halo-padded blocks from its local ones: the blocks
        themselves in replicate mode; in exchange mode one `halo_exchange`
        of the flattened local cores, re-windowed into (p_local, width, d)
        (a copy).  The two are bit-identical."""
        if self.halo_mode == "replicate":
            return blocks_local
        from ..core.halo import halo_exchange

        s = self.spec
        p_local, nb, d = blocks_local.shape
        padded = halo_exchange(blocks_local.reshape(p_local * nb, d), s.h_left, s.h_right,
                               self.mesh, self.axis)
        return padded.unfold(0, s.padded_width, nb).transpose(1, 2).contiguous()

    def _global_blocks(self) -> torch.Tensor:
        """The whole block array (on a mesh every rank gathers it)."""
        return self.blocks if self.mesh is None else self.blocks.full_tensor()

    def padded_blocks_single_host(self) -> torch.Tensor:
        """The (num_blocks, width, d) padded view: the growth capacity past
        ``spec.num_blocks`` sliced off (a view in replicate mode).  On a mesh
        every rank gathers the whole store."""
        k = self.spec.num_blocks
        blocks = self._global_blocks()
        if self.halo_mode == "replicate":
            return blocks if blocks.shape[0] == k else blocks[:k]
        flat = blocks.reshape(-1, blocks.shape[-1])[: self.spec.n]
        return make_overlapping_blocks(flat, self.spec)[0]

    # -- compute -----------------------------------------------------------
    def map_reduce(self, kernel: Callable[[torch.Tensor], Any]) -> Any:
        """A per-window weak-memory estimator over the store: the block
        partials and one sum over the block axis.  On a mesh each rank sums
        its own halo-complete blocks (global block ids from its offset) and
        the partials merge in one `psum_tree`: the data never moves."""
        if self.mesh is None:
            partials = block_partials(kernel, self.padded_blocks_single_host(), self.spec)
            return tree_map(lambda leaf: leaf.sum(0), partials)
        from ..parallel.sharding import mesh_rank, psum_tree

        local = self.blocks.to_local()
        partials = block_partials(kernel, self.padded_blocks_local(local), self.spec,
                                  block_offset=mesh_rank(self.mesh, self.axis) * local.shape[0])
        return psum_tree(tree_map(lambda leaf: leaf.sum(0), partials), self.mesh, self.axis)

    def iter_chunks(self, chunk_size: int):
        """Contiguous (<= chunk_size, d) chunks of the series in time order
        (views of one gathered copy of the series; on a mesh every rank
        gathers it)."""
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        x = self.to_series()
        for start in range(0, self.spec.n, chunk_size):
            yield x[start: min(start + chunk_size, self.spec.n)]

    def to_series(self) -> torch.Tensor:
        """The contiguous (n, d) series (on a mesh every rank gathers it)."""
        if self.halo_mode == "replicate":
            return reconstruct(self.padded_blocks_single_host(), self.spec)
        blocks = self._global_blocks()
        return blocks.reshape(-1, blocks.shape[-1])[: self.spec.n]

    @property
    def replication_overhead(self) -> float:
        return _replication_overhead(self.spec) if self.halo_mode == "replicate" else 0.0
