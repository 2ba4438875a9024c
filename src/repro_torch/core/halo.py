"""Halo materialization strategies (port of `repro.core.halo`: the paper's §10
replication against the exchange on demand).

The paper's scheme replicates the halos at ingest ("replicate" mode): after
that no communication at all, best when the same blocks are swept many
times.  The alternative keeps the blocks disjoint and exchanges the halos
once per sweep ("exchange" mode): no replicated memory, one neighbour
exchange of ``(h_left + h_right) d`` elements a rank per sweep.  On the
mesh the exchange is one ``batch_isend_irecv`` of point-to-point sends: the
local tail to rank + 1 and the head to rank - 1 (NCCL on the card, gloo on
the CPU).

These helpers run on each SPMD rank: ``x`` is the rank's local shard.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["halo_exchange", "halo_exchange_grouped", "edge_zeros_note"]


def _exchange(x: torch.Tensor, h_left: int, h_right: int, mesh, axis: str, time_axis: int,
              ring: bool) -> torch.Tensor:
    rows = x.shape[time_axis]
    if h_left > rows or h_right > rows:
        raise ValueError(f"halos ({h_left}, {h_right}) exceed the {rows} local rows: a halo "
                         f"comes from the neighbouring rank only")
    group = mesh.get_group(axis)
    rank, world = group.rank(), group.size()

    def peer(r):  # the global rank of the neighbour r along the line (or ring)
        if ring:
            r %= world
        return dist.get_global_rank(group, r) if 0 <= r < world else None

    def part(start, size):  # contiguous whatever time_axis is
        return x.narrow(time_axis, start, size).contiguous()

    # (what to send, to whom, the buffer that receives, from whom); the ends
    # of the line receive nothing and keep zeros, like the zero-filled slots
    # of make_overlapping_blocks.  The tag keeps the two streams apart where
    # both neighbours are one rank (a ring of 2).
    streams = []
    if h_left > 0:  # my tail feeds the next rank's left halo
        streams.append((part(rows - h_left, h_left), peer(rank + 1),
                        torch.zeros_like(part(0, h_left)), peer(rank - 1)))
    if h_right > 0:  # my head feeds the previous rank's right halo
        streams.append((part(0, h_right), peer(rank - 1),
                        torch.zeros_like(part(0, h_right)), peer(rank + 1)))
    if world == 1:  # no peer but, on a ring, myself ([] would make batch_isend_irecv raise)
        if ring:
            for send, _, recv, _ in streams:
                recv.copy_(send)
    else:
        ops = []
        for tag, (send, dst, recv, src) in enumerate(streams):
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, send, dst, group=group, tag=tag))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, recv, src, group=group, tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    left = [streams[0][2]] if h_left > 0 else []
    right = [streams[-1][2]] if h_right > 0 else []
    return torch.cat(left + [x] + right, dim=time_axis)


def halo_exchange(x: torch.Tensor, h_left: int, h_right: int, mesh, axis: str = "data", *,
                  time_axis: int = 0) -> torch.Tensor:
    """Pad the local time shard with its neighbours' boundary samples.

    Args:
      x: the rank's local shard, time along ``time_axis``.
      h_left: trailing samples pulled from the previous rank.
      h_right: leading samples pulled from the next rank.
      mesh / axis: the mesh dimension the time axis is sharded over.

    Returns the shard extended to ``h_left + T_local + h_right`` along
    ``time_axis``; the slots with no neighbour (the ends of the line) are
    zeros.  Raises ``ValueError`` when a halo exceeds the local rows.
    """
    return _exchange(x, h_left, h_right, mesh, axis, time_axis, ring=False)


def halo_exchange_grouped(x: torch.Tensor, h_left: int, h_right: int, mesh,
                          axis: str = "data", *, time_axis: int = 0,
                          ring: bool = False) -> torch.Tensor:
    """:func:`halo_exchange`, or with ``ring`` the wrap-around exchange (the
    first rank's left halo is the last rank's tail, and the other way
    round) for periodic workloads."""
    return _exchange(x, h_left, h_right, mesh, axis, time_axis, ring=ring)


def edge_zeros_note() -> str:
    return ("the line exchange zero-fills the halos that have no neighbour; this matches "
            "the zero-filled boundary slots of make_overlapping_blocks, so exchange mode "
            "and replication mode are bit-identical (tested).")
