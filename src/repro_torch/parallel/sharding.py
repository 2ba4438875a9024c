"""The mesh and its one collective (port of `repro.parallel.sharding`'s
statistics half).

The process model is SPMD: one process per card, each holding its shard of
the block axis.  The mesh is a 1-D `torch.distributed.device_mesh.
DeviceMesh` whose dimension is named ``"data"``: NCCL on the card, gloo on
the CPU.  A mesh-placed array is a `torch.distributed.tensor.DTensor` --
``Shard(0)`` on the block axis is the reference's ``NamedSharding(mesh,
P("data"))``, ``Replicate()`` its ``P()`` -- that keeps the reference's
global shape; every computation reads its ``.to_local()``.

The reference's ``shard_map_compat`` has no counterpart: each SPMD rank runs
the per-shard body directly on its local blocks.  Its logical-axis rules
(``logical_to_spec``, ``param_pspecs``, ``zero1_pspecs``, ``shard``,
``set_sp_mode``) place LM parameters and wait for a sharded training slice.

:func:`psum_tree` is the cluster-level merge of the weak-memory monoid: the
per-shard partial statistics of halo-complete blocks already hold every
window a shard owns, so the global merge is ONE reduction of the (tiny)
sufficient statistics, never of the data.  It gathers every rank's partials
(one ``all_gather`` per dtype of the leaves) and sums them in rank order on
every rank, so the result is bitwise the same on every rank and from run to
run, and at world 1 bitwise the local partial.  A plain ``all_reduce``
gives neither: NCCL picks its reduction order by message size.
:func:`collective_count` counts the collectives, as a kernel wrapper counts
its launches.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

from ..core.backend import resolve_device
from ..core.mapreduce import tree_leaves, tree_map

__all__ = ["data_mesh", "mesh_axis_size", "mesh_rank", "mesh_device", "gather_tree",
           "psum_tree", "sum_ranks", "collective_count", "reset_collective_count"]

_collectives = 0


def collective_count() -> int:
    """Collectives made by :func:`gather_tree` / :func:`psum_tree` since the
    last reset."""
    return _collectives


def reset_collective_count() -> None:
    global _collectives
    _collectives = 0


def data_mesh(world_size: int, rank: int, init_method: str, device="cuda",
              axis: str = "data"):
    """Join the process group and build the 1-D mesh named ``axis``.

    On the card: the process's card is ``cuda:<rank mod cards>`` (set before
    the NCCL group is made, or its point-to-point calls can hang) and the
    backend is NCCL, which must be present; a mesh on the card never runs
    gloo.  On the CPU (``device="cpu"``): gloo.  ``init_method`` is the
    rendezvous (``file://<path>`` or ``tcp://host:port``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)  # raises on "cuda" without a GPU
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on the card needs NCCL, and this PyTorch has none")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; a {dev.type} mesh "
                           f"needs {backend}")
    return init_device_mesh(dev.type, (world_size,), mesh_dim_names=(axis,))


def mesh_axis_size(mesh, names: Sequence[str]) -> int:
    """Ranks along the mesh dimensions ``names`` (1 for a name it lacks)."""
    dims = mesh.mesh_dim_names or ()
    return math.prod(mesh.size(dims.index(n)) if n in dims else 1 for n in names)


def mesh_rank(mesh, axis: str = "data") -> int:
    """This process's index along ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh) -> torch.device:
    """Where this rank's shard lives: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather_tree(tree: Any, mesh, axis: str = "data") -> Any:
    """Every rank's copy of ``tree``, stacked: each leaf gains a leading
    (world,) axis in rank order.  The leaves are flattened into one buffer
    per dtype and gathered with one ``all_gather`` each."""
    global _collectives
    leaves = tree_leaves(tree)
    group = mesh.get_group(axis)
    world = group.size()
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    out = [None] * len(leaves)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        gathered = flat.new_empty((world, flat.numel()))
        dist.all_gather(list(gathered.unbind(0)), flat, group=group)
        _collectives += 1
        start = 0
        for i in idx:
            size = leaves[i].numel()
            out[i] = gathered[:, start: start + size].reshape((world,) + leaves[i].shape)
            start += size
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def sum_ranks(stacked: torch.Tensor) -> torch.Tensor:
    """The (world, ...) partials summed in rank order (rank 0 first)."""
    acc = stacked[0]
    for r in range(1, stacked.shape[0]):
        acc = acc + stacked[r]
    return acc


def psum_tree(tree: Any, mesh, axis: str = "data") -> Any:
    """The sum over the mesh dimension ``axis`` of every rank's ``tree`` of
    partial statistics: one collective per dtype, then the world's partials
    added in rank order on every rank (bitwise alike on every rank; at world
    1 bitwise the local partial)."""
    return tree_map(sum_ranks, gather_tree(tree, mesh, axis))
