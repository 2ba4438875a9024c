"""Weak-memory map-reduce engine (port of `repro.core.mapreduce`).

An order-(h_left, h_right) weak-memory estimator is

    Est(X) = sum_t k(window(t)),     window(t) = X[t - h_left : t + h_right + 1],

and this module runs it three ways with the same result:

  * :func:`serial_window_map_reduce` -- every complete window of one series
    (an ``unfold`` view, never a copy) through ``torch.func.vmap`` of the
    per-window kernel: the oracle;
  * :func:`block_window_map_reduce` -- per-block partials over the
    overlapping blocks of `repro_torch.core.overlap`, then one sum over the
    block axis: the paper's embarrassingly parallel scheme.  A
    ``chunk_kernel`` (masked-window reducer built from a backend primitive)
    replaces the per-window vmap and takes the whole block stack at once:
    y (P, width, d) and mask (P, block_size), one kernel launch for every
    block on the card;
  * :func:`scan_window_map_reduce` -- the same blocks folded one at a time
    with a running :func:`tree_sum`: P chunk-kernel calls, O(1) memory in
    the block count;
  * :func:`sharded_window_map_reduce` -- the block axis sharded over a mesh
    (`repro_torch.parallel`): each rank reduces its own blocks and the
    partials merge in ONE `psum_tree`, the paper's cluster scheme.

Gradients flow through the per-window paths (autograd through the vmap).

A statistic is a tensor or a dict / tuple / list of statistics; the tree
helpers walk that structure directly instead of through a pytree library.
Dicts are walked in sorted key order, so two statistics built in different
insertion orders flatten alike.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .overlap import OverlapSpec, make_overlapping_blocks

__all__ = ["tree_map", "tree_leaves", "tree_sum", "tree_zeros_like",
           "serial_window_map_reduce", "block_window_map_reduce", "scan_window_map_reduce",
           "sharded_window_map_reduce", "block_partials"]

KernelFn = Callable[[torch.Tensor], Any]  # (window (W, d)) -> statistic


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


def _windows(x: torch.Tensor, h_left: int, h_right: int) -> torch.Tensor:
    """Every width-(h_left + 1 + h_right) window along the second-to-last
    axis of ``x`` (..., n, d): a (..., n - W + 1, W, d) view.  The centres
    run over t in [h_left, n - h_right); edge samples are not centres."""
    n = x.shape[-2]
    w = h_left + 1 + h_right
    if n - w + 1 <= 0:
        raise ValueError(f"series of length {n} has no full window of width {w}")
    return x.unfold(-2, w, 1).transpose(-1, -2)


def _window_reduce(kernel: KernelFn, wins: torch.Tensor, mask: Optional[torch.Tensor],
                   lead: int) -> Any:
    """``kernel`` vmapped over windows (..., C, W, d) (``lead`` leading axes
    before C), contributions of the centres where ``mask`` (..., C) is False
    zeroed, then summed over C."""
    fn = kernel
    for _ in range(lead + 1):  # nested vmaps: the windows stay a view
        fn = torch.func.vmap(fn)
    contribs = fn(wins)

    def reduce(leaf):
        if mask is not None:
            m = mask.reshape(mask.shape + (1,) * (leaf.ndim - mask.ndim))
            leaf = torch.where(m, leaf, torch.zeros((), dtype=leaf.dtype, device=leaf.device))
        return leaf.sum(lead)

    return tree_map(reduce, contribs)


def serial_window_map_reduce(kernel: KernelFn, x: torch.Tensor, h_left: int,
                             h_right: int) -> Any:
    """Oracle path: sum_t k(X[t - h_left : t + h_right + 1]) over every
    complete window of ``x`` ((n,) or (n, d))."""
    if x.ndim == 1:
        x = x[:, None]
    return _window_reduce(kernel, _windows(x, h_left, h_right), None, 0)


def _core_valid_mask(block_ids: torch.Tensor, spec: OverlapSpec) -> torch.Tensor:
    """(..., block_size) bool: the core centres whose full window lies inside
    the series (the serial estimator's centre range), tail padding masked."""
    centers = block_ids[..., None] * spec.block_size + torch.arange(
        spec.block_size, device=block_ids.device)
    valid = (centers - spec.h_left >= 0) & (centers + spec.h_right <= spec.n - 1)
    return valid & (centers < spec.n)


def _block_reducer(kernel: Optional[KernelFn], chunk_kernel: Optional[Callable],
                   spec: OverlapSpec) -> Callable:
    """(blocks (..., width, d), valid mask (..., block_size)) -> partials
    with the leading axes, shared by the stacked (`block_partials`) and the
    folded (`scan_window_map_reduce`) paths.  A chunk kernel takes the
    leading axes itself (the batched contract of the port's chunk kernels)."""
    if chunk_kernel is not None:
        return chunk_kernel
    if kernel is None:
        raise ValueError("need a per-window kernel or a chunk_kernel")

    def per_block(blocks, mask):
        return _window_reduce(kernel, _windows(blocks, spec.h_left, spec.h_right), mask,
                              blocks.ndim - 2)

    return per_block


def block_partials(kernel: Optional[KernelFn], blocks: torch.Tensor, spec: OverlapSpec,
                   block_offset: "torch.Tensor | int" = 0,
                   chunk_kernel: Optional[Callable] = None) -> Any:
    """Per-block partial sums, each leaf with a leading P axis.

    Every core centre whose full window lies inside the series contributes.
    ``block_offset`` is the global id of ``blocks[0]``.  ``chunk_kernel``
    (``(y_padded, start_mask) -> stat``) replaces the per-window vmap: a
    halo-padded block IS a valid ``y_padded`` with its core starts as the
    mask, and the kernel receives all P blocks at once (y (P, width, d),
    mask (P, block_size)), one launch for every block on the card.
    """
    per_block = _block_reducer(kernel, chunk_kernel, spec)
    block_ids = torch.as_tensor(block_offset, device=blocks.device) + torch.arange(
        blocks.shape[0], device=blocks.device)
    return per_block(blocks, _core_valid_mask(block_ids, spec))


def block_window_map_reduce(kernel: Optional[KernelFn], x: torch.Tensor, spec: OverlapSpec,
                            chunk_kernel: Optional[Callable] = None) -> Any:
    """Embarrassingly parallel path on one device: build the overlapping
    blocks, reduce each, sum the P partials."""
    blocks, _ = make_overlapping_blocks(x, spec)
    partials = block_partials(kernel, blocks, spec, chunk_kernel=chunk_kernel)
    return tree_map(lambda leaf: leaf.sum(0), partials)


def scan_window_map_reduce(kernel: Optional[KernelFn], x: torch.Tensor, spec: OverlapSpec,
                           chunk_kernel: Optional[Callable] = None) -> Any:
    """`block_window_map_reduce` folded block by block with a running
    :func:`tree_sum`: the same result in O(1) memory in the block count
    (the chunk kernel is called once per block, on one block)."""
    blocks, _ = make_overlapping_blocks(x, spec)
    per_block = _block_reducer(kernel, chunk_kernel, spec)
    masks = _core_valid_mask(torch.arange(blocks.shape[0], device=blocks.device), spec)
    acc = per_block(blocks[0], masks[0])
    for i in range(1, blocks.shape[0]):
        acc = tree_sum(acc, per_block(blocks[i], masks[i]))
    return acc


def sharded_window_map_reduce(kernel: Optional[KernelFn], blocks, spec: OverlapSpec, mesh,
                              axis: str = "data",
                              chunk_kernel: Optional[Callable] = None) -> Any:
    """Cluster path: the block axis sharded over the mesh dimension
    ``axis``, one `psum_tree` at the end.

    ``blocks`` is the halo-padded block array as a ``Shard(0)`` DTensor (a
    replicate-mode `TimeSeriesStore`'s ``blocks``).  Each rank applies
    ``kernel`` (or ``chunk_kernel``, on all its blocks at once) to its local
    blocks with their global ids, sums them, and the only cross-rank traffic
    is the reduction of the (tiny) sufficient statistics, never the data.
    """
    from ..parallel.sharding import mesh_axis_size, mesh_rank, psum_tree

    world = mesh_axis_size(mesh, (axis,))
    if spec.num_blocks % world != 0:
        raise ValueError(f"num_blocks {spec.num_blocks} must divide evenly over mesh axis "
                         f"{axis}={world}")
    local = blocks.to_local()
    partials = block_partials(kernel, local, spec,
                              block_offset=mesh_rank(mesh, axis) * (spec.num_blocks // world),
                              chunk_kernel=chunk_kernel)
    return psum_tree(tree_map(lambda leaf: leaf.sum(0), partials), mesh, axis)
