"""int8 gradient compression with error feedback (port of
`repro.training.compression`).

Each leaf is quantized to int8 in blocks of 256 with a per-block float32
scale (max |x| / 127, 1 for an all-zero block) before the cross-rank
reduction, and the quantization residual is fed back into the next step's
gradient (error feedback keeps SGD / Adam convergence: Karimireddy et al.
2019).  The reduction sums the int8 codes as int32 (exact), and averages
the scales; decompression takes the mean code times the mean scale, and
the residual is what this rank's own codes lost.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

__all__ = ["BLOCK", "compress_int8", "decompress_int8", "error_feedback_allreduce"]

BLOCK = 256


def compress_int8(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes (n_blocks, block), float32 scales
    (n_blocks, 1)), the flat x zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.clip(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """Codes times their block's scale, cut to ``shape``'s size, in
    ``dtype``."""
    flat = (codes.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def error_feedback_allreduce(grads: Dict[str, torch.Tensor], residual: Dict[str, torch.Tensor],
                             group: Any = None) -> Tuple[Dict[str, torch.Tensor],
                                                         Dict[str, torch.Tensor]]:
    """(the ranks' mean gradient, this rank's new residual) of
    ``grads`` + ``residual`` compressed to int8: an ``all_reduce`` of the
    int32 codes (exact) and one of the scales, over ``group`` (default: the
    world).  Every rank of the group calls it with leaves of the same
    shapes."""
    world = dist.get_world_size(group)
    reduced, new_residual = {}, {}
    for k, g in grads.items():
        target = g.float() + residual[k]
        codes, scale = compress_int8(target)
        codes_sum = codes.to(torch.int32)
        dist.all_reduce(codes_sum, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        reduced[k] = decompress_int8(codes_sum.float() / world, scale_sum / world, g.shape)
        new_residual[k] = target - decompress_int8(codes, scale, g.shape)
    return reduced, new_residual
