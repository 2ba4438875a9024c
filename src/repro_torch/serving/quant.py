"""Weight-only int8 quantization for serving (port of `repro.serving.quant`).

Decode at small batch is weight-bandwidth-bound: every step streams the
full parameter set.  Weights stored as int8 codes with per-channel float32
scales halve that stream against bf16 (quarter it against f32).

Per-channel absmax scaling over axis -2; small leaves (norm scales,
biases) stay in full precision.  A leaf is quantized when it is a float
tensor with ndim >= 2 and at least 65,536 elements, counted on the
reference's params layout, where each layer leaf is stacked over the L
layers ((L, ...): `models.params_to_tree`).  So a stacked norm scale (L,
d_model) is eligible when L d_model >= 65,536, and its scale is then the
max over the layer axis, as in the reference.

    qtree = quantize_tree(params_to_tree(model))      # once
    model = params_from_tree(dequantize_tree(qtree, dtype), cfg)   # per call

Codes and scales are bitwise the reference's on the same weights
(``torch.round`` and ``jnp.round`` both round half to even).  The
dequantization is elementwise PyTorch, one pass a leaf; a fused int8 GEMM
is not written.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.mapreduce import tree_leaves, tree_map

__all__ = ["QuantTensor", "quantize_leaf", "dequantize_leaf", "quantize_tree",
           "dequantize_tree", "tree_param_bytes"]

MIN_ELEMENTS = 65536


@dataclasses.dataclass
class QuantTensor:
    codes: torch.Tensor  # int8, the original shape
    scale: torch.Tensor  # float32, the shape with axis -2 reduced to 1

    @property
    def shape(self):
        return self.codes.shape

    @property
    def nbytes(self) -> int:
        return self.codes.numel() + self.scale.numel() * 4


def quantize_leaf(w: torch.Tensor) -> QuantTensor:
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones((), dtype=scale.dtype, device=scale.device), scale)
    codes = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantTensor(codes=codes, scale=scale)


def dequantize_leaf(q: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.codes.float() * q.scale).to(dtype)


def _eligible(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and leaf.numel() >= MIN_ELEMENTS
            and leaf.is_floating_point())


def quantize_tree(params: Any) -> Any:
    """Quantize every large >= 2-D float leaf of a tree (dicts, tuples,
    lists of tensors); leave the rest as they are."""
    return tree_map(lambda leaf: quantize_leaf(leaf) if _eligible(leaf) else leaf, params)


def dequantize_tree(params: Any, dtype=torch.bfloat16) -> Any:
    """Every :class:`QuantTensor` of the tree back to a ``dtype`` tensor."""
    return tree_map(
        lambda leaf: dequantize_leaf(leaf, dtype) if isinstance(leaf, QuantTensor) else leaf,
        params)


def tree_param_bytes(params: Any) -> int:
    """Bytes of a tree's leaves: codes plus float32 scales for a quantized
    leaf, the element size times the count otherwise."""
    return sum(leaf.nbytes if isinstance(leaf, QuantTensor)
               else leaf.numel() * leaf.element_size() for leaf in tree_leaves(params))
