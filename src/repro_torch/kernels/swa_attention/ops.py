"""Wrapper of the sliding-window attention CUDA kernel (port of
`repro.kernels.swa_attention.ops`).

:func:`swa_attention` takes the heads as the projections produce them --
q (B, S, H, D), k and v (B, S, KVH, D) -- and reads the G = H / KVH query
heads of each KV head without repeating K/V and without padding S.  CUDA
tensors run ``csrc/swa_attention.cu`` (bf16 on the tensor cores, float32 on
SIMT FMA); CPU tensors run the chunked plain version (``ref.py``), which
has the semantics of the reference model's `_chunked_attention`.  A CUDA
tensor never falls back to the plain version.

The kernel has no backward, as the reference's has none: the wrapper raises
on inputs that require grad.
"""
from __future__ import annotations

import torch

from .._build import SWA_MAX_D, SwaParams
from .._launch import Kernel, Prepared, on_cuda, register, require
from .ref import swa_attention_chunked

__all__ = ["SWA_ATTENTION", "swa_attention", "prepare_swa_attention"]

SWA_ATTENTION = register(Kernel("swa_attention", "rt_swa_attention"))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q (B, S, H, D) and k, v (B, S, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not serve q {tuple(q.shape)}: need "
                         f"(B, S, KVH, D) with H % KVH == 0")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("swa_attention has no backward (the reference kernel is "
                           "forward only); call it under torch.no_grad()")


def prepare_swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                          scale: float) -> Prepared:
    """Sliding-window attention over contiguous CUDA tensors q (B, S, H, D),
    k and v (B, S, KVH, D), all bfloat16 or all float32; ``.launch()``
    returns out (B, S, H, D) in their dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    require(q, "q", (b, s, h, d), q.dtype)
    require(k, "k", (b, s, kvh, d), q.dtype)
    require(v, "v", (b, s, kvh, d), q.dtype)
    if d > SWA_MAX_D or (q.dtype == torch.bfloat16 and d % 8):
        raise ValueError(f"the kernel takes head dims up to {SWA_MAX_D} (multiples of 8 in "
                         f"bfloat16), got {d}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bfloat16 operands must start on a 16-byte boundary")
    out = torch.empty_like(q)
    p = SwaParams()
    p.q, p.k, p.v, p.out = q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()
    p.B, p.S, p.H, p.KVH, p.D, p.G = b, s, h, kvh, d, h // kvh
    p.window = min(int(window), s)  # a window beyond S masks nothing more
    p.dtype = _DTYPES[q.dtype]
    p.scale = scale
    return Prepared(SWA_ATTENTION, p, q.device, out, (q, k, v))


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, *,
                  scale: float | None = None) -> torch.Tensor:
    """Sliding-window causal attention with GQA: position q attends to keys
    in (q - window, q].  q (B, S, H, D), k and v (B, S, KVH, D) ->
    (B, S, H, D); ``window >= S`` is plain causal attention."""
    _check(q, k, v, window)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not on_cuda(q, k, v):
        return swa_attention_chunked(q, k, v, window, scale=scale)
    return prepare_swa_attention(q, k, v, window, scale).launch()
