"""Wrapper of the segment-DFT power CUDA kernel (port of
`repro.kernels.segment_dft.ops`, the ``segment_fft_power`` half).

CUDA tensors run ``csrc/segment_dft.cu``; CPU tensors run the plain version
(``ref.py``).  A CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

import torch

from .._launch import Kernel, Prepared, add_welch, new_params, on_cuda, register, require
from .ref import dft_power_matrices, segment_dft_power_ref

__all__ = ["SEGMENT_DFT_POWER", "segment_fft_power", "prepare_segment_power"]

SEGMENT_DFT_POWER = register(Kernel("segment_dft_power", "rt_segment_power"))


def prepare_segment_power(segments: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                          detrend: bool) -> Prepared:
    """(S, L, d) contiguous float32 segments (S >= 1) and (L, F) twiddles;
    ``.launch()`` returns the (S, F, d) power."""
    S, L, d = segments.shape
    require(segments, "segments", (S, L, d))
    if S == 0:
        raise ValueError("need at least one segment")
    F = cos.shape[1]
    out = torch.empty((S, F, d), device=segments.device)
    p = new_params(segments.view(S * L, d), 0)
    p.detrend = int(detrend)
    add_welch(p, cos, sin, None, S, 1, L, 1, segments.device, out=out)
    return Prepared(SEGMENT_DFT_POWER, p, segments.device, out, (segments, cos, sin))


def segment_fft_power(segments: torch.Tensor, taper: torch.Tensor,
                      detrend: bool = True) -> torch.Tensor:
    """Per-segment one-sided power |rfft((seg - mean) * taper)|^2.

    Args:
      segments: (S, L, d), any float dtype (float32 accumulation).
      taper: (L,) window function.

    Returns (S, L//2+1, d) float32.
    """
    if segments.ndim != 3:
        raise ValueError(f"segments must be (S, L, d), got {tuple(segments.shape)}")
    L = segments.shape[1]
    if tuple(taper.shape) != (L,):
        raise ValueError(f"taper must be ({L},), got {tuple(taper.shape)}")
    if not on_cuda(segments, taper):
        return segment_dft_power_ref(segments, taper, detrend)
    if segments.shape[0] == 0:
        return segments.new_zeros((0, L // 2 + 1, segments.shape[2]))
    C, Sn = dft_power_matrices(L, taper)
    return prepare_segment_power(segments.float().contiguous(), C.contiguous(),
                                 Sn.contiguous(), detrend).launch()
