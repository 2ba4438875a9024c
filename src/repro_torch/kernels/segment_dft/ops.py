"""Wrappers of the segment-DFT CUDA kernels (port of
`repro.kernels.segment_dft.ops`): per-segment power ``segment_fft_power``
and cross-spectra ``segment_csd``.

CUDA tensors run ``csrc/segment_dft.cu``; CPU tensors run the plain versions
(``ref.py``).  A CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

import torch

from .._launch import Kernel, Prepared, add_welch, new_params, on_cuda, register, require
from .ref import dft_power_matrices, segment_csd_ref, segment_dft_power_ref

__all__ = ["SEGMENT_DFT_POWER", "SEGMENT_CSD", "segment_fft_power", "segment_csd",
           "prepare_segment_power", "prepare_segment_csd"]

SEGMENT_DFT_POWER = register(Kernel("segment_dft_power", "rt_segment_power"))
SEGMENT_CSD = register(Kernel("segment_csd", "rt_segment_csd"))


def _check_segments(segments: torch.Tensor, taper: torch.Tensor) -> None:
    if segments.ndim != 3:
        raise ValueError(f"segments must be (S, L, d), got {tuple(segments.shape)}")
    L = segments.shape[1]
    if tuple(taper.shape) != (L,):
        raise ValueError(f"taper must be ({L},), got {tuple(taper.shape)}")


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
    _check_segments(segments, taper)
    L = segments.shape[1]
    if not on_cuda(segments, taper):
        return segment_dft_power_ref(segments, taper, detrend)
    if segments.shape[0] == 0:
        return segments.new_zeros((0, L // 2 + 1, segments.shape[2]))
    C, Sn = dft_power_matrices(L, taper)
    return prepare_segment_power(segments.float().contiguous(), C.contiguous(),
                                 Sn.contiguous(), detrend).launch()


def prepare_segment_csd(segments: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                        detrend: bool) -> Prepared:
    """(S, L, d) contiguous float32 segments (S >= 1) and (L, F) twiddles;
    ``.launch()`` returns the (S, F, d, d) complex64 cross-spectra, a view of
    the kernel's interleaved (re, im) float32 output."""
    S, L, d = segments.shape
    require(segments, "segments", (S, L, d))
    if S == 0:
        raise ValueError("need at least one segment")
    F = cos.shape[1]
    out = torch.empty((S, F, d, d, 2), device=segments.device)
    p = new_params(segments.view(S * L, d), 0)
    p.detrend = int(detrend)
    add_welch(p, cos, sin, None, S, 1, L, 1, segments.device, out=out)
    p.welch[0].ctas *= p.d_tiles  # one CTA per (segment, f tile, i tile, j tile)
    return Prepared(SEGMENT_CSD, p, segments.device, torch.view_as_complex(out),
                    (segments, cos, sin, out))


def segment_csd(segments: torch.Tensor, taper: torch.Tensor,
                detrend: bool = True) -> torch.Tensor:
    """Per-segment cross-spectral products rfft_i * conj(rfft_j) of
    (seg - mean) * taper.

    Args:
      segments: (S, L, d), any float dtype (float32 accumulation).
      taper: (L,) window function.

    Returns (S, L//2+1, d, d) complex64, Hermitian in (i, j).
    """
    _check_segments(segments, taper)
    S, L, d = segments.shape
    if not on_cuda(segments, taper):
        return segment_csd_ref(segments, taper, detrend)
    if S == 0:
        return torch.zeros((0, L // 2 + 1, d, d), dtype=torch.complex64,
                           device=segments.device)
    C, Sn = dft_power_matrices(L, taper)
    return prepare_segment_csd(segments.float().contiguous(), C.contiguous(),
                               Sn.contiguous(), detrend).launch()
