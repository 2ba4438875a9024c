"""Wrappers of the segment-DFT CUDA kernels (port of
`repro.kernels.segment_dft.ops`): per-segment power ``segment_fft_power``
and cross-spectra ``segment_csd``.

CUDA tensors run ``csrc/segment_dft.cu``; CPU tensors run the plain versions
(``ref.py``).  A CUDA tensor never falls back to the plain version.  The
power kernel takes one of two paths, chosen by the segment length
(``_launch.welch_path``): the shared-memory FFT for a power of two up to
``FFT_MAX_L``, the twiddle contraction for any other length; the
cross-spectra kernel always contracts against the twiddles.
"""
from __future__ import annotations

import torch

from .._launch import (Kernel, Prepared, add_welch, new_params, on_cuda, register, require,
                       welch_path)
from .ref import segment_csd_ref, segment_dft_power_ref

__all__ = ["SEGMENT_DFT_POWER", "SEGMENT_CSD", "segment_fft_power", "segment_csd",
           "prepare_segment_power", "prepare_segment_csd"]

SEGMENT_DFT_POWER = register(Kernel("segment_dft_power", "rt_segment_power",
                                   paths=("fft", "twiddle")))
# Segments per CTA on the FFT path, one after the other, the next one's copy
# in flight during this one's transform: of 1, 2, 3 and 4, four was the
# fastest at 511 segments of (256, 64) on the H100, 2-3% ahead of one, and
# within 1% of two, the fastest, at 1,023; three was the slowest at both
# (tools/kernel_variants/variants_bench.py stats; PERF.md).
FFT_GROUP = 4
SEGMENT_CSD = register(Kernel("segment_csd", "rt_segment_csd"))


def _check_segments(segments: torch.Tensor, taper: torch.Tensor) -> None:
    if segments.ndim != 3:
        raise ValueError(f"segments must be (S, L, d), got {tuple(segments.shape)}")
    L = segments.shape[1]
    if tuple(taper.shape) != (L,):
        raise ValueError(f"taper must be ({L},), got {tuple(taper.shape)}")


def prepare_segment_power(segments: torch.Tensor, taper: torch.Tensor,
                          detrend: bool) -> Prepared:
    """(S, L, d) contiguous float32 segments (S >= 1) and their (L,) taper;
    ``.launch()`` returns the (S, F, d) power."""
    S, L, d = segments.shape
    require(segments, "segments", (S, L, d))
    if S == 0:
        raise ValueError("need at least one segment")
    out = torch.empty((S, L // 2 + 1, d), device=segments.device)
    p = new_params(segments.view(S * L, d), 0)
    p.detrend = int(detrend)
    group = FFT_GROUP if welch_path(L) == "fft" else 1  # the twiddle path: one a CTA
    _, _, operands = add_welch(p, taper, None, S, 1, L, group, segments.device, out=out)
    return Prepared(SEGMENT_DFT_POWER, p, segments.device, out, (segments,) + operands)


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
    return prepare_segment_power(segments.float().contiguous(), taper, detrend).launch()


def prepare_segment_csd(segments: torch.Tensor, taper: torch.Tensor,
                        detrend: bool) -> Prepared:
    """(S, L, d) contiguous float32 segments (S >= 1) and their (L,) taper;
    ``.launch()`` returns the (S, F, d, d) complex64 cross-spectra, a view of
    the kernel's interleaved (re, im) float32 output."""
    S, L, d = segments.shape
    require(segments, "segments", (S, L, d))
    if S == 0:
        raise ValueError("need at least one segment")
    out = torch.empty((S, L // 2 + 1, d, d, 2), device=segments.device)
    p = new_params(segments.view(S * L, d), 0)
    p.detrend = int(detrend)
    _, _, operands = add_welch(p, taper, None, S, 1, L, 1, segments.device, out=out,
                               path="twiddle")
    p.welch[0].ctas *= p.d_tiles  # one CTA per (segment, f tile, i tile, j tile)
    return Prepared(SEGMENT_CSD, p, segments.device, torch.view_as_complex(out),
                    (segments, out) + operands)


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
    return prepare_segment_csd(segments.float().contiguous(), taper, detrend).launch()
