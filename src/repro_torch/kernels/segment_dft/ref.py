"""Plain PyTorch versions of the segment-DFT kernels (port of
`repro.kernels.segment_dft.ref`): power and cross-spectra, both in the
matmul form against taper-folded twiddle matrices (no library FFT); and
the host-built tables the kernels read: the twiddles, and the roots of the
FFT path."""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dft_phase", "dft_power_matrices", "fft_roots_host", "fft_roots",
           "segment_dft_power_ref", "segment_dft_ref", "segment_csd_ref"]


@functools.lru_cache(maxsize=32)
def _phase_host(L: int) -> np.ndarray:
    F = L // 2 + 1
    # t*f grows to ~L^2/2, which float32 cannot hold past L ~ 4k: reduce it
    # mod L in exact int64 host arithmetic first (the twiddles are L-periodic).
    return np.mod(np.outer(np.arange(L, dtype=np.int64), np.arange(F, dtype=np.int64)),
                  L).astype(np.float32)


@functools.lru_cache(maxsize=32)
def dft_phase(L: int, device: torch.device) -> torch.Tensor:
    """(L, L//2+1) float32 phase index t*f mod L on ``device`` (copied once)."""
    return torch.from_numpy(_phase_host(L)).to(device)


@functools.lru_cache(maxsize=32)
def fft_roots_host(L: int) -> np.ndarray:
    """(L//2, 2) float32 (cos, sin) of exp(-2 pi i k / L), k < L/2: the FFT
    path's roots.  The phase k is already reduced mod L in exact integers
    (as in :func:`_phase_host`); the angle and both functions are taken in
    float64 and rounded once to float32."""
    ang = np.arange(max(L // 2, 1), dtype=np.int64) * (2.0 * np.pi / L)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def fft_roots(L: int, device: torch.device) -> torch.Tensor:
    """:func:`fft_roots_host` on ``device``, copied once per (L, device)."""
    return torch.from_numpy(fft_roots_host(L)).to(device)


def dft_power_matrices(L: int, taper: torch.Tensor) -> tuple:
    """Taper-folded real-DFT twiddles, both (L, L//2+1) float32:
    rfft(y * taper)[f] = sum_t y_t C[t, f] + i sum_t y_t S[t, f]."""
    ang = dft_phase(L, taper.device) * np.float32(2.0 * np.pi / L)
    taper = taper.float()[:, None]
    return taper * torch.cos(ang), -taper * torch.sin(ang)


def segment_dft_ref(segments: torch.Tensor, taper: torch.Tensor,
                    detrend: bool = True) -> tuple:
    """(S, L, d) segments -> (re, im), each (S, L//2+1, d) float32: the real
    and imaginary parts of rfft((y - mean) taper) per segment."""
    y = segments.float()
    if detrend:
        y = y - y.mean(dim=1, keepdim=True)
    C, S = dft_power_matrices(segments.shape[1], taper)
    return torch.einsum("std,tf->sfd", y, C), torch.einsum("std,tf->sfd", y, S)


def segment_dft_power_ref(segments: torch.Tensor, taper: torch.Tensor,
                          detrend: bool = True) -> torch.Tensor:
    """(S, L, d) segments -> (S, L//2+1, d) power |rfft((y - mean) taper)|^2."""
    re, im = segment_dft_ref(segments, taper, detrend)
    return re * re + im * im


def segment_csd_ref(segments: torch.Tensor, taper: torch.Tensor,
                    detrend: bool = True) -> torch.Tensor:
    """(S, L, d) segments -> (S, L//2+1, d, d) complex64 per-segment
    cross-spectral products rfft_i * conj(rfft_j), Hermitian in (i, j)."""
    f = torch.complex(*segment_dft_ref(segments, taper, detrend))
    return f[..., :, None] * f.conj()[..., None, :]
