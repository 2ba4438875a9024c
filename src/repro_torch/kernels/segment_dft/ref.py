"""Plain PyTorch version of the segment-DFT power kernel (port of
`repro.kernels.segment_dft.ref`): the matmul form against taper-folded
twiddle matrices."""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dft_phase", "dft_power_matrices", "segment_dft_power_ref"]


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


def dft_power_matrices(L: int, taper: torch.Tensor) -> tuple:
    """Taper-folded real-DFT twiddles, both (L, L//2+1) float32:
    rfft(y * taper)[f] = sum_t y_t C[t, f] + i sum_t y_t S[t, f]."""
    ang = dft_phase(L, taper.device) * np.float32(2.0 * np.pi / L)
    taper = taper.float()[:, None]
    return taper * torch.cos(ang), -taper * torch.sin(ang)


def segment_dft_power_ref(segments: torch.Tensor, taper: torch.Tensor,
                          detrend: bool = True) -> torch.Tensor:
    """(S, L, d) segments -> (S, L//2+1, d) power |rfft((y - mean) taper)|^2."""
    y = segments.float()
    if detrend:
        y = y - y.mean(dim=1, keepdim=True)
    C, S = dft_power_matrices(segments.shape[1], taper)
    re = torch.einsum("std,tf->sfd", y, C)
    im = torch.einsum("std,tf->sfd", y, S)
    return re * re + im * im
