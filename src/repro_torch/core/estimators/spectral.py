"""Welch spectral estimation: PSD and cross-spectral matrix (port of the
batch part of `repro.core.estimators.spectral`)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...kernels.fused_plan.ref import welch_candidates
from ..backend import BackendSpec, get_backend, resolve_device

__all__ = ["hann_window", "welch_psd", "welch_csd", "welch_chunk_kernel"]


def hann_window(n: int, device="cuda") -> torch.Tensor:
    """Periodic Hann taper of length ``n`` on ``device`` (the card unless
    the CPU is asked for)."""
    dev = resolve_device(device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n, device=dev) / n)


def _one_sided(psd: torch.Tensor, nperseg: int, fs: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-sided -> one-sided: double every bin but DC (and Nyquist for even
    ``nperseg``); returns (freqs, psd).  A batch of PSDs (B, nfreq, d) gives
    freqs (B, nfreq), as the reference's vmap does."""
    nfreq = psd.shape[-2]
    mult = torch.full((nfreq,), 2.0, device=psd.device)
    mult[0] = 1.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    freqs = torch.arange(nfreq, device=psd.device) * (1.0 / (nperseg * (1.0 / fs)))
    return freqs.expand(psd.shape[:-1]), psd * mult[:, None]


def _segments(x: torch.Tensor, nperseg: int, overlap: int) -> torch.Tensor:
    """(n_seg, nperseg, d) overlapping segments, step nperseg - overlap (the
    reference's overlap container, as a view)."""
    step = nperseg - overlap
    n_seg = (x.shape[0] - overlap) // step
    if n_seg < 1:
        raise ValueError(f"series of length {x.shape[0]} too short for nperseg={nperseg}")
    return x.float().unfold(0, nperseg, step)[:n_seg].transpose(1, 2)


def welch_psd(x: torch.Tensor, nperseg: int = 256, overlap: Optional[int] = None,
              fs: float = 1.0, backend: BackendSpec = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Welch PSD per dimension: (freqs (nfreq,), psd (nfreq, d)), one-sided,
    through the backend's ``segment_fft_power``."""
    if x.ndim == 1:
        x = x[:, None]
    overlap = nperseg // 2 if overlap is None else overlap
    segs = _segments(x, nperseg, overlap)
    w = hann_window(nperseg, x.device)
    scale = 1.0 / (fs * torch.sum(w**2))
    power = get_backend(backend, x.device).segment_fft_power(segs, w)
    return _one_sided(power.mean(0) * scale, nperseg, fs)


def welch_csd(x: torch.Tensor, nperseg: int = 256, overlap: Optional[int] = None,
              fs: float = 1.0, backend: BackendSpec = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-spectral density matrix: (freqs (nfreq,), csd (nfreq, d, d)
    complex64), two-sided scale per pair, Hermitian in (i, j), through the
    backend's ``segment_csd`` (the segment-CSD kernel on "cuda")."""
    if x.ndim == 1:
        x = x[:, None]
    overlap = nperseg // 2 if overlap is None else overlap
    segs = _segments(x, nperseg, overlap)
    w = hann_window(nperseg, x.device)
    scale = 1.0 / (fs * torch.sum(w**2))
    csd = get_backend(backend, x.device).segment_csd(segs, w)  # (S, nfreq, d, d)
    return torch.fft.rfftfreq(nperseg, d=1.0 / fs, device=x.device), csd.mean(0) * scale


def welch_chunk_kernel(nperseg: int, step: int, scale, be, device="cuda"):
    """Offset-aware chunk kernel accumulating Welch segment-PSD partials:
    only the stride-aligned candidate starts are gathered and transformed.
    Batched operands (y (B, rows, d), mask (B, L), z0 (B,)) stack every
    tenant's candidates into ONE ``segment_fft_power`` call (B * K
    segments), then sum each tenant's valid powers."""
    w = hann_window(nperseg, device)

    def chunk_kernel(y_padded: torch.Tensor, start_mask: torch.Tensor, z0) -> dict:
        wins, valid = welch_candidates(y_padded, start_mask, z0, nperseg, step)
        power = be.segment_fft_power(wins.reshape((-1,) + wins.shape[-2:]), w) * scale
        power = power.reshape(wins.shape[:-2] + power.shape[-2:])
        psd = torch.where(valid[..., None, None], power, 0.0).sum(-3)
        return {"psd": psd, "n_seg": valid.float().sum(-1)}

    return chunk_kernel
