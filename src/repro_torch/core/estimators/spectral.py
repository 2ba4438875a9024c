"""Welch spectral estimation: PSD, cross-spectral matrix and the streaming
engine (port of `repro.core.estimators.spectral`).

A Welch estimate is an order-(nperseg - 1) weak-memory map-reduce with
windows starting at global multiples of ``step = nperseg - overlap``:
:func:`welch_engine` streams it (the chunk kernel gathers only the aligned
candidate segments, through the backend's ``segment_fft_power``, kernel 4
on the card) and :func:`streaming_welch` finalizes its state.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...kernels.fused_plan.ref import welch_candidates
from ..backend import BackendSpec, get_backend, resolve_device
from ..streaming import PartialState, StreamingEngine, resolved_stat

__all__ = ["hann_window", "welch_psd", "welch_csd", "ar1_theoretical_psd", "welch_chunk_kernel",
           "welch_engine", "streaming_welch"]


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
    Batched operands (y (B, rows, d), mask (B, L), z0 (B,)) pass every
    tenant's candidates (B, K, nperseg, d) to ONE ``segment_fft_power``
    call, B problems of K segments, then sum each tenant's valid powers."""
    w = hann_window(nperseg, device)

    def chunk_kernel(y_padded: torch.Tensor, start_mask: torch.Tensor, z0) -> dict:
        wins, valid = welch_candidates(y_padded, start_mask, z0, nperseg, step)
        power = be.segment_fft_power(wins, w) * scale
        psd = torch.where(valid[..., None, None], power, 0.0).sum(-3)
        return {"psd": psd, "n_seg": valid.float().sum(-1)}

    return chunk_kernel


def welch_engine(nperseg: int = 256, overlap: Optional[int] = None, d: int = 1,
                 fs: float = 1.0, backend: BackendSpec = None,
                 device="cuda") -> StreamingEngine:
    """Streaming engine of Welch segment-PSD partials: windows of
    ``nperseg`` rows at global multiples of ``step = nperseg - overlap``
    (``stride=step``), so the stream equals :func:`welch_psd` of the
    concatenated series.  ``state.stat`` = {"psd": (nperseg//2+1, d) summed
    segment powers, "n_seg": () segments}.  Finalize with
    :func:`streaming_welch`."""
    overlap = nperseg // 2 if overlap is None else overlap
    if not 0 <= overlap < nperseg:
        raise ValueError(f"need 0 <= overlap < nperseg, got {overlap}/{nperseg}")
    step = nperseg - overlap
    be = get_backend(backend, device)
    w = hann_window(nperseg, device)
    ck = welch_chunk_kernel(nperseg, step, 1.0 / (fs * torch.sum(w**2)), be, device)
    F = nperseg // 2 + 1
    engine = StreamingEngine(
        d=d, h_left=0, h_right=nperseg - 1, chunk_kernel=ck, stride=step, backend=be,
        kernel_takes_offset=True,
        stat_zeros=lambda dev: {"n_seg": torch.zeros((), device=dev),
                                "psd": torch.zeros((F, d), device=dev)},
        device=device)
    engine.welch_fs = fs  # the frequency grid and the density scale share fs
    return engine


def streaming_welch(engine: StreamingEngine, state: PartialState) -> Tuple[torch.Tensor,
                                                                            torch.Tensor]:
    """A Welch state as (freqs, one-sided psd (nperseg//2+1, d)); NaN while
    no segment is complete (``state.stat["n_seg"] == 0``)."""
    stat = resolved_stat(state)
    return _one_sided(stat["psd"] / stat["n_seg"][..., None, None], engine.window,
                      engine.welch_fs)


def ar1_theoretical_psd(phi: float, sigma2: float, freqs: torch.Tensor) -> torch.Tensor:
    """One-sided theoretical PSD of an AR(1): sigma2 / |1 - phi e^{-i w}|^2
    (fs = 1), the Nyquist bin not doubled."""
    two_sided = sigma2 / (1 + phi**2 - 2 * phi * torch.cos(2 * math.pi * freqs))
    mult = torch.ones_like(freqs)
    mult[1:] = 2.0
    if freqs.shape[0] > 1 and float(freqs[-1]) == 0.5:
        mult[-1] = 1.0
    return two_sided * mult
