"""Plain PyTorch version of the fused-plan megakernel.

The `JnpBackend.fused_plan_update` composition restated in torch: lag and
moment sums through ``window_stats.ref``, each Welch member through the
stride-aligned candidate gather and ``segment_dft.ref``.  Takes a leading
tenant axis (series (B, rows, d), mask (B, L), z0 (B,)) as the batched
kernel does, broadcast rather than looped.
"""
from __future__ import annotations

import torch

from ..segment_dft.ref import segment_dft_power_ref
from ..window_stats.ref import (as_2d, extend_rows, fused_lag_moments_ref,
                                masked_lagged_sums_ref)

__all__ = ["fused_plan_update_ref", "welch_candidates", "stage"]


def stage(y: torch.Tensor, stage_dtype) -> torch.Tensor:
    """Round the series through ``stage_dtype`` (e.g. "bfloat16"), back to
    float32 -- the narrowed staging of the reference, bit for bit."""
    if stage_dtype is not None:
        y = y.to(getattr(torch, str(stage_dtype)))
    return y.float()


def welch_candidates(y: torch.Tensor, start_mask: torch.Tensor, z0, Lseg: int,
                     step: int) -> tuple:
    """Candidate segments of one Welch member: (windows (..., K, Lseg, d),
    valid (..., K) bool), the leading axes those of ``start_mask`` (..., L)
    and ``z0`` (...,).  Local start c is valid when (z0 + c) % step == 0, c <
    L and start_mask[c]; K = L // step + 1 bounds the aligned starts."""
    L = start_mask.shape[-1]
    K = L // step + 1
    z0 = torch.as_tensor(z0, dtype=torch.int64, device=start_mask.device)
    base = torch.remainder(-z0, step)
    cand = base[..., None] + torch.arange(K, device=start_mask.device) * step
    clipped = cand.clamp(0, max(L - 1, 0))
    valid = (cand < L) & torch.gather(start_mask, -1, clipped)
    y = extend_rows(y, L + Lseg - 1)
    rows = clipped[..., None] + torch.arange(Lseg, device=y.device)
    if y.ndim == 2:
        return y[rows], valid
    tenant = torch.arange(y.shape[0], device=y.device)[:, None, None]
    return y[tenant, rows], valid


def fused_plan_update_ref(y_padded: torch.Tensor, start_mask: torch.Tensor, z0,
                          max_lag: int, windows: tuple = (), seg_lens: tuple = (),
                          seg_steps: tuple = (), tapers: tuple = (),
                          detrend: bool = True, stage_dtype=None) -> tuple:
    """(lag, mom | None, psds, n_segs) -- the megakernel's contract."""
    windows = tuple(windows)
    y = stage(as_2d(y_padded), stage_dtype)
    L = start_mask.shape[-1]
    w_max = max(windows) if windows else 1
    l_max = max(seg_lens) if seg_lens else 1
    y = extend_rows(y, L + max(max_lag, w_max - 1, l_max - 1))
    if windows:
        lag, mom = fused_lag_moments_ref(y, start_mask, max_lag, windows)
    else:
        lag, mom = masked_lagged_sums_ref(y, start_mask, max_lag), None
    psds, n_segs = [], []
    for Lseg, step, taper in zip(seg_lens, seg_steps, tapers):
        wins, valid = welch_candidates(y, start_mask, z0, Lseg, step)
        power = segment_dft_power_ref(wins.reshape((-1,) + wins.shape[-2:]), taper, detrend)
        power = power.reshape(wins.shape[:-2] + power.shape[-2:])
        psds.append(torch.where(valid[..., None, None], power, 0.0).sum(-3))
        n_segs.append(valid.float().sum(-1))
    return lag, mom, tuple(psds), tuple(n_segs)
