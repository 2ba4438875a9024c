"""Sufficient statistics of second-order stationary series (port of the
main-path part of `repro.core.estimators.stats`)."""
from __future__ import annotations

from typing import Literal

import torch

from ..backend import BackendSpec, get_backend

Normalization = Literal["paper", "standard"]

__all__ = ["mean", "gamma_normalizer", "autocovariance", "windowed_moments"]


def mean(x: torch.Tensor) -> torch.Tensor:
    """mu = (1/N) sum X_k."""
    if x.ndim == 1:
        x = x[:, None]
    return x.mean(0)


def gamma_normalizer(n, max_lag: int, normalization: Normalization) -> torch.Tensor:
    """Per-lag normalizers for gamma(h), h = 0..max_lag.

    "paper":    1/(N-h-1), the divisor clamped to >= 1
    "standard": 1/N (biased, keeps the block-Toeplitz matrix PSD)

    ``n`` may be an int, a 0-d integer tensor (a state's length) or a (B,)
    one (a batch of states' lengths: the result is then (B, max_lag+1)).
    """
    n = torch.as_tensor(n)[..., None]
    h = torch.arange(max_lag + 1, device=n.device)
    if normalization == "paper":
        return 1.0 / torch.clamp(n - h - 1, min=1)
    return torch.ones(max_lag + 1, device=n.device) / n


def autocovariance(x: torch.Tensor, max_lag: int, normalization: Normalization = "paper",
                   center: bool = False, backend: BackendSpec = None) -> torch.Tensor:
    """Serial gamma(h), h = 0..max_lag: (max_lag+1, d, d), through the
    backend's ``lagged_sums`` (the cross_window_stats kernel on "cuda")."""
    if x.ndim == 1:
        x = x[:, None]
    if center:
        x = x - mean(x)[None, :]
    s = get_backend(backend, x.device).lagged_sums(x, max_lag)
    norm = gamma_normalizer(x.shape[0], max_lag, normalization).to(s.device)
    return s * norm[:, None, None]


def windowed_moments(x: torch.Tensor, window: int, backend: BackendSpec = None) -> dict:
    """Rolling mean and population variance over every full width-``window``
    slice: {"mean": (n_win, d), "var": (n_win, d)}, from the backend's
    ``windowed_moments`` sums (the rolling-moments kernel on "cuda").

    The sums run on the globally centred series: the variance is
    shift-invariant, and E[x^2] - E[x]^2 in float32 cancels catastrophically
    for a high-mean series, so the second moment is taken about the global
    mean and clamped at 0.
    """
    if x.ndim == 1:
        x = x[:, None]
    mu = mean(x.float())
    s = get_backend(backend, x.device).windowed_moments(x - mu[None, :], window)
    m_c = s[:, 0] / window
    var = torch.clamp(s[:, 1] / window - m_c * m_c, min=0.0)
    return {"mean": m_c + mu[None, :], "var": var}
