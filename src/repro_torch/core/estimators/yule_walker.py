"""Yule-Walker AR estimation (port of `repro.core.estimators.yule_walker`).

gamma(h) = E[X_t X_{t+h}^T] for h >= 0, gamma(-h) = gamma(h)^T.  With rows
j = 1..p and S = [A_1^T; ...; A_p^T] stacked (p*d, d):
[gamma(j-i)] S = [gamma(j)], and Sigma = gamma(0) - sum_i A_i gamma(i).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["yule_walker"]


def _gamma_at(gamma: torch.Tensor, h: int) -> torch.Tensor:
    return gamma[h] if h >= 0 else gamma[-h].T


def _block_toeplitz(gamma: torch.Tensor, p: int) -> torch.Tensor:
    """(p*d, p*d) block-Toeplitz with block (r, c) = gamma(r - c)."""
    return torch.cat([torch.cat([_gamma_at(gamma, r - c) for c in range(p)], 1)
                      for r in range(p)], 0)


def _stack_rhs(gamma: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat([gamma[j] for j in range(1, p + 1)], 0)


def yule_walker(gamma: torch.Tensor, p: int, backend=None,
                normalization: str = "standard") -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense YW solve from gamma(0..p), or from a raw series (ndim < 3).

    Returns A (p, d, d) and sigma (d, d).
    """
    if gamma.ndim < 3:
        from .stats import autocovariance

        gamma = autocovariance(gamma, p, normalization=normalization, backend=backend)
    if gamma.shape[0] < p + 1:
        raise ValueError(f"need gamma up to lag {p}, got {gamma.shape[0] - 1}")
    d = gamma.shape[1]
    sol = torch.linalg.solve(_block_toeplitz(gamma, p), _stack_rhs(gamma, p))
    A = torch.stack([sol[i * d: (i + 1) * d, :].T for i in range(p)])
    sigma = gamma[0] - sum(A[i] @ gamma[i + 1] for i in range(p))
    return A, sigma
