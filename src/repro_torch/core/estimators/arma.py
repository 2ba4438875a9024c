"""ARMA(p, q) estimation via innovations and a block solve (port of
`repro.core.estimators.arma`)."""
from __future__ import annotations

from typing import Tuple

import torch

from .innovation import innovation_algorithm

__all__ = ["solve_arma_from_psi", "fit_arma"]


def solve_arma_from_psi(psi: torch.Tensor, p: int, q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover (A, B) from Psi_1..Psi_{p+q} (psi[0] = I): the block system
    sum_i A_i Psi_{q+r-i} = Psi_{q+r} for r = 1..p, then B by
    back-substitution."""
    d = psi.shape[1]
    P = lambda j: psi.new_zeros((d, d)) if j < 0 else psi[j]
    M = torch.cat([torch.cat([P(q + r - i).T for i in range(1, p + 1)], 1)
                   for r in range(1, p + 1)], 0)
    R = torch.cat([P(q + r).T for r in range(1, p + 1)], 0)
    sol = torch.linalg.solve(M, R)
    A = torch.stack([sol[i * d: (i + 1) * d, :].T for i in range(p)])
    Bs = []
    for j in range(1, q + 1):
        acc = P(j)
        for i in range(1, min(j, p) + 1):
            acc = acc - A[i - 1] @ P(j - i)
        Bs.append(acc)
    B = torch.stack(Bs) if q > 0 else psi.new_zeros((0, d, d))
    return A, B


def fit_arma(gamma: torch.Tensor, p: int, q: int, m: int | None = None, backend=None,
             ridge: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit ARMA(p, q) from gamma(0..m) (or a raw series, ndim < 3).

    Returns A (p, d, d), B (q, d, d), sigma (d, d).
    """
    if m is None:
        m = p + q
    m = max(m, p + q)
    if gamma.ndim < 3:
        from .stats import autocovariance

        gamma = autocovariance(gamma, m, normalization="standard", backend=backend)
    theta, V = innovation_algorithm(gamma, m, ridge=ridge)
    d = gamma.shape[1]
    eye = torch.eye(d, device=gamma.device, dtype=gamma.dtype)[None]
    psi = torch.cat([eye, torch.stack([theta[m - 1, j - 1] for j in range(1, p + q + 1)])])
    A, B = solve_arma_from_psi(psi, p, q)
    return A, B, V[m]
