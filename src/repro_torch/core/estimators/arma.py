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
    back-substitution.  Leading batch axes of ``psi`` carry through."""
    lead, d = psi.shape[:-3], psi.shape[-1]
    T = lambda a: a.transpose(-1, -2)
    P = lambda j: psi.new_zeros(lead + (d, d)) if j < 0 else psi[..., j, :, :]
    M = torch.cat([torch.cat([T(P(q + r - i)) for i in range(1, p + 1)], -1)
                   for r in range(1, p + 1)], -2)
    R = torch.cat([T(P(q + r)) for r in range(1, p + 1)], -2)
    sol = torch.linalg.solve(M, R)
    A = torch.stack([T(sol[..., i * d: (i + 1) * d, :]) for i in range(p)], -3)
    Bs = []
    for j in range(1, q + 1):
        acc = P(j)
        for i in range(1, min(j, p) + 1):
            acc = acc - A[..., i - 1, :, :] @ P(j - i)
        Bs.append(acc)
    B = torch.stack(Bs, -3) if q > 0 else psi.new_zeros(lead + (0, d, d))
    return A, B


def fit_arma(gamma: torch.Tensor, p: int, q: int, m: int | None = None, backend=None,
             ridge: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit ARMA(p, q) from gamma(0..m) (or a raw series, ndim < 3).

    Returns A (p, d, d), B (q, d, d), sigma (d, d); a leading batch of
    gammas (B, m+1, d, d) gives each a leading batch axis.
    """
    if m is None:
        m = p + q
    m = max(m, p + q)
    if gamma.ndim < 3:
        from .stats import autocovariance

        gamma = autocovariance(gamma, m, normalization="standard", backend=backend)
    theta, V = innovation_algorithm(gamma, m, ridge=ridge)
    lead, d = gamma.shape[:-3], gamma.shape[-1]
    eye = torch.eye(d, device=gamma.device, dtype=gamma.dtype).expand(lead + (1, d, d))
    psi = torch.cat([eye, torch.stack([theta[..., m - 1, j - 1, :, :]
                                       for j in range(1, p + q + 1)], -3)], -3)
    A, B = solve_arma_from_psi(psi, p, q)
    return A, B, V[..., m, :, :]
