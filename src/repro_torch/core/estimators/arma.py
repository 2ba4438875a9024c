"""ARMA(p, q) estimation via innovations and a block solve (port of
`repro.core.estimators.arma`)."""
from __future__ import annotations

from typing import Tuple

import torch

from .innovation import innovation_algorithm

__all__ = ["arma_psi_weights", "solve_arma_from_psi", "fit_arma", "fit_arma_streaming"]


def arma_psi_weights(A: torch.Tensor, B: torch.Tensor, n_weights: int) -> torch.Tensor:
    """Psi_0..Psi_{n_weights-1} (n_weights, d, d) of the ARMA model A (p, d,
    d), B (q, d, d) by the forward recursion Psi_j = B_j + sum_i A_i
    Psi_{j-i}, Psi_0 = I."""
    p, d, q = A.shape[0], A.shape[1], B.shape[0]
    psis = [torch.eye(d, dtype=A.dtype, device=A.device)]
    for j in range(1, n_weights):
        acc = B[j - 1] if j <= q else A.new_zeros((d, d))
        for i in range(1, min(j, p) + 1):
            acc = acc + A[i - 1] @ psis[j - i]
        psis.append(acc)
    return torch.stack(psis)


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
    sol = torch.linalg.solve_ex(M, R)[0]  # unchecked, as yule_walker's solve
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


def fit_arma_streaming(engine, state, p: int, q: int, m: int | None = None,
                       normalization: str = "standard") -> Tuple[torch.Tensor, torch.Tensor,
                                                                 torch.Tensor]:
    """ARMA(p, q) fit from a lag-sum state (`stats.lag_sum_engine`) whose
    ``h_right`` covers the recursion depth (>= m, default p+q)."""
    m_eff = max(m if m is not None else p + q, p + q)
    if engine.h_right < m_eff:
        raise ValueError(f"state tracks lags 0..{engine.h_right}, innovation recursion "
                         f"needs {m_eff}")
    from .stats import streaming_autocovariance

    return fit_arma(streaming_autocovariance(engine, state, normalization), p, q, m_eff)
