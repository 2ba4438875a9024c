"""The multivariate innovation algorithm and MA fitting (port of
`repro.core.estimators.innovation`; paper §3.3).

With Gamma(h) = gamma(h)^T:  V_0 = Gamma(0); for m = 1, 2, ...:
Theta_{m,m-k} = [Gamma(m-k) - sum_{j<k} Theta_{m,m-j} V_j Theta_{k,k-j}^T] V_k^{-1}
and V_m = Gamma(0) - sum_{j<m} Theta_{m,m-j} V_j Theta_{m,m-j}^T.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["innovation_algorithm", "fit_ma"]


def innovation_algorithm(gamma: torch.Tensor, m_max: int,
                         ridge: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the recursion to order ``m_max``.

    ``ridge`` adds ridge * I to each V_k before its solve (0.0 is exact).
    Returns theta (m_max, m_max, d, d) with theta[m-1, j-1] = Theta_{m,j},
    and V (m_max+1, d, d); a leading batch of gammas (B, m_max+1, d, d)
    runs every recursion at once and gives both a leading batch axis.
    """
    if gamma.shape[-3] < m_max + 1:
        raise ValueError(f"need gamma up to lag {m_max}, got {gamma.shape[-3] - 1}")
    d = gamma.shape[-1]
    T = lambda a: a.transpose(-1, -2)
    G = lambda h: T(gamma[..., h, :, :])
    reg = ridge * torch.eye(d, device=gamma.device, dtype=gamma.dtype)
    theta = [[None] * (m + 1) for m in range(m_max + 1)]
    V = [G(0)]
    for m in range(1, m_max + 1):
        for k in range(m):
            acc = G(m - k)
            for j in range(k):
                acc = acc - theta[m][m - j] @ V[j] @ T(theta[k][k - j])
            theta[m][m - k] = T(torch.linalg.solve_ex(T(V[k] + reg), T(acc))[0])
        Vm = G(0)
        for j in range(m):
            Vm = Vm - theta[m][m - j] @ V[j] @ T(theta[m][m - j])
        V.append(Vm)
    out = gamma.new_zeros(gamma.shape[:-3] + (m_max, m_max, d, d))
    for m in range(1, m_max + 1):
        for j in range(1, m + 1):
            out[..., m - 1, j - 1, :, :] = theta[m][j]
    return out, torch.stack(V, -3)


def fit_ma(gamma: torch.Tensor, q: int, m: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit a MA(q) model from gamma(0..m) (>= m+1, d, d) (paper §3.3): the
    innovation recursion to depth ``m`` (default: every lag given), then
    B_j = Theta_{m,j} for j = 1..q (q, d, d) and sigma = V_m (d, d)."""
    if m is None:
        m = gamma.shape[0] - 1
    if m < q:
        raise ValueError(f"recursion depth m={m} must be ≥ q={q}")
    theta, V = innovation_algorithm(gamma, m)
    return theta[m - 1, :q], V[m]
