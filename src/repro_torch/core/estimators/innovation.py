"""The multivariate innovation algorithm (port of
`repro.core.estimators.innovation`).

With Gamma(h) = gamma(h)^T:  V_0 = Gamma(0); for m = 1, 2, ...:
Theta_{m,m-k} = [Gamma(m-k) - sum_{j<k} Theta_{m,m-j} V_j Theta_{k,k-j}^T] V_k^{-1}
and V_m = Gamma(0) - sum_{j<m} Theta_{m,m-j} V_j Theta_{m,m-j}^T.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["innovation_algorithm"]


def innovation_algorithm(gamma: torch.Tensor, m_max: int,
                         ridge: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the recursion to order ``m_max``.

    ``ridge`` adds ridge * I to each V_k before its solve (0.0 is exact).
    Returns theta (m_max, m_max, d, d) with theta[m-1, j-1] = Theta_{m,j},
    and V (m_max+1, d, d).
    """
    if gamma.shape[0] < m_max + 1:
        raise ValueError(f"need gamma up to lag {m_max}, got {gamma.shape[0] - 1}")
    d = gamma.shape[1]
    G = lambda h: gamma[h].T
    reg = ridge * torch.eye(d, device=gamma.device, dtype=gamma.dtype)
    theta = [[None] * (m + 1) for m in range(m_max + 1)]
    V = [G(0)]
    for m in range(1, m_max + 1):
        for k in range(m):
            acc = G(m - k)
            for j in range(k):
                acc = acc - theta[m][m - j] @ V[j] @ theta[k][k - j].T
            theta[m][m - k] = torch.linalg.solve((V[k] + reg).T, acc.T).T
        Vm = G(0)
        for j in range(m):
            Vm = Vm - theta[m][m - j] @ V[j] @ theta[m][m - j].T
        V.append(Vm)
    out = gamma.new_zeros((m_max, m_max, d, d))
    for m in range(1, m_max + 1):
        for j in range(1, m + 1):
            out[m - 1, j - 1] = theta[m][j]
    return out, torch.stack(V)
