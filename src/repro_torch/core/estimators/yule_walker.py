"""Yule-Walker AR estimation and Levinson-type recursions (port of
`repro.core.estimators.yule_walker`).

gamma(h) = E[X_t X_{t+h}^T] for h >= 0, gamma(-h) = gamma(h)^T.  With rows
j = 1..p and S = [A_1^T; ...; A_p^T] stacked (p*d, d):
[gamma(j-i)] S = [gamma(j)], and Sigma = gamma(0) - sum_i A_i gamma(i).

Solvers: :func:`yule_walker` (dense), :func:`levinson_durbin` (univariate,
O(p^2)) and :func:`block_levinson` (Whittle's multivariate recursion,
O(p^2 d^3), with the PACF for free); :func:`streaming_yule_walker` solves
from a lag-sum engine's state.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["yule_walker", "levinson_durbin", "block_levinson", "streaming_yule_walker",
           "_block_toeplitz", "_stack_rhs"]


def _gamma_at(gamma: torch.Tensor, h: int) -> torch.Tensor:
    return gamma[..., h, :, :] if h >= 0 else gamma[..., -h, :, :].transpose(-1, -2)


def _block_toeplitz(gamma: torch.Tensor, p: int) -> torch.Tensor:
    """(..., p*d, p*d) block-Toeplitz with block (r, c) = gamma(r - c)."""
    return torch.cat([torch.cat([_gamma_at(gamma, r - c) for c in range(p)], -1)
                      for r in range(p)], -2)


def _stack_rhs(gamma: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat([gamma[..., j, :, :] for j in range(1, p + 1)], -2)


def yule_walker(gamma: torch.Tensor, p: int, backend=None,
                normalization: str = "standard") -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense YW solve from gamma(0..p), or from a raw series (ndim < 3).
    A leading batch of gammas (B, p+1, d, d) solves every one at once.

    Returns A (p, d, d) and sigma (d, d) (with the leading batch axes).
    """
    if gamma.ndim < 3:
        from .stats import autocovariance

        gamma = autocovariance(gamma, p, normalization=normalization, backend=backend)
    if gamma.shape[-3] < p + 1:
        raise ValueError(f"need gamma up to lag {p}, got {gamma.shape[-3] - 1}")
    d = gamma.shape[-1]
    # solve_ex: no error check, so no device-to-host sync; a singular system
    # (a series with constant or no samples) gives that series non-finite
    # results, as the reference's jnp.linalg.solve does, instead of raising
    # for the whole batch
    sol = torch.linalg.solve_ex(_block_toeplitz(gamma, p), _stack_rhs(gamma, p))[0]
    A = torch.stack([sol[..., i * d: (i + 1) * d, :].transpose(-1, -2) for i in range(p)], -3)
    sigma = gamma[..., 0, :, :] - sum(A[..., i, :, :] @ gamma[..., i + 1, :, :]
                                      for i in range(p))
    return A, sigma


def streaming_yule_walker(engine, state, p: int,
                          normalization: str = "standard") -> Tuple[torch.Tensor, torch.Tensor]:
    """YW solve from a lag-sum state (`stats.lag_sum_engine`, ``h_right >=
    p``): (A (p, d, d), sigma (d, d)), as :func:`yule_walker`."""
    if engine.h_right < p:
        raise ValueError(f"state tracks lags 0..{engine.h_right}, need {p} for order-{p} YW")
    from .stats import streaming_autocovariance

    gamma = streaming_autocovariance(engine, state, normalization)
    return yule_walker(gamma[..., : p + 1, :, :], p)


def levinson_durbin(gamma: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """Univariate Durbin-Levinson from gamma(0..p) (any shape with >= p+1
    entries): (phi (p,), innovation variance (), pacf (p,))."""
    gamma = gamma.reshape(-1)
    phi = gamma.new_zeros(p)
    pacf = gamma.new_zeros(p)
    v = gamma[0]
    for m in range(1, p + 1):
        if m == 1:
            k = gamma[1] / gamma[0]
        else:
            k = (gamma[m] - torch.dot(phi[: m - 1], gamma[1:m].flip(0))) / v
        new_phi = phi.clone()
        new_phi[m - 1] = k
        if m > 1:
            new_phi[: m - 1] = phi[: m - 1] - k * phi[: m - 1].flip(0)
        phi = new_phi
        pacf[m - 1] = k
        v = v * (1.0 - k**2)
    return phi, v, pacf


def block_levinson(gamma: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                         torch.Tensor]:
    """Whittle's multivariate Levinson recursion from gamma(0..p) (p+1, d, d):
    (A (p, d, d) forward coefficients, sigma (d, d), pacf (p, d, d) with
    kappa(m) = Phi_{m,m})."""
    G = lambda h: gamma[h].T if h >= 0 else gamma[-h]  # Gamma(h) = gamma(h)^T
    right_div = lambda a, b: torch.linalg.solve(b.T, a.T).T  # a @ b^{-1}
    fwd, bwd, pacf = [], [], []
    V = W = G(0)  # forward / backward prediction error covariances
    for m in range(1, p + 1):
        acc = G(m)
        for j in range(1, m):
            acc = acc - fwd[j - 1] @ G(m - j)
        phi_mm = right_div(acc, W)
        accb = G(m).T
        for j in range(1, m):
            accb = accb - bwd[j - 1] @ G(m - j).T
        psi_mm = right_div(accb, V)
        fwd, bwd = ([fwd[j - 1] - phi_mm @ bwd[m - j - 1] for j in range(1, m)] + [phi_mm],
                    [bwd[j - 1] - psi_mm @ fwd[m - j - 1] for j in range(1, m)] + [psi_mm])
        V, W = V - phi_mm @ W @ phi_mm.T, W - psi_mm @ V @ psi_mm.T
        pacf.append(phi_mm)
    A = torch.stack(fwd)
    sigma = gamma[0] - sum(A[i] @ gamma[i + 1] for i in range(p))
    return A, sigma, torch.stack(pacf)
