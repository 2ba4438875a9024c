"""Synthetic VAR / VMA / VARMA series with stability control (port of
`repro.timeseries.generator`).

Causality: the companion matrix of A(z) must have spectral radius < 1, so
random coefficients are rescaled to a target companion radius (the same for
the MA part's invertibility).  Randomness comes from an explicit
``torch.Generator`` (None: PyTorch's default generator).

The reference runs the VAR recursion as a ``lax.scan``; one launch per
step would cost seconds per 10^5 rows here, so the recursion runs as a
log-step scan over the companion matrix C: with s_t = C s_{t-1} + e_t,
s_t = sum_k C^k e_{t-k}, and ceil(log2 T) doublings y_t += C^s y_{t-s}
(C^s squared each time) sum it, in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.backend import resolve_device

__all__ = ["companion_matrix", "spectral_radius", "random_stable_var", "random_invertible_ma",
           "simulate_var", "simulate_vma", "simulate_varma"]


def _host(A) -> np.ndarray:
    return A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)


def _companion_host(A: np.ndarray) -> np.ndarray:
    p, d = A.shape[0], A.shape[1]
    top = np.concatenate([A[i] for i in range(p)], axis=1)
    if p == 1:
        return top
    bottom = np.concatenate([np.eye((p - 1) * d), np.zeros(((p - 1) * d, d))], axis=1)
    return np.concatenate([top, bottom], axis=0)


def companion_matrix(A) -> torch.Tensor:
    """(p d, p d) companion of the coefficient stack A (p, d, d), on A's
    device (the CPU for numpy input)."""
    dev = A.device if isinstance(A, torch.Tensor) else "cpu"
    return torch.from_numpy(_companion_host(_host(A))).to(dev)


def spectral_radius(A) -> float:
    """Largest eigenvalue modulus of A's companion matrix (on the host)."""
    return float(np.max(np.abs(np.linalg.eigvals(_companion_host(_host(A))))))


def _rescale_to_radius(A: np.ndarray, radius: float) -> np.ndarray:
    """A_i <- s^i A_i, so the companion's eigenvalues become s * lambda and
    its spectral radius ``radius``."""
    rho = spectral_radius(A)
    if rho == 0:
        return A
    s = radius / rho
    return np.stack([A[i] * s ** (i + 1) for i in range(A.shape[0])])


def _random_scaled(generator, k: int, d: int, radius: float, device) -> torch.Tensor:
    dev = resolve_device(device)
    a = torch.randn((k, d, d), generator=generator, device=dev) / np.sqrt(d * k)
    return torch.from_numpy(_rescale_to_radius(_host(a), radius)).to(dev)


def random_stable_var(generator, p: int, d: int, radius: float = 0.7,
                      device="cuda") -> torch.Tensor:
    """Random causal AR coefficients (p, d, d) with companion radius
    ``radius``; ``generator`` is a torch.Generator on ``device``."""
    return _random_scaled(generator, p, d, radius, device)


def random_invertible_ma(generator, q: int, d: int, radius: float = 0.5,
                         device="cuda") -> torch.Tensor:
    """Random invertible MA coefficients (q, d, d) (companion radius
    ``radius``)."""
    return _random_scaled(generator, q, d, radius, device)


def _noise(generator, n: int, d: int, sigma, dev: torch.device) -> torch.Tensor:
    eps = torch.randn((n, d), generator=generator, device=dev)
    if sigma is not None:
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
        eps = eps @ torch.linalg.cholesky(sigma).T
    return eps


def _simulate_from_noise(A: torch.Tensor, B: torch.Tensor, eps: torch.Tensor,
                         burn_in: int = 0) -> torch.Tensor:
    """The VARMA recursion over given noise: with q = B.shape[0], the
    moving-average input u_t = e_{t+q} + sum_j B_j e_{t+q-j} for t <
    len(eps) - q, then x_t = sum_i A_i x_{t-i} + u_t from zero lags (a
    log-step scan over the companion matrix, float64), the first
    ``burn_in`` rows dropped.  A (p, d, d) or B (q, d, d) may be empty."""
    p, q, d = A.shape[0], B.shape[0], eps.shape[1]
    T = eps.shape[0] - q
    u = eps[q:].double()
    for j in range(1, q + 1):
        u = u + eps[q - j: q - j + T].double() @ B[j - 1].double().T
    if p > 0:
        y = torch.cat([u, u.new_zeros((T, (p - 1) * d))], 1)
        M = companion_matrix(A).to(device=u.device, dtype=torch.float64)
        shift = 1
        while shift < T:  # y_t += C^shift y_{t-shift}: doubles the horizon each step
            y = torch.cat([y[:shift], y[shift:] + y[:-shift] @ M.T])
            M = M @ M
            shift *= 2
        u = y[:, :d]
    return u[burn_in:].float()


def simulate_var(generator, A, n: int, sigma=None, burn_in: int = 256,
                 device="cuda") -> torch.Tensor:
    """A causal VAR(p) series (n, d) after ``burn_in`` discarded rows."""
    dev = resolve_device(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    eps = _noise(generator, n + burn_in, A.shape[1], sigma, dev)
    return _simulate_from_noise(A, A.new_zeros((0,) + A.shape[1:]), eps, burn_in)


def simulate_vma(generator, B, n: int, sigma=None, device="cuda") -> torch.Tensor:
    """A VMA(q) series X_t = e_t + sum_j B_j e_{t-j} (n, d), exact."""
    dev = resolve_device(device)
    B = torch.as_tensor(B, dtype=torch.float32, device=dev)
    eps = _noise(generator, n + B.shape[0], B.shape[1], sigma, dev)
    return _simulate_from_noise(B.new_zeros((0,) + B.shape[1:]), B, eps)


def simulate_varma(generator, A, B, n: int, sigma=None, burn_in: int = 256,
                   device="cuda") -> torch.Tensor:
    """A causal ARMA(p, q) series (n, d) after ``burn_in`` discarded rows."""
    dev = resolve_device(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    B = torch.as_tensor(B, dtype=torch.float32, device=dev)
    eps = _noise(generator, n + burn_in + B.shape[0], A.shape[1], sigma, dev)
    return _simulate_from_noise(A, B, eps, burn_in)
