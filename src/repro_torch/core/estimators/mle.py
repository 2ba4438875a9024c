"""Z-estimators: conditional-MLE AR fitting by first-order methods (port of
`repro.core.estimators.mle`; paper §5).

The conditional Gaussian log-likelihood of an AR(p) sample is a sum over t
of terms that each read only the window (X_{t-p}, ..., X_t): an order-p
weak-memory estimator (paper §7.2).  Its gradient runs through the same
overlapping-block map-reduce as the M-estimators (autograd through the
vmapped per-window kernel), so full-batch gradient descent and SGD are
embarrassingly parallel across blocks.

Paper §6.3 step sizes: with Pi = I the Hessian blocks are Cov(X), and the
step 2 / (m + L) with m, L the extreme eigenvalues of Cov(X) converges at
an exponential rate; with a precision Pi the Hessian is Pi (x) Cov(X),
whose eigen-extremes are products of the factors'.

The reference jits each step with the series closed over.  Here a fit
builds the overlapping blocks and their valid mask once and reduces the
same blocks at every step (`make_overlapping_blocks` builds its index
arrays on the host).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..mapreduce import _block_reducer, _core_valid_mask, serial_window_map_reduce, tree_map
from ..overlap import OverlapSpec, make_overlapping_blocks

__all__ = ["ar_residual", "ar_conditional_nll", "ar_nll_and_grad_blocked", "optimal_step_size",
           "FitResult", "fit_ar_mle", "fit_ar_sgd"]


def ar_residual(A: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """e_t = X_t - sum_i A_i X_{t-i} for one window (p+1, d) -> (d,):
    window[-1] is X_t, window[-1-i] is X_{t-i}."""
    p = A.shape[0]
    lags = window[-1 - p:-1].flip(0)  # X_{t-1}, ..., X_{t-p}
    return window[-1] - torch.einsum("pij,pj->i", A, lags)


def _nll_kernel(A: torch.Tensor, precision: torch.Tensor, window: torch.Tensor):
    """Per-window contribution (1/2 r^T Pi r, 1); the constant -1/2 log det Pi
    per sample is added by the caller."""
    r = ar_residual(A, window)
    return 0.5 * (r @ precision @ r), torch.ones((), dtype=window.dtype, device=window.device)


def _mean_nll(quad: torch.Tensor, count: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    return quad / count - 0.5 * torch.linalg.slogdet(precision)[1]


def ar_conditional_nll(A: torch.Tensor, precision: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean conditional negative log-likelihood, up to an additive constant:
    1/2 mean(r^T Pi r) - 1/2 log det Pi, over every complete window."""
    quad, count = serial_window_map_reduce(functools.partial(_nll_kernel, A, precision), x,
                                           h_left=A.shape[0], h_right=0)
    return _mean_nll(quad, count, precision)


class _Blocks:
    """The overlapping blocks (h_left = p, h_right = 0) of one series and
    their core valid mask, built once and reduced at every step."""

    def __init__(self, x: torch.Tensor, p: int, block_size: int):
        self.spec = OverlapSpec(n=x.shape[0], block_size=block_size, h_left=p, h_right=0)
        self.blocks, _ = make_overlapping_blocks(x, self.spec)
        self.mask = _core_valid_mask(
            torch.arange(self.spec.num_blocks, device=x.device), self.spec)

    def nll(self, A: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
        reduce = _block_reducer(functools.partial(_nll_kernel, A, precision), None, self.spec)
        quad, count = tree_map(lambda leaf: leaf.sum(0), reduce(self.blocks, self.mask))
        return _mean_nll(quad, count, precision)

    def value_and_grad(self, A: torch.Tensor,
                       precision: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            A = A.detach().requires_grad_(True)
            value = self.nll(A, precision)
            (grad,) = torch.autograd.grad(value, A)
        return value.detach(), grad


def ar_nll_and_grad_blocked(A: torch.Tensor, precision: torch.Tensor, x: torch.Tensor,
                            block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, d nll / d A) through the overlapping-block path: autograd
    differentiates through the block map-reduce, each block contributes its
    local gradient and the sum over blocks is the only reduction (§7.2)."""
    if x.ndim == 1:
        x = x[:, None]
    return _Blocks(x, A.shape[0], block_size).value_and_grad(A, precision)


def optimal_step_size(x: torch.Tensor, precision: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper §6.3: 2 / (m + L) from the extreme eigenvalues of the Hessian,
    Cov(X) (ddof 1) with Pi = I, else the products of Pi's and Cov(X)'s."""
    if x.ndim == 1:
        x = x[:, None]
    d = x.shape[1]
    ev = torch.linalg.eigvalsh(torch.cov(x.T).reshape(d, d))  # ascending
    m_c, L_c = ev[0], ev[-1]
    if precision is None:
        return 2.0 / (m_c + L_c)
    pv = torch.linalg.eigvalsh(precision)
    return 2.0 / (pv[0] * m_c + pv[-1] * L_c)


def _series(x, device) -> torch.Tensor:
    """A fit's series as an (n, d) tensor: a tensor stays where it lies
    unless ``device`` is given; anything else goes to ``device``, the card
    by default."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if x.ndim == 2 else x[:, None]
    x = torch.as_tensor(x, device=resolve_device(device or "cuda"))
    return x if x.ndim == 2 else x[:, None]


class FitResult(NamedTuple):
    A: torch.Tensor
    precision: torch.Tensor
    nll_trace: torch.Tensor


def fit_ar_mle(x: torch.Tensor, p: int, *, n_steps: int = 200, block_size: int = 1024,
               step_size: Optional[float] = None, update_precision_every: int = 0,
               seed_A: Optional[torch.Tensor] = None, device=None) -> FitResult:
    """Full-batch gradient-descent conditional MLE (paper §5.1.1, §6.3).

    Gradient steps on A with Pi fixed, and, every ``update_precision_every``
    steps, the closed-form Pi update (the inverse residual covariance): the
    paper's argument-wise alternate maximisation.  Runs where the tensor
    ``x`` lies, or on ``device`` (the card by default) for other input.
    """
    x = _series(x, device)
    d = x.shape[1]
    A = seed_A if seed_A is not None else x.new_zeros((p, d, d))
    precision = torch.eye(d, dtype=x.dtype, device=x.device)
    lr = optimal_step_size(x) if step_size is None else step_size
    blocks = _Blocks(x, p, min(block_size, x.shape[0]))
    trace = []
    for i in range(n_steps):
        nll, g = blocks.value_and_grad(A, precision)
        A = A - lr * g
        trace.append(nll)
        if update_precision_every and (i + 1) % update_precision_every == 0:
            precision = _residual_precision(A, x)
    return FitResult(A, precision, torch.stack(trace))


def _residual_precision(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Closed-form Pi update: inverse of the empirical residual covariance."""
    def kern(window):
        r = ar_residual(A, window)
        return torch.outer(r, r), torch.ones((), dtype=window.dtype, device=window.device)

    s, n = serial_window_map_reduce(kern, x, h_left=A.shape[0], h_right=0)
    cov = s / n
    return torch.linalg.inv(cov + 1e-8 * torch.eye(cov.shape[0], dtype=cov.dtype,
                                                   device=cov.device))


def _minibatch_nll(A: torch.Tensor, precision: torch.Tensor, x: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
    """Mean of 1/2 r^T Pi r over the windows x[s : s + p + 1], s in ``starts``."""
    wins = x[starts[:, None] + torch.arange(A.shape[0] + 1, device=x.device)]
    quads = torch.func.vmap(lambda w: _nll_kernel(A, precision, w)[0])(wins)
    return quads.mean()


def fit_ar_sgd(x: torch.Tensor, p: int, *, n_steps: int = 2000, batch: int = 64,
               lr0: Optional[float] = None, decay: float = 0.05,
               generator: Optional[torch.Generator] = None, device=None) -> FitResult:
    """Stochastic first-order conditional MLE (paper §5.1.3).

    Each step draws ``batch`` window starts uniformly from [0, n - p), with
    replacement, from ``generator`` (on ``x``'s device; None: PyTorch's
    default), takes the minibatch gradient (each term reads only
    X_{t-p..t}) and a step lr0 / (1 + decay i), i in float32.  The trace
    keeps the minibatch NLL every max(1, n_steps // 100) steps.  Runs where
    ``x`` lies, as :func:`fit_ar_mle`.
    """
    x = _series(x, device)
    n, d = x.shape
    A = x.new_zeros((p, d, d))
    precision = torch.eye(d, dtype=x.dtype, device=x.device)
    lr0 = float(optimal_step_size(x)) if lr0 is None else lr0
    every = max(1, n_steps // 100)
    trace = []
    for i in range(n_steps):
        starts = torch.randint(0, n - p, (batch,), generator=generator, device=x.device)
        with torch.enable_grad():
            A_ = A.detach().requires_grad_(True)
            nll = _minibatch_nll(A_, precision, x, starts)
            (g,) = torch.autograd.grad(nll, A_)
        lr = np.float32(lr0) / (np.float32(1.0) + np.float32(decay) * np.float32(i))
        A = A - float(lr) * g
        if i % every == 0:
            trace.append(nll.detach())
    return FitResult(A, precision, torch.stack(trace))
