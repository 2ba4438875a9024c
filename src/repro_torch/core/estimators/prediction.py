"""Linear prediction with AR and ARMA models (port of
`repro.core.estimators.prediction`).

AR one-step prediction is an order-p windowed kernel; multi-step forecasts
feed predictions back in.  ARMA prediction runs the innovation recursion,
each step needing only max(p, q) past observations and innovations.  The
reference's ``lax.scan`` recursions are Python loops here, one step of
small tensor operations each.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ar_one_step", "ar_forecast", "arma_innovations_filter", "arma_forecast"]


def _newest_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` rows of ``x``, newest first ((0, d) for k = 0)."""
    return x[x.shape[0] - k:].flip(0) if k > 0 else x[:0]


def ar_one_step(A: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """X_{t+1} predicted from the last p rows of ``history`` (>= p, d),
    newest last."""
    return torch.einsum("pij,pj->i", A, _newest_first(history, A.shape[0]))


def ar_forecast(A: torch.Tensor, history: torch.Tensor, steps: int) -> torch.Tensor:
    """Iterated multi-step AR forecast: (steps, d).  With p = 0 (a pure
    noise model) the forecast is the mean, zero, from no lags: the buffer is
    empty, not the whole history (``history[-0:]`` would be all of it)."""
    p, d = A.shape[0], A.shape[1]
    buf = history[history.shape[0] - p:] if p > 0 else history.new_zeros((0, d))
    preds = []
    for _ in range(steps):
        nxt = torch.einsum("pij,pj->i", A, buf.flip(0))
        if p > 0:
            buf = torch.cat([buf[1:], nxt[None]])
        preds.append(nxt)
    return torch.stack(preds) if preds else history.new_zeros((0, d))


def arma_innovations_filter(A: torch.Tensor, B: torch.Tensor,
                            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step predictions and innovation estimates of ``x`` (T, d) under
    the steady-state recursion X_{t+1} = sum_i A_i X_{t+1-i} + sum_j B_j
    e_{t+1-j}, e_s = X_s - X_s^, from zero initial lags.

    Leading batch axes ride along: A (..., p, d, d), B (..., q, d, d), x
    (..., T, d) filter every series at once, one step of batched
    operations a row whatever the batch.

    Returns (preds (..., T, d), innovations (..., T, d))."""
    p, d, q = A.shape[-3], A.shape[-2], B.shape[-3]
    lead = torch.broadcast_shapes(A.shape[:-3], B.shape[:-3], x.shape[:-2])
    xlag = x.new_zeros(lead + (p, d))  # newest first
    elag = x.new_zeros(lead + (q, d))
    preds, innovs = [], []
    for t in range(x.shape[-2]):
        x_t = x[..., t, :]
        pred = torch.einsum("...pij,...pj->...i", A, xlag)
        if q > 0:
            pred = pred + torch.einsum("...qij,...qj->...i", B, elag)
        innov = x_t - pred
        if p > 0:
            xlag = torch.cat([x_t[..., None, :], xlag[..., :-1, :]], -2)
        if q > 0:
            elag = torch.cat([innov[..., None, :], elag[..., :-1, :]], -2)
        preds.append(pred)
        innovs.append(innov)
    if not preds:
        return x.new_zeros(lead + (0, d)), x.new_zeros(lead + (0, d))
    return torch.stack(preds, -2), torch.stack(innovs, -2)


def arma_forecast(A: torch.Tensor, B: torch.Tensor, history: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """Multi-step ARMA forecast: filter the history, then iterate with the
    future innovations at their mean (zero).  (steps, d)."""
    p, d, q = A.shape[0], A.shape[1], B.shape[0]
    _, innovs = arma_innovations_filter(A, B, history)
    xlag, elag = _newest_first(history, p), _newest_first(innovs, q)
    preds = []
    for _ in range(steps):
        pred = torch.einsum("pij,pj->i", A, xlag)
        if q > 0:
            pred = pred + torch.einsum("qij,qj->i", B, elag)
        if p > 0:
            xlag = torch.cat([pred[None], xlag[:-1]])
        if q > 0:
            elag = torch.cat([elag.new_zeros((1, d)), elag[:-1]])
        preds.append(pred)
    return torch.stack(preds) if preds else history.new_zeros((0, d))
