"""Differencing and integration (port of `repro.core.differencing`; paper
§1.4, §10.3: long-memory reduction).

An integrated process becomes weak-memory after Delta^I, and the
overlapping structure then applies.  Delta itself is an order-1 weak-memory
kernel, so a block with h_left >= 1 differences its own rows with no
communication (:func:`difference_blocked`).
"""
from __future__ import annotations

import torch

__all__ = ["difference", "integrate", "difference_blocked"]


def difference(x: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Delta^order x along the first axis, paper convention Delta(x)_t =
    x_{t+1} - x_t: length N - order."""
    for _ in range(order):
        x = x[1:] - x[:-1]
    return x


def integrate(dx: torch.Tensor, initial: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Inverse of :func:`difference`: x from Delta^order x (N - order, ...)
    and ``initial`` (order, ...), where initial[k] is the first element of
    Delta^k x.  Each level is a float32 cumulative sum, so the rounding
    grows with the order and the length."""
    for k in reversed(range(order)):
        x0 = initial[k]
        dx = torch.cat([x0[None], x0[None] + torch.cumsum(dx, dim=0)], dim=0)
    return dx


def difference_blocked(blocks: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Per-block differencing of overlapping blocks (P, width, d): a block
    padded with h_left >= order differences its own data; the result is a
    valid block structure with h_left reduced by ``order``."""
    for _ in range(order):
        blocks = blocks[:, 1:, :] - blocks[:, :-1, :]
    return blocks


def fractional_diff_weights(d: float, truncation: int, device="cpu") -> torch.Tensor:
    """Truncated binomial weights of (1 - L)^d (paper §10.3): w_0 = 1, w_k =
    w_{k-1} (k - 1 - d) / k, built in Python floats, then float32."""
    ws = [1.0]
    for k in range(1, truncation + 1):
        ws.append(ws[-1] * (k - 1 - d) / k)
    return torch.tensor(ws, dtype=torch.float32, device=device)


def fractional_difference(x: torch.Tensor, d: float, truncation: int = 64) -> torch.Tensor:
    """(1 - L)^d x with a ``truncation``-lag kernel: y_t = sum_j w_j x_{t-j}
    for every t with a full support, (N - truncation, dims).

    The windows are the series' ``unfold`` times the reversed weights,
    computed as one depthwise ``conv1d`` (a cross-correlation with the
    reversed weights), so the overlapping windows are never copied: a
    matmul of the unfold view would materialise (N - K) dims (K + 1)
    elements, 16.6 GB at N = 10^6, 64 dims, K = 64.

    A series that is not floating point is computed and returned in
    float32, as the reference promotes it; a series of at most
    ``truncation`` rows has no full support and gives (0, dims).
    """
    if x.ndim == 1:
        x = x[:, None]
    if not x.is_floating_point():
        x = x.float()
    dims = x.shape[1]
    if x.shape[0] <= truncation:
        return x.new_empty((0, dims))
    w = fractional_diff_weights(d, truncation, device=x.device).to(x.dtype).flip(0)
    y = torch.nn.functional.conv1d(x.T[None], w.expand(dims, 1, truncation + 1), groups=dims)
    return y[0].T
