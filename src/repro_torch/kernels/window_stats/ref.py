"""Plain PyTorch versions of the window-statistics kernels.

Port of `repro.kernels.window_stats.ref` and of the `JnpBackend` formulas
for the same primitives: one einsum per lag for the lagged sums, one
cumulative sum shared by every moment window.  The kernel wrappers in
``ops.py`` use these for CPU tensors; the ``"torch"`` backend uses them on
any device.
"""
from __future__ import annotations

import torch

__all__ = ["normalize_windows", "as_2d", "extend_rows", "cross_lagged_sums_ref",
           "lagged_sums_ref", "masked_lagged_sums_ref", "fused_lag_moments_ref"]


def normalize_windows(window: "int | tuple") -> tuple:
    """(windows tuple, was_single) for the fused primitive's ``window``
    argument.  Tuples must hold distinct positive ints."""
    if isinstance(window, int):
        windows: tuple = (window,)
        single = True
    else:
        windows = tuple(window)
        single = False
    if not windows:
        raise ValueError("need at least one moment window")
    if any((not isinstance(w, int)) or w < 1 for w in windows):
        raise ValueError(f"moment windows must be positive ints, got {windows}")
    if len(set(windows)) != len(windows):
        raise ValueError(f"moment windows must be distinct, got {windows}")
    return windows, single


def as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def extend_rows(y: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-extend (n, d) to at least ``rows`` rows."""
    if y.shape[0] >= rows:
        return y
    return torch.nn.functional.pad(y, (0, 0, 0, rows - y.shape[0]))


def cross_lagged_sums_ref(a: torch.Tensor, b: torch.Tensor, max_lag: int) -> torch.Tensor:
    """S(h) = sum_{t<n} a_t b_{t+h}^T for h = 0..max_lag; ``b`` holds at
    least n + max_lag rows.  Returns (max_lag+1, d, d) float32."""
    n = a.shape[0]
    return torch.stack(
        [torch.einsum("ti,tj->ij", a, b[h: h + n]) for h in range(max_lag + 1)]
    )


def lagged_sums_ref(x: torch.Tensor, max_lag: int) -> torch.Tensor:
    """S(h) = sum_{k=0}^{n-1-h} x_k x_{k+h}^T (ragged full sums)."""
    x = as_2d(x).float()
    return cross_lagged_sums_ref(x, extend_rows(x, x.shape[0] + max_lag), max_lag)


def masked_lagged_sums_ref(y_padded: torch.Tensor, start_mask: torch.Tensor,
                           max_lag: int) -> torch.Tensor:
    """sum_{s: start_mask[s]} y_s y_{s+h}^T, zero-extending ``y_padded``."""
    L = start_mask.shape[0]
    y = extend_rows(as_2d(y_padded).float(), L + max_lag)
    head = torch.where(start_mask[:, None], y[:L], 0.0)
    return cross_lagged_sums_ref(head, y, max_lag)


def fused_lag_moments_ref(y_padded: torch.Tensor, start_mask: torch.Tensor,
                          max_lag: int, window: "int | tuple") -> tuple:
    """(lag (max_lag+1, d, d), mom) with mom = sum_{s: mask} sum_{j<w}
    [y_{s+j}, y_{s+j}^2]: (2, d) for an int window, (K, 2, d) for a tuple.
    One cumulative sum is shared by every window (`JnpBackend` formula)."""
    windows, single = normalize_windows(window)
    L = start_mask.shape[0]
    w_max = max(windows)
    y = extend_rows(as_2d(y_padded).float(), L + max(max_lag, w_max - 1))
    lag = masked_lagged_sums_ref(y, start_mask, max_lag)
    zero = y.new_zeros((1, y.shape[1]))
    rows = y[: L + w_max - 1]
    cs = torch.cat([zero, torch.cumsum(rows, 0)])
    cs2 = torch.cat([zero, torch.cumsum(rows * rows, 0)])
    m = start_mask.float()[:, None]
    moms = []
    for w in windows:
        s1 = cs[w: L + w] - cs[:L]
        s2 = cs2[w: L + w] - cs2[:L]
        moms.append(torch.stack([(m * s1).sum(0), (m * s2).sum(0)]))
    mom = torch.stack(moms)
    return lag, (mom[0] if single else mom)
