"""Wrappers of the window-statistics CUDA kernels (port of
`repro.kernels.window_stats.ops`).

Each public function pads its operands as the reference does, then runs the
hand-written kernel for CUDA tensors and the plain version (``ref.py``) for
CPU tensors.  A CUDA tensor never falls back to the plain version: the
kernel launches or the call raises.

Kernels (``csrc/window_stats.cu``):
  * ``cross_window_stats`` -- S(h) = sum_k a_k b_{k+h}^T; serves
    ``lagged_sums``, ``cross_lagged_sums`` and ``masked_lagged_sums``;
  * ``fused_lag_moments`` -- masked lag sums plus K-window moment sums.
"""
from __future__ import annotations

import torch

from .._launch import (Kernel, Prepared, add_lag, add_moments, check_window_count,
                       new_params, on_cuda, register, require, sm_count)
from .ref import (as_2d, cross_lagged_sums_ref, extend_rows, fused_lag_moments_ref,
                  normalize_windows)

__all__ = ["CROSS_WINDOW_STATS", "FUSED_LAG_MOMENTS", "cross_lagged_sums",
           "lagged_sums", "masked_lagged_sums", "fused_lagged_moments",
           "prepare_cross_lagged_sums", "prepare_fused_lag_moments"]

CROSS_WINDOW_STATS = register(Kernel("cross_window_stats", "rt_cross_lag_sums"))
FUSED_LAG_MOMENTS = register(Kernel("fused_lag_moments", "rt_fused_lag_moments"))


def prepare_cross_lagged_sums(a: torch.Tensor, b: torch.Tensor, max_lag: int) -> Prepared:
    """S(h) = sum_{t<n} a_t b_{t+h}^T with a (n, d) and b (n + max_lag, d),
    both contiguous float32 on one device; ``.launch()`` returns S."""
    n, d = a.shape
    require(a, "a", (n, d))
    require(b, "b", (n + max_lag, d))
    p = new_params(b, n)
    p.a = a.data_ptr()
    part, out = add_lag(p, max_lag, sm_count(b.device), b.device)
    return Prepared(CROSS_WINDOW_STATS, p, b.device, out, (a, b, part))


def prepare_fused_lag_moments(y: torch.Tensor, start_mask: torch.Tensor, max_lag: int,
                              windows: tuple) -> Prepared:
    """Masked lag sums and K-window moment sums.  ``y`` is (L + reach, d)
    contiguous float32, reach = max(max_lag, max(windows) - 1);
    ``start_mask`` is (L,) bool.  ``.launch()`` returns (lag, mom (K, 2, d))."""
    L = start_mask.shape[0]
    reach = max(max_lag, max(windows) - 1)
    require(y, "y", (L + reach, y.shape[1]))
    require(start_mask, "start_mask", (L,), torch.bool)
    check_window_count(windows)
    m = start_mask.float()
    prefix = torch.nn.functional.pad(torch.cumsum(start_mask, 0, dtype=torch.int32), (1, 0))
    p = new_params(y, L)
    p.m = m.data_ptr()
    sms = sm_count(y.device)
    lag_part, lag = add_lag(p, max_lag, sms, y.device)
    mom_part, mom = add_moments(p, windows, prefix, L + max(windows) - 1, sms, y.device)
    return Prepared(FUSED_LAG_MOMENTS, p, y.device, (lag, mom),
                    (y, m, prefix, lag_part, mom_part))


def cross_lagged_sums(a: torch.Tensor, b: torch.Tensor, max_lag: int) -> torch.Tensor:
    """S(h) = sum_k a_k b_{k+h}^T for h = 0..max_lag; ``a`` may be shorter
    than ``b`` (zero-extended on the right).  Accumulates in float32."""
    a, b = as_2d(a).float(), as_2d(b).float()
    n = b.shape[0]
    a = extend_rows(a, n).contiguous()
    b = extend_rows(b, n + max_lag).contiguous()
    if not on_cuda(a, b):
        return cross_lagged_sums_ref(a, b, max_lag)
    return prepare_cross_lagged_sums(a, b, max_lag).launch()


def lagged_sums(x: torch.Tensor, max_lag: int) -> torch.Tensor:
    """S(h) = sum_k x_k x_{k+h}^T for h = 0..max_lag."""
    return cross_lagged_sums(x, x, max_lag)


def masked_lagged_sums(y_padded: torch.Tensor, start_mask: torch.Tensor,
                       max_lag: int) -> torch.Tensor:
    """sum_{s: start_mask[s]} y_s y_{s+h}^T -- the streaming chunk-kernel
    form: a cross-lagged sum of the mask-zeroed head rows against the
    zero-extended series."""
    L = start_mask.shape[0]
    y = extend_rows(as_2d(y_padded).float(), L + max_lag)[: L + max_lag]
    head = torch.where(start_mask[:, None], y[:L], 0.0)
    if not on_cuda(y, start_mask):
        return cross_lagged_sums_ref(head, y, max_lag)
    return prepare_cross_lagged_sums(head.contiguous(), y.contiguous(), max_lag).launch()


def fused_lagged_moments(y_padded: torch.Tensor, start_mask: torch.Tensor,
                         max_lag: int, window: "int | tuple") -> tuple:
    """Masked lagged sums AND masked windowed-moment sums from one launch.

    Returns lag (max_lag+1, d, d) and mom: (2, d) for an int window,
    (K, 2, d) for a tuple of distinct windows.
    """
    windows, single = normalize_windows(window)
    L = start_mask.shape[0]
    reach = max(max_lag, max(windows) - 1)
    y = extend_rows(as_2d(y_padded).float(), L + reach)[: L + reach]
    if not on_cuda(y, start_mask):
        return fused_lag_moments_ref(y, start_mask, max_lag, window)
    lag, mom = prepare_fused_lag_moments(y.contiguous(), start_mask.contiguous(),
                                         max_lag, windows).launch()
    return lag, (mom[0] if single else mom)
