"""Sufficient statistics of second-order stationary series (port of
`repro.core.estimators.stats`).

Every lagged contraction goes through the backend registry: the serial
path's ``lagged_sums``, the block path's ``masked_lagged_sums`` (the block
axis in ONE batched launch of kernel 2 on the card) and the streaming
engines' chunk kernels.  :func:`lag_sum_engine` and :func:`moment_engine`
build `StreamingEngine`s; :func:`streaming_autocovariance` and
:func:`streaming_window_moments` finalize their states (the ragged
end-of-series lag pairs recovered from the carried tail).  Finalizers take
states with leading batch axes as well.  :func:`autocovariance_sharded`
is the mesh path: each rank's blocks in one batched launch, one
`psum_tree` of the (max_lag+1, d, d) sums.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from ..backend import BackendSpec, get_backend
from ..overlap import OverlapSpec, make_overlapping_blocks
from ..streaming import PartialState, StreamingEngine, resolved_stat

Normalization = Literal["paper", "standard"]

__all__ = ["mean", "raw_lag_sums", "block_lag_sums", "autocovariance",
           "autocovariance_blocked", "autocovariance_sharded", "autocorrelation",
           "partial_autocorrelation", "gamma_normalizer", "windowed_moments", "lag_sum_engine",
           "moment_engine", "streaming_autocovariance", "streaming_window_moments",
           "streaming_mean"]


def mean(x: torch.Tensor) -> torch.Tensor:
    """mu = (1/N) sum X_k."""
    if x.ndim == 1:
        x = x[:, None]
    return x.mean(0)


def gamma_normalizer(n, max_lag: int, normalization: Normalization) -> torch.Tensor:
    """Per-lag normalizers for gamma(h), h = 0..max_lag.

    "paper":    1/(N-h-1), the divisor clamped to >= 1
    "standard": 1/N (biased, keeps the block-Toeplitz matrix PSD)

    ``n`` may be an int, a 0-d integer tensor (a state's length) or a (B,)
    one (a batch of states' lengths: the result is then (B, max_lag+1)).
    """
    n = torch.as_tensor(n)[..., None]
    h = torch.arange(max_lag + 1, device=n.device)
    if normalization == "paper":
        return 1.0 / torch.clamp(n - h - 1, min=1)
    return torch.ones(max_lag + 1, device=n.device) / n


def raw_lag_sums(x: torch.Tensor, max_lag: int, backend: BackendSpec = None) -> torch.Tensor:
    """S(h) = sum_{k=0}^{N-1-h} X_k X_{k+h}^T, h = 0..max_lag, through the
    backend's ``lagged_sums``."""
    return get_backend(backend, x.device).lagged_sums(x, max_lag)


def block_lag_sums(blocks: torch.Tensor, spec: OverlapSpec, max_lag: int,
                   backend: BackendSpec = None) -> torch.Tensor:
    """Per-block lag sums (P, max_lag+1, d, d) through ONE batched
    ``masked_lagged_sums`` call over every block (one launch of kernel 2 on
    the card).  Needs ``spec.h_left == 0`` and ``spec.h_right >= max_lag``:
    the halo slots past the series end are zeros, so their products vanish
    and every core start stays in the mask."""
    if spec.h_left != 0 or spec.h_right < max_lag:
        raise ValueError(f"autocovariance at max_lag={max_lag} needs h_left=0, "
                         f"h_right>={max_lag}; got ({spec.h_left},{spec.h_right})")
    nb = spec.block_size
    ones = torch.ones((blocks.shape[0], nb), dtype=torch.bool, device=blocks.device)
    return get_backend(backend, blocks.device).masked_lagged_sums(
        blocks[:, : nb + max_lag], ones, max_lag)


def autocovariance(x: torch.Tensor, max_lag: int, normalization: Normalization = "paper",
                   center: bool = False, backend: BackendSpec = None) -> torch.Tensor:
    """Serial gamma(h), h = 0..max_lag: (max_lag+1, d, d), through the
    backend's ``lagged_sums`` (the cross_window_stats kernel on "cuda")."""
    if x.ndim == 1:
        x = x[:, None]
    if center:
        x = x - mean(x)[None, :]
    s = get_backend(backend, x.device).lagged_sums(x, max_lag)
    norm = gamma_normalizer(x.shape[0], max_lag, normalization).to(s.device)
    return s * norm[:, None, None]


def autocovariance_blocked(x: torch.Tensor, max_lag: int, block_size: int,
                           normalization: Normalization = "paper", center: bool = False,
                           backend: BackendSpec = None) -> torch.Tensor:
    """gamma(0..max_lag) over overlapping blocks of ``block_size`` rows (the
    paper's Fig. 2/4): the per-block lag sums in one batched launch, summed
    over the blocks."""
    if x.ndim == 1:
        x = x[:, None]
    if center:
        x = x - mean(x)[None, :]
    spec = OverlapSpec(n=x.shape[0], block_size=block_size, h_left=0, h_right=max_lag)
    blocks, _ = make_overlapping_blocks(x.float(), spec)
    s = block_lag_sums(blocks, spec, max_lag, backend=backend).sum(0)
    return s * gamma_normalizer(x.shape[0], max_lag, normalization).to(s.device)[:, None, None]


def autocovariance_sharded(blocks, spec: OverlapSpec, max_lag: int, mesh, axis: str = "data",
                           normalization: Normalization = "paper",
                           backend: BackendSpec = None) -> torch.Tensor:
    """Cluster path: the blocks (a ``Shard(0)`` DTensor, ``h_left`` 0 and
    ``h_right >= max_lag``) sharded over ``axis``; each rank's lag sums in
    one batched launch of kernel 2 on its local blocks, then ONE `psum_tree`
    of the (max_lag+1, d, d) sums.  The data never moves between ranks:
    only the sufficient statistic is reduced, the paper's scaling claim."""
    from ...parallel.sharding import psum_tree

    s = psum_tree(block_lag_sums(blocks.to_local(), spec, max_lag, backend=backend).sum(0),
                  mesh, axis)
    return s * gamma_normalizer(spec.n, max_lag, normalization).to(s.device)[:, None, None]


def windowed_moments(x: torch.Tensor, window: int, backend: BackendSpec = None) -> dict:
    """Rolling mean and population variance over every full width-``window``
    slice: {"mean": (n_win, d), "var": (n_win, d)}, from the backend's
    ``windowed_moments`` sums (the rolling-moments kernel on "cuda").

    The sums run on the globally centred series: the variance is
    shift-invariant, and E[x^2] - E[x]^2 in float32 cancels catastrophically
    for a high-mean series, so the second moment is taken about the global
    mean and clamped at 0.
    """
    if x.ndim == 1:
        x = x[:, None]
    mu = mean(x.float())
    s = get_backend(backend, x.device).windowed_moments(x - mu[None, :], window)
    m_c = s[:, 0] / window
    var = torch.clamp(s[:, 1] / window - m_c * m_c, min=0.0)
    return {"mean": m_c + mu[None, :], "var": var}


def lag_sum_engine(max_lag: int, d: int, backend: BackendSpec = None,
                   device="cuda") -> StreamingEngine:
    """Streaming engine of the lag sums S(0..max_lag): ``state.stat`` is
    (max_lag+1, d, d) and an update carries the last ``max_lag`` samples.
    The chunk kernel is the backend's ``masked_lagged_sums`` (kernel 2 on
    the card).  Finalize with :func:`streaming_autocovariance`."""
    be = get_backend(backend, device)

    def ck(y_padded, start_mask):
        return be.masked_lagged_sums(y_padded, start_mask, max_lag)

    return StreamingEngine(d=d, h_left=0, h_right=max_lag, chunk_kernel=ck, backend=be,
                           stat_zeros=lambda dev: torch.zeros((max_lag + 1, d, d), device=dev),
                           device=device)


def moment_engine(window: int, d: int, backend: BackendSpec = None,
                  device="cuda") -> StreamingEngine:
    """Streaming engine of aggregate windowed moments: ``state.stat`` is
    {"sums": (2, d) of sum_s [sum_j x_{s+j}, sum_j x_{s+j}^2], "count": ()}
    over every full width-``window`` start s.  The chunk kernel is the
    backend's ``fused_lagged_moments`` at max_lag 0 (kernel 3 on the card),
    as a fused plan's moment member.  Finalize with
    :func:`streaming_window_moments`."""
    be = get_backend(backend, device)

    def ck(y_padded, start_mask):
        _, mom = be.fused_lagged_moments(y_padded, start_mask, 0, window)
        return {"sums": mom, "count": start_mask.float().sum(-1)}

    return StreamingEngine(
        d=d, h_left=0, h_right=window - 1, chunk_kernel=ck, backend=be,
        stat_zeros=lambda dev: {"count": torch.zeros((), device=dev),
                                "sums": torch.zeros((2, d), device=dev)},
        device=device)


def streaming_window_moments(engine: StreamingEngine, state: PartialState) -> dict:
    """A moment-engine state as {"mean": (d,), "var": (d,), "count": ()}:
    the population moments over every sample of every full window
    (overlapping windows weight interior samples up).  NaN while no window
    is complete."""
    stat = resolved_stat(state)
    total = (stat["count"] * engine.window)[..., None]
    m1 = stat["sums"][..., 0, :] / total
    m2 = stat["sums"][..., 1, :] / total
    return {"mean": m1, "var": torch.clamp(m2 - m1 * m1, min=0.0),
            "count": stat["count"].clone()}


def streaming_autocovariance(engine: StreamingEngine, state: PartialState,
                             normalization: Normalization = "paper") -> torch.Tensor:
    """A lag-sum state as gamma(0..max_lag) (max_lag+1, d, d), equal to
    :func:`autocovariance` of the concatenated stream.  The stream counts
    starts with a full forward window only; the serial estimator's ragged
    end-of-series pairs lie in ``state.tail`` and are recovered by one more
    masked lag contraction through the engine's backend."""
    H = engine.h_right
    s = resolved_stat(state)
    if H > 0:
        ones = torch.ones(state.tail.shape[:-1], dtype=torch.bool, device=state.tail.device)
        s = s + engine.backend.masked_lagged_sums(state.tail, ones, H)
    return s * gamma_normalizer(state.length, H, normalization)[..., None, None]


def streaming_mean(state: PartialState) -> torch.Tensor:
    """mu from any PartialState: the order-0 rolling statistic."""
    return state.sample_sum / state.length.to(state.sample_sum.dtype)[..., None]


def autocorrelation(gamma: torch.Tensor) -> torch.Tensor:
    """rho(h) = diag(gamma(0))^{-1/2} gamma(h) diag(gamma(0))^{-1/2}."""
    inv = 1.0 / torch.sqrt(torch.diagonal(gamma[0]))
    return gamma * inv[None, :, None] * inv[None, None, :]


def partial_autocorrelation(gamma: torch.Tensor,
                            max_order: Optional[int] = None) -> torch.Tensor:
    """kappa(p) for p = 1..max_order from gamma, one dense block-Toeplitz
    solve per order (`yule_walker.block_levinson` is the recursion).
    Returns (max_order, d, d): entry p-1 is U_p^{(p)}."""
    from .yule_walker import _block_toeplitz, _stack_rhs

    H = gamma.shape[0] - 1
    max_order = H if max_order is None else max_order
    if max_order > H:
        raise ValueError(f"need gamma up to lag {max_order}, got {H}")
    d = gamma.shape[1]
    out = []
    for p in range(1, max_order + 1):
        sol = torch.linalg.solve(_block_toeplitz(gamma, p), _stack_rhs(gamma, p))
        out.append(sol[(p - 1) * d: p * d, :].T)
    return torch.stack(out)
