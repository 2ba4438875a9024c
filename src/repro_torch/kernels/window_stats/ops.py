"""Wrappers of the window-statistics CUDA kernels (port of
`repro.kernels.window_stats.ops`).

Each public function pads its operands as the reference does, then runs the
hand-written kernel for CUDA tensors and the plain version (``ref.py``) for
CPU tensors.  A CUDA tensor never falls back to the plain version: the
kernel launches or the call raises.

Kernels (``csrc/window_stats.cu``):
  * ``cross_window_stats`` -- S(h) = sum_k a_k b_{k+h}^T; serves
    ``lagged_sums``, ``cross_lagged_sums`` and ``masked_lagged_sums``;
  * ``fused_lag_moments`` -- masked lag sums plus K-window moment sums; at
    max_lag = 0 (every call of the port's paths) one launch of its
    symmetric path (``lag_moments_sym_kernel``, grid :func:`sym_shape`);
  * ``window_moments`` -- rolling [sum x, sum x^2] per window start; serves
    ``windowed_moments``.

``masked_lagged_sums`` and ``fused_lagged_moments`` also take a leading
tenant axis (y (B, rows, d), mask (B, L)): one launch serves every tenant of
a multi-tenant session's batched finalize.  :func:`lag_moments_path` routes
kernel 3: one problem at H = 0 to the symmetric path; two or more tenants at
H = 0 and d <= MID_TILE, each tenant's rows fitting one staging slot, to
the batched path (``lag_moments_batched_kernel``, grid
:func:`batched_shape`: whole tenants a CTA, a tile sized by d, one launch);
everything else (H > 0, d > MID_TILE) to the two-role kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import (LM_BATCH_BLK, LM_BATCH_SLOT, LM_MAX_CLUSTER, LM_MAX_SLAB, LM_PART_FLOATS,
                      MID_TILE, THREADS, TILE, LagMomBatchParams, LagMomParams,
                      MomentParams, check, library)
from .._launch import (Kernel, Prepared, add_lag, add_moments, check_window_count, lag_tile,
                       new_params, on_cuda, register, require, sm_count)
from .ref import (as_2d, cross_lagged_sums_ref, extend_rows, fused_lag_moments_ref,
                  normalize_windows, window_moments_ref)

__all__ = ["CROSS_WINDOW_STATS", "FUSED_LAG_MOMENTS", "WINDOW_MOMENTS", "cross_lagged_sums",
           "lagged_sums", "masked_lagged_sums", "fused_lagged_moments", "windowed_moments",
           "prepare_cross_lagged_sums", "prepare_fused_lag_moments",
           "prepare_window_moments", "moment_chain", "sym_shape", "resident_clusters",
           "lag_moments_path", "batched_shape"]

CROSS_WINDOW_STATS = register(Kernel("cross_window_stats", "rt_cross_lag_sums"))
FUSED_LAG_MOMENTS = register(Kernel("fused_lag_moments", "rt_fused_lag_moments",
                                    paths=("sym", "batched", "two_role")))
WINDOW_MOMENTS = register(Kernel("window_moments", "rt_window_moments"))


def prepare_cross_lagged_sums(a: torch.Tensor, b: torch.Tensor, max_lag: int,
                              sms: "int | None" = None) -> Prepared:
    """S(h) = sum_{t<n} a_t b_{t+h}^T with a (n, d) and b (n + max_lag, d),
    both contiguous float32 on one device -- or (B, n, d) and (B, n +
    max_lag, d), one problem per tenant in one launch; ``.launch()``
    returns S ((B, max_lag+1, d, d) batched).  ``sms``: as in
    ``fused_plan.ops.prepare_fused_plan``."""
    lead, (n, d) = tuple(a.shape[:-2]), a.shape[-2:]
    require(a, "a", (n, d), lead=lead)
    require(b, "b", (n + max_lag, d), lead=lead)
    p = new_params(b, n)
    p.a, p.a_stride = a.data_ptr(), (n * d if lead else 0)
    part, out = add_lag(p, max_lag, sms or sm_count(b.device), b.device)
    return Prepared(CROSS_WINDOW_STATS, p, b.device, out, (a, b, part))


# Launch shape of kernel 3's symmetric path (H = 0), chosen by timing its
# variants on the H100 (tools/kernel_variants/variants_bench.py lagmom):
# about LAGMOM_CTAS_PER_SM CTAs per SM over the tile pairs, but no more
# clusters than the device holds at once (one wave); slabs of at least
# LAGMOM_MIN_SLAB rows (short launches: the merge boundary, the tail); and
# clusters of up to LAGMOM_CLUSTER slabs.
LAGMOM_CTAS_PER_SM = 2
LAGMOM_MIN_SLAB = 32
LAGMOM_CLUSTER = LM_MAX_CLUSTER


def sym_shape(n: int, rows: int, d: int, windows: int, sms: int,
              resident: "int | None" = None) -> dict:
    """Grid of ``lag_moments_sym_kernel`` for ``n`` starts over ``rows`` moment
    rows of d channels: tile pairs I <= J of 64 channels, each split into
    ``cluster`` x ``groups`` slabs of ``slab`` rows (one CTA each; the last
    slabs may be empty).  ``resident``: the clusters of LAGMOM_CLUSTER CTAs
    the device holds at once (:func:`resident_clusters`), which caps the
    CTAs a pair asks for."""
    d_tiles = -(-d // TILE)
    pairs = d_tiles * (d_tiles + 1) // 2
    want = max(1, LAGMOM_CTAS_PER_SM * sms // pairs)
    if resident:
        want = min(want, max(1, resident // pairs) * LAGMOM_CLUSTER)
    slab = min(LM_MAX_SLAB, max(LAGMOM_MIN_SLAB, -(-rows // want)))
    slabs = -(-rows // slab)
    cluster = min(LAGMOM_CLUSTER, slabs)
    return {"n": n, "rows": rows, "d": d, "K": windows, "d_tiles": d_tiles, "pairs": pairs,
            "slab": slab, "cluster": cluster, "groups": -(-slabs // cluster)}


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, windows: int, pairs: int, cluster: int) -> int:
    p = LagMomParams()
    p.d_tiles, p.pairs, p.K = 1, pairs, windows
    p.slab, p.cluster, p.groups = LM_MAX_SLAB, cluster, 1
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        check(library().rt_lag_moments_occupancy(ctypes.byref(p), out), "lag_moments_occupancy")
    return out[1]


def resident_clusters(device: torch.device, windows: int, pairs: int) -> int:
    """Clusters of LAGMOM_CLUSTER CTAs of the symmetric path that ``device``
    holds at once (CUDA's occupancy calculator, at the most shared memory a
    launch of ``windows`` windows may take)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _resident_clusters(index, windows, pairs, LAGMOM_CLUSTER)


def _prepare_lag_moments_sym(y: torch.Tensor, start_mask: torch.Tensor, windows: tuple,
                             rows: int) -> Prepared:
    """The H = 0 launch: S(0) (1, d, d) and the moment sums (K, 2, d).  The
    arrival counters (one per tile pair and cluster rank) are zeros padded
    after the prefix count (no launch of their own); the kernel leaves them
    at zero."""
    L, d = start_mask.shape[0], y.shape[1]
    K = len(windows)
    pairs = (-(-d // TILE)) * (-(-d // TILE) + 1) // 2
    sms = sm_count(y.device)
    s = sym_shape(L, rows, d, K, sms, resident_clusters(y.device, K, pairs))
    buf = torch.nn.functional.pad(torch.cumsum(start_mask, 0, dtype=torch.int32),
                                  (1, s["pairs"] * s["cluster"]))
    p = LagMomParams()
    for k in ("n", "rows", "d", "K", "d_tiles", "pairs", "slab", "cluster", "groups"):
        setattr(p, k, s[k])
    for k, w in enumerate(windows):
        p.windows[k] = int(w)
    p.vec = int(d % 4 == 0 and y.data_ptr() % 16 == 0)
    lag = torch.empty((1, d, d), device=y.device)
    mom = torch.empty((len(windows), 2, d), device=y.device)
    part = torch.empty((s["pairs"] * s["groups"] * LM_PART_FLOATS if s["groups"] > 1 else 0,),
                       device=y.device)
    p.y, p.prefix, p.arrive = y.data_ptr(), buf.data_ptr(), buf[L + 1:].data_ptr()
    p.part, p.lag_out, p.mom_out = part.data_ptr(), lag.data_ptr(), mom.data_ptr()
    return Prepared(FUSED_LAG_MOMENTS, p, y.device, (lag, mom), (y, buf, part),
                    entry="rt_lag_moments_sym", path="sym")


# Launch shape of kernel 3's batched path (H = 0, d <= MID_TILE), chosen by
# timing its variants on the H100 (tools/kernel_variants/variants_bench.py
# session): LAGMOM_TENANTS consecutive tenants a CTA, at most LAGMOM_LANES
# row lanes of S(0)'s blocks.
LAGMOM_TENANTS = 4
LAGMOM_LANES = 16


def lag_moments_path(max_lag: int, lead: tuple, d: int, rows: int) -> str:
    """The launch that serves kernel 3 for series of ``rows`` rows of ``d``
    channels with tenant axes ``lead``: "sym" for one problem at max_lag =
    0 (``lag_moments_sym_kernel``); "batched" for at least two tenants at
    max_lag = 0 and d <= MID_TILE whose rows fit one staging slot (rows x
    lag_tile(d) <= LM_BATCH_SLOT floats: ``lag_moments_batched_kernel``);
    else "two_role" (``fused_lag_moments_kernel`` and its reduction)."""
    if max_lag == 0 and lead in ((), (1,)):
        return "sym"
    if (max_lag == 0 and len(lead) == 1 and lead[0] >= 2 and d <= MID_TILE
            and rows * lag_tile(d) <= LM_BATCH_SLOT):
        return "batched"
    return "two_role"


def batched_shape(batch: int, d: int) -> dict:
    """Grid of ``lag_moments_batched_kernel`` for ``batch`` tenants of d <=
    MID_TILE channels: the tile lag_tile(d), S(0)'s upper blocks of
    LM_BATCH_BLK x LM_BATCH_BLK on it, one a thread in ``lanes`` row lanes,
    and ``tenants`` consecutive tenants a CTA."""
    tile = lag_tile(d)
    side = tile // LM_BATCH_BLK
    blocks = side * (side + 1) // 2
    return {"tile": tile, "blocks": blocks, "lanes": min(THREADS // blocks, LAGMOM_LANES),
            "tenants": LAGMOM_TENANTS, "ctas": -(-batch // LAGMOM_TENANTS)}


def _prepare_lag_moments_batched(y: torch.Tensor, start_mask: torch.Tensor,
                                 windows: tuple) -> Prepared:
    """The batched H = 0 launch: S(0) (B, 1, d, d) and the moment sums (B, K,
    2, d), the start mask read as bools (no prefix count of its own)."""
    (B, rows, d), L = y.shape, start_mask.shape[-1]
    s = batched_shape(B, d)
    p = LagMomBatchParams()
    p.batch, p.n, p.d, p.rows, p.K = B, L, d, rows, len(windows)
    for k, w in enumerate(windows):
        p.windows[k] = int(w)
    p.tenants, p.lanes = s["tenants"], s["lanes"]
    p.vec = int(d % 4 == 0 and y.data_ptr() % 16 == 0)
    lag = torch.empty((B, 1, d, d), device=y.device)
    mom = torch.empty((B, len(windows), 2, d), device=y.device)
    p.y, p.mask = y.data_ptr(), start_mask.data_ptr()
    p.lag_out, p.mom_out = lag.data_ptr(), mom.data_ptr()
    return Prepared(FUSED_LAG_MOMENTS, p, y.device, (lag, mom), (y, start_mask),
                    entry="rt_lag_moments_batched", path="batched")


def prepare_fused_lag_moments(y: torch.Tensor, start_mask: torch.Tensor, max_lag: int,
                              windows: tuple, sms: "int | None" = None) -> Prepared:
    """Masked lag sums and K-window moment sums.  ``y`` is (L + reach, d)
    contiguous float32, reach = max(max_lag, max(windows) - 1);
    ``start_mask`` is (L,) bool; or (B, L + reach, d) and (B, L), one
    problem per tenant.  ``.launch()`` returns (lag, mom (K, 2, d)), with a
    leading tenant axis when batched.  The launch is the one
    :func:`lag_moments_path` names: the symmetric path's or the batched
    path's (S(0) exactly symmetric, one launch), else the two roles' (lag
    groups and moment slabs) with its reduction.  ``sms``: as in
    ``fused_plan.ops.prepare_fused_plan`` (the two-role launch only)."""
    lead, L = tuple(y.shape[:-2]), start_mask.shape[-1]
    reach = max(max_lag, max(windows) - 1)
    require(y, "y", (L + reach, y.shape[-1]), lead=lead)
    require(start_mask, "start_mask", (L,), torch.bool, lead)
    check_window_count(windows)
    path = lag_moments_path(max_lag, lead, y.shape[-1], L + max(windows) - 1)
    if path == "batched":
        return _prepare_lag_moments_batched(y, start_mask, windows)
    if path == "sym":
        prep = _prepare_lag_moments_sym(y[0] if lead else y,
                                        start_mask[0] if lead else start_mask,
                                        windows, L + max(windows) - 1)
        if lead:
            prep.out = tuple(t[None] for t in prep.out)
        return prep
    m = start_mask.float()
    prefix = torch.nn.functional.pad(torch.cumsum(start_mask, -1, dtype=torch.int32), (1, 0))
    p = new_params(y, L)
    p.m, p.m_stride = m.data_ptr(), (L if lead else 0)
    sms = sms or sm_count(y.device)
    lag_part, lag = add_lag(p, max_lag, sms, y.device, tile=TILE)
    mom_part, mom = add_moments(p, windows, prefix, L + max(windows) - 1, sms, y.device)
    return Prepared(FUSED_LAG_MOMENTS, p, y.device, (lag, mom),
                    (y, m, prefix, lag_part, mom_part), path="two_role")


def moment_chain(n_out: int, d: int, window: int, sms: int) -> int:
    """Window starts per thread of the rolling-moments kernel: long enough
    that a chain's first window (``window`` reads) costs at most half its
    slide, short enough that about 512 threads per SM have a chain."""
    per_thread = -(-n_out * d // (512 * sms))
    return max(64, min(max(2 * window, 1024), per_thread))


def prepare_window_moments(x: torch.Tensor, window: int) -> Prepared:
    """Rolling moment sums of a contiguous float32 (n, d) series;
    ``.launch()`` returns (n - window + 1, 2, d)."""
    n, d = x.shape
    require(x, "x", (n, d))
    n_out = n - window + 1
    if window < 1 or n_out < 1:
        raise ValueError(f"series of length {n} has no full window of width {window}")
    out = torch.empty((n_out, 2, d), device=x.device)
    require(out, "out", (n_out, 2, d))
    p = MomentParams()
    p.x, p.out = x.data_ptr(), out.data_ptr()
    p.n, p.d, p.w, p.n_out = n, d, window, n_out
    p.chain = moment_chain(n_out, d, window, sm_count(x.device))
    chains = -(-n_out // p.chain)
    p.ctas = -(-chains * d // THREADS)
    return Prepared(WINDOW_MOMENTS, p, x.device, out, (x,))


def windowed_moments(x: torch.Tensor, window: int) -> torch.Tensor:
    """(n - window + 1, 2, d) of [sum x, sum x^2] over every full
    width-``window`` slice of ``x`` ((n,) or (n, d), any float dtype, float32
    out).  Raises ValueError when the series has no full window."""
    x = as_2d(x).float()
    n = x.shape[0]
    if window < 1 or n - window + 1 < 1:
        raise ValueError(f"series of length {n} has no full window of width {window}")
    if not on_cuda(x):
        return window_moments_ref(x, window)
    return prepare_window_moments(x.contiguous(), window).launch()


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
    zero-extended series.  A leading tenant axis (y (B, rows, d), mask (B,
    L)) is one launch for every tenant."""
    L = start_mask.shape[-1]
    y = extend_rows(as_2d(y_padded).float(), L + max_lag)[..., : L + max_lag, :]
    head = torch.where(start_mask[..., None], y[..., :L, :], 0.0)
    if not on_cuda(y, start_mask):
        return cross_lagged_sums_ref(head, y, max_lag)
    return prepare_cross_lagged_sums(head.contiguous(), y.contiguous(), max_lag).launch()


def fused_lagged_moments(y_padded: torch.Tensor, start_mask: torch.Tensor,
                         max_lag: int, window: "int | tuple") -> tuple:
    """Masked lagged sums AND masked windowed-moment sums from one launch.

    Returns lag (max_lag+1, d, d) and mom: (2, d) for an int window,
    (K, 2, d) for a tuple of distinct windows; each with a leading tenant
    axis for y (B, rows, d) and mask (B, L).
    """
    windows, single = normalize_windows(window)
    L = start_mask.shape[-1]
    reach = max(max_lag, max(windows) - 1)
    y = extend_rows(as_2d(y_padded).float(), L + reach)[..., : L + reach, :]
    if not on_cuda(y, start_mask):
        return fused_lag_moments_ref(y, start_mask, max_lag, window)
    lag, mom = prepare_fused_lag_moments(y.contiguous(), start_mask.contiguous(),
                                         max_lag, windows).launch()
    return lag, (mom[..., 0, :, :] if single else mom)
