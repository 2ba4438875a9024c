"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); skips
elsewhere.  This file imports no JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.core import plan as tplan
from repro_torch.core.estimators import spatial as tsp
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.banded_matvec import ops as bm, ref as bmr
from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
from repro_torch.kernels.window_stats import ops as ws, ref as wsr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def _close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= tol * b.abs().max()


def _per_bin(got, want, tol, per_segment=True):
    """Each entry of a power against the plain power at its (frequency,
    channel): averaged over segments for (S, F, d), itself for a power
    summed over segments (F, d) -- chip_smoke.py's TOL_NEW["psd"] check."""
    g, w = (got, want) if per_segment else (got[None], want[None])
    diff = (g.double() - w.double()).abs()
    scale = w.double().mean(0, keepdim=True).expand_as(diff)
    assert bool(((diff == 0) | (diff <= tol * scale)).all()), (
        (diff / scale).nan_to_num(posinf=float("inf")).max().item())


def _series(dev, n=600, d=70):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return torch.randn((n, d), generator=g, device=dev)


def test_lag_and_moment_kernels_match_plain(dev):
    y = _series(dev)
    mask = torch.ones(500, dtype=torch.bool, device=dev)
    mask[100::7] = False
    _close(ws.masked_lagged_sums(y, mask, 9), wsr.masked_lagged_sums_ref(y, mask, 9), 1e-4)
    _close(ws.lagged_sums(y, 3), wsr.lagged_sums_ref(y, 3), 1e-4)
    _close(ws.fused_lagged_moments(y, mask, 3, (5, 64)),
           wsr.fused_lag_moments_ref(y, mask, 3, (5, 64)), 1e-4)


def test_segment_power_kernel_matches_plain(dev):
    taper = torch.hann_window(64, periodic=False, device=dev)
    segs = _series(dev)[:512].reshape(8, 64, 70)
    for detrend in (True, False):
        got, want = (sd.segment_fft_power(segs, taper, detrend),
                     sdr.segment_dft_power_ref(segs, taper, detrend))
        _close(got, want, 1e-3)
        _per_bin(got, want, 1e-3)


def test_megakernel_matches_plain_and_repeats_bitwise(dev):
    y = _series(dev)
    mask = torch.ones(500, dtype=torch.bool, device=dev)
    mask[100::7] = False
    taper = torch.hann_window(64, periodic=False, device=dev)
    args = (y, mask, 5, 9, (5, 64), (64, 32), (16, 8), (taper, taper[:32]))
    got, want = fp.fused_plan_update(*args), fpr.fused_plan_update_ref(*args)
    _close(got[:2] + got[2], want[:2] + want[2], 1e-3)
    assert [float(n) for n in got[3]] == [float(n) for n in want[3]]
    again = fp.fused_plan_update(*args)
    assert all(torch.equal(a, b) for a, b in zip(again[:2] + again[2], got[:2] + got[2]))


def test_plan_on_the_card_matches_torch_backend(dev):
    x = _series(dev, n=5000, d=8)
    # moments(128) widens the halo to 127 rows, so finalize recovers the
    # lag, moments(16) and Welch tails through kernels 2, 3 and 4
    reqs = lambda: [tplan.autocovariance_request(6), tplan.yule_walker_request(3),
                    tplan.moments_request(16), tplan.moments_request(128),
                    tplan.welch_request(64, 32)]
    reset_launch_counts()
    got = tplan.analyze(x, reqs(), chunk_size=1000, device=dev)
    counts = launch_counts()
    want = tplan.analyze(x, reqs(), backend="torch", chunk_size=1000, device=dev)
    assert counts["fused_plan_megakernel"] == 2 * 5
    assert all(counts[k] >= 1 for k in ("cross_window_stats", "fused_lag_moments",
                                        "segment_dft_power"))
    np.testing.assert_allclose(got["autocovariance"].cpu(), want["autocovariance"].cpu(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["welch"][1].cpu(), want["welch"][1].cpu(), rtol=1e-3,
                               atol=1e-5)
    for key in ("mean", "var", "count"):
        np.testing.assert_allclose(got["moments"][key].cpu(), want["moments"][key].cpu(),
                                   rtol=1e-4, atol=1e-5)


# ----------------------------- kernels 1-4: the Welch paths, lag groups
FFT_LENGTHS = [2, 4, 8, 16, 64, 256, 1024, 4096]  # 4096: FFT_MAX_L


def _segments(dev, S, L, d, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn((S, L, d), generator=g, device=dev) + 2.0


def _power_case(dev, S, L, d, detrend, path):
    """The segment power on ``path`` against the plain version: 1e-3 of
    max|plain| (chip_smoke.py's TOL["psd"]) and 1e-3 per bin (TOL_NEW["psd"];
    the offset of 2 makes the DC bin tens of times the others without
    detrend); two launches bitwise equal."""
    from repro_torch.kernels import path_counts

    segs = _segments(dev, S, L, d, L + d)
    # the symmetric Hann window of 2 points is zero; a flat one would leave
    # the detrended DC bin pure rounding
    taper = (torch.hann_window(L, periodic=False, device=dev) if L > 2
             else torch.tensor([0.25, 1.0], device=dev))
    reset_launch_counts()
    got, again = sd.segment_fft_power(segs, taper, detrend), sd.segment_fft_power(
        segs, taper, detrend)
    assert path_counts()["segment_dft_power"][path] == 2
    want = sdr.segment_dft_power_ref(segs, taper, detrend)
    assert got.shape == want.shape
    _close(got, want, 1e-3)
    _per_bin(got, want, 1e-3)
    assert torch.equal(got, again)


@pytest.mark.parametrize("detrend", [True, False])
@pytest.mark.parametrize("d", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("L", FFT_LENGTHS)
def test_segment_power_fft_path_matches_plain(dev, L, d, detrend):
    _power_case(dev, 5, L, d, detrend, "fft")


@pytest.mark.parametrize("d", [1, 64, 65])
@pytest.mark.parametrize("L", [17, 255])
def test_segment_power_twiddle_path_matches_plain(dev, L, d):
    _power_case(dev, 4, L, d, True, "twiddle")


@pytest.mark.parametrize("n,d,H,seg_lens,seg_steps", [
    (700, 70, 0, (256, 17), (128, 5)), (700, 70, 1, (256, 17), (128, 5)),
    (700, 70, 16, (256, 17), (128, 5)), (700, 70, 40, (256, 17), (128, 5)),
    (600, 1, 16, (256, 17), (64, 3)),    # d = 1
    (24, 3, 40, (16,), (8,)),             # max_lag > chunk
])
def test_megakernel_lag_groups_and_welch_paths(dev, n, d, H, seg_lens, seg_steps):
    """Lag (1e-4), moments (1e-4) and both Welch paths (1e-3 of max|plain|,
    1e-3 per bin) against the plain version; counts exact; two launches
    bitwise equal; each launch counted once per Welch path it took."""
    from repro_torch.kernels import path_counts

    windows = (5, 12)
    reach = max(H, max(windows) - 1, max(seg_lens) - 1)
    y = _series(dev, n + reach, d)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[n // 3:: 7] = False
    tapers = tuple(torch.hann_window(L, periodic=False, device=dev) for L in seg_lens)
    args = (y, mask, 3, H, windows, seg_lens, seg_steps, tapers)
    reset_launch_counts()
    got, again = fp.fused_plan_update(*args), fp.fused_plan_update(*args)
    assert launch_counts()["fused_plan_megakernel"] == 2
    paths = {"fft" if L in (16, 256) else "twiddle" for L in seg_lens}
    assert {k for k, v in path_counts()["fused_plan_megakernel"].items() if v} == paths
    want = fpr.fused_plan_update_ref(*args)
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)
    _close(got[2], want[2], 1e-3)
    for g, w in zip(got[2], want[2]):
        _per_bin(g, w, 1e-3, per_segment=False)
    assert [float(v) for v in got[3]] == [float(v) for v in want[3]]
    assert all(torch.equal(a, b) for a, b in zip(again[:2] + again[2], got[:2] + got[2]))


@pytest.mark.parametrize("d", [1, 64, 130])
@pytest.mark.parametrize("n,H", [(2000, 0), (2000, 16), (2000, 40), (30, 40)])
def test_cross_lag_kernel_lag_groups(dev, n, H, d):
    """Kernel 2 (and kernel 3's lag part) at H = 0, 16, 40 and H > n: 1e-4
    of max|plain|, repeats bitwise."""
    y = _series(dev, n, d)
    got, again = ws.lagged_sums(y, H), ws.lagged_sums(y, H)
    _close(got, wsr.lagged_sums_ref(y, H), 1e-4)
    assert torch.equal(got, again)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[::3] = False
    yy = wsr.extend_rows(y, n + max(H, 7))
    _close(ws.fused_lagged_moments(yy, mask, H, (3, 8)),
           wsr.fused_lag_moments_ref(yy, mask, H, (3, 8)), 1e-4)


# -------------------------------------------- kernel 3, its symmetric path
LAGMOM_WINDOWS = [(1,), (64, 1024), (3, 8, 17, 64, 100, 257, 512, 1024)]


def _lagmom_case(dev, n, d, max_lag, windows, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed + n + d + max_lag)
    y = torch.randn((n + max(max_lag, max(windows) - 1), d), generator=g, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[n // 3:: 5] = False
    mask[-(n // 10):] = False
    return y, mask


def _lagmom_close(got, want, y, mask, windows, tol=1e-4):
    """chip_smoke.py's kernel 3 check: S within tol of max|S|; each moment sum
    within tol of the same sum over |y| (a first-moment sum cancels)."""
    assert (got[0] - want[0]).abs().max() <= tol * want[0].abs().max()
    scale = wsr.fused_lag_moments_ref(y.abs(), mask, 0, windows)[1]
    err = (got[1] - want[1]).abs()
    assert bool(((err == 0) | (err <= tol * scale)).all())


@pytest.mark.parametrize("windows", LAGMOM_WINDOWS)
@pytest.mark.parametrize("d", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("max_lag", [0, 1, 16, 40])
def test_fused_lag_moments_kernel_grid(dev, max_lag, d, windows):
    """Kernel 3 against the plain version (TOL lag and moments 1e-4),
    bitwise repeatable; at H = 0 (the symmetric path) S(0) is bitwise its
    transpose."""
    y, mask = _lagmom_case(dev, 3000, d, max_lag, windows)
    got = ws.fused_lagged_moments(y, mask, max_lag, windows)
    again = ws.fused_lagged_moments(y, mask, max_lag, windows)
    _lagmom_close(got, wsr.fused_lag_moments_ref(y, mask, max_lag, windows), y, mask, windows)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if max_lag == 0:
        assert torch.equal(got[0][0], got[0][0].t())


@pytest.mark.parametrize("rows,n,windows", [(1086, 1023, (64,)), (2046, 1023, (64, 1024)),
                                            (65536 + 1023, 65536, (64, 1024))])
def test_lag_moments_path_shapes_launch_once_and_replay(dev, rows, n, windows):
    """The tail, merge-boundary and chunk shapes: one launch per call, the
    arrival counters left at zero, and a CUDA graph of the launch replays
    to the same result."""
    y, mask = _lagmom_case(dev, n, 64, 0, windows)
    assert y.shape[0] == rows
    prep = ws.prepare_fused_lag_moments(y, mask, 0, windows)
    reset_launch_counts()
    got = tuple(t.clone() for t in prep.launch())
    assert launch_counts()["fused_lag_moments"] == 1
    _lagmom_close(got, wsr.fused_lag_moments_ref(y, mask, 0, windows), y, mask, windows)
    arrive = prep.keep[1][n + 1:]
    torch.cuda.synchronize()
    assert int(arrive.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        prep.launch()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(prep.out[0], got[0]) and torch.equal(prep.out[1], got[1])
    assert int(arrive.abs().sum()) == 0


@pytest.fixture(scope="module")
def lagmom_fault():
    """chip_smoke.py's copy of kernel 3 with the planted fault (the middle
    slab's partial left out of the in-launch sum), built here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.start_lagmom_fault_build()()


@pytest.mark.parametrize("n,d,windows", [(65536, 64, (64, 1024)), (3000, 130, (64,))])
def test_lag_moments_slab_left_out_is_caught(dev, lagmom_fault, n, d, windows):
    """The planted fault: the faulty copy's launch on the shipped wrapper's
    prepared params fails the check; the shipped kernel on the same params
    passes."""
    y, mask = _lagmom_case(dev, n, d, 0, windows)
    want = wsr.fused_lag_moments_ref(y, mask, 0, windows)
    prep = ws.prepare_fused_lag_moments(y, mask, 0, windows)
    assert lagmom_fault(ctypes.byref(prep.params), torch.cuda.current_stream().cuda_stream) == 0
    faulty = tuple(t.clone() for t in prep.out)
    with pytest.raises(AssertionError):
        _lagmom_close(faulty, want, y, mask, windows)
    _lagmom_close(prep.launch(), want, y, mask, windows)


# ---------------------------------- kernel 3, its batched path (d <= 32)
BATCHED_WINDOWS = [(1,), (32,), (32, 128), (1, 3, 8, 17, 32, 64, 100, 257)]  # 257 > L
BATCHED_CASES = [(d, B) for d in (1, 3, 15, 16, 17, 31, 32, 33) for B in (2, 7)] + [
    (16, 4095), (16, 4096)]


def _batched_case(dev, B, d, windows, mask_kind, L=127, seed=0):
    """y (B, L + max(windows) - 1, d) and a (B, L) mask: every start valid,
    none, a random 70%, or the moments finalize's tail mask (starts from
    carry - length to carry - w, length per tenant in [0, 2 L])."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + B + d + len(windows))
    y = torch.randn((B, L + max(windows) - 1, d), generator=g, device=dev)
    t = torch.arange(L, device=dev)
    if mask_kind == "all":
        mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    elif mask_kind == "none":
        mask = torch.zeros((B, L), dtype=torch.bool, device=dev)
    elif mask_kind == "random":
        mask = torch.rand((B, L), generator=g, device=dev) < 0.7
    else:
        length = torch.randint(0, 2 * L, (B,), generator=g, device=dev)
        mask = (t >= L - length[:, None]) & (t <= L - min(windows))
    return y, mask.contiguous()


@pytest.mark.parametrize("mask_kind", ["all", "none", "random", "tail"])
@pytest.mark.parametrize("windows", BATCHED_WINDOWS)
@pytest.mark.parametrize("d,B", BATCHED_CASES)
def test_batched_lag_moments_match_plain(dev, d, B, windows, mask_kind):
    """Batched kernel 3 at H = 0 against the plain version (TOL lag and
    moments 1e-4): the batched path up to d = 32, the two-role kernel at 33;
    one launch a call, two launches bitwise, S(0) exactly symmetric.  The
    plain version runs in float64: in float32 its moment sums are
    differences of cumulative sums over every row, which keep about 1e-7 of
    their magnitude, far more than 1e-4 of the sum of a tenant with one or
    two valid starts (the tail mask's)."""
    y, mask = _batched_case(dev, B, d, windows, mask_kind)
    prep = ws.prepare_fused_lag_moments(y, mask, 0, windows)
    assert prep.entry == ("rt_lag_moments_batched" if d <= 32 else None)
    reset_launch_counts()
    got = tuple(t.clone() for t in prep.launch())
    assert launch_counts()["fused_lag_moments"] == 1
    again = prep.launch()
    want = wsr.fused_lag_moments_ref(y, mask, 0, windows, dtype=torch.float64)
    _lagmom_close(got, want, y, mask, windows)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if d <= 32:
        assert torch.equal(got[0], got[0].transpose(-1, -2))
    if mask_kind == "none":
        assert not got[0].any()


@pytest.mark.parametrize("windows", [(32,), (32, 128)])
def test_batched_lag_moments_tenant_is_bitwise_whatever_the_batch(dev, windows):
    """Tenant i's S(0) and moment sums are bitwise the same in batches of 2,
    4,095 and 4,096 (whatever CTA holds it), through the wrapper too."""
    y, mask = _batched_case(dev, 4096, 16, windows, "tail")
    full = ws.fused_lagged_moments(y, mask, 0, windows)
    for B in (2, 4095):
        part = ws.fused_lagged_moments(y[:B].contiguous(), mask[:B].contiguous(), 0, windows)
        assert torch.equal(part[0], full[0][:B]) and torch.equal(part[1], full[1][:B])
    assert torch.equal(full[0], full[0].transpose(-1, -2))


# ------------------------------------------------------- kernels 5, 6 and 7
@pytest.mark.parametrize("n,d,window", [(5000, 70, 64), (300, 3, 1), (257, 2, 257),
                                        (40, 1, 7), (3000, 5, 1024)])
def test_window_moments_kernel_matches_float64_plain(dev, n, d, window):
    """Each window sum within 1e-5 of its own scale (the window's sum of |x|,
    or its sum of x^2) of the float64 plain version; repeats bitwise."""
    x = _series(dev, n, d) + 3.0
    got, again = ws.windowed_moments(x, window), ws.windowed_moments(x, window)
    want = wsr.window_moments_ref(x, window).double()
    scale = torch.stack([wsr.window_moments_ref(x.abs(), window)[:, 0],
                         wsr.window_moments_ref(x, window)[:, 1]], 1).double()
    assert ((got.double() - want).abs() / scale).max() <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("S,L,d,detrend", [(6, 64, 70, True), (3, 17, 1, True),
                                           (5, 33, 3, False), (4, 256, 64, True)])
def test_segment_csd_kernel_matches_plain(dev, S, L, d, detrend):
    """Entry (s, f, i, j) within 1e-4 of sqrt(P_ii(f) P_jj(f)), P the power
    averaged over segments; Hermitian; repeats bitwise."""
    segs = _series(dev, S * L, d).reshape(S, L, d)
    taper = torch.hann_window(L, periodic=False, device=dev)
    got, again = sd.segment_csd(segs, taper, detrend), sd.segment_csd(segs, taper, detrend)
    want = sdr.segment_csd_ref(segs, taper, detrend)
    p = sdr.segment_dft_power_ref(segs, taper, detrend).mean(0)  # (F, d)
    scale = (p[:, :, None] * p[:, None, :]).sqrt()[None]
    assert ((got - want).abs() / scale).max() <= 1e-4
    assert (got - got.transpose(2, 3).conj()).abs().max() <= 1e-5 * scale.max()
    assert torch.equal(got, again)


BAND_SHAPES = [
    (1000, 3, 5, torch.float32, 0), (300, 0, 3, torch.float32, 0),    # float4 path
    (4096, 6, 7, torch.float32, 0), (131072, 4, 1, torch.float32, 0),  # float4, two-float4 halo
    (700, 300, 4, torch.float32, 0), (513, 2, 6, torch.bfloat16, 0),   # shared-memory path
    (1000, 3, 5, torch.float32, 1),                                     # unaligned rows
]


def _band_operands(dev, d, b, m, dtype, offset, rows=1):
    """Diagonals with random off-matrix slots and ``rows`` (m, d) operands,
    the latter starting ``offset`` floats past a 16-byte boundary."""
    g = torch.Generator(device=dev)
    g.manual_seed(d + b)
    diags = torch.randn((d, 2 * b + 1), generator=g, device=dev).to(dtype)
    xs = [torch.randn(offset + m * d, generator=g, device=dev)[offset:].view(m, d).to(dtype)
          for _ in range(rows)]
    return diags, xs


def _within(got, want, scale, tol=1e-5):
    """Each entry within tol of its own scale; an entry whose scale is 0 (an
    off-matrix slot of d diags) must match exactly."""
    diff = (got.double() - want.double()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool(((diff == 0) | (diff <= tol * scale.double())).all()), (
        (diff / scale.double()).nan_to_num(posinf=float("inf")).max().item())


@pytest.mark.parametrize("d,b,m,dtype,offset", BAND_SHAPES)
def test_banded_matvec_kernel_matches_plain(dev, d, b, m, dtype, offset):
    """Each output within 1e-5 of sum_o |diag| |x|; off-matrix slots hold
    random values; repeats bitwise."""
    diags, (x,) = _band_operands(dev, d, b, m, dtype, offset)
    got, again = bm.banded_matvec_rows(diags, x), bm.banded_matvec_rows(diags, x)
    want = bmr.banded_matvec_ref(diags.float(), x.float())
    scale = bmr.banded_matvec_ref(diags.float().abs(), x.float().abs())
    assert ((got - want).abs() / scale.clamp_min(1e-30)).max() <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("d,b,m,dtype,offset", BAND_SHAPES + [(131072, 4, 2047, torch.float32, 0)])
def test_band_gradient_kernel_matches_plain(dev, d, b, m, dtype, offset):
    """d diags within 1e-5 of sum_n |g| |x| (off-matrix slots exactly 0,
    though the output's memory held random values before the launch);
    repeats bitwise; dropping one offset fails the check."""
    _, (g, x) = _band_operands(dev, d, b, m, dtype, offset, rows=2)
    g, x = g.float(), x.float()
    junk = torch.randn(d * (2 * b + 1) + 64, device=dev)  # memory the output may reuse
    del junk
    got, again = bm.band_gradient(g, x, b), bm.band_gradient(g, x, b)
    want = bmr.band_gradient(g, x, b)
    scale = bmr.band_gradient(g.abs(), x.abs(), b)
    _within(got, want, scale)
    assert torch.equal(got, again)
    dropped = got.clone()
    dropped[:, b + min(1, b)] = 0.0  # the fault: one offset's products never summed
    with pytest.raises(AssertionError):
        _within(dropped, want, scale)


@pytest.mark.parametrize("d,b,m,offset", [(1000, 3, 5, 0), (4096, 6, 7, 0), (131072, 4, 1, 0),
                                          (131072, 4, 2047, 0), (5, 4, 3, 0), (700, 300, 4, 0),
                                          (1000, 3, 5, 1)])
def test_transposed_flag_is_bitwise_the_kernel_on_band_transpose(dev, d, b, m, offset):
    """A^T x through the flag (the diagonals read where they lie) is bitwise
    the product kernel on band_transpose(diags), on every path."""
    diags, (x,) = _band_operands(dev, d, b, m, torch.float32, offset)
    flag = bm.prepare_banded_matvec(diags, x.contiguous(), transposed=True).launch()
    copy = bm.prepare_banded_matvec(bmr.band_transpose(diags), x.contiguous()).launch()
    assert torch.equal(flag, copy)
    _within(flag, bmr.banded_matvec_ref(bmr.band_transpose(diags), x),
            bmr.banded_matvec_ref(bmr.band_transpose(diags).abs(), x.abs()))


def test_fit_step_launches_the_banded_kernel_once(dev, monkeypatch):
    """One product launch and one d diags launch per fit step; two product
    launches and no d diags launch when the loss needs d/dx (the forward and
    A^T g), with no band_transpose built on the card's path, and that d/dx
    matches the plain backend's."""
    transposes = []
    for module in (bm, bmr):
        real = module.band_transpose
        monkeypatch.setattr(module, "band_transpose",
                            lambda dg, real=real: transposes.append(dg.device.type) or real(dg))
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn((64, 4096), generator=g, device=dev)
    reset_launch_counts()
    fit = tsp.fit_banded_ar(x, 2, n_steps=3, step_size=0.8)
    assert launch_counts()["banded_matvec"] == 3 and launch_counts()["band_gradient"] == 3
    plain = tsp.fit_banded_ar(x, 2, n_steps=3, step_size=0.8, backend="torch")
    assert (fit.diags - plain.diags).abs().max() <= 1e-5
    diags = 0.1 * torch.randn((4096, 5), generator=g, device=dev)
    grads = {}
    for backend in ("cuda", "torch"):
        xx = x.clone().requires_grad_(True)
        reset_launch_counts()
        loss = torch.sin(tsp.banded_predict(diags, xx, backend=backend)).square().sum()
        (grads[backend],) = torch.autograd.grad(loss, xx)
        assert launch_counts()["banded_matvec"] == (2 if backend == "cuda" else 0)
        assert launch_counts()["band_gradient"] == 0
    assert transposes == []  # neither backend builds A^T on the card
    scale = bmr.banded_matvec_ref(bmr.band_transpose(diags).abs(), torch.ones_like(x))  # |dL/dy| <= 1
    assert ((grads["cuda"] - grads["torch"]).abs() / scale).max() <= 1e-5


# ------------------------------------------------ kernel 8: swa_attention --

SWA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# per output row, ||kernel - plain|| / ||plain||: at most, and on average
# over the rows whose window is full (chip_smoke.py's limits)
SWA_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
SWA_ROW_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _qkv(dev, b, s, h, kvh, d, dtype, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.randn((b, s, n, d), generator=g, device=dev).to(dtype)
                 for n in (h, kvh, kvh))


@pytest.mark.parametrize("s,window,group,d,dtype,b,kvh", [
    (1000, 70, 4, 80, torch.bfloat16, 1, 2), (1000, 1, 4, 80, torch.bfloat16, 1, 2),
    (1000, 2000, 1, 64, torch.bfloat16, 1, 2), (300, 70, 4, 128, torch.bfloat16, 1, 2),
    # D a multiple of 8 but not of 16; the registry's G = 7 and 16 at D =
    # 128; S below one key tile and S = 1; two batch rows of 8 KV heads
    (1000, 70, 4, 72, torch.bfloat16, 1, 2), (1000, 300, 7, 128, torch.bfloat16, 1, 2),
    (500, 100, 16, 128, torch.bfloat16, 1, 2), (40, 16, 4, 80, torch.bfloat16, 1, 2),
    (1, 4, 4, 80, torch.bfloat16, 1, 2), (700, 200, 4, 80, torch.bfloat16, 2, 8),
    (1000, 70, 4, 80, torch.float32, 1, 2), (250, 16, 1, 128, torch.float32, 1, 2),
    (128, 300, 4, 64, torch.float32, 1, 2)])
def test_swa_kernel_matches_chunked_plain(dev, s, window, group, d, dtype, b, kvh):
    """Each output entry within tol of its row's max|v| of the chunked plain
    version, and each output row within its limits of its own norm; two
    launches bitwise equal; one launch per call."""
    from repro_torch.kernels.swa_attention import ops as sw, ref as swr

    q, k, v = _qkv(dev, b, s, kvh * group, kvh, d, dtype)
    reset_launch_counts()
    got, again = sw.swa_attention(q, k, v, window), sw.swa_attention(q, k, v, window)
    assert launch_counts()["swa_attention"] == 2
    want = swr.swa_attention_chunked(q, k, v, window)
    scale = swr.swa_row_scale(v, window, kvh * group)
    assert got.dtype == dtype and got.shape == q.shape
    assert ((got.float() - want.float()).abs() / scale).max() <= SWA_TOL[dtype]
    rows = (got.double() - want.double()).norm(dim=-1) / want.double().norm(dim=-1)
    assert rows.max() <= SWA_ROW_TOL[dtype]
    assert rows[:, min(window, s) - 1:].mean() <= SWA_ROW_MEAN_TOL[dtype]
    assert torch.equal(got, again)


def test_swa_kernel_refuses_grad_and_bad_shapes(dev):
    from repro_torch.kernels.swa_attention import ops as sw

    q, k, v = _qkv(dev, 1, 64, 4, 1, 16, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        sw.swa_attention(q.clone().requires_grad_(True), k, v, 8)
    with pytest.raises(ValueError, match="head dims"):
        sw.swa_attention(*_qkv(dev, 1, 64, 4, 1, 12, torch.bfloat16), 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_generate_kernel_path_matches_plain_path(dev, dtype):
    """Reduced h2o-danube (window 16, G = 4), a prompt longer than the
    window: the kernel path's tokens equal the plain path's, its logits are
    close, and prefill launches the kernel once per layer, decode never."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine

    cfg = get_arch("danube").reduced()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=dev)
    eng = ServeEngine(cfg, params, max_len=48, dtype=dtype, device=dev)
    reset_launch_counts()
    served = eng.generate(prompts, 8, keep_logits=True)
    assert launch_counts()["swa_attention"] == cfg.n_layers
    # the plain path: prefill on the chunked plain attention, then decode on
    # the served tokens
    reset_launch_counts()
    logits, cache = prefill(params, {"tokens": prompts}, cfg, attention=swa_attention_chunked)
    cache = eng._grow_cache(cache, prompts.shape[0])
    tokens = torch.from_numpy(served.tokens).to(dev)
    steps = [logits]
    for i in range(1, 8):
        logits, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": 40 + i - 1},
                                    cfg)
        steps.append(logits)
    assert launch_counts()["swa_attention"] == 0
    got, want = served.logits, torch.stack([s.float() for s in steps], 1)
    err = (got - want).abs().max() / want.abs().max()
    assert err <= (1e-4 if dtype == torch.float32 else 3e-2)
    if dtype == torch.float32:
        np.testing.assert_array_equal(served.tokens, want.argmax(-1).cpu().numpy())


def _qkv_dv(dev, b, s, h, kvh, d, dv, dtype, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.randn((b, s, n, w), generator=g, device=dev).to(dtype)
                 for n, w in ((h, d), (kvh, d), (kvh, dv)))


@pytest.mark.parametrize("s,window,group,d,dv,dtype", [
    # multi-head latent attention's q/k 192, v 128 (G = 1, W = S), a pair
    # the (192, 128) instantiation serves with zero columns, square
    # instantiations serving a narrower v or q/k; S not a multiple of 64
    (1000, 1000, 1, 192, 128, torch.bfloat16), (300, 70, 2, 192, 128, torch.bfloat16),
    (130, 130, 1, 184, 120, torch.bfloat16), (1000, 300, 4, 24, 16, torch.bfloat16),
    (200, 50, 2, 64, 128, torch.bfloat16), (1, 4, 1, 192, 128, torch.bfloat16),
    (1000, 1000, 1, 192, 128, torch.float32), (130, 40, 2, 184, 120, torch.float32),
    (300, 70, 4, 24, 16, torch.float32)])
def test_swa_kernel_takes_a_v_narrower_than_q(dev, s, window, group, d, dv, dtype):
    """q/k of D and v of DV: out (B, S, H, DV) held to the chunked plain
    version as at D = DV; two launches bitwise equal."""
    from repro_torch.kernels.swa_attention import ops as sw, ref as swr

    kvh = 2
    q, k, v = _qkv_dv(dev, 1, s, kvh * group, kvh, d, dv, dtype)
    got, again = sw.swa_attention(q, k, v, window), sw.swa_attention(q, k, v, window)
    want = swr.swa_attention_chunked(q, k, v, window)
    scale = swr.swa_row_scale(v, window, kvh * group)
    assert got.dtype == dtype and tuple(got.shape) == (1, s, kvh * group, dv)
    assert ((got.float() - want.float()).abs() / scale).max() <= SWA_TOL[dtype]
    rows = (got.double() - want.double()).norm(dim=-1) / want.double().norm(dim=-1)
    assert rows.max() <= SWA_ROW_TOL[dtype]
    assert rows[:, min(window, s) - 1:].mean() <= SWA_ROW_MEAN_TOL[dtype]
    assert torch.equal(got, again)


def test_swa_kernel_refuses_heads_wider_than_its_instantiations(dev):
    from repro_torch.kernels.swa_attention import ops as sw

    for d, dv in ((200, 128), (192, 136)):
        with pytest.raises(ValueError, match="head dims"):
            sw.swa_attention(*_qkv_dv(dev, 1, 64, 2, 2, d, dv, torch.bfloat16), 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_deepseek_generate_kernel_path_matches_plain_path(dev, dtype):
    """Reduced deepseek-v2 (MLA: q/k 24, v 16 through kernel 8): the kernel
    path's logits close to the plain path's, prefill launches the kernel
    once per layer and the absorbed decode never."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine

    cfg = get_arch("deepseek-v2").reduced()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (2, 40), generator=g, device=dev)
    eng = ServeEngine(cfg, params, max_len=48, dtype=dtype, device=dev)
    reset_launch_counts()
    served = eng.generate(prompts, 8, keep_logits=True)
    assert launch_counts()["swa_attention"] == cfg.n_layers
    reset_launch_counts()
    logits, cache = prefill(params, {"tokens": prompts}, cfg, attention=swa_attention_chunked)
    cache = eng._grow_cache(cache, prompts.shape[0])
    tokens = torch.from_numpy(served.tokens).to(dev)
    steps = [logits]
    for i in range(1, 8):
        logits, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": 40 + i - 1},
                                    cfg)
        steps.append(logits)
    assert launch_counts()["swa_attention"] == 0
    got, want = served.logits, torch.stack([s.float() for s in steps], 1)
    assert (got - want).abs().max() / want.abs().max() <= (1e-4 if dtype == torch.float32
                                                           else 3e-2)


# ------------------------------- batched kernels 1-4 (the tenant axis)
def _tenants(dev, B, n, d, reach, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    y = torch.randn((B, n + reach, d), generator=g, device=dev)
    mask = torch.rand((B, n), generator=g, device=dev) < 0.8
    z0 = torch.randint(0, 1000, (B,), generator=g, device=dev, dtype=torch.int32)
    return y, mask, z0


def _unbatched_bitwise(batched_out, one_out):
    flat = lambda t: [x for v in t for x in (v if isinstance(v, tuple) else (v,))]
    return all(torch.equal(a[0], b) for a, b in zip(flat(batched_out), flat(one_out)))


@pytest.mark.parametrize("B,n,d,H", [(1, 600, 70, 9), (5, 600, 70, 9), (37, 256, 16, 16)])
def test_batched_megakernel_matches_plain(dev, B, n, d, H):
    """One launch for B tenants against the plain batched version; at B = 1
    bitwise the one-problem launch; repeated, bitwise the same."""
    taper = torch.hann_window(64, periodic=True, device=dev)
    y, mask, z0 = _tenants(dev, B, n, d, 127)
    args = (y, mask, z0, H, (32, 128), (64,), (32,), (taper,))
    reset_launch_counts()
    got = fp.fused_plan_update(*args)
    assert launch_counts()["fused_plan_megakernel"] == 1
    want = fpr.fused_plan_update_ref(*args)
    for b in range(B):
        _close((got[0][b], got[1][b], got[2][0][b]), (want[0][b], want[1][b], want[2][0][b]),
               1e-4)
    assert torch.equal(got[3][0], want[3][0])
    again = fp.fused_plan_update(*args)
    assert all(torch.equal(a, b) for a, b in zip(again[:2] + again[2], got[:2] + got[2]))
    if B == 1:
        one = fp.fused_plan_update(y[0], mask[0], z0[0], *args[3:])
        assert _unbatched_bitwise(got[:3], one[:3])


@pytest.mark.parametrize("B,max_lag", [(1, 0), (1, 3), (6, 0), (6, 3), (300, 16)])
def test_batched_lag_and_moment_kernels_match_plain(dev, B, max_lag):
    """Kernels 2 and 3 over a tenant axis (kernel 3 through the two-role
    kernel for B > 1) against their plain batched versions; at B = 1
    bitwise the one-problem launches."""
    y, mask, _ = _tenants(dev, B, 127, 16, max(max_lag, 63), seed=1)
    reset_launch_counts()
    lag = ws.masked_lagged_sums(y, mask, max_lag)
    mom = ws.fused_lagged_moments(y, mask, max_lag, (32, 64))
    counts = launch_counts()
    assert counts["cross_window_stats"] == 1 and counts["fused_lag_moments"] == 1
    want_lag = wsr.masked_lagged_sums_ref(y, mask, max_lag)
    want_mom = wsr.fused_lag_moments_ref(y, mask, max_lag, (32, 64))
    for b in range(B):
        _close(lag[b], want_lag[b], 1e-4)
        _close((mom[0][b], mom[1][b]), (want_mom[0][b], want_mom[1][b]), 1e-4)
    if B == 1:
        assert torch.equal(lag[0], ws.masked_lagged_sums(y[0], mask[0], max_lag))
        one = ws.fused_lagged_moments(y[0], mask[0], max_lag, (32, 64))
        assert torch.equal(mom[0][0], one[0]) and torch.equal(mom[1][0], one[1])


# ---------------- kernels 1 and 2 at small widths: the lag tile sized by d
SMALL_DIMS = [1, 3, 15, 16, 17, 31, 32, 33]  # both small tiles, their edges, and 64 above
SMALL_LAGS = [0, 1, 2, 16, 17, 40]  # one run, a run of SMALL_LAGS and one past it, H > 17


def _gapped(dev, B, n, d, reach, seed):
    """_tenants with a gap of 20 masked starts in every tenant."""
    y, mask, z0 = _tenants(dev, B, n, d, reach, seed)
    mask[:, n // 4: n // 4 + 20] = False
    return y, mask, z0


def _per_tenant_close(got, want, tol=1e-4):
    for a, b in zip(got, want):
        _close(a, b, tol)


@pytest.mark.parametrize("d", SMALL_DIMS)
@pytest.mark.parametrize("H", SMALL_LAGS)
def test_cross_lag_kernel_small_widths(dev, H, d):
    """Kernel 2 at small widths, batched (37 tenants of 203 starts: not a
    multiple of 32, a gap in the mask) and one problem (the first tenant, and
    5,003 starts: several slabs, summed by the reduction), 1e-4 of each
    tenant's max|plain|; two launches bitwise equal; one launch a call."""
    y, mask, _ = _gapped(dev, 37, 203, d, H, seed=100 * d + H)
    reset_launch_counts()
    got, again = ws.masked_lagged_sums(y, mask, H), ws.masked_lagged_sums(y, mask, H)
    assert launch_counts()["cross_window_stats"] == 2
    _per_tenant_close(got, wsr.masked_lagged_sums_ref(y, mask, H))
    assert torch.equal(got, again)
    _close(ws.masked_lagged_sums(y[0], mask[0], H), wsr.masked_lagged_sums_ref(y[0], mask[0], H),
           1e-4)
    long = _series(dev, 5003 + H, d)
    lmask = torch.ones(5003, dtype=torch.bool, device=dev)
    lmask[1000:1500] = False
    got = ws.masked_lagged_sums(long, lmask, H)
    _close(got, wsr.masked_lagged_sums_ref(long, lmask, H), 1e-4)
    assert torch.equal(got, ws.masked_lagged_sums(long, lmask, H))


@pytest.mark.parametrize("d", SMALL_DIMS)
@pytest.mark.parametrize("H", SMALL_LAGS)
def test_megakernel_small_widths(dev, H, d):
    """Kernel 1 at small widths, batched (37 tenants of 203 starts with a
    gap) and one problem (the first tenant): lag and moments 1e-4, Welch
    1e-3 of each tenant's max|plain|, segment counts exact; two launches
    bitwise equal."""
    taper = torch.hann_window(16, periodic=True, device=dev)
    reach = max(H, 11, 15)
    y, mask, z0 = _gapped(dev, 37, 203, d, reach, seed=100 * d + H + 7)
    args = (y, mask, z0, H, (5, 12), (16,), (8,), (taper,))
    got, again = fp.fused_plan_update(*args), fp.fused_plan_update(*args)
    want = fpr.fused_plan_update_ref(*args)
    _per_tenant_close(got[0], want[0])
    _per_tenant_close(got[1], want[1])
    _per_tenant_close(got[2][0], want[2][0], 1e-3)
    assert torch.equal(got[3][0], want[3][0])
    assert all(torch.equal(a, b) for a, b in zip(again[:2] + again[2], got[:2] + got[2]))
    one_args = (y[0], mask[0], z0[0]) + args[3:]
    one, one_want = fp.fused_plan_update(*one_args), fpr.fused_plan_update_ref(*one_args)
    _close(one[:2] + one[2], one_want[:2] + one_want[2], 1e-3)
    _close(one[0], one_want[0], 1e-4)


@pytest.mark.parametrize("B", [2, 37, 4096])
def test_small_width_batches_at_the_session_shape(dev, B):
    """Kernels 1 and 2 at the session's d = 16 and H = 16 for B tenants: the
    chunk (256 starts, 129 valid, windows (32, 128), Welch 64/32) and a
    query's lag tail (127 starts), every tenant against the plain version."""
    taper = torch.hann_window(64, periodic=True, device=dev)
    y, mask, z0 = _tenants(dev, B, 256, 16, 127, seed=B)
    mask[:, 129:] = False
    args = (y, mask, z0, 16, (32, 128), (64,), (32,), (taper,))
    got, want = fp.fused_plan_update(*args), fpr.fused_plan_update_ref(*args)
    _per_tenant_close(got[0], want[0])
    _per_tenant_close(got[1], want[1])
    _per_tenant_close(got[2][0], want[2][0], 1e-3)
    tail = y[:, :127].contiguous()
    ones = torch.ones((B, 127), dtype=torch.bool, device=dev)
    _per_tenant_close(ws.masked_lagged_sums(tail, ones, 16),
                      wsr.masked_lagged_sums_ref(tail, ones, 16))


def test_small_width_tenant_bits_do_not_depend_on_the_batch(dev):
    """A tenant's outputs of kernels 1 and 2 at d = 16 are the same bits in a
    batch of 4,095 tenants as in one of 4,096."""
    taper = torch.hann_window(64, periodic=True, device=dev)
    y, mask, z0 = _tenants(dev, 4096, 256, 16, 127, seed=11)
    members = (16, (32, 128), (64,), (32,), (taper,))
    full = fp.fused_plan_update(y, mask, z0, *members)
    part = fp.fused_plan_update(y[:4095], mask[:4095], z0[:4095], *members)
    assert all(torch.equal(a[:4095], b) for a, b in zip(full[:2] + full[2], part[:2] + part[2]))
    lag = ws.masked_lagged_sums(y[:, :143], mask[:, :127], 16)
    assert torch.equal(lag[:4095], ws.masked_lagged_sums(y[:4095, :143], mask[:4095, :127], 16))


@pytest.mark.parametrize("d", [3, 16, 32, 64])
def test_nan_in_a_masked_starts_reach_reaches_the_lag_sums(dev, d):
    """A NaN at row 40 of channel 2, where only masked starts (24-40) reach
    it within H = 16: the reference zeroes masked rows and then multiplies,
    so 0 * NaN reaches S(h); kernels 1 and 2 give the plain version's
    non-finite entries, and equal finite ones within 1e-4."""
    taper = torch.hann_window(16, periodic=True, device=dev)
    y, mask, z0 = _tenants(dev, 3, 203, d, 16, seed=d)
    mask[:, 20:60] = False
    y[:, 40, min(2, d - 1)] = float("nan")
    got = (ws.masked_lagged_sums(y, mask, 16),
           fp.fused_plan_update(y, mask, z0, 16, (5,), (16,), (8,), (taper,))[0])
    want = wsr.masked_lagged_sums_ref(y, mask, 16)
    assert not bool(torch.isfinite(want).all())
    for g in got:
        assert torch.equal(torch.isfinite(g), torch.isfinite(want))
        fin = torch.isfinite(want)
        assert (g[fin] - want[fin]).abs().max() <= 1e-4 * want[fin].abs().max()


def test_batched_launch_takes_more_than_65535_tenants(dev):
    """70,000 tenants in one launch of kernels 1 and 2 (the tenant folds into
    blockIdx.x; no grid dimension limits it), every tenant against the plain
    version."""
    B = 70000
    taper = torch.hann_window(8, periodic=True, device=dev)
    y, mask, z0 = _tenants(dev, B, 24, 3, 7, seed=2)
    args = (y, mask, z0, 2, (4, 8), (8,), (4,), (taper,))
    reset_launch_counts()
    got = fp.fused_plan_update(*args)
    lag = ws.masked_lagged_sums(y, mask, 2)
    counts = launch_counts()
    assert counts["fused_plan_megakernel"] == 1 and counts["cross_window_stats"] == 1
    want = fpr.fused_plan_update_ref(*args)
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[2][0], want[2][0]),
                 (lag, want[0])):
        scale = b.abs().flatten(1).amax(1).clamp_min(1e-30)
        assert bool(((a - b).abs().flatten(1).amax(1) <= 1e-4 * scale).all())


def test_session_on_the_card_matches_the_cpu_session(dev):
    """A FrameSession on the card (growing and eviction mode) against the
    same session on the CPU (plain versions): query and query_batch; each
    ingest two megakernel launches, each batched query one launch of kernel
    2 per lag member, one of kernel 3 and one of kernel 4."""
    from repro_torch import FrameSession

    def session(device, **kw):
        sess = FrameSession(d=4, num_users=9, device=device, **kw)
        sess.autocovariance(6)
        sess.yule_walker(3)
        sess.moments(16)
        sess.moments(64)
        sess.welch(nperseg=32, overlap=16)
        return sess

    g = np.random.default_rng(0)
    for kw in ({}, {"window": 256, "num_buckets": 4}):
        card, cpu = session(dev, **kw), session("cpu", **kw)
        for tick in range(6):
            ids = g.permutation(9)[:7]
            chunk = g.standard_normal((7, 64, 4)).astype(np.float32)
            reset_launch_counts()
            card.ingest(ids, chunk)
            assert launch_counts()["fused_plan_megakernel"] == 2
            cpu.ingest(ids, chunk)
        reset_launch_counts()
        got = card.query_batch(np.arange(9))
        counts = launch_counts()
        assert counts["cross_window_stats"] == 2 and counts["segment_dft_power"] == 1
        assert counts["fused_lag_moments"] == 1
        want = cpu.query_batch(np.arange(9))
        np.testing.assert_allclose(got["autocovariance"].cpu(), want["autocovariance"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["welch"][1].cpu(), want["welch"][1], rtol=1e-4,
                                   atol=1e-4)
        for key in ("mean", "var", "count"):
            np.testing.assert_allclose(got["moments"][key].cpu(), want["moments"][key],
                                       rtol=1e-5, atol=1e-5)
        one = card.query(3)
        np.testing.assert_allclose(one["yule_walker"][0].cpu(), want["yule_walker"][0][3],
                                   rtol=1e-3, atol=1e-4)


# ------------------------------------------------ the overlapping block store
def _store_plan(frame):
    frame.autocovariance(6)
    frame.yule_walker(3)
    frame.moments(8)
    frame.moments(64)
    frame.welch(nperseg=32, overlap=16)
    return frame


def _results_close(got, want, tol=1e-4):
    for name in want:
        g, w = got[name], want[name]
        pairs = ([(g[k], w[k]) for k in sorted(w)] if isinstance(w, dict)
                 else list(zip(g, w)) if isinstance(w, tuple) else [(g, w)])
        for a, b in pairs:
            a, b = a.double().cpu(), b.double().cpu()
            assert (a - b).abs().max() <= tol * b.abs().max().clamp_min(1e-30), name


@pytest.mark.parametrize("P", [1, 7, 512])
def test_store_collect_launches_the_megakernel_once(dev, P):
    """A sharded collect over P blocks is ONE megakernel launch for every
    block (plus the finalize tails: kernel 2 per lag member, 3 for the
    moment window inside the carry, 4 for Welch), equal to the chunk path
    and to the same plan on the CPU; a repeat is bitwise."""
    from repro_torch import SeriesFrame

    B, d = 128, 4
    g = torch.Generator(device=dev)
    g.manual_seed(P)
    x = torch.randn((P * B - 5 if P > 1 else 100, d), generator=g, device=dev)
    reset_launch_counts()
    frame = _store_plan(SeriesFrame.from_sharded(x, block_size=B, device=dev))
    got = frame.collect()
    counts = launch_counts()
    assert counts["fused_plan_megakernel"] == 1
    assert counts["cross_window_stats"] == 2 and counts["fused_lag_moments"] == 1
    assert counts["segment_dft_power"] == 1
    chunks = _store_plan(SeriesFrame.from_chunks(list(x.split(100)), device=dev)).collect()
    _results_close(got, chunks)
    cpu = _store_plan(SeriesFrame.from_sharded(x.cpu(), block_size=B, device="cpu")).collect()
    _results_close(got, cpu)
    again = _store_plan(SeriesFrame.from_sharded(x, block_size=B, device=dev)).collect()
    assert all(torch.equal(a, b) for a, b in zip(
        (got["autocovariance"], got["welch"][1], got["moments"]["var"]),
        (again["autocovariance"], again["welch"][1], again["moments"]["var"])))


def test_batched_lag_sums_over_blocks_equal_per_block_calls(dev):
    """block_lag_sums: one launch of kernel 2 for every block, each block's
    partial against its own launch and its plain version."""
    from repro_torch.core.estimators import stats
    from repro_torch.core.overlap import OverlapSpec, make_overlapping_blocks

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((3000, 70), generator=g, device=dev)
    spec = OverlapSpec(3000, 256, 0, 9)
    blocks, _ = make_overlapping_blocks(x, spec)
    reset_launch_counts()
    got = stats.block_lag_sums(blocks, spec, 9)
    assert launch_counts()["cross_window_stats"] == 1
    ones = torch.ones(256, dtype=torch.bool, device=dev)
    for b in range(spec.num_blocks):
        _close(got[b], ws.masked_lagged_sums(blocks[b], ones, 9), 1e-4)
        _close(got[b], wsr.masked_lagged_sums_ref(blocks[b], ones, 9), 1e-4)
    reset_launch_counts()
    gamma = stats.autocovariance_blocked(x, 9, 256)
    assert launch_counts()["cross_window_stats"] == 1
    _close(gamma, stats.autocovariance(x, 9, backend="torch"), 1e-4)


def test_append_rows_on_the_card_is_bitwise_replacement(dev):
    from repro_torch import TimeSeriesStore

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x, extra = (torch.randn((n, 3), generator=g, device=dev) for n in (333, 415))
    for B, hr in [(64, 7), (32, 50), (128, 0)]:
        store = TimeSeriesStore.from_series(x, B, 0, hr, device=dev)
        for lo in range(0, 415, 111):
            store.append_rows(extra[lo: lo + 111])
        fresh = TimeSeriesStore.from_series(torch.cat([x, extra]), B, 0, hr, device=dev)
        assert store.spec == fresh.spec
        assert torch.equal(store.padded_blocks_single_host(), fresh.blocks)


def test_store_path_never_reaches_the_plain_versions(dev, monkeypatch):
    """On CUDA tensors the store's collect, append, replan, block lag sums
    and streaming estimator launch kernels: every plain version the kernel
    wrappers hold raises if called."""
    from repro_torch import SeriesFrame, StreamingEstimator, TimeSeriesStore
    from repro_torch.core.estimators import stats
    from repro_torch.kernels.segment_dft import ops as sdo

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for module, names in ((fp, ("fused_plan_update_ref",)),
                          (ws, ("cross_lagged_sums_ref", "fused_lag_moments_ref",
                                "window_moments_ref")),
                          (sdo, ("segment_dft_power_ref", "segment_csd_ref"))):
        for name in names:
            monkeypatch.setattr(module, name, refuse)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn((2000, 4), generator=g, device=dev)
    frame = _store_plan(SeriesFrame.from_sharded(x, block_size=128, device=dev))
    frame.collect()
    frame.append(x[:300])
    frame.collect()
    frame.moments(16)
    frame.collect()
    stats.autocovariance_blocked(x, 5, 128)
    store = TimeSeriesStore.from_series(x, 128, 0, 5, device=dev)
    StreamingEstimator.from_store(stats.lag_sum_engine(5, 4, device=dev), store, 333).finalize(
        stats.streaming_autocovariance)


def test_batched_estimator_finalize_on_the_card(dev):
    """A batched StreamingEstimator on the card: its finalize cannot vmap a
    kernel launch, so it calls the finalizer once per series; each series
    equals the same estimator on the CPU."""
    from repro_torch import StreamingEstimator
    from repro_torch.core.estimators import spectral, stats

    xb = np.random.default_rng(6).standard_normal((5, 400, 3)).astype(np.float32)
    for make, fin, idx in ((lambda d: stats.lag_sum_engine(4, 3, device=d),
                            stats.streaming_autocovariance, None),
                           (lambda d: spectral.welch_engine(32, 16, d=3, device=d),
                            spectral.streaming_welch, 1)):
        card = StreamingEstimator(make(dev), batch=5).ingest(xb[:, :150]).ingest(xb[:, 150:])
        cpu = StreamingEstimator(make("cpu"), batch=5).ingest(xb[:, :150]).ingest(xb[:, 150:])
        got, want = card.finalize(fin), cpu.finalize(fin)
        got, want = (got, want) if idx is None else (got[idx], want[idx])
        assert got.shape[0] == 5
        for b in range(5):
            _close(got[b].cpu(), want[b], 1e-4)


# ------------------------------------------- forecasts and the gateway
def _forecast_session(device, users, **kw):
    from repro_torch import FrameSession

    sess = FrameSession(d=4, num_users=users, device=device, **kw)
    sess.autocovariance(6)
    sess.moments(8)
    sess.moments(40)
    sess.welch(nperseg=32, overlap=16)
    sess.forecast(5, "ar", p=3)
    sess.forecast(4, "auto", p=2, max_period=12)
    sess.anomaly_scores("arma", p=1, q=1)
    return sess


def _seasonal_chunks(g, users, rows, t0=0):
    """Per user a stable AR(1) plus a sinusoid of period 5 + (user % 6)."""
    e = 0.3 * g.standard_normal((users, rows, 4)).astype(np.float32)
    x = np.zeros_like(e)
    for t in range(1, rows):
        x[:, t] = 0.5 * x[:, t - 1] + e[:, t]
    period = 5 + (np.arange(users) % 6)
    t = np.arange(t0, t0 + rows)
    return (x + np.sin(2 * np.pi * t[None, :] / period[:, None])[..., None]).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def test_forecast_query_on_the_card_matches_the_cpu(dev):
    """Forecasts and anomaly scores of a session on the card against the
    CPU session (plain versions), and the gateway phase's launch counts: a
    batched query launches kernel 2 once per lag-family member (4 here),
    kernel 3 once and kernel 4 twice, for 1 tenant as for 37."""
    g = np.random.default_rng(3)
    card, cpu = _forecast_session(dev, 37), _forecast_session("cpu", 37)
    for tick in range(4):
        chunk = _seasonal_chunks(g, 37, 64, 64 * tick)
        card.ingest(np.arange(37), chunk)
        cpu.ingest(np.arange(37), chunk)
    per_size = {}
    for users in (1, 37):
        reset_launch_counts()
        got = card.query_batch(np.arange(users))
        torch.cuda.synchronize()
        per_size[users] = launch_counts()
    assert per_size[1] == per_size[37]
    assert per_size[37]["cross_window_stats"] == 4 and per_size[37]["segment_dft_power"] == 2
    assert per_size[37]["fused_lag_moments"] == 1
    want = cpu.query_batch(np.arange(37))
    for name, keys in (("forecast", ("pred", "sigma")), ("forecast_2", ("pred", "sigma")),
                       ("anomaly", ("z", "score", "sigma"))):
        for key in keys:
            np.testing.assert_allclose(got[name][key].cpu(), want[name][key], rtol=1e-4,
                                       atol=1e-5)
    assert torch.equal(got["forecast_2"]["period"].cpu(), want["forecast_2"]["period"])
    assert torch.equal(got["anomaly"]["valid"].cpu(), want["anomaly"]["valid"])


def test_gateway_on_the_card_is_bitwise_its_twin_and_restarts(dev, tmp_path):
    """The gateway on the card: its answers bitwise a twin session fed the
    same batches, kernel 1 twice a tick, and a restarted gateway bitwise
    the answers of its snapshot's tick."""
    import asyncio

    from repro_torch.serving.gateway import GatewayConfig, StatsGateway, _to_host

    users, g = 96, np.random.default_rng(4)
    cfg = GatewayConfig(sentinel=True, snapshot_every=2, checkpoint_dir=str(tmp_path))
    gw = StatsGateway(_forecast_session(dev, users), cfg)
    twin = _forecast_session(dev, users)
    loop = asyncio.new_event_loop()
    snap_answers = None
    try:
        for tick in range(4):
            chunk = _seasonal_chunks(g, users, 64, 64 * tick)
            reset_launch_counts()
            for u in range(users):
                gw.submit_ingest(u, chunk[u])
            futs = [gw.submit_query(u) for u in range(0, users, 3)]
            loop.run_until_complete(gw.tick())
            assert launch_counts()["fused_plan_megakernel"] == 2
            twin.ingest(np.arange(users), chunk)
            want = _to_host(twin.query_batch(np.arange(0, users, 3)))
            for i, f in enumerate(futs):
                got = f.result()
                for name in ("autocovariance", "forecast", "forecast_2", "anomaly"):
                    w = want[name]
                    pairs = ([(got[name][k], w[k][i]) for k in w] if isinstance(w, dict)
                             else [(got[name], w[i])])
                    for a, b in pairs:
                        assert np.array_equal(_bits(a), _bits(b)), name
            if tick == 3:  # the newest generation: snapshot_every=2
                snap_answers = [f.result() for f in futs]
        gw._loop_rt.manager.flush()
        gw2 = StatsGateway(_forecast_session(dev, users), cfg)
        assert gw2._tick == 4 and gw2.session.plan.device == dev
        futs = [gw2.submit_query(u) for u in range(0, users, 3)]
        loop.run_until_complete(gw2.tick())
        for f, want_u in zip(futs, snap_answers):
            got = f.result()
            for name in ("forecast", "anomaly"):
                for key in want_u[name]:
                    assert np.array_equal(_bits(got[name][key]), _bits(want_u[name][key]))
    finally:
        loop.close()


# ------------------------------------------------ the backend policy layer
@pytest.fixture
def fresh_table(monkeypatch, tmp_path):
    from repro_torch.core import calibrate as cal

    monkeypatch.setenv("REPRO_TORCH_CALIB_CACHE", str(tmp_path / "calib.json"))
    yield cal
    cal.set_active_table(None)


def _plan_args(dev, L, B=None):
    g = torch.Generator(device=dev)
    g.manual_seed(L)
    lead = () if B is None else (B,)
    y = torch.randn(lead + (L + 63, 8), generator=g, device=dev)
    mask = torch.ones(lead + (L,), dtype=torch.bool, device=dev)
    z0 = torch.zeros(lead, dtype=torch.int32, device=dev)
    taper = torch.hann_window(64, periodic=False, device=dev)
    return (y, mask, z0, 8, (16,), (64,), (32,), (taper,))


def test_calibrate_on_the_card_gives_finite_medians(dev, fresh_table, tmp_path):
    cal = fresh_table
    table = cal.calibrate(sizes=(512, 2048), iters=2, warmup=1, tune_blocks=True,
                          path=str(tmp_path / "t.json"))
    assert table.platform == "cuda" and table.device == torch.cuda.get_device_name()
    for prim in cal.PRIMITIVES:
        for n in (512, 2048):
            m = table.timings["crossover"][prim][n]
            assert set(m) == {"torch", "cuda"}
            assert all(np.isfinite(t) and t > 0 for t in m.values()), (prim, n, m)
    # a block is recorded only where it beats the built-in one beyond the spread
    assert table.blocks.get("fused_plan_update", {}).get(
        "block_t", cal.BLOCK_CANDIDATES["block_t"][0]) in cal.BLOCK_CANDIDATES["block_t"]
    timed = table.timings["blocks"]["fused_plan_update"]["block_t"]
    assert set(cal.BLOCK_CANDIDATES["block_t"]) <= set(timed)
    saved = cal.CalibrationTable.from_json(
        __import__("json").load(open(tmp_path / "t.json")))
    assert saved.thresholds == table.thresholds and saved.device == table.device


@pytest.mark.parametrize("B", [None, 37])
def test_auto_at_its_threshold_launches_the_kernel_bitwise_cuda(dev, fresh_table, B):
    from repro_torch.core.backend import AutoBackend, CudaBackend

    cal = fresh_table
    L = 384
    auto = AutoBackend(table=cal.CalibrationTable(
        "cuda", {p: float(L) for p in cal.PRIMITIVES}, "test",
        device=torch.cuda.get_device_name()))
    below = _plan_args(dev, L - 1, B)
    reset_launch_counts()
    auto.fused_plan_update(*below)
    torch.cuda.synchronize()
    assert launch_counts()["fused_plan_megakernel"] == 0
    at = _plan_args(dev, L, B)
    reset_launch_counts()
    got = auto.fused_plan_update(*at)
    torch.cuda.synchronize()
    assert launch_counts()["fused_plan_megakernel"] == 1
    want = CudaBackend().fused_plan_update(*at)
    flat = lambda o: [t for x in o for t in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    assert [r for (_, r, _) in auto.routes] == ["torch", "cuda"]


@pytest.mark.parametrize("fallback", ["torch", "cuda"])
def test_breaker_on_the_card_under_an_injected_fault(dev, fallback):
    """A (cuda, cuda) breaker serves a failing call bitwise; a (cuda,
    torch) breaker serves nothing from the plain version on the card: the
    failure is re-raised and the open breaker refuses.  Both recover at the
    probe, bitwise "cuda"."""
    from repro_torch.core.backend import CircuitBreakerBackend, CudaBackend, TorchBackend
    from repro_torch.runtime import chaos

    br = CircuitBreakerBackend(primary=CudaBackend(),
                               fallback=TorchBackend() if fallback == "torch" else CudaBackend(),
                               trip_after=1, cooldown_calls=2)
    args = _plan_args(dev, 1000)
    want = CudaBackend().fused_plan_update(*args)
    flat = lambda o: [t for x in o for t in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    inj = chaos.FaultInjector().fail("backend.fused_plan_update", calls={0})
    with chaos.scoped(inj):
        if fallback == "torch":
            with pytest.raises(chaos.InjectedFault):
                br.fused_plan_update(*args)  # the failure is re-raised
            with pytest.raises(RuntimeError, match="CPU tensors only"):
                br.fused_plan_update(*args)  # the open breaker refuses
            outs = [br.fused_plan_update(*args) for _ in range(2)]  # the probe closes it
        else:
            outs = [br.fused_plan_update(*args) for _ in range(4)]
    m = br.breaker_metrics()
    served = 2 if fallback == "cuda" else 0
    assert (m["trips"], m["recoveries"], m["fallback_calls"]) == (1, 1, served)
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(want)))


# ------------------------------------------------------- the mesh on the card
@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A one-rank NCCL mesh on the card (the driver's machine has one)."""
    import torch.distributed as dist

    from repro_torch.parallel import data_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # no network there
    mesh = data_mesh(1, 0, "file://" + str(tmp_path / "rendezvous"))
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


def _mesh_series(dev, n=8 * 512, d=16):
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    return torch.randn((n, d), generator=g, device=dev)


def _mesh_counted(fn):
    from repro_torch.parallel import collective_count, reset_collective_count

    reset_launch_counts()
    reset_collective_count()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}, collective_count()


def test_mesh_collect_over_nccl_is_bitwise_the_one_device_collect(dev, nccl_mesh):
    """(a) from_sharded(mesh=) at world 1: kernel 1 once and one collective
    a collect, bitwise the one-device frame; an append and its collect
    bitwise too; a replan walks the blocks and replays the append."""
    from repro_torch import SeriesFrame
    from repro_torch.core.mapreduce import tree_leaves

    x, extra = _mesh_series(dev), _mesh_series(dev, 300)
    mesh_frame = _store_plan(SeriesFrame.from_sharded(x, mesh=nccl_mesh, block_size=512,
                                                      device=dev))
    free = _store_plan(SeriesFrame.from_sharded(x, block_size=512, device=dev))
    got, counts, coll = _mesh_counted(mesh_frame.collect)
    assert counts["fused_plan_megakernel"] == 1 and coll == 1
    want = free.collect()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    got, counts, coll = _mesh_counted(lambda: mesh_frame.append(extra).collect())
    assert counts["fused_plan_megakernel"] == 2 and coll == 0  # the chunk and its boundary
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(free.append(extra).collect())))
    mesh_frame.moments(8)
    free.moments(8)
    got, counts, coll = _mesh_counted(mesh_frame.collect)
    assert counts["fused_plan_megakernel"] == 3 and coll == 1
    _results_close(got, free.collect())


def test_mesh_stores_over_nccl_are_bitwise_the_one_device_store(dev, nccl_mesh):
    """(b) mesh stores in both halo modes: map_reduce exchange bitwise
    replicate bitwise the one-device store, one collective each;
    sharded_window_map_reduce of a chunk kernel launches kernel 2 once;
    halo_exchange at world 1 is the zero-padded shard."""
    from repro_torch import TimeSeriesStore
    from repro_torch.core.backend import get_backend
    from repro_torch.core.halo import halo_exchange
    from repro_torch.core.mapreduce import block_window_map_reduce, sharded_window_map_reduce

    x = _mesh_series(dev)
    kern = lambda w: torch.outer(w[0], w[-1])
    free = TimeSeriesStore.from_series(x, 512, 0, 40, device=dev)
    want = free.map_reduce(kern)
    for mode in ("replicate", "exchange"):
        st = TimeSeriesStore.from_series(x, 512, 0, 40, mesh=nccl_mesh, halo_mode=mode,
                                         device=dev)
        got, _, coll = _mesh_counted(lambda: st.map_reduce(kern))
        assert torch.equal(got, want) and coll == 1
    be = get_backend(None, dev)
    ck = lambda y, m: be.masked_lagged_sums(y, m, 16)
    st = TimeSeriesStore.from_series(x, 512, 0, 40, mesh=nccl_mesh, device=dev)
    got, counts, coll = _mesh_counted(lambda: sharded_window_map_reduce(
        None, st.blocks, st.spec, nccl_mesh, chunk_kernel=ck))
    assert counts == {"cross_window_stats": 1} and coll == 1
    assert torch.equal(got, block_window_map_reduce(None, x, free.spec, chunk_kernel=ck))
    padded = halo_exchange(x, 4, 5, nccl_mesh)
    assert torch.equal(padded[4:-5], x) and not padded[:4].any() and not padded[-5:].any()


def test_autocovariance_sharded_over_nccl_is_bitwise_blocked(dev, nccl_mesh):
    """(c) autocovariance_sharded at world 1: kernel 2 once, one collective,
    bitwise autocovariance_blocked."""
    from repro_torch import TimeSeriesStore
    from repro_torch.core.estimators.stats import autocovariance_blocked, autocovariance_sharded

    x = _mesh_series(dev)
    st = TimeSeriesStore.from_series(x, 512, 0, 16, mesh=nccl_mesh, device=dev)
    got, counts, coll = _mesh_counted(lambda: autocovariance_sharded(st.blocks, st.spec, 16,
                                                                     nccl_mesh))
    assert counts == {"cross_window_stats": 1} and coll == 1
    assert torch.equal(got, autocovariance_blocked(x, 16, 512))


# ------------------------------- the paper's last estimators and int8 serving


def test_fit_ar_mle_on_the_card_matches_the_cpu(dev):
    """The §5 fit's blocks and autograd on the card against the same fit on
    the CPU: A, precision and trace within rtol 1e-4 / atol 1e-5."""
    from repro_torch.core.estimators import fit_ar_mle
    from repro_torch.timeseries import random_stable_var, simulate_var

    g = torch.Generator().manual_seed(0)
    A = random_stable_var(g, 2, 5, radius=0.6, device="cpu")
    x = simulate_var(g, A, 20_000, device="cpu")
    want = fit_ar_mle(x, 2, n_steps=20, block_size=4096, update_precision_every=10)
    got = fit_ar_mle(x.to(dev), 2, n_steps=20, block_size=4096, update_precision_every=10)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_graph_map_reduce_on_the_card_matches_the_cpu(dev):
    from repro_torch.core import graphs

    g = graphs.grid_graph(32, 32)
    part = graphs.make_graph_partition(g, 8, 1)
    x = torch.randn((1024, 64), generator=torch.Generator().manual_seed(1))

    def kern(xc, nb, mask):
        nbm = torch.where(mask[:, None], nb, 0.0).sum(0) / torch.clamp(mask.sum(), min=1)
        return (xc * nbm).sum(), torch.outer(xc[:4], nbm[:4])

    got = graphs.graph_window_map_reduce(kern, x.to(dev), g, part)
    want = graphs.graph_window_map_reduce(kern, x, g, part)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    traj = graphs.simulate_traffic_dbn(graphs.line_graph(256), torch.full((256,), 0.4), 64,
                                       inflow_scale=0.0, device=dev)
    cpu = graphs.simulate_traffic_dbn(graphs.line_graph(256), torch.full((256,), 0.4), 64,
                                      inflow_scale=0.0, device="cpu")
    np.testing.assert_allclose(traj.cpu().numpy(), cpu.numpy(), rtol=1e-4, atol=1e-5)


def test_quantized_generate_on_the_card_matches_the_cpu(dev):
    """ServeEngine(quantize=True) in float32: the card's tokens equal the
    CPU's (kernel 8 once per layer in prefill against the chunked plain
    attention), its codes bitwise."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_arch("danube").reduced(), d_model=256, d_ff=512, vocab=1024)
    cpu_model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    card_model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu").to(dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    want = ServeEngine(cfg, cpu_model, max_len=48, quantize=True, device="cpu").generate(
        prompts, 8, keep_logits=True)
    eng = ServeEngine(cfg, card_model, max_len=48, quantize=True, device=dev)
    assert torch.equal(eng.params["embed"].codes.cpu(),
                       ServeEngine(cfg, cpu_model, max_len=48, quantize=True,
                                   device="cpu").params["embed"].codes)
    reset_launch_counts()
    got = eng.generate(prompts, 8, keep_logits=True)
    assert launch_counts()["swa_attention"] == cfg.n_layers
    err = (got.logits.cpu() - want.logits).abs().max() / want.logits.abs().max()
    assert err <= 1e-4
    np.testing.assert_array_equal(got.tokens, want.tokens)
