"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); skips
elsewhere.  This file imports no JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan as tplan
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
from repro_torch.kernels.window_stats import ops as ws, ref as wsr


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
        _close(sd.segment_fft_power(segs, taper, detrend),
               sdr.segment_dft_power_ref(segs, taper, detrend), 1e-3)


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
