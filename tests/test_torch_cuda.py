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
from repro_torch.core.estimators import spatial as tsp
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.banded_matvec import ops as bm, ref as bmr
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


@pytest.mark.parametrize("d,b,m,dtype,offset", [
    (1000, 3, 5, torch.float32, 0), (300, 0, 3, torch.float32, 0),    # float4 path
    (4096, 6, 7, torch.float32, 0), (131072, 4, 1, torch.float32, 0),  # float4, two-float4 halo
    (700, 300, 4, torch.float32, 0), (513, 2, 6, torch.bfloat16, 0),   # shared-memory path
    (1000, 3, 5, torch.float32, 1),                                     # unaligned rows
])
def test_banded_matvec_kernel_matches_plain(dev, d, b, m, dtype, offset):
    """Each output within 1e-5 of sum_o |diag| |x|; off-matrix slots hold
    random values; repeats bitwise."""
    g = torch.Generator(device=dev)
    g.manual_seed(d + b)
    diags = torch.randn((d, 2 * b + 1), generator=g, device=dev).to(dtype)
    x = torch.randn(offset + m * d, generator=g, device=dev)[offset:].view(m, d).to(dtype)
    got, again = bm.banded_matvec_rows(diags, x), bm.banded_matvec_rows(diags, x)
    want = bmr.banded_matvec_ref(diags.float(), x.float())
    scale = bmr.banded_matvec_ref(diags.float().abs(), x.float().abs())
    assert ((got - want).abs() / scale.clamp_min(1e-30)).max() <= 1e-5
    assert torch.equal(got, again)


def test_fit_step_launches_the_banded_kernel_once(dev):
    """One launch per fit step (the diagonals' gradient is plain PyTorch);
    two when the loss needs d/dx (the forward and A^T g), and that d/dx
    matches the plain backend's."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn((64, 4096), generator=g, device=dev)
    reset_launch_counts()
    fit = tsp.fit_banded_ar(x, 2, n_steps=3, step_size=0.8)
    assert launch_counts()["banded_matvec"] == 3
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


@pytest.mark.parametrize("s,window,group,d,dtype", [
    (1000, 70, 4, 80, torch.bfloat16), (1000, 1, 4, 80, torch.bfloat16),
    (1000, 2000, 1, 64, torch.bfloat16), (300, 70, 4, 128, torch.bfloat16),
    (1000, 70, 4, 80, torch.float32), (250, 16, 1, 128, torch.float32),
    (128, 300, 4, 64, torch.float32)])
def test_swa_kernel_matches_chunked_plain(dev, s, window, group, d, dtype):
    """Each output entry within tol of its row's max|v| of the chunked plain
    version, and each output row within its limits of its own norm; two
    launches bitwise equal; one launch per call."""
    from repro_torch.kernels.swa_attention import ops as sw, ref as swr

    q, k, v = _qkv(dev, 1, s, 2 * group, 2, d, dtype)
    reset_launch_counts()
    got, again = sw.swa_attention(q, k, v, window), sw.swa_attention(q, k, v, window)
    assert launch_counts()["swa_attention"] == 2
    want = swr.swa_attention_chunked(q, k, v, window)
    scale = swr.swa_row_scale(v, window, 2 * group)
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
