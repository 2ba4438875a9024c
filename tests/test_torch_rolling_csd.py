"""The port's rolling moments (kernel 5) and cross-spectra (kernel 6) held
against the JAX reference.

At small sizes on the CPU, where each kernel wrapper runs its plain
version.  The JAX side runs ``JnpBackend`` and ``PallasBackend`` in
interpret mode; inputs come from numpy with a seed.  Tolerances are those of
the reference's own tests (cited per case).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JnpBackend, PallasBackend
from repro.core.estimators import spectral as jspec, stats as jstats
from repro.kernels.segment_dft.ref import segment_csd_ref as jax_csd_ref
from repro.kernels.window_stats.ref import window_moments_ref as jax_moments_ref
from repro_torch.core.backend import CudaBackend, TorchBackend
from repro_torch.core.estimators import spectral as tspec, stats as tstats
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
from repro_torch.kernels.window_stats import ops as ws, ref as wsr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

JNP = JnpBackend()
PALLAS = PallasBackend(interpret=True)
PORT = {"cuda": CudaBackend(), "torch": TorchBackend()}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------ kernel 5: rolling moments
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("n,window", [(200, 16), (17, 17), (40, 1)])
def test_windowed_moments_matches_reference_backends(backend, n, window):
    """tests/test_backend.py:140-148: atol 1e-4; no full window raises."""
    x = _rand(n, 3, seed=6)
    want = JNP.windowed_moments(jnp.asarray(x), window)
    pal = PALLAS.windowed_moments(jnp.asarray(x), window)
    got = PORT[backend].windowed_moments(_t(x), window)
    assert got.shape == (n - window + 1, 2, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(_np(got), np.asarray(pal), atol=1e-4)
    with pytest.raises(ValueError, match="no full window"):
        PORT[backend].windowed_moments(_t(x), n + 1)


@pytest.mark.parametrize("n,window,d", [(90, 7, 2), (33, 33, 1), (12, 1, 4)])
def test_window_moments_plain_matches_reference_oracle(n, window, d):
    """The float64 plain version against the reference's naive oracle (every
    window summed from scratch); 1-D input included."""
    x = _rand(n, d, seed=n)
    want = jax_moments_ref(jnp.asarray(x), window)
    np.testing.assert_allclose(_np(wsr.window_moments_ref(_t(x), window)), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ws.windowed_moments(_t(x[:, 0]), window)),
                               np.asarray(jax_moments_ref(jnp.asarray(x[:, :1]), window)),
                               rtol=1e-5, atol=1e-5)


def test_float64_plain_keeps_digits_the_float32_formula_loses():
    """Over a long series of large squares the float32 cumulative sum of the
    reference's formula loses digits; the float64 plain version does not."""
    x = 30.0 + _rand(200_000, 1, seed=3)
    exact = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64)[:, 0] ** 2, 8)[-50:]
    want = exact.sum(1)
    f64 = _np(wsr.window_moments_ref(_t(x), 8))[-50:, 1, 0]
    f32 = _np(wsr.window_moments_ref(_t(x), 8, torch.float32))[-50:, 1, 0]
    assert np.max(np.abs(f64 - want) / want) < 1e-6
    assert np.max(np.abs(f32 - want) / want) > 1e-4


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_windowed_moments_estimator_matches_reference(backend):
    x = _rand(300, 3, seed=8) + np.array([0.0, 5.0, -2.0], np.float32)
    want = jstats.windowed_moments(jnp.asarray(x), 24, backend="jnp")
    got = tstats.windowed_moments(_t(x), 24, backend=backend)
    for key in ("mean", "var"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_windowed_moments_high_mean_variance(backend):
    """tests/test_backend.py:464-480: centring on the global mean keeps the
    variance of a 100-offset, 1e-2-signal series (rtol 0.05) and clamps at
    0 at a 1e4 offset."""
    noise = 1e-2 * _rand(512, 1, seed=18)
    x = 100.0 + noise
    wm = tstats.windowed_moments(_t(x), 64, backend=backend)
    assert np.all(_np(wm["var"]) >= 0)
    np.testing.assert_allclose(_np(wm["var"])[0, 0], np.var(x[:64].astype(np.float64)),
                               rtol=0.05)
    np.testing.assert_allclose(_np(wm["mean"])[0, 0], np.mean(x[:64]), rtol=1e-6)
    wm = tstats.windowed_moments(_t(1e4 + noise), 64, backend=backend)
    assert np.all(_np(wm["var"]) >= 0)


# ------------------------------------------------ kernel 6: cross-spectra
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("detrend", [True, False])
@pytest.mark.parametrize("S,L,d", [(5, 64, 2), (3, 17, 1), (9, 16, 3), (1, 32, 2)])
def test_segment_csd_matches_reference_backends(backend, S, L, d, detrend):
    """tests/test_backend.py:209-230: against the jnp rfft oracle and the
    Pallas kernel (interpret mode), rtol 1e-3, atol 1e-4 L; Hermitian in
    (i, j); the diagonal equals the segment power."""
    segs = _rand(S, L, d, seed=11)
    taper = np.hanning(L).astype(np.float32)
    want = JNP.segment_csd(jnp.asarray(segs), jnp.asarray(taper), detrend)
    pal = PALLAS.segment_csd(jnp.asarray(segs), jnp.asarray(taper), detrend)
    got = PORT[backend].segment_csd(_t(segs), _t(taper), detrend)
    assert got.shape == (S, L // 2 + 1, d, d) and got.dtype == torch.complex64
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-3, atol=1e-4 * L)
    np.testing.assert_allclose(_np(got), np.asarray(pal), rtol=1e-3, atol=1e-4 * L)
    out = _np(got)
    np.testing.assert_allclose(out, np.conj(np.swapaxes(out, 2, 3)), atol=1e-5 * L)
    power = _np(PORT[backend].segment_fft_power(_t(segs), _t(taper), detrend))
    np.testing.assert_allclose(np.real(out[:, :, np.arange(d), np.arange(d)]), power,
                               rtol=1e-3, atol=1e-4 * L)


def test_segment_csd_plain_matches_reference_oracle():
    segs = _rand(4, 24, 3, seed=12)
    taper = np.hanning(24).astype(np.float32)
    want = jax_csd_ref(jnp.asarray(segs), jnp.asarray(taper), True)
    np.testing.assert_allclose(_np(sdr.segment_csd_ref(_t(segs), _t(taper), True)), want,
                               rtol=1e-4, atol=1e-4 * 24)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_welch_csd_matches_reference(backend):
    """tests/test_backend.py:233-241: rtol 2e-3, atol 1e-5; frequencies
    equal."""
    x = _rand(2048, 3, seed=21)
    fj, cj = jspec.welch_csd(jnp.asarray(x), nperseg=64, backend="jnp")
    fp, cp = tspec.welch_csd(_t(x), nperseg=64, backend=backend)
    np.testing.assert_allclose(_np(fp), np.asarray(fj))
    np.testing.assert_allclose(_np(cp), np.asarray(cj), rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("nperseg,overlap", [(32, 8), (17, 5)])
def test_welch_csd_segments_and_diagonal(nperseg, overlap):
    """The port's segments (an unfold) equal the reference's overlap
    container, and the CSD diagonal is the two-sided Welch PSD."""
    x = _rand(500, 2, seed=nperseg)
    fj, cj = jspec.welch_csd(jnp.asarray(x), nperseg=nperseg, overlap=overlap, backend="jnp")
    f, c = tspec.welch_csd(_t(x), nperseg=nperseg, overlap=overlap)
    np.testing.assert_allclose(_np(c), np.asarray(cj), rtol=2e-3, atol=1e-5)
    _, psd = tspec.welch_psd(_t(x), nperseg=nperseg, overlap=overlap)
    mult = np.full(len(f), 2.0)
    mult[0] = 1.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    np.testing.assert_allclose(np.real(_np(c)[:, [0, 1], [0, 1]]) * mult[:, None], _np(psd),
                               rtol=1e-4, atol=1e-6)


def test_wrappers_validate_and_count_no_cpu_launches():
    reset_launch_counts()
    ws.windowed_moments(torch.zeros(10, 2), 3)
    sd.segment_csd(torch.zeros(2, 8, 1), torch.ones(8))
    assert launch_counts()["window_moments"] == launch_counts()["segment_csd"] == 0
    with pytest.raises(ValueError, match="taper"):
        sd.segment_csd(torch.zeros(2, 8, 1), torch.ones(7))
    with pytest.raises(ValueError, match="no full window"):
        ws.windowed_moments(torch.zeros(10, 2), 0)
    with pytest.raises(ValueError, match="no full window"):
        ws.prepare_window_moments(torch.zeros(10, 2), 11)
    with pytest.raises(TypeError, match="float32"):
        sd.prepare_segment_csd(torch.zeros(2, 8, 1, dtype=torch.float64), torch.zeros(8), True)


@pytest.mark.parametrize("n_out,d,window,sms,want", [
    (2**22 - 63, 64, 64, 132, 1024),     # the smoke run's w = 64
    (2**22 - 1023, 64, 1024, 132, 2048),  # and w = 1024
    (100, 3, 5, 132, 64),                 # short series: the floor
])
def test_moment_chain_lengths(n_out, d, window, sms, want):
    assert ws.moment_chain(n_out, d, window, sms) == want
