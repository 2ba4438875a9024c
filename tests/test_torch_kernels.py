"""The port's four kernels held against the JAX reference.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
pin those plain versions (and the wrappers' padding) to the reference's
``ref.py`` oracles and ``JnpBackend`` primitives, check one tiny case of each
against the Pallas kernels in interpret mode, and check the launch-side
argument validation.  The CUDA kernels themselves run only on the card:
see tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JnpBackend, PallasBackend
from repro.kernels.fused_plan import fused_plan_update_ref as jax_fused_ref
from repro.kernels.segment_dft.ref import segment_dft_power_ref as jax_power_ref
from repro_torch.core.backend import CudaBackend, TorchBackend
from repro_torch.kernels import _build, _launch
from repro_torch.kernels.fused_plan import ops as fp
from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
from repro_torch.kernels.window_stats import ops as ws

JNP = JnpBackend()
# The reference oracles, jitted: one compile per shape instead of one per op.
jnp_lagged_sums = jax.jit(JNP.lagged_sums, static_argnums=1)
jnp_masked_lagged_sums = jax.jit(JNP.masked_lagged_sums, static_argnums=2)
jnp_fused_lagged_moments = jax.jit(JNP.fused_lagged_moments, static_argnums=(2, 3))
jnp_segment_power = jax.jit(JNP.segment_fft_power, static_argnums=2)
jnp_fused_plan_update = jax.jit(JNP.fused_plan_update, static_argnums=(2, 3, 4, 5, 6),
                                static_argnames="stage_dtype")
LAG_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_backend.py:167


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------ lagged sums (kernel 2)
@pytest.mark.parametrize("n,d,max_lag", [(64, 3, 5), (7, 2, 9), (200, 1, 0)])
def test_lagged_sums_plain_matches_jnp(n, d, max_lag):
    x = _rng(n).standard_normal((n, d)).astype(np.float32)
    want = jnp_lagged_sums(jnp.asarray(x), max_lag)
    np.testing.assert_allclose(_np(ws.lagged_sums(_t(x), max_lag)), want, **LAG_TOL)
    np.testing.assert_allclose(_np(TorchBackend().lagged_sums(_t(x), max_lag)), want, **LAG_TOL)


@pytest.mark.parametrize("L,extra,max_lag,holes", [(50, 0, 4, False), (50, 9, 4, True),
                                                   (12, 30, 20, True)])
def test_masked_lagged_sums_plain_matches_jnp(L, extra, max_lag, holes):
    rng = _rng(L + extra)
    y = rng.standard_normal((L + extra, 2)).astype(np.float32)
    mask = np.ones(L, bool)
    if holes:
        mask[L // 3:: 4] = False
    want = jnp_masked_lagged_sums(jnp.asarray(y), jnp.asarray(mask), max_lag)
    got = ws.masked_lagged_sums(_t(y), _t(mask), max_lag)
    np.testing.assert_allclose(_np(got), want, **LAG_TOL)


# ------------------------------------------ fused lag + moments (kernel 3)
@pytest.mark.parametrize("window", [8, (3, 8, 17), (40,)])
def test_fused_lag_moments_plain_matches_jnp(window):
    rng = _rng(7)
    L, max_lag = 90, 5
    y = rng.standard_normal((L + 60, 3)).astype(np.float32)
    mask = np.ones(L, bool)
    mask[L // 3:: 5] = False
    lag_w, mom_w = jnp_fused_lagged_moments(jnp.asarray(y), jnp.asarray(mask), max_lag,
                                            window)
    lag_g, mom_g = ws.fused_lagged_moments(_t(y), _t(mask), max_lag, window)
    np.testing.assert_allclose(_np(lag_g), lag_w, **LAG_TOL)
    np.testing.assert_allclose(_np(mom_g), mom_w, **LAG_TOL)
    assert mom_g.shape == mom_w.shape  # (2, d) for an int window, (K, 2, d) for a tuple


# ----------------------------------------------- segment power (kernel 4)
@pytest.mark.parametrize("L,detrend", [(16, True), (13, True), (32, False)])
def test_segment_power_plain_matches_jnp(L, detrend):
    segs = _rng(L).standard_normal((5, L, 3)).astype(np.float32)
    taper = np.hanning(L).astype(np.float32)
    got = _np(sd.segment_fft_power(_t(segs), _t(taper), detrend))
    want_fft = jnp_segment_power(jnp.asarray(segs), jnp.asarray(taper), detrend)
    np.testing.assert_allclose(got, want_fft, rtol=1e-3, atol=1e-4 * L)  # test_backend.py:199
    want_mm = jax_power_ref(jnp.asarray(segs), jnp.asarray(taper), detrend)
    np.testing.assert_allclose(got, want_mm, rtol=1e-5, atol=1e-5 * L)


def test_dft_phase_reduced_mod_L():
    """The twiddle phase t*f is reduced mod L in int64 before float32."""
    L = 5000
    phase = sdr.dft_phase(L, torch.device("cpu"))
    assert phase.dtype == torch.float32 and phase.shape == (L, L // 2 + 1)
    assert float(phase.max()) < L
    assert float(phase[L - 1, L // 2]) == float(((L - 1) * (L // 2)) % L)


# ----------------------------------------------- megakernel (kernel 1)
EDGE_GRID = {  # tests/test_megakernel.py:60-72
    "short_chunk": dict(n=40),
    "d_one": dict(n=80, d=1, windows=(4, 12)),
    "odd_seg_len": dict(n=90, seg_lens=(13,), seg_steps=(5,)),
    "lag_exceeds_chunk": dict(n=24, max_lag=40, seg_lens=(), seg_steps=(), windows=(6,)),
    "multi_window": dict(n=100, windows=(3, 8, 17), mask_holes=True),
    "multi_welch": dict(n=128, seg_lens=(16, 24), seg_steps=(8, 12), z0=7, mask_holes=True),
    "tiled_offset": dict(n=96, z0=11, mask_holes=True),
    "no_moments": dict(n=64, windows=()),
}


def _mega_args(n=96, d=2, max_lag=6, windows=(8,), seg_lens=(16,), seg_steps=(8,), z0=0,
               mask_holes=False, seed=0):
    reach = max([max_lag] + [w - 1 for w in windows] + [s - 1 for s in seg_lens])
    y = _rng(seed).standard_normal((n + reach, d)).astype(np.float32)
    mask = np.ones(n, bool)
    if mask_holes:
        mask[n // 3:: 5] = False
    tapers = tuple(np.hanning(L).astype(np.float32) for L in seg_lens)
    return y, mask, z0, max_lag, windows, seg_lens, seg_steps, tapers


def _to_jax(args):
    y, mask, z0, max_lag, windows, seg_lens, seg_steps, tapers = args
    return (jnp.asarray(y), jnp.asarray(mask), z0, max_lag, windows, seg_lens, seg_steps,
            tuple(jnp.asarray(t) for t in tapers))


def _to_torch(args):
    y, mask, z0, max_lag, windows, seg_lens, seg_steps, tapers = args
    return (_t(y), _t(mask), z0, max_lag, windows, seg_lens, seg_steps,
            tuple(_t(t) for t in tapers))


def _assert_fused_close(got, want, rtol, atol=1e-4):  # test_megakernel.py:46-57
    lag_g, mom_g, psds_g, nseg_g = got
    lag_w, mom_w, psds_w, nseg_w = want
    np.testing.assert_allclose(_np(lag_g), lag_w, rtol=rtol, atol=atol)
    assert (mom_g is None) == (mom_w is None)
    if mom_w is not None:
        np.testing.assert_allclose(_np(mom_g), mom_w, rtol=rtol, atol=atol)
    assert len(psds_g) == len(psds_w)
    for pg, pw in zip(psds_g, psds_w):
        np.testing.assert_allclose(_np(pg), pw, rtol=10 * rtol, atol=10 * atol)
    for ng, nw in zip(nseg_g, nseg_w):
        np.testing.assert_allclose(_np(ng), nw)


@pytest.mark.parametrize("case", sorted(EDGE_GRID))
def test_megakernel_plain_edge_grid(case):
    """Against the reference's composition oracle (itself pinned to the
    naive ``fused_plan_update_ref`` by tests/test_megakernel.py)."""
    args = _mega_args(**EDGE_GRID[case])
    want = jnp_fused_plan_update(*_to_jax(args))
    _assert_fused_close(fp.fused_plan_update(*_to_torch(args)), want, rtol=2e-3)


def test_megakernel_plain_matches_naive_reference():
    args = _mega_args(n=48, max_lag=5, windows=(4, 9), seg_lens=(16,), seg_steps=(8,), z0=3,
                      mask_holes=True)
    want = jax_fused_ref(*_to_jax(args))
    _assert_fused_close(TorchBackend().fused_plan_update(*_to_torch(args)), want, rtol=2e-3)


def test_megakernel_plain_bf16_staging_matches_jnp():
    args = _mega_args(n=128, max_lag=5, seed=7)
    want = jnp_fused_plan_update(*_to_jax(args), stage_dtype="bfloat16")
    got = CudaBackend().fused_plan_update(*_to_torch(args), stage_dtype="bfloat16")
    _assert_fused_close(got, want, rtol=2e-3)


def test_candidate_offsets_match_reference():
    from repro.kernels.fused_plan.ops import _candidate_offsets

    _candidate_offsets = jax.jit(_candidate_offsets, static_argnums=(1, 2, 3, 4))
    mask = np.ones(100, bool)
    mask[7::9] = False
    for z0, bt, step in [(0, 32, 8), (11, 32, 5), (7, 64, 12)]:
        tiles = -(-100 // bt) + 1
        want = _candidate_offsets(jnp.asarray(z0, jnp.int32), 100, tiles, bt, step,
                                  jnp.asarray(mask))
        got = fp.candidate_offsets(torch.tensor(z0), 100, tiles, bt, step, _t(mask))
        np.testing.assert_array_equal(_np(got), want)


# ------------------------------------------- against Pallas interpret mode
def test_plain_versions_match_pallas_interpret():
    pal = PallasBackend(block_t=32, block_s=2, interpret=True)
    rng = _rng(3)
    y = rng.standard_normal((70, 2)).astype(np.float32)
    mask = np.ones(60, bool)
    mask[5::7] = False
    np.testing.assert_allclose(
        _np(ws.masked_lagged_sums(_t(y), _t(mask), 4)),
        pal.masked_lagged_sums(jnp.asarray(y), jnp.asarray(mask), 4), **LAG_TOL)
    lag_p, mom_p = pal.fused_lagged_moments(jnp.asarray(y), jnp.asarray(mask), 3, (4, 9))
    lag_g, mom_g = ws.fused_lagged_moments(_t(y), _t(mask), 3, (4, 9))
    np.testing.assert_allclose(_np(lag_g), lag_p, **LAG_TOL)
    np.testing.assert_allclose(_np(mom_g), mom_p, **LAG_TOL)
    segs = rng.standard_normal((3, 16, 2)).astype(np.float32)
    taper = np.hanning(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(sd.segment_fft_power(_t(segs), _t(taper))),
        pal.segment_fft_power(jnp.asarray(segs), jnp.asarray(taper)), rtol=1e-3, atol=1e-4 * 16)
    args = _mega_args(n=64, max_lag=4, windows=(5,), seg_lens=(16,), seg_steps=(8,), z0=3,
                      mask_holes=True, seed=5)
    _assert_fused_close(fp.fused_plan_update(*_to_torch(args)),
                        pal.fused_plan_update(*_to_jax(args)), rtol=2e-3)


# ------------------------------------------------- launch-side validation
def test_launch_validation_raises_before_any_launch():
    y = torch.zeros((40, 2))
    mask = torch.ones(30, dtype=torch.bool)
    with pytest.raises(ValueError, match="at most 8 moment windows"):  # reach 9: 39 rows
        ws.prepare_fused_lag_moments(y[:39], mask, 0, tuple(range(1, 11)))
    with pytest.raises(TypeError, match="float32"):
        ws.prepare_cross_lagged_sums(torch.zeros((10, 2), dtype=torch.float64),
                                    torch.zeros((12, 2), dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ws.prepare_cross_lagged_sums(torch.zeros((2, 10)).T, torch.zeros((12, 2)), 2)
    with pytest.raises(ValueError, match="shape"):
        ws.prepare_cross_lagged_sums(torch.zeros((10, 2)), torch.zeros((11, 2)), 2)
    p = _launch.new_params(y, 30)
    cos = torch.zeros((16, 9))
    for _ in range(_build.MAX_WELCH):
        _launch.add_welch(p, cos, cos, None, 1, 1, 16, 1, y.device)
    with pytest.raises(ValueError, match="at most 4 Welch members"):
        _launch.add_welch(p, cos, cos, None, 1, 1, 16, 1, y.device)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        ws.cross_lagged_sums(torch.zeros((4, 2), device="meta"), torch.zeros((4, 2)), 1)


def test_struct_mirrors_have_the_c_layout():
    """The ctypes mirrors of PlanParams / WelchMember, laid out as the C
    compiler lays out csrc/stats_tiles.cuh on x86-64 (checked against the
    built library at load time on the card)."""
    import ctypes

    assert ctypes.sizeof(_build.WelchMember) == 80
    assert _build.PlanParams.welch.offset % 8 == 0
    assert ctypes.sizeof(_build.PlanParams) == _build.PlanParams.detrend.offset + 8


def test_new_struct_mirrors_have_the_c_layout():
    """MomentParams (window_stats.cu), BandParams (banded_matvec.cu) and
    SwaParams (swa_attention.cu): the pointers first, then ints (and the
    float scale), padded to 8 bytes."""
    import ctypes

    assert ctypes.sizeof(_build.MomentParams) == 2 * 8 + 6 * 4
    assert ctypes.sizeof(_build.BandParams) == 3 * 8 + 10 * 4
    assert ctypes.sizeof(_build.SwaParams) == 4 * 8 + 8 * 4 + 4 + 4
    assert _build.SwaParams.scale.offset == 4 * 8 + 8 * 4
    names = {n for n, _ in _build.STRUCT_SIZES}
    assert names == {"rt_plan_params_size", "rt_welch_member_size", "rt_moment_params_size",
                     "rt_band_params_size", "rt_swa_params_size"}


def test_kernels_are_registered_with_counters():
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts

    assert set(KERNELS) == {"cross_window_stats", "fused_lag_moments", "segment_dft_power",
                            "fused_plan_megakernel", "window_moments", "segment_csd",
                            "banded_matvec", "swa_attention"}
    reset_launch_counts()
    ws.masked_lagged_sums(torch.zeros((10, 2)), torch.ones(8, dtype=torch.bool), 2)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU runs plain versions
