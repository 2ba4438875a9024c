"""The result checks of ``chip_smoke.py``, on the CPU.

The smoke run holds the port's kernels and its main path against the plain
versions with :func:`compare`; these tests pin that each leaf is held to its
own scale, so a small error in a small leaf is not hidden by a large one.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _smoke()


def _moments(seed=0, d=8):
    g = torch.Generator().manual_seed(seed)
    var = torch.rand(d, generator=g) * 5 + 1
    mean = torch.randn(d, generator=g) * 1e-3
    return {"mean": mean, "var": var, "count": torch.tensor(4194241.0)}


def test_compare_accepts_rounding_sized_differences():
    want = _moments()
    got = {"mean": want["mean"] + 1e-6 * want["var"].sqrt(), "var": want["var"] * (1 + 1e-6),
           "count": want["count"].clone()}
    res = smoke.compare(got, want, 1e-4)
    assert res["ok"], res
    assert res["max_rel_err"] < 1e-5


def test_planted_errors_are_all_caught():
    caught = smoke.planted_errors(_moments(), 1e-4)
    assert caught == {"var[0]*1.01": True, "mean[0]+1e-3*std": True, "count+1": True}


@pytest.mark.parametrize("leaf", ["small", "large"])
def test_each_leaf_is_held_to_its_own_scale(leaf):
    want = {"small": torch.full((4,), 1.0), "large": torch.full((4,), 1e6)}
    got = dict(want)
    got[leaf] = want[leaf] * (1 + 1e-3)
    res = smoke.compare(got, want, 1e-4)
    assert not res["ok"] and res["bad"] == [f"/{leaf}"]


@pytest.mark.parametrize("where", [(0, 0, 1), (1, 0, 2), (1, 1, 0)])
def test_moment_sums_checked_per_window_and_moment(where):
    """A 1e-3 relative error in any one (window, moment, channel) sum is
    caught, even where another window's sums are 16x larger."""
    g = torch.Generator().manual_seed(1)
    y = torch.randn(4096, 3, generator=g)
    windows = (4, 64)
    abs_mom = torch.stack([torch.stack([y.abs().sum(0) * w, (y * y).sum(0) * w])
                           for w in windows])
    want = torch.stack([torch.stack([y.sum(0) * w, (y * y).sum(0) * w]) for w in windows])
    assert smoke.compare_moment_sums(want.clone(), want, abs_mom, 1e-4)["ok"]
    got = want.clone()
    got[where] += 1e-3 * abs_mom[where]
    res = smoke.compare_moment_sums(got, want, abs_mom, 1e-4)
    assert not res["ok"]
    moment = "sum_y" if where[1] == 0 else "sum_y2"
    assert res["bad"] == [f"/w{where[0]}/{moment}"]


def test_welch_bound_counts_an_fft_not_the_twiddle_contraction():
    """At the main path's kernel-4 shape the function is bound by its bytes."""
    nbytes = 513 * 256 * 64 * 4 + 256 * 4 + 513 * 129 * 64 * 4
    ms, by = smoke.bound_ms(nbytes, 513 * 64 * (2.5 * 256 * 8 + 3 * 256 + 3 * 129))
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / smoke.PEAK_BYTES * 1e3)


# ------------------------------------------------ kernels 5-7 checks
def test_scaled_error_is_per_entry_and_takes_complex_and_broadcast_scales():
    want = torch.tensor([[1.0 + 1.0j, 100.0 + 0.0j]])
    got = want.clone()
    got[0, 0] += 2e-4
    scale = torch.tensor([[1.0, 100.0]])
    err, rel, finite = smoke.scaled_error(got, want, scale)
    assert finite and err == pytest.approx(2e-4, rel=1e-3) and rel == pytest.approx(2e-4, rel=1e-3)
    # a leading 1 broadcasts over the rows, which are walked in chunks
    want = torch.randn(10, 3, dtype=torch.float64)
    scale = torch.ones(1, 3)
    assert smoke.scaled_error(want.clone(), want, scale, max_elems=3)[1] == 0.0
    bad = want.clone()
    bad[7, 1] = float("nan")
    assert not smoke.scaled_error(bad, want, scale, max_elems=3)[2]


@pytest.mark.parametrize("shape,scale_shape", [((6, 4), (6, 4)), ((5, 3, 2, 2), (1, 3, 2, 2))])
def test_planted_error_is_caught_at_its_own_scale(shape, scale_shape):
    g = torch.Generator().manual_seed(3)
    want = torch.randn(shape, generator=g)
    scale = torch.rand(scale_shape, generator=g) + 1e-3
    assert smoke.planted_error_caught(want.clone(), want, scale, 1e-5)


def test_new_kernel_bounds_at_the_slice_shapes():
    """The byte bounds of kernels 5-7 at the shapes the paths run."""
    n, d = 2**22, 64
    b5, f5, _ = smoke.new_kernel_work("window_moments", dict(n=n, d=d, w=1024))
    assert smoke.bound_ms(b5, f5) == (pytest.approx(b5 / smoke.PEAK_BYTES * 1e3), "bytes")
    assert 0.9 < b5 / smoke.PEAK_BYTES * 1e3 < 1.0  # 3.22 GB: 0.96 ms
    b6, f6, design6 = smoke.new_kernel_work("segment_csd", dict(S=1023, L=256, d=64))
    assert smoke.bound_ms(b6, f6)[1] == "bytes" and design6 > f6
    assert 1.30 < b6 / smoke.PEAK_BYTES * 1e3 < 1.32  # 4.32 GB written, 4.39 GB moved
    valid = 131072 * 9 - 4 * 5
    b7, f7, _ = smoke.new_kernel_work("banded_matvec",
                                      dict(m=2047, d=131072, b=4, valid_slots=valid))
    assert smoke.bound_ms(b7, f7)[1] == "bytes"
    assert 0.64 < b7 / smoke.PEAK_BYTES * 1e3 < 0.645  # 2.15 GB
    assert f7 / smoke.PEAK_FP32 * 1e3 == pytest.approx(0.0721, rel=1e-2)


def test_kernel3_bound_counts_the_distinct_entries_of_s0():
    """Kernel 3 at the chunk (66,559 rows, 64,513 valid starts of 65,536,
    windows (64, 1,024)): 17.12 MB against 0.307 GFLOP (d (d + 1) entries
    a valid start, not 2 d^2), so bytes bound it at about 0.0051 ms; the
    design's full-d^2 count is reported beside it."""
    nbytes, flops, design = smoke.lag_moments_work(65536 + 1023, 65536, 65536 - 1023, 64, 2)
    assert nbytes == pytest.approx(17.122e6, rel=1e-3)
    assert flops == pytest.approx(0.3067e9, rel=1e-3)
    assert design - flops == (65536 - 1023) * 64 * 63
    assert smoke.bound_ms(nbytes, flops) == (pytest.approx(0.005111, rel=1e-3), "bytes")
    tail = smoke.lag_moments_work(1086, 1023, 960, 64, 1)
    assert smoke.bound_ms(*tail[:2])[1] == "bytes" and tail[1] < tail[2]


@pytest.mark.parametrize("n,d,windows", [(1023, 64, (64,)), (500, 5, (64, 1024)),
                                         (300, 3, (1, 7, 300))])
def test_kernel3_library_yardstick_is_the_same_function(n, d, windows):
    """The two cuBLAS products (S(0) = a^T y over the masked head rows, the
    moment sums as the window counts times [y, y^2]) against the plain
    version, per part as chip_smoke.py holds them."""
    from repro_torch.kernels.window_stats.ref import fused_lag_moments_ref

    g = torch.Generator().manual_seed(n + d)
    y = torch.randn((n + max(windows) - 1, d), generator=g)
    mask = torch.ones(n, dtype=torch.bool)
    mask[n // 3:: 5] = False
    mask[-(n // 10):] = False
    got = smoke.lag_moments_library(*smoke.lag_moments_library_operands(y, mask, windows))
    lag, mom = fused_lag_moments_ref(y, mask, 0, windows)
    abs_mom = fused_lag_moments_ref(y.abs(), mask, 0, windows)[1]
    assert smoke.compare(got[0], lag, smoke.TOL["lag"])["ok"]
    assert smoke.compare_moment_sums(got[1], mom, abs_mom, smoke.TOL["moments"])["ok"]
    assert tuple(got[1].shape) == (len(windows), 2, d)


def test_band_gradient_bound_and_its_per_entry_check():
    """Kernel 7b's bound at the fit shape (g and x read once: the product's
    2.15 GB), and its check: d diags held per entry to sum_n |g||x| passes
    the plain version on a rounding-sized error, and fails it with one
    offset dropped, and with a non-zero off-matrix slot (whose scale is 0)."""
    valid = 131072 * 9 - 4 * 5
    shape = dict(m=2047, d=131072, b=4, valid_slots=valid)
    assert smoke.new_kernel_work("band_gradient", shape) == smoke.new_kernel_work(
        "banded_matvec", shape)
    nbytes, flops, _ = smoke.new_kernel_work("band_gradient", shape)
    assert nbytes == 2 * 2047 * 131072 * 4 + 131072 * 9 * 4
    assert smoke.bound_ms(nbytes, flops) == (pytest.approx(0.6421, rel=1e-3), "bytes")
    from repro_torch.kernels.banded_matvec.ref import band_gradient

    g = torch.Generator().manual_seed(6)
    gy, x, b = torch.randn(40, 30, generator=g), torch.randn(40, 30, generator=g), 3
    want, scale = band_gradient(gy, x, b), smoke.grad_scale(gy, x, b)
    tol = smoke.TOL_NEW["band"]
    assert smoke.scaled_error(want * (1 + 1e-7), want, scale)[1] <= tol
    dropped = want.clone()
    dropped[:, b + 1] = 0.0
    assert smoke.scaled_error(dropped, want, scale)[1] > tol
    off = want.clone()
    off[0, 0] = 1e-30  # row 0 has no neighbour at offset -b
    assert float(scale[0, 0]) == 0 and smoke.scaled_error(off, want, scale)[1] > tol


def test_band_helpers_and_the_fit_step_size():
    g = torch.Generator().manual_seed(4)
    d, b = 11, 2
    diags = torch.randn(d, 2 * b + 1, generator=g) * smoke.band_valid(d, b, "cpu")
    x = torch.randn(d, 3, generator=g)
    from repro_torch.core.estimators.spatial import banded_to_dense

    dense = banded_to_dense(diags)
    torch.testing.assert_close(torch.sparse.mm(smoke.band_csr(diags), x), dense @ x)
    assert int(smoke.band_valid(d, b, "cpu").sum()) == d * (2 * b + 1) - b * (b + 1)
    # 2 / (lambda_min + lambda_max) with the covariance between I and I / (1 - 0.45^2)
    assert smoke.A_NORM == pytest.approx(0.45)
    assert smoke.STEP_SIZE == pytest.approx(2 / (1 + 1 / (1 - 0.45**2)))


# ------------------------------------------------ kernel 8 and lm_serve checks
def test_swa_bound_at_the_prefill_layer_shape():
    """(4, 32, 8000, 80), W = 4096, bf16: 24,381,440 pairs per head, 1.00
    TFLOP, 0.41 GB -- bound by operations at 1.01 ms (989 TFLOP/s)."""
    nbytes, flops = smoke.swa_work(4, 8000, 32, 8, 80, 4096, 2)
    assert nbytes == 409_600_000
    assert flops == 4 * 80 * 24_381_440 * 4 * 32
    ms, by = smoke.bound_ms(nbytes, flops, smoke.PEAK_BF16)
    assert by == "operations" and ms == pytest.approx(1.0098, rel=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_planted_error_is_caught_at_the_row_scale(dtype):
    """An error of 2 tol of its row's max|v| in one output entry is caught;
    the chunked plain version against itself is not flagged."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked, swa_row_scale

    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 300, n, 16, generator=g).to(dtype) for n in (8, 2, 2))
    want = swa_attention_chunked(q, k, v, 70)
    scale = swa_row_scale(v, 70, 8)
    tol = smoke.SWA_TOL[dtype]
    assert smoke.scaled_error(want.clone(), want, scale)[1] == 0.0
    assert smoke.planted_error_caught(want.clone(), want, scale, tol)


def test_row_norm_errors_and_the_planted_row_error():
    want = torch.randn(2, 5, 3, 16, generator=torch.Generator().manual_seed(7))
    got = want.clone()
    assert smoke.row_norm_errors(got, want).shape == (2, 5, 3)
    assert smoke.row_norm_errors(got, want).max() == 0
    got[1, 2, 0] *= 1.001
    rows = smoke.row_norm_errors(got, want)
    assert rows[1, 2, 0] == pytest.approx(1e-3, rel=1e-4) and rows.sum() == rows[1, 2, 0]
    for tol in (1e-5, 1e-2):
        assert smoke.planted_row_error_caught(want.clone(), want, tol)


@pytest.mark.parametrize("window", [70, 200])
def test_swa_row_check_passes_rounding_and_fails_a_cut_window(window):
    """bf16 on the CPU: the chunked plain version (P rounded to bf16) against
    the dense one (P in f32) passes the row check; the same with the window
    cut by SWA_FAULT keys fails it."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked, swa_attention_ref

    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(1, 400, n, 64, generator=g).to(torch.bfloat16) for n in (8, 2, 2))
    want = swa_attention_ref(q, k, v, window)
    tol, mean_tol = smoke.SWA_ROW_TOL[torch.bfloat16], smoke.SWA_ROW_MEAN_TOL[torch.bfloat16]
    rows = smoke.row_norm_errors(swa_attention_chunked(q, k, v, window), want)
    assert rows.max() <= tol and rows[:, window - 1:].mean() <= mean_tol
    bad = smoke.row_norm_errors(swa_attention_chunked(q, k, v, window - smoke.SWA_FAULT), want)
    assert bad.max() > 5 * tol and bad[:, window - 1:].mean() > 5 * mean_tol


def test_row_rel_errors_and_the_top2_margin_rule():
    plain = torch.tensor([[[5.0, 1.0, 0.0], [2.0, 1.99, 0.0], [0.0, 3.0, 1.0]]])  # (1, 3, 3)
    # step 1's margin (0.01) is below tol * max|logit| = 0.06: undecided
    assert smoke.greedy_disagreements(plain, torch.tensor([[0, 1, 1]]), 3e-2) == (2, 0)
    assert smoke.greedy_disagreements(plain, torch.tensor([[0, 0, 1]]), 3e-2) == (2, 0)
    assert smoke.greedy_disagreements(plain, torch.tensor([[1, 0, 1]]), 3e-2) == (2, 1)
    got = plain.clone()
    got[0, 2, 1] += 0.06
    rel = smoke.row_rel_errors(got, plain)
    assert rel.shape == (1, 3) and rel[0, 2] == pytest.approx(0.02) and rel[0, 0] == 0


def test_serving_launch_pin():
    pinned = {"generate": 24, "prefill": 24, "extended_prefill": 24, "decode": 0}
    assert smoke.serve_launches_ok(pinned, 24)
    for key, bad in (("decode", 1), ("generate", 48), ("prefill", 0), ("extended_prefill", 23)):
        assert not smoke.serve_launches_ok({**pinned, key: bad}, 24)


def _ar_power(S=40, L=64, d=6, seed=0):
    """Per-segment power |rfft|^2 of AR(1) segments with phi from 0.3 to
    0.95: the high bins of the phi = 0.95 channel are hundreds of times
    fainter than its low bins, which set max|power|."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((S * L, d), generator=g, dtype=torch.float64)
    phi = torch.linspace(0.3, 0.95, d, dtype=torch.float64)
    for t in range(1, x.shape[0]):
        x[t] += phi * x[t - 1]
    segs = x.reshape(S, L, d)
    segs = segs - segs.mean(1, keepdim=True)
    return (torch.fft.rfft(segs, dim=1).abs() ** 2).float()


@pytest.mark.parametrize("per_segment", [True, False])
def test_power_is_held_per_bin_where_normwise_misses_a_faint_bin(per_segment):
    power = _ar_power()
    want = power if per_segment else power.sum(0)
    noise = 1 + 1e-6 * torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    assert smoke.power_bin_error(want * noise, want, per_segment)["ok"]
    # 15% off in the faintest high-frequency bin of the faintest channel
    scale = want.mean(0) if per_segment else want
    F = scale.shape[0]
    f = F // 2 + int(scale[F // 2:, -1].argmin())
    bad = want.clone()
    bad[..., f, -1] *= 1.15
    assert smoke.leaf_error(bad, want)[1] < smoke.TOL["psd"]  # normwise passes it
    res = smoke.power_bin_error(bad, want, per_segment)
    assert not res["ok"] and res["max_rel_err"] > 0.1


@pytest.mark.parametrize("per_segment", [True, False])
def test_planted_bin_error_lands_in_a_faint_high_bin_and_is_caught(per_segment):
    power = _ar_power()
    want = power if per_segment else power.sum(0)
    got = want * (1 + 1e-7)
    res = smoke.planted_bin_error(got, want, per_segment)
    scale = want.mean(0) if per_segment else want
    F = scale.shape[0]
    assert res["caught"] and F // 2 <= res["bin"] < F
    assert scale[res["bin"], res["channel"]] == scale[F // 2:].min()  # the faintest there
    assert res["channel"] >= 3  # one of the high-phi channels
    assert 1.5 * smoke.TOL_NEW["psd"] < res["per_bin_rel"] < 2.5 * smoke.TOL_NEW["psd"]
    assert res["normwise_rel"] < smoke.TOL["psd"] and res["bin_share_of_max"] < 1e-2


@pytest.mark.parametrize("P,n,d,H", [(1, 40, 3, 0), (5, 64, 4, 6), (3, 33, 2, 9)])
def test_store_kernel2_library_yardstick_is_the_same_function(P, n, d, H):
    """The store phase's kernel-2 yardstick (one GEMM over the unfolded
    blocks, lags stacked into the rows) computes the per-block lag sums of
    the plain version."""
    from repro_torch.kernels.window_stats import ref as wsr

    g = torch.Generator().manual_seed(P * n)
    blocks = torch.randn((P, n + H, d), generator=g)
    want = wsr.masked_lagged_sums_ref(blocks, torch.ones((P, n), dtype=torch.bool), H)
    got = smoke.lag_library_stacked(blocks[:, :n].contiguous(), blocks)
    assert got.shape == want.shape == (P, H + 1, d, d)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_store_fault_is_visible_per_block_not_in_the_total():
    """A zeroed halo row moves its own block's lag partial by far more than
    TOL["lag"], while the sum over many blocks moves by far less: the store
    phase holds the fault block by block."""
    from repro_torch.core.overlap import OverlapSpec, make_overlapping_blocks
    from repro_torch.kernels.window_stats import ref as wsr

    P, B, H, d = 64, 256, 4, 8
    x = smoke.make_series(P * B, d, 0, torch.device("cpu"))
    blocks, _ = make_overlapping_blocks(x, OverlapSpec(P * B, B, 0, H))
    ones = torch.ones((P, B), dtype=torch.bool)
    clean = wsr.masked_lagged_sums_ref(blocks, ones, H)
    faulty = blocks.clone()
    faulty[P // 2 - 1, B] = 0.0
    bad = wsr.masked_lagged_sums_ref(faulty, ones, H)
    rel, at, _ = smoke.tenant_rel(bad, clean)
    assert at == P // 2 - 1 and rel > smoke.TOL["lag"]
    total = smoke.compare(bad.sum(0), clean.sum(0), smoke.TOL["lag"])
    assert total["max_rel_err"] < rel / 10


# ---------------------------------------------------- the gateway's checks
@pytest.mark.parametrize("plant", ["finite", "inf", "nan"])
def test_nonfinite_entries_are_held_exactly(plant):
    """``compare(same_nonfinite=True)`` (forecasts, anomaly scores): the
    finite entries against their own max, each non-finite one exactly; a
    non-finite entry moved, flipped or turned finite fails, as does a finite
    error above the tolerance."""
    want = {"z": torch.tensor([[1.0, float("inf")], [2.0, float("nan")]])}
    ok = {"z": want["z"] * torch.tensor([[1 + 1e-6, 1.0], [1.0, 1.0]])}
    res = smoke.compare(ok, want, 1e-4, same_nonfinite=True)
    assert res["ok"] and res["nonfinite"] == 2, res
    bad = want["z"].clone()
    if plant == "finite":
        bad[0, 0] = 1.01
    elif plant == "inf":
        bad[0, 1] = -float("inf")
    else:
        bad[1, 1] = 3.0
    assert not smoke.compare({"z": bad}, want, 1e-4, same_nonfinite=True)["ok"]
    assert not smoke.compare(ok, want, 1e-4)["ok"]  # without the flag: non-finite fails


def test_forecast_leaf_error_and_same_bits():
    import numpy as np

    w = np.array([1.0, np.inf, np.nan, -2.0], np.float32)
    err, same, off = smoke.forecast_leaf_error(w * np.float32(1 + 1e-5), w)
    assert same and off == 2 and err < 2e-5
    assert not smoke.forecast_leaf_error(np.array([1.0, 1e30, np.nan, -2.0]), w)[1]
    assert smoke.same_bits(w, w.copy()) and not smoke.same_bits(w, w.astype(np.float64))
    assert not smoke.same_bits(np.float32(0.0), np.float32(-0.0))


def test_answers_are_stacked_and_compared_bitwise():
    import numpy as np

    a = [{"f": {"pred": np.full((2, 3), i, np.float32), "period": np.int32(i)}} for i in range(3)]
    stacked = smoke.stacked_answers(a)
    assert stacked["/f/pred"].shape == (3, 2, 3) and stacked["/f/period"].tolist() == [0, 1, 2]
    want = {"f": {"pred": stacked["/f/pred"].copy(), "period": stacked["/f/period"].copy()}}
    assert smoke.answers_equal(a, want) and smoke.answers_equal(a, [dict(x) for x in a])
    want["f"]["period"][1] = 7
    assert not smoke.answers_equal(a, want)


def test_gateway_compare_holds_diverging_residuals_by_their_fit():
    """A tenant's gateway answer against its frame: statistics by the
    session tolerances, forecasts normwise at TOL["fit"], period and valid
    exactly; a diverging member's residuals are reported, not held."""
    import numpy as np

    want = {"autocovariance": torch.ones(3, 2, 2),
            "anomaly": {"z": torch.tensor([[1.0, 2.0], [1e30, float("inf")]]),
                        "score": torch.tensor([1.0, float("inf")]),
                        "sigma": torch.eye(2), "valid": torch.tensor([True, True])}}
    got = {"autocovariance": np.ones((3, 2, 2), np.float32),
           "anomaly": {"z": np.array([[1.0, 2.0], [2e30, np.inf]], np.float32),
                       "score": np.array([1.0, np.inf], np.float32),
                       "sigma": np.eye(2, dtype=np.float32), "valid": np.array([True, True])}}
    assert not smoke.gateway_compare(got, want)["anomaly"]["ok"]
    rep = smoke.gateway_compare(got, want, diverging={"anomaly"})
    assert rep["anomaly"]["ok"] and rep["anomaly"]["unheld_worst"] > 0.4
    assert rep["autocovariance"]["ok"]
    got["anomaly"]["valid"] = np.array([False, True])
    assert not smoke.gateway_compare(got, want, diverging={"anomaly"})["anomaly"]["ok"]


def test_ma_radius_of_a_fitted_member():
    """The MA part's spectral radius from a collected frame: below 1 for an
    invertible ARMA(1, 1) process, 0 for an AR member."""
    from repro_torch import SeriesFrame

    g = torch.Generator().manual_seed(0)
    e = torch.randn(20000, 2, generator=g)
    x = torch.zeros_like(e)
    for t in range(1, x.shape[0]):
        x[t] = 0.5 * x[t - 1] + e[t] + 0.4 * e[t - 1]
    frame = SeriesFrame.from_array(x, device="cpu")
    frame.anomaly_scores("arma", p=1, q=1, m=12)
    frame.forecast(4, "ar", p=2)
    frame.collect()
    assert 0.2 < smoke.ma_radius(frame, "anomaly") < 0.7
    assert smoke.ma_radius(frame, "forecast") == 0.0


@pytest.mark.parametrize("extra", [0, 1, 3])
def test_ops_per_call_counts_each_dispatched_operator_exactly(monkeypatch, extra):
    """The auto phase's exact count of the aten operators a run dispatches:
    the same run twice gives the same counts, and each extra operator shows."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    x = torch.arange(12.0).reshape(3, 4)

    def run(more):
        y = (x * 2.0).sum(0)
        for _ in range(more):
            y = y + 1.0
        return y

    base = smoke.ops_per_call(lambda: run(0))
    again = smoke.ops_per_call(lambda: run(0))
    got = smoke.ops_per_call(lambda: run(extra))
    assert base == again and base["aten.mul.Tensor"] == 1 and base["aten.sum.dim_IntList"] == 1
    assert got.get("aten.add.Tensor", 0) - base.get("aten.add.Tensor", 0) == extra
    assert (got == base) == (extra == 0)


def test_results_bitwise_holds_nan_and_structure():
    """The mesh phase's bitwise check: NaN equal to NaN bit for bit, one
    flipped bit or another nesting caught."""
    a = {"x": torch.tensor([1.0, float("nan")]), "y": (torch.zeros(2), torch.ones(1))}
    b = {"x": a["x"].clone(), "y": (torch.zeros(2), torch.ones(1))}
    assert smoke.results_bitwise(a, b)
    b["y"][0][1] = -0.0
    assert not smoke.results_bitwise(a, b)
    assert not smoke.results_bitwise(a, {"x": a["x"], "z": a["y"]})


def _var_series(n=3000, d=3, p=2, seed=0):
    from repro_torch.timeseries import random_stable_var, simulate_var

    g = torch.Generator().manual_seed(seed)
    A = random_stable_var(g, p, d, radius=0.6, device="cpu")
    return A, simulate_var(g, A, n, device="cpu")


@pytest.mark.parametrize("p", [1, 3])
def test_hessian_step_is_two_over_the_stacked_lag_extremes(p):
    """paper_var's GD step: 2 / (m + L) of the (p d, p d) stacked-lag
    covariance; at p = 1 it is the default step's Cov(X) up to one row."""
    import numpy as np

    from repro_torch.core.estimators import optimal_step_size

    _, x = _var_series(p=p, seed=p)
    xn, n = x.numpy().astype(np.float64), x.shape[0]
    z = np.concatenate([xn[p - 1 - i: n - 1 - i] for i in range(p)], 1)
    ev = np.linalg.eigvalsh(np.cov(z, rowvar=False))
    assert smoke.hessian_step(x, p) == pytest.approx(2 / (ev[0] + ev[-1]), rel=1e-9)
    if p == 1:
        assert smoke.hessian_step(x, 1) == pytest.approx(float(optimal_step_size(x)), rel=1e-2)


def test_mle_plain_holds_the_blocked_gradient_at_its_entry_scale():
    """The float64 plain value and gradient agree with the blocked float32
    path to rounding; the scale bounds every gradient entry, and a gradient
    entry moved by 2e-4 of its scale is caught at PV_TOL."""
    from repro_torch.core.estimators.mle import ar_nll_and_grad_blocked

    A, x = _var_series()
    v, g = ar_nll_and_grad_blocked(A, torch.eye(3), x, 512)
    v64, g64, scale = smoke.mle_plain(A, x)
    assert abs(v.item() - v64.item()) <= smoke.PV_TOL * abs(v64.item())
    assert (g64.abs() <= scale + 1e-12).all()
    assert smoke.scaled_error(g, g64, scale)[1] <= smoke.PV_TOL
    assert smoke.planted_error_caught(g, g64, scale, smoke.PV_TOL)


def test_nll_fall_share_is_the_reference_tests_rule():
    """tests/test_estimators.py:139-140: a step falls when the NLL rises by
    less than 1e-6; a flat step falls, a rise of one float32 ulp at 4 does
    not."""
    trace = [4.5, 4.2, 4.0, 4.0, 4.0 - 1e-6, 4.0 - 1e-6 + 5e-7]
    assert smoke.nll_fall_share(trace) == 1.0
    assert smoke.nll_fall_share(trace + [4.0 + 4.8e-7 * 4]) == pytest.approx(5 / 6)


def test_sym_pd_rejects_asymmetry_indefiniteness_and_nan():
    m = torch.tensor([[2.0, 0.5], [0.5, 1.0]])
    assert smoke.sym_pd(m)["ok"]
    assert not smoke.sym_pd(m + torch.tensor([[0.0, 1e-3], [0.0, 0.0]]))["ok"]
    assert not smoke.sym_pd(torch.tensor([[1.0, 2.0], [2.0, 1.0]]))["ok"]
    assert not smoke.sym_pd(torch.tensor([[float("nan"), 0.0], [0.0, 1.0]]))["ok"]


def test_within_is_allclose():
    want = torch.tensor([1.0, -2.0, 1e-7])
    assert smoke.within(want + torch.tensor([1e-4, -2e-4, 9e-6]), want, 1e-4, 1e-5)[1]
    assert not smoke.within(want + torch.tensor([0.0, 0.0, 2e-5]), want, 1e-4, 1e-5)[1]


def test_fractional_plain_holds_the_port_and_catches_a_planted_error():
    from repro_torch.core.differencing import fractional_difference

    x = torch.cumsum(torch.randn((2000, 3), generator=torch.Generator().manual_seed(4)), 0)
    y = fractional_difference(x, smoke.PV_FRAC_D, smoke.PV_FRAC_K)
    y64, scale = smoke.fractional_plain(x, smoke.PV_FRAC_D, smoke.PV_FRAC_K)
    assert y.shape == y64.shape == (2000 - smoke.PV_FRAC_K, 3)
    assert smoke.scaled_error(y, y64, scale)[1] <= smoke.PV_TOL
    assert smoke.planted_error_caught(y, y64, scale, smoke.PV_TOL)


@pytest.mark.parametrize("n,block", [(1000, 128), (4096, 4096), (777, 100)])
def test_blocked_difference_rows_are_bitwise(n, block):
    x = torch.cumsum(torch.randn((n, 2), generator=torch.Generator().manual_seed(n)), 0)
    got, want = smoke.blocked_difference_rows(x, block)
    assert got.shape == want.shape == (n - 1, 2) and torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["neighbour_statistic", "neighbour_pair"])
def test_graph_plain_equals_the_partitioned_map_reduce(kernel):
    from repro_torch.core import graphs

    g = graphs.grid_graph(8, 8)
    x = torch.randn((64, 32), generator=torch.Generator().manual_seed(5))
    kern = getattr(smoke, kernel)
    got = graphs.graph_window_map_reduce(kern, x, g, graphs.make_graph_partition(g, 4, 1))
    want = smoke.graph_plain(kern, x, g)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert b.dtype == torch.float64
        assert abs(a.item() - b.item()) <= smoke.GRAPH_RTOL * abs(b.item())


def test_traffic_checks_pass_rounding_and_catch_a_changed_send_rate():
    """A closed corridor: the float32 run against float64 stays inside the
    phase's per-step rounding bound and its mass does not rise; a send rate
    moved by 1e-3 in the float64 run is caught."""
    from repro_torch.core import graphs

    steps, v = 256, 512
    nbrs = torch.from_numpy(graphs.line_graph(v).nbrs).long()
    x0 = torch.rand(v, generator=torch.Generator().manual_seed(6))

    def run(x, rate):
        out = [x]
        for _ in range(steps):
            x = graphs.traffic_dbn_step(x, nbrs, 0.0, send_rate=rate)
            out.append(x)
        return torch.stack(out)

    f32, f64 = run(x0, 0.3), run(x0.double(), 0.3)
    tol = steps * 2.0 ** -22
    assert (f32.double() - f64).abs().max().item() <= tol
    assert smoke.mass_rise(f32) <= v * 2.0 ** -22
    assert (f32.double() - run(x0.double(), 0.301)).abs().max().item() > tol
    assert smoke.GRAPH_TRAJ_TOL <= smoke.GRAPH_STEPS * 2.0 ** -22
    assert smoke.GRAPH_MASS_SLACK <= smoke.GRAPH_LINKS * 2.0 ** -22


def test_closed_corridor_from_the_phase_start_stays_inside_the_phase_limits():
    """The graphs phase's closed corridor (occupancy GRAPH_X0, GRAPH_STEPS
    steps, inflow 0) on 4,096 links, which drift as the phase's 65,536 do:
    float32 against float64 inside GRAPH_TRAJ_TOL, mass rise inside
    GRAPH_MASS_SLACK."""
    from repro_torch.core import graphs

    line = graphs.line_graph(4096)
    x0 = torch.full((4096,), smoke.GRAPH_X0)
    gen = torch.Generator().manual_seed(0)
    f32 = graphs.simulate_traffic_dbn(line, x0, smoke.GRAPH_STEPS, generator=gen,
                                      inflow_scale=0.0, device="cpu")
    f64 = graphs.simulate_traffic_dbn(line, x0.double(), smoke.GRAPH_STEPS, generator=gen,
                                      inflow_scale=0.0, device="cpu")
    assert (f32.double() - f64).abs().max().item() <= smoke.GRAPH_TRAJ_TOL
    assert smoke.mass_rise(f32) <= smoke.GRAPH_MASS_SLACK


def test_gamma_plain_check_passes_the_port_and_catches_a_planted_error():
    """varma's gamma held against the plain version at TOL["lag"]: the
    port's autocovariance passes; one entry moved by 2e-4 of max|gamma| is
    caught."""
    from repro_torch.core.estimators import autocovariance

    x = torch.randn((3000, 4), generator=torch.Generator().manual_seed(8))
    got = autocovariance(x, smoke.PV_ARMA["lags"], normalization="standard")
    assert got.shape == (smoke.PV_ARMA["lags"] + 1, 4, 4)
    assert smoke.gamma_plain_check(x, got)["ok"]
    bad = got.clone()
    bad[7, 1, 2] += 2 * smoke.TOL["lag"] * got.abs().max()
    assert not smoke.gamma_plain_check(x, bad)["ok"]


@pytest.mark.parametrize("top_k,shared,cf", [(1, 1, 1.0), (2, 2, 1.0), (1, 0, 4.0)])
def test_moe_plain_loop_holds_moe_apply_and_recounts_the_drops(top_k, shared, cf):
    """lm_moe's checks 2-3 on a reduced llama4 in float32: the loop over
    experts agrees with ``moe_apply`` to float32 rounding, the three drop
    counts agree, and the layer one slot short (or one below its fullest
    bucket when none is full) fails the dispatch check."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    base = get_arch("llama4").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, top_k=top_k, num_shared=shared, capacity_factor=cf))
    layer = moe.moe_init(torch.Generator().manual_seed(top_k), cfg, torch.float32)
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(7))
    xt = x.reshape(-1, cfg.d_model)
    cap = moe.moe_capacity(96, cfg)
    got, _ = moe.moe_apply(layer, x, cfg)
    want, idx, plain_drops = smoke.moe_plain(layer, xt, top_k, cap)
    assert smoke.row_rel_errors(got.reshape(-1, cfg.d_model), want).max().item() < 1e-5
    ridx, pos = moe.moe_route(layer, xt, cfg)[3:]
    assert torch.equal(idx, ridx)
    drops = int((pos >= cap).sum())
    assert drops == plain_drops == smoke.host_drops(idx.numpy(), cap, 4)
    assert (drops > 0) == (cf == 1.0)
    loads = torch.bincount(idx.reshape(-1), minlength=4)
    short = smoke.planted_capacity(cfg, 96, min(cap, int(loads.max())) - 1)
    bad, _ = moe.moe_apply(layer, x, short)
    assert smoke.row_rel_errors(bad.reshape(-1, cfg.d_model), want).max().item() > smoke.MOE_TOL


@pytest.mark.parametrize("t,top_k,capacity", [(32000, 1, 311), (32000, 1, 5), (96, 2, 47),
                                              (7, 1, 4)])
def test_planted_capacity_gives_the_asked_slots_by_the_static_rule(t, top_k, capacity):
    """lm_moe's planted fault: llama4's 128 experts over 4 x 8,000 tokens
    one slot short of 312, and small cases down to the rule's floor; a
    capacity below the floor min(t k, 4) has no factor and raises."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.moe import moe_capacity

    base = get_arch("llama4")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, top_k=top_k))
    assert moe_capacity(t, smoke.planted_capacity(cfg, t, capacity)) == capacity
    with pytest.raises(ValueError):
        smoke.planted_capacity(cfg, t, min(t * top_k, 4) - 1)


def test_route_differences_count_tokens_not_choices():
    a = [(torch.tensor([[0, 1], [2, 3], [1, 0]]), torch.tensor([[True, True], [True, False],
                                                                 [True, True]]))]
    b = [(torch.tensor([[0, 1], [3, 2], [1, 0]]), torch.tensor([[True, True], [True, True],
                                                                 [False, True]]))]
    assert smoke.route_differences(a, b) == {"routes_differ": 1, "kept_vs_dropped": 2}


def test_split_events_takes_ranges_from_cpu_events_and_totals_device_kernels():
    """The MoE range's device time, split by the operators called directly
    in it (a bmm inside an einsum is not an expert's), kernel 8 by its
    kernel name, the rest; annotations left out of the total."""
    from types import SimpleNamespace as E

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def op(name, parent, *us):  # an operator and the kernels it launched itself
        return E(name=name, device_type=cpu, cpu_parent=parent,
                 kernels=[E(duration=u) for u in us])

    moe = op(smoke.MOE_RANGE, None)
    einsum = op("aten::einsum", moe)
    events = [moe, einsum, op("aten::bmm", moe, 3000.0), op("aten::bmm", einsum, 400.0),
              op("aten::index", moe, 300.0), op("aten::index_put_", moe, 200.0),
              op("aten::matmul", moe, 600.0), op("aten::mul", moe, 500.0),
              op("aten::index", None, 90.0),
              E(name=smoke.MOE_RANGE, device_type=cuda, device_time_total=5100.0,
                is_user_annotation=True),
              E(name="nvjet_gemm", device_type=cuda, device_time_total=3600.0),
              E(name="gather_kernel", device_type=cuda, device_time_total=590.0),
              E(name="elementwise", device_type=cuda, device_time_total=900.0),
              E(name="void swa_bf16_kernel<128>(SwaParams)", device_type=cuda,
                device_time_total=2000.0)]
    out = smoke.split_events(events)
    assert out[smoke.MOE_RANGE] == 5.0 and out["experts_bmm"] == 3.0
    assert out["gathers_scatters"] == 0.5 and out["shared_and_router_mm"] == 0.6
    assert out["moe_other"] == pytest.approx(0.9)
    assert out["swa_bf16_kernel"] == 2.0 and out["total"] == pytest.approx(7.09)
    assert out["rest"] == pytest.approx(0.09)
    assert out["calls"] == {"experts_bmm": 1, "gathers_scatters": 2, "shared_and_router_mm": 1}


def test_moe_ranged_profile_finds_each_layers_operators_on_the_cpu():
    """A reduced llama4 prefill and decode step profiled on the CPU inside
    :func:`smoke.moe_ranged`: each MoE layer's three expert bmms, its
    gathers and scatters (two bucket-rank gathers and one scatter, the
    dispatch's scatter and gather, the combine's gather) and its router and
    shared-expert products (1 + 3) sit directly in a MOE_RANGE range; none
    outside the block."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine

    cfg = get_arch("llama4").reduced()
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    _, cache = prefill(model, {"tokens": tokens}, cfg)
    cache = ServeEngine(cfg, model, max_len=25, device="cpu")._grow_cache(cache, 2)
    want = {"experts_bmm": 3, "gathers_scatters": 6, "shared_and_router_mm": 4}
    for call in (lambda: prefill(model, {"tokens": tokens}, cfg),
                 lambda: decode_step(model, cache, {"tokens": tokens[:, -1], "pos": 24}, cfg)):
        with smoke.moe_ranged(), profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        seen = smoke.split_events(prof.events())["calls"]
        assert seen == {k: v * cfg.n_layers for k, v in want.items()}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        assert smoke.split_events(prof.events())["calls"] == dict.fromkeys(want, 0)


def test_moe_bounds_at_llama4_full_width():
    """The prefill of 4 x 8,000 tokens through 2 layers: 10.05 TFLOP of
    experts a layer (E x C = 128 x 312 slots), 24.75 TFLOP a layer in all,
    bound by operations at about 50 ms (50.95 as the sum of each operation's
    bound: lm_head's 2.07 GB read, 0.62 ms, the 0.65 GB embedding gather and
    the router added); a decode step reads every
    expert in the static-capacity formulation, about 67 GB: bytes, ~20 ms."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("llama4"), n_layers=2)
    work = smoke.moe_serve_work(cfg, 4, 8000, 8000, 312)
    assert work["experts"][1] / 2 == pytest.approx(10.05e12, rel=1e-3)
    per_layer = sum(work[k][1] for k in ("experts", "shared", "projections", "attention")) / 2
    assert per_layer == pytest.approx(24.75e12, rel=2e-3)
    pre = smoke.work_bounds(work)
    assert pre["bound_by"] == "operations" and 49.9 < pre["bound_ms"] < 50.2
    assert 50.8 < pre["sum_of_op_bounds_ms"] < 51.1
    dec = smoke.work_bounds(smoke.moe_serve_work(cfg, 4, 1, 8015, 4))
    assert dec["bound_by"] == "bytes" and 66.5 < dec["gbytes"] < 68
    assert 19.8 < dec["bound_ms"] < 20.3
    routed = smoke.work_bounds(smoke.moe_serve_work(cfg, 4, 1, 8015, 4, experts_read=4))
    assert routed["gbytes"] < 6
    # the pairs a routing kept: 25,545 of 32,000 a layer -> 6.43 TFLOP of
    # experts a layer (against 10.05 over every slot), bound about 42.8 ms
    kept = smoke.moe_serve_work(cfg, 4, 8000, 8000, 312, expert_pairs=2 * 25545)
    assert kept["experts"][1] / 2 == pytest.approx(6.427e12, rel=1e-3)
    assert {k: v for k, v in kept.items() if k != "experts"} == \
        {k: v for k, v in work.items() if k != "experts"}
    kept_bound = smoke.work_bounds(kept)
    assert kept_bound["bound_by"] == "operations" and 42.7 < kept_bound["bound_ms"] < 42.9
    assert smoke.moe_serve_work(cfg, 4, 8000, 8000, 312, expert_pairs=2 * 128 * 312) == work


# ------------------------------------------------------------ lm_mla checks
def _deepseek(layers=2, q_lora_rank=24, dtype=torch.float32, seed=0):
    """Reduced deepseek-v2 with the full model's low-rank query path."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch("deepseek-v2").reduced()
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              mla=dataclasses.replace(cfg.mla, q_lora_rank=q_lora_rank))
    return cfg, init_params(cfg, seed=seed, dtype=dtype, device="cpu")


def test_swa_bound_at_the_mla_layer_shape():
    """q/k (4, 8,000, 128, 192), v (.., 128) bf16, W = S, G = 1: 32,004,000
    causal pairs a head, 640 operations each, 10.49 TFLOP -- bound by
    operations at 10.60 ms; 5.24 GB; D = DV gives the old count."""
    nbytes, flops = smoke.swa_work(4, 8000, 128, 128, 192, 8000, 2, dv=128)
    assert nbytes == 5_242_880_000 and flops == 640 * 32_004_000 * 4 * 128
    ms, by = smoke.bound_ms(nbytes, flops, smoke.PEAK_BF16)
    assert by == "operations" and ms == pytest.approx(10.6037, rel=1e-4)
    assert smoke.swa_work(4, 8000, 32, 8, 80, 4096, 2, dv=80) == smoke.swa_work(
        4, 8000, 32, 8, 80, 4096, 2)


@pytest.mark.parametrize("layers,prefill_ms,decode_gb", [(8, 278.54, 64.91), (7, 243.73, 56.93)])
def test_mla_bounds_at_deepseek_full_width(layers, prefill_ms, decode_gb):
    """A prefill of 4 x 8,000 tokens: 34.4 TFLOP a layer (projections 9.55,
    attention 10.49, experts 11.32 over 160 x 1,500 slots, shared 3.02),
    bound by operations; a decode step reads every expert, the MLA weights
    and the latent cache: bytes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.moe import moe_capacity

    cfg = dataclasses.replace(get_arch("deepseek-v2"), n_layers=layers)
    assert moe_capacity(32000, cfg) == 1500
    work = smoke.moe_serve_work(cfg, 4, 8000, 8000, 1500)
    per_layer = {k: work[k][1] / layers / 1e12 for k in ("projections", "attention", "experts",
                                                           "shared")}
    assert per_layer == pytest.approx({"projections": 9.5504, "attention": 10.4871,
                                       "experts": 11.3246, "shared": 3.0199}, rel=1e-4)
    pre = smoke.work_bounds(work)
    assert pre["bound_by"] == "operations" and pre["bound_ms"] == pytest.approx(prefill_ms,
                                                                                rel=1e-4)
    dec = smoke.work_bounds(smoke.moe_serve_work(cfg, 4, 1, 8015, moe_capacity(4, cfg)))
    assert dec["bound_by"] == "bytes" and dec["gbytes"] == pytest.approx(decode_gb, rel=1e-3)
    # the latent cache read a step: L x 4 x 8,015 x 576 bf16
    assert smoke.mla_work(cfg, 4, 1, 8015)[1][0] == layers * 4 * 8015 * 576 * 2


def test_mla_layer_check_passes_rounding_and_fails_a_cut_window():
    """A bf16 MLA layer through the wrapper (the chunked plain version, P
    rounded to bf16) against the dense one (P in float32) passes; the same
    at half the window fails."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked, swa_attention_ref
    from repro_torch.models.attention import mla_apply

    cfg, model = _deepseek(dtype=torch.bfloat16)
    x = torch.randn(2, 96, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    pos = torch.arange(96, dtype=torch.int32)
    attn = model.layers[0].attn
    want, _ = mla_apply(attn, x, cfg, pos, attention=lambda q, k, v, w, scale: swa_attention_ref(
        q, k, v, w, scale))
    got, _ = mla_apply(attn, x, cfg, pos)
    ok = smoke.mla_layer_check(got, want)
    assert ok["ok"] and 0 < ok["row_norm_rel_err"] <= smoke.SWA_ROW_TOL[torch.bfloat16]
    bad, _ = mla_apply(attn, x, cfg, pos, attention=lambda q, k, v, w, scale:
                       swa_attention_chunked(q, k, v, w // 2, scale=scale))
    assert not smoke.mla_layer_check(bad, want)["ok"]


def _decode_runs(cfg, model, prompt=24, steps=5, seed=3):
    """The model's prefill cache grown by ``steps``, the steps' tokens, and
    the absorbed decode's logits (B, steps, V) and routes."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ServeEngine

    g = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (2, prompt), generator=g)
    tokens = torch.randint(0, cfg.vocab, (2, steps), generator=g)
    _, cache = prefill(model, {"tokens": prompts}, cfg)
    cache = ServeEngine(cfg, model, max_len=prompt + steps, dtype=model.embed.dtype,
                        device="cpu")._grow_cache(cache, 2)
    return prompts, tokens, cache, decode_step


def _steps(model, cfg, cache, tokens, prompt, decode_step, form=None, record=None, force=None):
    import contextlib

    cache = {k: v.clone() for k, v in cache.items()}
    hooks = [] if record is None else smoke.moe_routes(model, cfg, record)
    out = []
    with contextlib.ExitStack() as stack:
        if form is not None:
            stack.enter_context(form())
        if force is not None:
            stack.enter_context(smoke.forced_routes(force))
        for i in range(tokens.shape[1]):
            logits, cache = decode_step(model, cache, {"tokens": tokens[:, i], "pos": prompt + i},
                                        cfg)
            out.append(logits.float())
    for hk in hooks:
        hk.remove()
    return torch.stack(out, 1), cache


@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_non_absorbed_decode_is_the_absorbed_math(q_lora_rank):
    """In float32 the check's non-absorbed step (per-head keys and values
    from the latent) gives the absorbed step's logits within 1e-5 and writes
    the same cache; absorbed_check passes them and fails them one step
    off."""
    cfg, model = _deepseek(q_lora_rank=q_lora_rank)
    _, tokens, cache, decode_step = _decode_runs(cfg, model)
    absorbed, ca = _steps(model, cfg, cache, tokens, 24, decode_step)
    plain, cb = _steps(model, cfg, cache, tokens, 24, decode_step,
                       form=smoke.non_absorbed_decoding)
    assert smoke.row_rel_errors(absorbed, plain).max() <= 1e-5
    assert torch.equal(ca["pos"], cb["pos"])
    assert torch.allclose(ca["lat"], cb["lat"], rtol=1e-4, atol=1e-5)
    res = smoke.absorbed_check(absorbed, plain, smoke.SERVE_TOL)
    assert res["ok"] and res["fault_caught"]
    bad = smoke.absorbed_check(absorbed, torch.roll(plain, 1, dims=1), smoke.SERVE_TOL)
    assert not bad["ok"]


def test_layer0_decode_check_holds_both_forms_and_catches_a_shifted_position():
    cfg, model = _deepseek(dtype=torch.bfloat16)
    _, tokens, cache, _ = _decode_runs(cfg, model)
    layer0 = {k: v[0] for k, v in cache.items()}
    res = smoke.layer0_decode_check(model, layer0, tokens, cfg, 24)
    assert res["ok"] and res["row_norm_rel_err"] <= smoke.SWA_ROW_TOL[torch.bfloat16]
    # the steps' tokens written one position later: their rope angles move
    from repro_torch.models.attention import mla_apply

    bad, good = [], []
    c1 = {k: v.clone() for k, v in layer0.items()}
    c2 = {k: v.clone() for k, v in layer0.items()}
    for i in range(tokens.shape[1] - 1):
        h = model.layers[0].attn_norm(model.embed[tokens[:, i:i + 1]])
        good.append(mla_apply(model.layers[0].attn, h, cfg, torch.tensor([24 + i]), cache=c1,
                              pos=24 + i)[0])
        bad.append(smoke.mla_decode_non_absorbed(model.layers[0].attn, h, cfg,
                                                 torch.tensor([25 + i]), cache=c2, pos=25 + i)[0])
    assert not smoke.mla_layer_check(torch.cat(bad, 1), torch.cat(good, 1))["ok"]


def test_forced_routes_replay_bitwise_and_move_the_output_when_wrong():
    """Replaying a run's own routes gives its logits bit for bit; the routes
    of other tokens move them past the serving limit; a call beyond the
    recorded ones raises."""
    cfg, model = _deepseek()
    _, tokens, cache, decode_step = _decode_runs(cfg, model)
    routes = []
    free, _ = _steps(model, cfg, cache, tokens, 24, decode_step, record=routes)
    assert len(routes) == tokens.shape[1] * cfg.n_layers
    again, _ = _steps(model, cfg, cache, tokens, 24, decode_step, force=routes)
    assert torch.equal(again, free)
    other = [(torch.flip(idx, [0]), kept) for idx, kept in routes]  # batch rows swapped
    moved, _ = _steps(model, cfg, cache, tokens, 24, decode_step, force=other)
    assert smoke.row_rel_errors(moved, free).max() > smoke.SERVE_TOL
    with pytest.raises(StopIteration):
        _steps(model, cfg, cache, tokens, 24, decode_step, force=routes[:-1])


def test_split_events_takes_the_mla_and_moe_ranges():
    """Two ranges split by their own groups; kernel 8, launched through
    ctypes inside the MLA range's function, is counted by its name outside
    both ranges."""
    from types import SimpleNamespace as E

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def op(name, parent, *us):  # an operator and the kernels it launched itself
        return E(name=name, device_type=cpu, cpu_parent=parent,
                 kernels=[E(duration=u) for u in us])

    mla, moe = op(smoke.MLA_RANGE, None), op(smoke.MOE_RANGE, None)
    events = [mla, moe, op("aten::matmul", mla, 1500.0), op("aten::einsum", mla, 100.0),
              op("aten::rms_norm", mla, 2400.0), op("aten::bmm", moe, 2000.0),
              op("aten::add", moe, 1000.0),
              E(name="gemm", device_type=cuda, device_time_total=3600.0),
              E(name="elementwise", device_type=cuda, device_time_total=3400.0),
              E(name="void swa_bf16_kernel<192, 128>(SwaParams)", device_type=cuda,
                device_time_total=2000.0),
              E(name="embedding", device_type=cuda, device_time_total=500.0)]
    out = smoke.split_events(events, ranges={smoke.MLA_RANGE: smoke.MLA_OPS,
                                             smoke.MOE_RANGE: smoke.MOE_OPS})
    assert out["mla_projections"] == 1.6 and out["swa_bf16_kernel"] == 2.0
    assert out["mla_other"] == pytest.approx(2.4) and out["experts_bmm"] == 2.0
    assert out["moe_other"] == pytest.approx(1.0) and out["total"] == pytest.approx(9.5)
    assert out["rest"] == pytest.approx(0.5)
    assert out["calls"] == {"mla_projections": 2, "experts_bmm": 1, "gathers_scatters": 0,
                            "shared_and_router_mm": 0}
    assert smoke.range_other(smoke.MLA_RANGE) == "mla_other"
    assert smoke.range_other(smoke.MOE_RANGE) == "moe_other"


def test_mla_ranged_profile_finds_each_layers_projections_on_the_cpu():
    """A reduced deepseek prefill and decode step in the MLA and MoE ranges:
    the MLA layer's products called directly in its range -- prefill: w_dq,
    w_uq, w_dkv, w_kr, w_uk, w_uv, wo (7 matmuls; on the CPU also the
    chunked plain attention's 2 einsums, which kernel 8 replaces on the
    card); decode: w_dq, w_uq, w_dkv, w_kr, the fold through w_uk, the two
    attention einsums, w_uv and wo (9) -- and the MoE's as before."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import prefill

    cfg, model = _deepseek()
    prompts, tokens, cache, decode_step = _decode_runs(cfg, model)
    names = (smoke.MLA_RANGE, smoke.MOE_RANGE)
    ranges = {smoke.MLA_RANGE: smoke.MLA_OPS, smoke.MOE_RANGE: smoke.MOE_OPS}
    for call, mla_ops in ((lambda: prefill(model, {"tokens": prompts}, cfg), 9),
                          (lambda: decode_step(model, cache, {"tokens": tokens[:, 0], "pos": 24},
                                               cfg), 9)):
        with smoke.moe_ranged(names), profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        seen = smoke.split_events(prof.events(), ranges=ranges)["calls"]
        assert seen["mla_projections"] == mla_ops * cfg.n_layers
        assert seen["experts_bmm"] == 3 * cfg.n_layers


# ---------------------------------------------------------- lm_zamba checks
def _zamba(chunk=None, layers=None, dtype=torch.float32):
    """Reduced zamba2 (4 layers, the shared block every 3: applications at
    layers 0 and 3), its chunk and depth as asked, on the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch("zamba2").reduced()
    if chunk is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, init_params(cfg, seed=0, dtype=dtype, device="cpu")


def test_zamba_bounds_at_full_width_and_depth():
    """A prefill of 4 x 8,000 tokens through 81 layers: Mamba2 projections
    403.99 TFLOP, the shared block at its 14 applications 184.15, the
    attention 25.69 (1.835 a launch), the SSD's float32 products 14.70 over
    the sequence padded to 8,192; bound 840.0 ms by operations (620.7 of
    bf16, 219.4 of float32).  A decode step: 20.9 GB (weights 13.50, KV
    caches, SSD states read and written), bound about 6.25 ms by bytes.
    The weight bytes counted are a model's own (reduced: 438,784 B)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("zamba2")
    work = smoke.zamba_work(cfg, 4, 8000)
    tflop = {k: work[k][1] / 1e12 for k in ("mamba_projections", "shared_block", "attention",
                                            "ssd_products")}
    assert tflop == pytest.approx({"mamba_projections": 403.99, "shared_block": 184.15,
                                   "attention": 25.69, "ssd_products": 14.70}, abs=5e-3)
    launch = smoke.swa_work(4, 8000, 32, 32, 112, 8000, 2)[1]
    assert work["attention"][1] == 14 * launch
    assert work["ssd_products"][2] == smoke.PEAK_FP32 and work["shared_block"][2] == smoke.PEAK_BF16
    pre = smoke.zamba_bounds(work)
    assert pre["bound_by"] == "operations" and pre["bound_ms"] == pytest.approx(840.04, rel=1e-4)
    assert pre["op_bounds_ms"]["ssd_products"] == pytest.approx(219.38, rel=1e-4)
    dec = smoke.zamba_bounds(smoke.zamba_work(cfg, 4, 1, 8015))
    assert dec["bound_by"] == "bytes" and dec["gbytes"] == pytest.approx(20.925, rel=1e-3)
    assert dec["bound_ms"] == pytest.approx(6.246, rel=1e-3)
    red, model = _zamba(dtype=torch.bfloat16)
    w = smoke.zamba_work(red, 1, 1, 5)
    weights = (w["mamba_projections"][0] + w["shared_block"][0] + w["lm_head"][0] - red.vocab * 2
               + red.vocab * red.d_model * 2)  # lm_head's entry writes the logits too
    assert weights == sum(p.numel() * p.element_size() for p in model.parameters())


def test_ssd_recurrence_check_passes_and_catches_the_planted_unmasked_decay():
    """Reduced zamba2 at chunk 256, B = 2, S = 300 (two chunks, padded):
    the port's chunked SSD holds its recurrence well inside the limit; the
    reference's unmasked decay planted in its place gives NaN in about half
    the outputs and fails the check; the planted scores equal the port's
    wherever they are finite."""
    cfg, model = _zamba(chunk=256)
    mixer = model.mamba_layers[0].mixer
    x = torch.randn((2, 300, cfg.d_model), generator=torch.Generator().manual_seed(1))
    report, step = smoke.ssd_recurrence_check(mixer, x, cfg)
    assert report["ok"] and report["nan_share"] == 0 and report["steps"] == 300
    assert max(report["rel_err"].values()) < 1e-5
    with smoke.planted_unmasked_decay():
        fault, again = smoke.ssd_recurrence_check(mixer, x, cfg, step=step)
    assert again is step
    assert not fault["ok"] and 0.2 < fault["nan_share"] < 0.8
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(2)
    cum = -torch.rand((1, 2, 3, 8), generator=g).cumsum(-1)
    cb, dt = torch.randn((1, 2, 8, 8), generator=g), torch.rand((1, 2, 3, 8), generator=g)
    assert torch.equal(smoke.unmasked_diag_scores(cum, cb, dt), ssm._diag_scores(cum, cb, dt))


def test_zamba_launch_count_comes_to_two_at_reduced():
    """Kernel 8's pin on the hybrid: one launch per application of the
    shared block a prefill (2 at reduced(): layers 0 and 3), none in decode;
    counted here through the prefill's attention hook."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import prefill

    cfg, model = _zamba()
    calls = []

    def attention(*a, **kw):
        calls.append(a[3])
        return swa_attention_chunked(*a, **kw)

    prefill(model, {"tokens": torch.zeros((2, 40), dtype=torch.long)}, cfg, attention=attention)
    assert calls == [40, 40]
    assert smoke.zamba_launches_ok({"generate": 2, "prefill": 2, "decode": 0}, cfg)
    for bad in ({"generate": 2, "prefill": 1, "decode": 0},
                {"generate": 4, "prefill": 4, "decode": 0},
                {"generate": 2, "prefill": 2, "decode": 1}):
        assert not smoke.zamba_launches_ok(bad, cfg)
    from repro_torch.configs import get_arch

    assert smoke.zamba_launches_ok({"generate": 14, "prefill": 14, "decode": 0},
                                   get_arch("zamba2"))


def test_zamba_ranged_profile_finds_each_group_on_the_cpu():
    """A reduced zamba2 prefill and decode step in ZAMBA_OPS' ranges: each
    mixer's two projections, its SSD's products (prefill: C B^T, the scores
    times x, the chunk states, their readout; decode: the state update's
    outer product and the readout), each application's four attention
    projections and three MLP products, each called directly in its range;
    none outside the block.  :func:`smoke.zamba_groups` splits the device
    time into its six groups."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ServeEngine

    cfg, model = _zamba()
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(0))
    _, cache = prefill(model, {"tokens": tokens}, cfg)
    cache = ServeEngine(cfg, model, max_len=41, device="cpu")._grow_cache(cache, 2)
    names = tuple(smoke.ZAMBA_OPS)
    for call, ssd_ops in ((lambda: prefill(model, {"tokens": tokens}, cfg), 4),
                          (lambda: decode_step(model, cache, {"tokens": tokens[:, -1],
                                                              "pos": 40}, cfg), 2)):
        with smoke.moe_ranged(names), profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        split = smoke.split_events(prof.events(), ranges=smoke.ZAMBA_OPS)
        assert split.pop("calls") == {"mamba_projections": 2 * 4, "ssd_products": ssd_ops * 4,
                                      "attention_projections": 4 * 2,
                                      "shared_mlp_products": 3 * 2}
        groups = smoke.zamba_groups(split)
        assert set(groups) == {"projections", "ssd_products", "ssd_elementwise", "kernel8",
                               "shared_mlp", "mixer_other", "rest"}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        assert set(smoke.split_events(prof.events(), ranges=smoke.ZAMBA_OPS)[
            "calls"].values()) == {0}


def test_split_events_counts_each_kernel_once_in_nested_ranges():
    """An SSD range nested in a mixer range, each carrying an annotation
    (device time of its own that covers its children's), and a runtime
    event holding a kernel an operator holds too: every kernel is counted
    once, in the innermost range above its operator and in the group of the
    operator called directly there (a bmm inside an einsum is the
    einsum's); kernel 8 by name; the rest outside every range."""
    from types import SimpleNamespace as E

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def op(name, parent, *us):
        return E(name=name, device_type=cpu, cpu_parent=parent,
                 kernels=[E(duration=u) for u in us])

    mixer = op(smoke.ZAMBA_MIXER_RANGE, None, 9000.0)  # its annotation, never counted
    ssd = op(smoke.ZAMBA_SSD_RANGE, mixer, 5000.0)
    einsum = op("aten::einsum", ssd)
    mlp = op(smoke.ZAMBA_MLP_RANGE, None)
    mlp_matmul = op("aten::matmul", mlp)
    events = [mixer, ssd, einsum, mlp, mlp_matmul,
              op("aten::matmul", mixer, 1000.0), op("aten::mul", mixer, 200.0),
              op("aten::bmm", einsum, 700.0), op("aten::exp_", ssd, 1500.0),
              op("aten::mm", mlp_matmul, 400.0),
              op("aten::add", None, 50.0),
              op("Command Buffer Full", einsum, 700.0),  # the bmm's kernel hung again
              E(name=smoke.ZAMBA_SSD_RANGE, device_type=cuda, device_time_total=2300.0,
                is_user_annotation=True),
              E(name="gemm", device_type=cuda, device_time_total=2100.0),
              E(name="elementwise", device_type=cuda, device_time_total=1750.0),
              E(name="void swa_bf16_kernel<112, 112>(SwaParams)", device_type=cuda,
                device_time_total=300.0)]
    out = smoke.split_events(events, ranges=smoke.ZAMBA_OPS)
    assert out[smoke.ZAMBA_MIXER_RANGE] == 1.2 and out["mamba_projections"] == 1.0
    assert out["mamba2_other"] == pytest.approx(0.2)
    assert out[smoke.ZAMBA_SSD_RANGE] == 2.2 and out["ssd_products"] == 0.7
    assert out["ssd_other"] == pytest.approx(1.5)
    assert out[smoke.ZAMBA_MLP_RANGE] == 0.4 and out["shared_mlp_products"] == 0.4
    assert out["total"] == pytest.approx(4.15) and out[smoke.KERNEL8_NAME] == 0.3
    assert out["rest"] == pytest.approx(4.15 - 1.2 - 2.2 - 0.4 - 0.3)
    assert out["calls"] == {"mamba_projections": 1, "ssd_products": 1,
                            "attention_projections": 0, "shared_mlp_products": 1}
    assert out["top_kernels"][0] == ("gemm", 2.1)
    groups = smoke.zamba_groups(out)
    assert groups["projections"] == 1.0 and groups["mixer_other"] == pytest.approx(0.2)
    assert sum(groups.values()) == pytest.approx(out["total"])


@pytest.mark.parametrize("cut", [0, 8])
def test_checked_attention_holds_each_call_and_catches_a_cut_window(cut):
    """The in-situ hook on the CPU, where kernel 8's wrapper runs the plain
    version: each application's rows read 0 against the plain version; the
    window cut by 8 keys fails the layer limits."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import prefill

    cfg, model = _zamba()
    report = []
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(3))
    logits, _ = prefill(model, {"tokens": tokens}, cfg,
                        attention=smoke.checked_attention(swa_attention_chunked, report, cut))
    assert len(report) == 2 and torch.isfinite(logits).all()
    assert smoke.in_situ_ok(report) == (cut == 0)
    if cut == 0:
        assert report == [(0.0, 0.0), (0.0, 0.0)]
    assert not smoke.in_situ_ok([]) and not smoke.in_situ_ok([(0.0, 0.02)])


# ---------------------------------------------------------- lm_xlstm checks
def _xlstm(layers=None, dtype=torch.float32):
    """Reduced xlstm-125m (one mLSTM -> sLSTM pair, d_model 64, 4 heads),
    its depth as asked, on the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch("xlstm").reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, init_params(cfg, seed=0, dtype=dtype, device="cpu")


def test_xlstm_bounds_at_full_width_and_depth():
    """A prefill of 4 x 2,000 tokens through xlstm-125m's 6 pairs: bf16
    products 1.474 TFLOP (the mLSTM's projections 1.0204, the sLSTM's gate
    projection and FFN 0.4530, lm_head at the last position), the mLSTM's
    float32 chunk products 0.1356 over the sequence padded to 2,048, the
    sLSTM's recurrent products 0.0566; bound 4.359 ms by operations.  A
    decode step: 0.383 GB (the matmul weights 0.191, lm_head 0.077, the
    mLSTM's C read and written 0.113), bound 0.1144 ms by bytes.  The
    weight bytes counted are a model's own (reduced: its parameters)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("xlstm")
    work = smoke.xlstm_work(cfg, 4, 2000)
    tflop = {k: work[k][1] / 1e12 for k in work}
    assert tflop == pytest.approx({"embed": 0.0, "mlstm_projections": 1.020396,
                                   "mlstm_scan": 0.135593, "slstm_recurrence": 0.0566231,
                                   "slstm_projections": 0.452985, "norms": 0.0,
                                   "lm_head": 0.000309068}, rel=1e-4)
    assert work["mlstm_scan"][2] == work["slstm_recurrence"][2] == smoke.PEAK_FP32
    assert work["lm_head"][2] == smoke.PEAK_BF16
    pre = smoke.zamba_bounds(work)
    assert pre["bound_by"] == "operations" and pre["bound_ms"] == pytest.approx(4.35898, rel=1e-4)
    dec = smoke.zamba_bounds(smoke.xlstm_work(cfg, 4, 1))
    assert dec["bound_by"] == "bytes" and dec["gbytes"] == pytest.approx(0.383111, rel=1e-5)
    assert dec["bound_ms"] == pytest.approx(0.114362, rel=1e-4)
    m_state = smoke.xlstm_work(cfg, 4, 1)["mlstm_scan"][0]
    assert m_state == 2 * 6 * 4 * 4 * (384 * 384 + 384 + 1) * 4  # C, n, m read and written
    red, model = _xlstm(dtype=torch.bfloat16)
    w = smoke.xlstm_work(red, 1, 1)
    weights = (w["mlstm_projections"][0] + w["slstm_projections"][0] + w["norms"][0]
               + w["lm_head"][0] - red.vocab * 2 + red.vocab * red.d_model * 2
               + w["slstm_recurrence"][0] - 4 * red.n_heads * (red.d_model // red.n_heads) * 4
               * 2)  # lm_head's entry writes the logits, the recurrence's moves the states
    assert weights == sum(p.numel() * p.element_size() for p in model.parameters())


def test_mlstm_recurrence_check_passes_and_catches_the_dropped_mask():
    """Layer 0's mLSTM over B = 2, S = 150 (three chunks of 64, the last
    padded) against its recurrence: well inside the limit; with the causal
    mask on the log weights dropped the outputs read later sources and fail
    it, while the chunk-end state (which the mask does not touch) holds."""
    cfg, model = _xlstm()
    mixer = model.pairs[0].mlstm
    x = torch.randn((2, 150, cfg.d_model), generator=torch.Generator().manual_seed(1))
    report, step = smoke.mlstm_recurrence_check(mixer, x, cfg)
    assert report["ok"] and report["steps"] == 150 and report["finite"]
    assert max(report["rel_err"].values()) < 1e-5
    with smoke.planted_unmasked_log_weights():
        fault, again = smoke.mlstm_recurrence_check(mixer, x, cfg, step=step)
    assert again is step and not fault["ok"] and fault["rel_err"]["output"] > 0.1
    assert fault["rel_err"]["C_exp_m"] < 1e-5
    from repro_torch.models import xlstm

    g = torch.Generator().manual_seed(2)
    cf, li = -torch.rand((2, 3, 8), generator=g).cumsum(-1), torch.randn((2, 3, 8), generator=g)
    masked = xlstm._log_weights(cf, li)
    lower = torch.ones((8, 8), dtype=torch.bool).tril()
    assert torch.equal(masked[..., lower], smoke.unmasked_log_weights(cf, li)[..., lower])
    assert torch.isneginf(masked[..., ~lower]).all()


def test_slstm_carry_check_passes_and_catches_the_restart():
    """Layer 1's sLSTM over B = 2, S = 120 split at 50: the two segments
    equal one pass; the second restarted from the fresh state fails."""
    cfg, model = _xlstm()
    x = torch.randn((2, 120, cfg.d_model), generator=torch.Generator().manual_seed(3))
    report = smoke.slstm_carry_check(model.pairs[0].slstm, x, cfg, 50)
    assert report["ok"] and max(report["excess_over_tol"].values()) <= 1.0
    fault = smoke.slstm_carry_check(model.pairs[0].slstm, x, cfg, 50, restart=True)
    assert not fault["ok"] and fault["excess_over_tol"]["output"] > 10


def test_xlstm_teacher_forced_steps_are_the_generate_logits():
    """The teacher-forced prefill and decode steps on a generate's tokens
    give that generate's logits, bitwise, and a float32 copy of a bf16
    model computes in float32 with the same values."""
    from repro_torch.serving import ServeEngine

    cfg, model = _xlstm(layers=4)
    prompts = torch.randint(0, cfg.vocab, (2, 30), generator=torch.Generator().manual_seed(4))
    res = ServeEngine(cfg, model, max_len=36, device="cpu").generate(prompts, 5, keep_logits=True)
    forced = smoke.teacher_forced(model, cfg, prompts, torch.from_numpy(res.tokens))
    assert torch.equal(forced, res.logits)
    _, bf16 = _xlstm(layers=4, dtype=torch.bfloat16)
    f32 = smoke.float_model(bf16, cfg, torch.device("cpu"))
    assert all(p.dtype == torch.float32 for p in f32.parameters())
    assert torch.equal(f32.pairs[1].slstm.r_gates, bf16.pairs[1].slstm.r_gates.float())


def test_xlstm_ranged_profile_finds_each_group_on_the_cpu():
    """A reduced xLSTM prefill (S = 100: two chunks) and decode step in
    XLSTM_OPS' ranges: each mLSTM's four projections, each chunk's six
    products (a decode step's one readout), each sLSTM step's recurrent
    baddbmm, the sLSTM's gate projection and two FFN products, lm_head;
    none outside the block.  :func:`smoke.xlstm_groups` splits the device
    time into its eight groups."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill

    cfg, model = _xlstm()
    tokens = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator().manual_seed(5))
    _, cache = prefill(model, {"tokens": tokens}, cfg)
    names = tuple(smoke.XLSTM_OPS)
    for call, want in ((lambda: prefill(model, {"tokens": tokens}, cfg),
                        {"scan_products": 12, "step_products": 0, "recurrent_products": 100}),
                       (lambda: decode_step(model, cache, {"tokens": tokens[:, -1], "pos": 100},
                                            cfg),
                        {"scan_products": 0, "step_products": 1, "recurrent_products": 1})):
        with smoke.moe_ranged(names), profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        split = smoke.split_events(prof.events(), ranges=smoke.XLSTM_OPS)
        assert split.pop("calls") == {"mlstm_projections": 4, "slstm_gate_projection": 1,
                                      "ffn_products": 2, "head_products": 1, **want}
        groups = smoke.xlstm_groups(split)
        assert set(groups) == {"mlstm_projections", "mlstm_scan", "slstm_recurrence",
                               "slstm_gate_projection", "slstm_ffn", "norms_and_gates",
                               "lm_head", "rest"}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        assert set(smoke.split_events(prof.events(), ranges=smoke.XLSTM_OPS)[
            "calls"].values()) == {0}


def _encdec(family="whisper", dtype=torch.float32):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch(family).reduced()
    return cfg, init_params(cfg, seed=0, dtype=dtype, device="cpu")


def _frontend(cfg, b=2, n=20, s=12):
    g = torch.Generator().manual_seed(3)
    key = "frames" if cfg.family == "encdec" else "patch_embeds"
    n = n if cfg.family == "encdec" else cfg.n_patches
    return ({key: torch.randn((b, n, cfg.d_model), generator=g)},
            torch.randint(0, cfg.vocab, (b, s), generator=g))


def test_whisper_bounds_at_full_width_and_depth():
    """32 clips of 1,500 frames, 192 prompt tokens: the encoder alone 3.30
    TFLOP (projections 0.604, MLP 1.812, every (query, key) pair 0.885),
    bound 3.337 ms by operations; the prefill adds the cross K/V 0.302, the
    decoder's projections 0.116 and MLP 0.232, its causal self-attention
    0.0073 (six kernel 8 launches) and cross-attention 0.113: 4.073 TFLOP,
    4.118 ms.  A decode step against 255 cached positions: 0.803 GB (the
    cross cache 0.590), bound 0.2398 ms by bytes.  The weight bytes counted
    are a model's own (reduced: its parameters)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("whisper")
    work = smoke.whisper_work(cfg, 32, 1500, 192)
    tflop = {k: w[1] / 1e12 for k, w in work.items() if w[1]}
    assert tflop == pytest.approx({
        "encoder_projections": 0.603980, "encoder_mlp": 1.811939, "encoder_attention": 0.884736,
        "decoder_projections": 0.115964, "cross_kv": 0.301990, "decoder_mlp": 0.231928,
        "self_attention": 0.007285, "cross_attention": 0.113246, "lm_head": 0.0016995}, rel=1e-4)
    assert work["self_attention"][1] == 6 * smoke.swa_work(32, 192, 8, 8, 64, 192, 2)[1]
    enc = smoke.zamba_bounds(smoke.whisper_work(cfg, 32, 1500))
    assert enc["bound_by"] == "operations" and enc["bound_ms"] == pytest.approx(3.33737, rel=1e-4)
    pre = smoke.zamba_bounds(work)
    assert pre["bound_by"] == "operations" and pre["bound_ms"] == pytest.approx(4.11807, rel=1e-4)
    dec = smoke.zamba_bounds(smoke.whisper_work(cfg, 32, 1500, 1, 255))
    assert dec["bound_by"] == "bytes" and dec["gbytes"] == pytest.approx(0.803231, rel=1e-5)
    assert dec["bound_ms"] == pytest.approx(0.239771, rel=1e-4)
    assert dec.keys() == pre.keys() and "cross_kv" not in smoke.whisper_work(cfg, 32, 1500, 1, 255)
    red, model = _encdec(dtype=torch.bfloat16)
    b, f, s = 1, 7, 5
    w = smoke.whisper_work(red, b, f, s)
    kv_row = red.n_kv_heads * red.resolved_head_dim * 2 * 2
    weights = (sum(x[0] for x in w.values()) - w["frames"][0] - w["embed"][0]
               - red.n_layers * b * (s + f) * kv_row  # the self and cross caches written
               - b * red.vocab * 2 + red.vocab * red.d_model * 2)  # logits out, embedding in
    assert weights == sum(p.numel() * p.element_size() for p in model.parameters())


def test_llava_bounds_at_full_width():
    """4 requests of 2,880 patches and 512 tokens through 60 layers: MLP
    717.05 TFLOP, projections 191.21, the causal attention 39.60 (60 kernel
    8 launches), patch_proj 1.18: bound 959.60 ms by operations.  A decode
    step against 3,423 cached positions: 71.23 GB (weights 68.88, the cache
    3.37), bound 21.26 ms by bytes.  The weight bytes counted are a model's
    own (reduced: its parameters)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("llava")
    work = smoke.llava_work(cfg, 4, 512)
    tflop = {k: w[1] / 1e12 for k, w in work.items() if w[1]}
    assert tflop == pytest.approx({"patch_proj": 1.18380, "projections": 191.2123,
                                   "mlp": 717.0451, "attention": 39.59852,
                                   "lm_head": 0.003670}, rel=1e-4)
    assert work["attention"][1] == 60 * smoke.swa_work(4, 3392, 56, 8, 128, 3392, 2)[1]
    pre = smoke.zamba_bounds(work)
    assert pre["bound_by"] == "operations" and pre["bound_ms"] == pytest.approx(959.598, rel=1e-5)
    dec = smoke.zamba_bounds(smoke.llava_work(cfg, 4, 512, 3423))
    assert dec["bound_by"] == "bytes" and dec["gbytes"] == pytest.approx(71.2259, rel=1e-5)
    assert dec["bound_ms"] == pytest.approx(21.2615, rel=1e-4)
    red, model = _encdec("llava", dtype=torch.bfloat16)
    b, s = 1, 5
    w = smoke.llava_work(red, b, s)
    kv_row = red.n_kv_heads * red.resolved_head_dim * 2 * 2
    weights = (sum(x[0] for x in w.values()) - w["embed"][0]
               - b * red.n_patches * red.d_model * 2  # the patch embeddings read
               - red.n_layers * b * (red.n_patches + s) * kv_row  # the cache written
               - b * red.vocab * 2 + red.vocab * red.d_model * 2)
    assert weights == sum(p.numel() * p.element_size() for p in model.parameters())


@pytest.mark.parametrize("family", ["whisper", "llava"])
def test_teacher_forced_steps_are_the_generate_logits(family):
    """On the frontend families too: the teacher-forced prefill (frames or
    patch embeddings as ``extra``) and decode steps from where the generate
    starts (after the VLM's patches) give that generate's logits, bitwise."""
    from repro_torch.serving import ServeEngine

    cfg, model = _encdec(family)
    extra, prompts = _frontend(cfg)
    eng = ServeEngine(cfg, model, max_len=40, device="cpu")
    res = eng.generate(prompts, 5, extra=extra, keep_logits=True)
    forced = smoke.teacher_forced(model, cfg, prompts, torch.from_numpy(res.tokens), extra,
                                  grow=eng._grow_cache)
    assert torch.equal(forced, res.logits)


def test_whisper_planted_faults_fail_the_float32_limit():
    """Check 3's causal encoder and check 4's cross K/V padded by 64 zero
    positions each move the float32 logits far beyond WHISPER_LOGITS_TOL of
    the row max; the pad leaves the prefill's row (its cache is grown
    after) and moves every decode step; outside the blocks the model is
    itself again."""
    from repro_torch.serving import ServeEngine

    cfg, model = _encdec()
    extra, prompts = _frontend(cfg)
    eng = ServeEngine(cfg, model, max_len=40, device="cpu")
    tokens = torch.from_numpy(eng.generate(prompts, 4, extra=extra).tokens)
    want = smoke.teacher_forced(model, cfg, prompts, tokens, extra, grow=eng._grow_cache)
    with smoke.planted_causal_encoder():
        causal = smoke.teacher_forced(model, cfg, prompts, tokens, extra, grow=eng._grow_cache)
    assert smoke.row_rel_errors(causal, want).min() > 100 * smoke.WHISPER_LOGITS_TOL
    padded = smoke.teacher_forced(model, cfg, prompts, tokens, extra,
                                  grow=smoke.padded_cross(eng._grow_cache, smoke.WHISPER_CROSS_PAD))
    rows = smoke.row_rel_errors(padded, want)
    assert rows[:, 0].max() == 0 and rows[:, 1:].min() > 100 * smoke.WHISPER_LOGITS_TOL
    again = smoke.teacher_forced(model, cfg, prompts, tokens, extra, grow=eng._grow_cache)
    assert torch.equal(again, want)


def test_prefill_launches_pin():
    """Kernel 8 once a layer in each prefill and nowhere else counted; any
    other kernel in the generate fails the pin."""
    good = {"swa_attention": {"generate": 6, "encode": 0, "cross_attention": 0, "prefill": 6,
                              "decode": 0}, "other_kernels": {"segment_csd": 0}}
    assert smoke.prefill_launches_ok(good, 6)
    assert not smoke.prefill_launches_ok(good, 60)
    for call, n in (("encode", 1), ("cross_attention", 6), ("decode", 1), ("prefill", 12),
                    ("generate", 5)):
        assert not smoke.prefill_launches_ok(
            {**good, "swa_attention": {**good["swa_attention"], call: n}}, 6)
    assert not smoke.prefill_launches_ok({**good, "other_kernels": {"segment_csd": 1}}, 6)


def test_whisper_ranged_profile_finds_each_group_on_the_cpu():
    """A reduced whisper prefill and decode step in WHISPER_OPS' ranges:
    each self-attention's four projections (the encoder's and the
    decoder's), each cross-attention's q and out projections, each decoder
    layer's cross K/V projections (prefill only), each MLP's three
    products, the encoder's attention products apart from the
    cross-attention's by caller; none outside the block."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ServeEngine

    cfg, model = _encdec()
    extra, prompts = _frontend(cfg)
    batch = {"tokens": prompts, **extra}
    _, cache = prefill(model, batch, cfg)
    cache = ServeEngine(cfg, model, max_len=20, device="cpu")._grow_cache(cache, 2)
    names = tuple(smoke.WHISPER_OPS)
    step = {"tokens": prompts[:, -1], "pos": 12}
    for call, want in (
            (lambda: prefill(model, batch, cfg),
             {"self_projections": 16, "cross_projections": 4, "cross_kv_projections": 4,
              "mlp_products": 12, "encoder_attention_products": 4,
              "cross_attention_products": 4}),
            (lambda: decode_step(model, cache, step, cfg),
             {"self_projections": 8, "cross_projections": 4, "cross_kv_projections": 0,
              "mlp_products": 6, "encoder_attention_products": 0,
              "cross_attention_products": 4})):
        with smoke.whisper_ranged(names), profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        split = smoke.split_events(prof.events(), ranges=smoke.WHISPER_OPS)
        assert split.pop("calls") == want
        assert set(smoke.whisper_groups(split)) == {
            "encoder_attention", "cross_attention", "kernel8", "projections", "mlp",
            "self_attention_other", "rest"}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        assert set(smoke.split_events(prof.events(), ranges=smoke.WHISPER_OPS)[
            "calls"].values()) == {0}


def test_llava_ranged_profile_finds_each_group_on_the_cpu():
    """A reduced llava prefill in LLAVA_OPS' ranges: each layer's four
    attention projections and three MLP products."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import prefill

    cfg, model = _encdec("llava")
    extra, prompts = _frontend(cfg)
    with smoke.moe_ranged(tuple(smoke.LLAVA_OPS)), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        prefill(model, {"tokens": prompts, **extra}, cfg)
    split = smoke.split_events(prof.events(), ranges=smoke.LLAVA_OPS)
    assert split.pop("calls") == {"attention_projections": 8, "mlp_products": 6}
    assert set(smoke.llava_groups(split)) == {"projections", "kernel8", "attention_other",
                                              "mlp", "rest"}


# ------------------------------------------------------------- lm_train --
def test_train_work_is_the_hand_count():
    """qwen3-0.6b: 28 layers of (2 x 1,024 x 2,048 + 2 x 1,024 x 1,024 +
    3 x 1,024 x 3,072) = 15,728,640 matmul weights, plus lm_head 1,024 x
    151,936; 6 x weights x tokens, plus 28 x n x 6 x S^2 x 16 x 128 for the
    causal attention; 1,048,576 tokens give 5.227 PFLOP, 5.285 s at 989
    TFLOP/s."""
    from repro_torch import get_arch

    cfg = get_arch("qwen3")
    w = smoke.train_work(cfg, 256, 4096)
    weights = 28 * (2 * 1024 * 2048 + 2 * 1024 * 1024 + 3 * 1024 * 3072) + 1024 * 151936
    assert w["matmul_weights"] == weights == 595_984_384
    assert w["tokens"] == 1_048_576
    assert w["matmul_flops"] == 6 * weights * 1_048_576
    assert w["attention_flops"] == 28 * 256 * 6 * 4096 ** 2 * 16 * 128
    assert w["flops"] == 5_227_353_156_354_048
    assert w["bound_by"] == "operations"
    assert w["bound_ms"] == pytest.approx(w["flops"] / 989e12 * 1e3, rel=1e-12)
    assert w["bound_ms"] == pytest.approx(5285.49, abs=0.01)
    model_params = w["params"]
    from repro_torch.models import init_params

    reduced = cfg.reduced()
    m = init_params(reduced, device="cpu", dtype=torch.float32)
    assert smoke.train_work(reduced, 1, 8)["params"] == sum(p.numel() for p in m.parameters())
    assert model_params == 751_632_384


def _train_fixture(dtype=torch.float32):
    from repro_torch import get_arch
    from repro_torch.models import init_params, trainable

    cfg = get_arch("qwen3").reduced()
    model = trainable(init_params(cfg, seed=0, dtype=dtype, device="cpu"))
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (4, 40)))
    return cfg, model, {"tokens": tok, "labels": tok}


def test_train_fd_check_holds_and_catches_the_detached_remat():
    cfg, model, batch = _train_fixture()
    res = smoke.fd_check(model, {k: v[:1] for k, v in batch.items()}, cfg, seed=0)
    assert res["ok"] and res["fault"]["caught"], res
    assert res["floor"] > 0 and len(res["directions"]) == smoke.TRAIN_FD_DIRS
    # the weights are put back bitwise
    cfg2, fresh, _ = _train_fixture()
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)


def test_train_accum_check_holds_and_catches_bf16_buffers():
    cfg, model, batch = _train_fixture()
    res = smoke.accum_check(model, {k: v[:2] for k, v in batch.items()}, cfg)
    assert res["ok"] and res["fault"]["caught"], res
    assert res["fault"]["err"] > 100 * res["tol"]


def test_train_serve_check_holds_and_catches_noncausal_training():
    cfg, model, batch = _train_fixture(torch.bfloat16)
    res = smoke.train_serve_check(model, batch, cfg)
    assert res["ok"] and res["fault"]["caught"], res
    assert res["floor"] > 0 and res["same_attention_rel_err"] <= smoke.TRAIN_SAME_TOL


def test_train_restart_is_bitwise_and_step_zero_is_caught(tmp_path):
    """The phase's restart on the CPU: a checkpoint after step 0 restored
    into a model of another seed, steps 1-2 again: bitwise; the
    optimizer's step restored as 0 moves step 1's parameters elsewhere."""
    import concurrent.futures

    from repro_torch import get_arch
    from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree
    from repro_torch.data.tokens import SyntheticTokenPipeline
    from repro_torch.models import init_params, trainable
    from repro_torch.training import (adamw_init, cosine_schedule, make_train_step,
                                      named_parameters)

    cfg = get_arch("qwen3").reduced()
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=24, global_batch=4, seed=0)
    step_fn = make_train_step(cfg, lr_fn=cosine_schedule(3e-4, warmup=1, total=3), accum=2,
                              fused_loss=True)
    dev = torch.device("cpu")

    def model_of(seed):
        m = trainable(init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cpu"))
        return m, named_parameters(m)

    model, named = model_of(0)
    mgr = CheckpointManager(str(tmp_path))
    kept = {}

    def after(s, opt):
        if s == 0:
            mgr.save({"params": {k: p.detach().clone() for k, p in named.items()}, "opt": opt}, 0)
        if s == 1:
            kept.update({k: p.detach().clone() for k, p in named.items()})

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        opt, records = smoke.train_steps(model, adamw_init(named), step_fn,
                                         smoke.timed_batches(pipe, 0, pool, []), range(3), dev,
                                         after)
        mgr.close()

        def restored(seed, zero=False):
            m2, n2 = model_of(seed)
            state = restore_pytree({"params": {k: p.detach() for k, p in n2.items()},
                                    "opt": adamw_init(n2)}, str(tmp_path), 0)
            with torch.no_grad():
                for k, p in n2.items():
                    p.copy_(state["params"][k])
            o = state["opt"]
            return m2, n2, (smoke.optimizer_step_as_zero(o) if zero else o)

        m2, n2, o2 = restored(1)
        o2, again = smoke.train_steps(m2, o2, step_fn, smoke.timed_batches(pipe, 1, pool, []),
                                      [1, 2], dev)
        m3, n3, o3 = restored(2, zero=True)
        smoke.train_steps(m3, o3, step_fn, smoke.timed_batches(pipe, 1, pool, []), [1], dev)
    assert [r["loss"] for r in again] == [r["loss"] for r in records[1:]]
    for k in named:
        assert torch.equal(n2[k], named[k]) and torch.equal(o2.m[k], opt.m[k])
        assert torch.equal(o2.v[k], opt.v[k])
    assert not all(torch.equal(p, kept[k]) for k, p in n3.items())
    assert records[0]["lr"] == 0.0 and records[1]["lr"] > 0
    assert smoke.finite_ok([r["loss"] for r in records])
    assert not smoke.finite_ok([1.0, float("nan")])


class _Ev:
    def __init__(self, name, shapes=(), parent=None):
        self.name, self.input_shapes, self.cpu_parent = name, list(shapes), parent


def test_train_group_classifies_the_profile_operators():
    opt = _Ev(smoke.TRAIN_OPT_RANGE)
    v = 151936
    cases = [(_Ev("aten::mul", [[1024, 2048]], _Ev("x", parent=opt)), "optimizer"),
             (_Ev("aten::mm", [[2048, 1024], [1024, v]]), "cross_entropy"),
             (_Ev("aten::mm", [[1024, 2048], [2048, v]]), "cross_entropy"),
             (_Ev("aten::logsumexp", [[8, 256, v]]), "cross_entropy"),
             (_Ev("aten::bmm", [[256, 512, 128], [256, 128, 4096]]), "attention_products"),
             (_Ev("aten::mm", [[32768, 1024], [1024, 3072]]), "projection_and_mlp_gemms"),
             (_Ev("aten::addmm", [[3072], [32768, 1024], [1024, 3072]]),
              "projection_and_mlp_gemms"),
             (_Ev("aten::_softmax", [[8, 8, 2, 512, 4096], [], []]), "attention_elementwise"),
             (_Ev("aten::index_put_", [[v, 1024], [], [32768, 1024]]), "other"),
             (_Ev("aten::mul", [[8, 4096, 16, 128], [4096, 1, 64]]), "other")]
    for ev, group in cases:
        assert smoke.train_group(ev, v) == group, (ev.name, ev.input_shapes)
    assert set(smoke.TRAIN_GROUPS) >= {g for _, g in cases}
