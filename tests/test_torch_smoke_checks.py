"""The result checks of ``chip_smoke.py``, on the CPU.

The smoke run holds the port's kernels and its main path against the plain
versions with :func:`compare`; these tests pin that each leaf is held to its
own scale, so a small error in a small leaf is not hidden by a large one.
"""
import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
