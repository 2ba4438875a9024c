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
