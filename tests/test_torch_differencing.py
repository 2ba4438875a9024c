"""The port's §1.4 / §10.3 differencing, `fit_ma` (§3.3) and the paper's
VAR workload configs, held against the JAX reference.

Same seeded numpy inputs through both packages on the CPU, rtol 1e-4 /
atol 1e-5 unless a test says otherwise.  `integrate`'s float32 cumulative
sums lose digits as the order grows, so its tolerance is scaled as
tests/test_property_hypothesis.py:66-68 scales it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs.paper_var import PAPER_VAR_CONFIGS as JPAPER_VAR
from repro.core import differencing as jd
from repro.core.estimators import autocovariance as jautocov
from repro.core.estimators import innovation as jinno
from repro.core.overlap import OverlapSpec as JSpec
from repro.core.overlap import make_overlapping_blocks as jblocks
from repro_torch import configs as tconfigs
from repro_torch.core import OverlapSpec, differencing as td, make_overlapping_blocks
from repro_torch.core.estimators import innovation as tinno

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

RTOL, ATOL = 1e-4, 1e-5


def _walk(n, d, seed=0):
    return np.cumsum(np.random.default_rng(seed).standard_normal((n, d)), 0).astype(np.float32)


@pytest.mark.parametrize("n", [10, 57, 100])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_difference_and_integrate_match(order, n):
    x = _walk(n, 2, seed=n)
    want = jd.difference(jnp.asarray(x), order)
    got = td.difference(torch.from_numpy(x), order)
    assert got.shape == want.shape == (n - order, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # the same subtractions
    initial = np.stack([np.asarray(jd.difference(jnp.asarray(x), k))[0] for k in range(order)])
    back = td.integrate(got, torch.from_numpy(initial), order)
    jback = jd.integrate(want, jnp.asarray(initial), order)
    scale = float(np.abs(x).max()) * n ** (order - 1) + 1.0
    np.testing.assert_allclose(back.numpy(), x, rtol=RTOL, atol=ATOL * scale)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=RTOL, atol=ATOL * scale)


def test_difference_of_a_1d_series_and_order_zero():
    x = _walk(30, 1, seed=1)[:, 0]
    np.testing.assert_array_equal(td.difference(torch.from_numpy(x)).numpy(),
                                  np.asarray(jd.difference(jnp.asarray(x))))
    assert torch.equal(td.difference(torch.from_numpy(x), 0), torch.from_numpy(x))


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("n,block", [(100, 16), (64, 64), (101, 25)])
def test_difference_blocked_matches_and_equals_the_series_rows(n, block, order):
    """h_left = order: each block differences its own rows, bitwise the
    reference's and, away from the first block's padding, the rows of
    difference(x)."""
    x = _walk(n, 3, seed=n + order)
    want_blocks, _ = jblocks(jnp.asarray(x), JSpec(n=n, block_size=block, h_left=order, h_right=0))
    blocks, _ = make_overlapping_blocks(torch.from_numpy(x),
                                        OverlapSpec(n=n, block_size=block, h_left=order,
                                                    h_right=0))
    got = td.difference_blocked(blocks, order)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jd.difference_blocked(want_blocks, order)))
    assert got.shape == (blocks.shape[0], block, 3)
    rows = got.reshape(-1, 3)[order:n]  # row j: Delta^order at j - order
    assert torch.equal(rows, td.difference(torch.from_numpy(x), order))


@pytest.mark.parametrize("d,k", [(0.4, 64), (0.25, 8), (1.0, 8), (-0.3, 16), (0.4, 512)])
def test_fractional_weights_are_bitwise(d, k):
    got, want = td.fractional_diff_weights(d, k), np.asarray(jd.fractional_diff_weights(d, k))
    assert got.dtype == torch.float32 and got.shape == (k + 1,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,k,dims", [(0.4, 16, 3), (0.4, 64, 2), (0.1, 4, 1)])
def test_fractional_difference_matches(d, k, dims):
    x = _walk(300, dims, seed=k)
    want = jd.fractional_difference(jnp.asarray(x), d, k)
    got = td.fractional_difference(torch.from_numpy(x), d, k)
    assert got.shape == want.shape == (300 - k, dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fractional_difference_of_an_integer_series_is_float32():
    """The reference promotes an int32 series to float32; the weights are
    not cut to the series' dtype (they would all round to 0 or 1)."""
    x = np.random.default_rng(11).integers(-5, 5, (40, 2)).astype(np.int32)
    want = jd.fractional_difference(jnp.asarray(x), 0.4, 8)
    got = td.fractional_difference(torch.from_numpy(x), 0.4, 8)
    assert got.dtype == torch.float32 and got.shape == want.shape == (32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [5, 8])
def test_fractional_difference_of_a_short_series_is_empty(n):
    """At most ``truncation`` rows: no full support, (0, dims) of the
    result's dtype, as the reference returns."""
    x = _walk(n, 3, seed=n)
    want = jd.fractional_difference(jnp.asarray(x), 0.4, 8)
    got = td.fractional_difference(torch.from_numpy(x), 0.4, 8)
    assert got.shape == want.shape == (0, 3)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32


def test_fractional_difference_of_order_one_is_delta():
    """tests/test_system.py:80-88: d = 1 gives weights (1, -1, 0, ...)."""
    x = _walk(500, 2, seed=3)
    fd = td.fractional_difference(torch.from_numpy(x), d=1.0, truncation=8)
    np.testing.assert_allclose(fd.numpy(), td.difference(torch.from_numpy(x))[7:].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert abs(float(td.fractional_diff_weights(0.4, 512).sum())) < 0.1
    one = td.fractional_difference(torch.from_numpy(x[:, 0]), 0.4, 8)
    assert one.shape == (492, 1)


def _vma_gamma(q, d, n, lags, seed=0):
    rng = np.random.default_rng(seed)
    B = (rng.standard_normal((q, d, d)) * 0.4 / np.sqrt(d)).astype(np.float32)
    e = rng.standard_normal((n + q, d)).astype(np.float32)
    x = e[q:].copy()
    for j in range(1, q + 1):
        x += e[q - j: q - j + n] @ B[j - 1].T
    return B, np.array(jautocov(jnp.asarray(x), lags, normalization="standard"))


@pytest.mark.parametrize("q,m", [(1, 10), (2, 12), (1, None)])
def test_fit_ma_matches(q, m):
    B, gamma = _vma_gamma(q, 3, 20_000, 14, seed=q)
    jB, jsig = jinno.fit_ma(jnp.asarray(gamma), q, m)
    tB, tsig = tinno.fit_ma(torch.from_numpy(gamma), q, m)
    assert tB.shape == (q, 3, 3) and tsig.shape == (3, 3)
    np.testing.assert_allclose(tB.numpy(), np.asarray(jB), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=RTOL, atol=ATOL)
    assert float(np.abs(tB.numpy() - B).max()) < 0.05  # near the true coefficients


def test_fit_ma_refuses_a_short_recursion():
    _, gamma = _vma_gamma(1, 2, 2000, 4)
    for fit in (jinno.fit_ma, tinno.fit_ma):
        with pytest.raises(ValueError, match="must be ≥ q=3"):
            fit(jnp.asarray(gamma) if fit is jinno.fit_ma else torch.from_numpy(gamma), 3, 2)
    with pytest.raises(ValueError, match="need"):
        tinno.fit_ma(torch.from_numpy(gamma), 1, 10)


def test_paper_var_configs_equal_the_reference():
    got = tconfigs.PAPER_VAR_CONFIGS
    assert list(got) == list(JPAPER_VAR)
    for name, want in JPAPER_VAR.items():
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(tconfigs.VARWorkload)] == [
        f.name for f in dataclasses.fields(type(JPAPER_VAR["varma"]))]


def test_shape_suites_and_skip_rules_equal_the_reference():
    assert [dataclasses.asdict(s) for s in tconfigs.SHAPES] == [
        dataclasses.asdict(s) for s in jbase.SHAPES]
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES_BY_NAME.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES_BY_NAME.items()}
    for name in jlist_archs():
        for s, js in zip(tconfigs.SHAPES, jbase.SHAPES):
            assert tconfigs.cell_is_runnable(tconfigs.get_arch(name), s) == \
                jbase.cell_is_runnable(jget_arch(name), js)
