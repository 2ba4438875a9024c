"""The port's fused plan against `repro.core.plan.analyze(..., backend="jnp")`.

The slice's six members, scaled down: autocovariance(5), yule_walker(3),
arma(1, 1), moments(8), moments(40), welch(32, 16) over n = 3000, d = 3.
One JAX reference (ragged chunks of 700) serves every placement and backend
of the port: the plan's result does not depend on how the series is cut.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro_torch.core import plan as tplan
from repro_torch.core.backend import TorchBackend
from repro_torch.core.frame import SeriesFrame

N, D = 3000, 3


def _series(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    x = np.zeros_like(e)
    for t in range(1, n):
        x[t] = 0.6 * x[t - 1] + e[t]
    return x + np.sin(2 * np.pi * np.arange(n) / 50)[:, None].astype(np.float32)


def _requests(m):
    return [m.autocovariance_request(5), m.yule_walker_request(3), m.arma_request(1, 1),
            m.moments_request(8), m.moments_request(40),
            m.welch_request(nperseg=32, overlap=16)]


TOLS = {"autocovariance": dict(rtol=1e-5, atol=1e-4), "yule_walker": dict(rtol=1e-4, atol=1e-5),
        "arma": dict(rtol=1e-4, atol=1e-4), "moments": dict(rtol=1e-5, atol=1e-6),
        "welch": dict(rtol=1e-4, atol=1e-5)}


def _assert_member(name, got, want):
    tol = TOLS[name.split("_2")[0]]
    if isinstance(want, dict):
        for key in want:
            np.testing.assert_allclose(got[key].cpu().numpy(), np.asarray(want[key]), **tol)
    else:
        for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
            np.testing.assert_allclose(g.cpu().numpy(), np.asarray(w), **tol)


@pytest.fixture(scope="module")
def x():
    return _series()


@pytest.fixture(scope="module")
def reference(x):
    return jplan.analyze(jnp.asarray(x), _requests(jplan), backend="jnp", chunk_size=700)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("chunk_size", [None, 271, 1000])
def test_analyze_matches_reference(x, reference, backend, chunk_size):
    got = tplan.analyze(x, _requests(tplan), backend=backend, chunk_size=chunk_size,
                        device="cpu")
    assert set(got) == set(reference)
    for name in reference:
        _assert_member(name, got[name], reference[name])


@pytest.mark.parametrize("placement", ["array", "chunks"])
def test_append_after_collect_matches_reference(x, reference, placement):
    head, rest = x[:2200], x[2200:]
    if placement == "array":
        frame = SeriesFrame.from_array(head, device="cpu")
    else:
        frame = SeriesFrame.from_chunks([head[i: i + 333] for i in range(0, 2200, 333)],
                                        device="cpu")
    for req in _requests(tplan):
        frame._defer(req)
    first = frame.collect()
    assert frame.collect()["autocovariance"] is not None  # memoized re-read
    frame.append(rest[:500]).append(rest[500:])
    second = frame.collect()
    assert frame.length == N
    assert not torch.equal(first["autocovariance"], second["autocovariance"])
    for name in reference:
        _assert_member(name, second[name], reference[name])


@pytest.mark.parametrize("members,names", [
    (lambda m: [m.autocovariance_request(5)], ["autocovariance"]),
    (lambda m: [m.moments_request(8), m.moments_request(40)], ["moments", "moments_2"]),
    (lambda m: [m.welch_request(nperseg=32, overlap=16)], ["welch"]),
])
def test_single_family_plans_match_reference(x, reference, members, names):
    plan = tplan.StatPlan(members(tplan), d=D, device="cpu")
    assert not plan.groups[0]._use_megakernel
    got = tplan.analyze(x, members(tplan), chunk_size=271, device="cpu")
    for name in names:
        _assert_member(name, got[name], reference[name])


class CountingBackend:
    """Wraps a backend and records every primitive call."""

    def __init__(self, inner):
        self.inner = inner
        self.name = "counting"
        self.calls = []

    def __getattr__(self, item):
        fn = getattr(self.inner, item)

        def call(*args, **kwargs):
            self.calls.append(item)
            return fn(*args, **kwargs)

        return call


def test_three_family_chunk_kernel_is_one_fused_call():
    """The counterpart of tests/test_megakernel.py:108-152: a plan with lag,
    moment and Welch members serves each chunk-kernel call with exactly ONE
    backend call, ``fused_plan_update``."""
    be = CountingBackend(TorchBackend())
    plan = tplan.StatPlan(_requests(tplan), d=D, backend=be, device="cpu")
    (group,) = plan.groups
    assert group._use_megakernel
    y = torch.randn(256 + group.window - 1, D)
    out = group._fused_chunk_kernel(y, torch.ones(256, dtype=torch.bool), torch.tensor(0))
    assert be.calls == ["fused_plan_update"]
    assert set(out) == {"lagged", "moments", "welch"}

    be.calls.clear()
    chunks = [torch.randn(300, D) for _ in range(5)]
    states = plan.consume(plan.init(), chunks)
    assert be.calls == ["fused_plan_update"] * (2 * len(chunks))  # chunk + merge boundary
    be.calls.clear()
    plan.finalize(states)
    assert "fused_plan_update" not in be.calls  # finalize recovers tails with the others


def test_forecast_members_wait_for_their_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tplan.forecast_request(8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tplan.anomaly_request()


def test_generic_member_through_map_reduce():
    def window_sums(y, mask):
        return (mask[:, None].float() * y[: mask.shape[0]]).sum(0)

    frame = SeriesFrame.from_array(torch.arange(40.0), device="cpu")
    handle = frame.map_reduce(window_sums, h_right=0, name="s")
    frame.moments(4)
    # no finalizer: the raw stat covers starts with a full fused window (0..36)
    assert float(handle.result()[0]) == float(sum(range(37)))


def test_tiling_matches_reference():
    from repro.kernels import tiling as jt
    from repro_torch.kernels import tiling as tt

    assert tt.DEFAULT_BLOCKS == jt.DEFAULT_BLOCKS
    for n, halo in [(0, 1), (5, 0), (70, 1), (64, 0)]:
        bt = tt.clamp_block_t(32, n, 3)
        assert bt == jt.clamp_block_t(32, n, 3)
        x = np.ones((n, 2), np.float32)
        assert tuple(tt.pad_tiles(torch.from_numpy(x), bt, halo).shape) == \
            jt.pad_tiles(jnp.asarray(x), bt, halo).shape
        assert tt.pad_to_multiple(n, 8) == jt.pad_to_multiple(n, 8)
    assert tt.resolve_block("fused_plan_update", "block_t", 96) == 96
