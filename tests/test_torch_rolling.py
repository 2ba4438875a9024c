"""The port's RollingStatsService against `repro.serving.rolling`.

Ports the reference's pins of the service (tests/test_streaming.py: the
batched update equals a per-series loop; lanes split across ingest shards
merge on query) onto the port's engine, a one-member `StatPlan` over the
same lag sums as the reference's ``lag_sum_engine``, with the same numpy
inputs through both.  Tolerances are the reference tests' own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimators.stats import (autocovariance, lag_sum_engine, streaming_autocovariance,
                                         streaming_mean)
from repro.core.estimators.yule_walker import streaming_yule_walker, yule_walker
from repro.serving.rolling import RollingStatsService as RefService
from repro_torch.core import plan as tplan
from repro_torch.serving import RollingStatsService

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _lag_plan(H, d, *extra):
    return tplan.StatPlan([tplan.autocovariance_request(H), *extra], d=d, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def test_batched_update_matches_per_series_loop():
    """tests/test_streaming.py:195 on the port: one batched update of B
    series equals the per-series loop, state for state and estimate for
    estimate, and equals the reference's vmapped update."""
    B, n, d, H = 6, 300, 2, 3
    xb = _data((B, n, d), 10)
    plan = _lag_plan(H, d)
    engine = plan.engine
    jeng = lag_sum_engine(H, d)

    batched = engine.init_batch(B)
    jb = jeng.init_batch(B)
    for off in range(0, n, 100):
        batched = engine.update_batch(batched, torch.from_numpy(xb[:, off: off + 100]))
        jb = jeng.update_batch(jb, jnp.asarray(xb[:, off: off + 100]))
    gamma = plan.finalize_batch((batched,))["autocovariance"]
    np.testing.assert_allclose(_np(batched.stat["lagged"]), np.asarray(jb.stat),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gamma), np.asarray(
        jax.vmap(lambda s: streaming_autocovariance(jeng, s))(jb)), rtol=1e-5, atol=1e-5)
    for i in range(B):
        st = engine.init()
        for off in range(0, n, 100):
            st = engine.update(st, torch.from_numpy(xb[i, off: off + 100]))
        for got, want in zip(batched.flatten(), st.flatten()):
            np.testing.assert_allclose(_np(got[i]), _np(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(gamma[i]), _np(plan.finalize((st,))["autocovariance"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(batched.sample_sum[i] / batched.length[i]),
                                   xb[i].mean(0), rtol=1e-5, atol=1e-5)


def test_cross_lane_merge():
    """tests/test_streaming.py:234 on the port: per-user partials split
    across two ingest lanes (t0 on the second) merge on query."""
    U, n, d, H = 4, 600, 2, 3
    xu = _data((U, n, d), 12)
    plan = _lag_plan(H, d, tplan.yule_walker_request(2))
    svc = RollingStatsService(plan.engine, num_users=U, num_shards=2)
    ref = RefService(lag_sum_engine(H, d), num_users=U, num_shards=2)
    ids = np.arange(U)
    for off in range(0, 300, 150):
        svc.ingest(ids, xu[:, off: off + 150], shard=0)
        ref.ingest(jnp.asarray(ids), jnp.asarray(xu[:, off: off + 150]), shard=0)
    for off in range(300, n, 100):
        t0 = np.full((U,), 300)
        svc.ingest(ids, xu[:, off: off + 100], shard=1, t0=t0)
        ref.ingest(jnp.asarray(ids), jnp.asarray(xu[:, off: off + 100]), shard=1,
                   t0=jnp.asarray(t0))
    assert _np(svc.lengths()).tolist() == [n] * U == np.asarray(ref.lengths()).tolist()

    got = svc.query_batch(ids, lambda eng, s: plan.finalize_batch((s,))["autocovariance"])
    want = jnp.stack([autocovariance(jnp.asarray(xu[i]), H) for i in range(U)])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(
        ref.query_batch(jnp.asarray(ids), streaming_autocovariance)), rtol=1e-5, atol=1e-5)

    A_one, _ = svc.query(2, lambda eng, s: plan.finalize((s,), cache=False)["yule_walker"])
    A_ref, _ = yule_walker(autocovariance(jnp.asarray(xu[2]), H, normalization="standard"), 2)
    np.testing.assert_allclose(_np(A_one), np.asarray(A_ref), rtol=1e-4, atol=1e-5)
    A_svc, _ = ref.query(2, streaming_yule_walker, 2)
    np.testing.assert_allclose(_np(A_one), np.asarray(A_svc), rtol=1e-4, atol=1e-5)


def test_ingest_scatters_in_place():
    """The stacked lanes are updated in place (index_copy_ / index_put_, the
    counterpart of the reference's donated buffers): every leaf keeps its
    storage across ingests, growing and eviction mode alike."""
    for kw in ({"num_shards": 2}, {"window": 64, "num_buckets": 4}):
        svc = RollingStatsService(_lag_plan(2, 3).engine, num_users=5, **kw)
        ptrs = [x.data_ptr() for x in svc.state_template()["lanes"].flatten()]
        for lo in range(0, 48, 16):
            svc.ingest(np.asarray([4, 1]), _data((2, 16, 3), lo))
        assert [x.data_ptr() for x in svc.state_template()["lanes"].flatten()] == ptrs
        assert _np(svc.lengths()).tolist() == [0, 48, 0, 0, 48]


def test_eviction_zero_length_chunk_is_a_noop():
    """tests/test_frame.py:635 on the port's service."""
    svc = RollingStatsService(_lag_plan(0, 1).engine, 1, window=16, num_buckets=4)
    ref = RefService(lag_sum_engine(0, 1), 1, window=16, num_buckets=4)
    x = np.arange(20.0, dtype=np.float32)[:, None]
    for lo in range(0, 20, 4):
        svc.ingest([0], x[None, lo: lo + 4])
        ref.ingest(jnp.asarray([0]), jnp.asarray(x[None, lo: lo + 4]))
    mean = lambda eng, s: s.sample_sum / s.length
    before = float(svc.query(0, mean)[0])
    svc.ingest([0], np.zeros((1, 0, 1), np.float32))  # cursor on a boundary
    after = float(svc.query(0, mean)[0])
    assert before == after == np.mean(np.arange(4, 20))
    assert before == float(ref.query(0, lambda eng, s: streaming_mean(s))[0])
    assert int(svc.retained_lengths()[0]) == 16 == int(ref.retained_lengths()[0])


def test_service_validation():
    engine = _lag_plan(2, 1).engine
    with pytest.raises(ValueError, match="single ingest lane"):
        RollingStatsService(engine, 4, num_shards=2, window=40)
    with pytest.raises(ValueError, match="multiple"):
        RollingStatsService(engine, 4, window=41, num_buckets=4)
    with pytest.raises(ValueError, match="only applies"):
        RollingStatsService(engine, 4, num_buckets=4)
    with pytest.raises(ValueError, match="positive"):
        RollingStatsService(engine, 0)
    svc = RollingStatsService(engine, 4)
    with pytest.raises(ValueError, match="out of range"):
        svc.export_tenant(4)
