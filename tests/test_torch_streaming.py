"""The port's streaming monoid: serial = streamed = merged, merge
commutativity, and the compensated mode's bit-identical ``stat``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimators.stats import autocovariance as jax_autocovariance
from repro_torch.core import plan as tplan
from repro_torch.core.estimators.stats import autocovariance
from repro_torch.core.mapreduce import tree_leaves

D = 2


def _x(n=900, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32))


def _plan(backend="cuda", compensated=False):
    return tplan.StatPlan([tplan.autocovariance_request(4), tplan.arma_request(1, 1),
                           tplan.moments_request(6), tplan.moments_request(20),
                           tplan.welch_request(nperseg=16, overlap=8)],
                          d=D, backend=backend, compensated=compensated, device="cpu")


def _assert_results_close(a, b, rtol=1e-5, atol=1e-5):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_serial_streamed_merged_agree(backend):
    x = _x()
    plan = _plan(backend)
    serial = plan.finalize(plan.from_chunk(x))
    cuts = [0, 7, 100, 101, 450, 900]
    streamed = plan.consume(plan.init(), [x[a:b] for a, b in zip(cuts, cuts[1:])])
    _assert_results_close(plan.finalize(streamed), serial)
    left = plan.consume(plan.init(), [x[:300], x[300:420]])
    right = plan.consume(plan.init(420), [x[420:700], x[700:]])
    _assert_results_close(plan.finalize(plan.merge(right, left)), serial)
    # serial = the reference's eager estimator on the whole series
    np.testing.assert_allclose(serial["autocovariance"].numpy(),
                               jax_autocovariance(jnp.asarray(x.numpy()), 4), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(autocovariance(x, 4).numpy(), serial["autocovariance"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_merge_is_commutative_and_neutral():
    x = _x(500, seed=1)
    engine = _plan().engine
    a = engine.from_chunk(x[:180], 0)
    b = engine.from_chunk(x[180:], 180)
    ab, ba = engine.merge(a, b), engine.merge(b, a)
    for u, v in zip(ab.flatten(), ba.flatten()):
        assert torch.equal(u, v)
    for u, v in zip(engine.merge(a, engine.init(77)).flatten(), a.flatten()):
        assert torch.equal(u, v)


def test_compensated_stat_is_bit_identical_to_plain():
    x = _x(1200, seed=2) * 1e3 + 5e3  # large offset: rounding is visible
    chunks = [x[i: i + 97] for i in range(0, 1200, 97)]
    plain, comp = _plan(), _plan(compensated=True)
    s_plain = plain.consume(plain.init(), chunks)[0]
    s_comp = comp.consume(comp.init(), chunks)[0]
    assert s_plain.stat_err is None and s_comp.stat_err is not None
    for u, v in zip(tree_leaves(s_plain.stat), tree_leaves(s_comp.stat)):
        assert torch.equal(u, v)
    assert any(bool((e != 0).any()) for e in tree_leaves(s_comp.stat_err))
    _assert_results_close(comp.finalize((s_comp,)), plain.finalize((s_plain,)), rtol=1e-4,
                          atol=1e-2)


def test_flatten_unflatten_round_trip_and_donated_update():
    x = _x(300, seed=3)
    engine = _plan(compensated=True).engine
    s = engine.from_chunk(x[:200])
    leaves = s.flatten()
    back = s.unflatten([t.clone() for t in leaves])
    assert all(torch.equal(u, v) for u, v in zip(back.flatten(), leaves))
    for u, v in zip(engine.update_donated(s, x[200:]).flatten(),
                    engine.update(back, x[200:]).flatten()):
        assert torch.equal(u, v)
