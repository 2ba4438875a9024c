"""The port's §5 conditional MLE held against `repro.core.estimators.mle`.

The same seeded numpy inputs go through the JAX function and the port's on
the CPU.  Tolerance rtol 1e-4 / atol 1e-5 unless a test says otherwise:
float32 sums of a few hundred windows in another order.  The statistical
recipes (tests/test_estimators.py:133-147) run on the port alone, on its
own generator's series.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimators import mle as jmle
from repro_torch.core.estimators import mle as tmle
from repro_torch.timeseries import random_stable_var, simulate_var

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

RTOL, ATOL = 1e-4, 1e-5
N = 250


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _spd(d, seed):
    m = _rand(d, d, seed=seed)
    return (m @ m.T / d + np.eye(d)).astype(np.float32)


def _case(p, d, precision, seed=0):
    A = _rand(p, d, d, seed=seed, scale=0.3 / np.sqrt(d * p))
    x = _rand(N, d, seed=seed + 1)
    P = np.eye(d, dtype=np.float32) if precision == "identity" else _spd(d, seed + 2)
    return A, P, x


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("precision", ["identity", "spd"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("p", [1, 3])
def test_residual_nll_and_blocked_gradient_match(p, d, precision):
    """Block size 64 does not divide n = 250: the last block's tail is masked."""
    A, P, x = _case(p, d, precision, seed=p * 10 + d)
    jA, jP, jx = jnp.asarray(A), jnp.asarray(P), jnp.asarray(x)
    tA, tP, tx = torch.from_numpy(A), torch.from_numpy(P), torch.from_numpy(x)
    _close(tmle.ar_residual(tA, tx[:p + 1]), jmle.ar_residual(jA, jx[:p + 1]))
    _close(tmle.ar_conditional_nll(tA, tP, tx), jmle.ar_conditional_nll(jA, jP, jx))
    v, g = tmle.ar_nll_and_grad_blocked(tA, tP, tx, 64)
    jv, jg = jmle.ar_nll_and_grad_blocked(jA, jP, jx, 64)
    _close(v, jv)
    _close(g, jg)
    # the blocked value is the serial one
    _close(v, tmle.ar_conditional_nll(tA, tP, tx))


def test_blocked_gradient_matches_jax_grad_of_the_serial_nll():
    A, P, x = _case(2, 3, "spd", seed=5)
    want = jax.grad(lambda a: jmle.ar_conditional_nll(a, jnp.asarray(P), jnp.asarray(x)))(
        jnp.asarray(A))
    _, got = tmle.ar_nll_and_grad_blocked(torch.from_numpy(A), torch.from_numpy(P),
                                          torch.from_numpy(x), 37)
    _close(got, want)


@pytest.mark.parametrize("with_precision", [False, True])
@pytest.mark.parametrize("d", [1, 3])
def test_optimal_step_size_matches(d, with_precision):
    x = _rand(500, d, seed=7) * np.linspace(0.5, 2.0, d).astype(np.float32)
    P = _spd(d, 8) if with_precision else None
    want = jmle.optimal_step_size(jnp.asarray(x), None if P is None else jnp.asarray(P))
    got = tmle.optimal_step_size(torch.from_numpy(x), None if P is None else torch.from_numpy(P))
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want)


def test_optimal_step_size_of_a_1d_series():
    x = _rand(300, seed=9)
    _close(tmle.optimal_step_size(torch.from_numpy(x)), jmle.optimal_step_size(jnp.asarray(x)))


@pytest.mark.parametrize("update_every", [0, 4])
def test_fit_ar_mle_ten_steps_match(update_every):
    A, _, _ = _case(2, 3, "identity", seed=11)
    x = np.asarray(simulate_var(torch.Generator().manual_seed(3), torch.from_numpy(A), 600,
                                device="cpu"))
    want = jmle.fit_ar_mle(jnp.asarray(x), 2, n_steps=10, block_size=128,
                           update_precision_every=update_every)
    got = tmle.fit_ar_mle(torch.from_numpy(x), 2, n_steps=10, block_size=128,
                          update_precision_every=update_every)
    assert got.nll_trace.shape == (10,)
    _close(got.A, want.A)
    _close(got.precision, want.precision)
    _close(got.nll_trace, want.nll_trace)


def test_fit_ar_mle_with_step_and_seed():
    A, _, _ = _case(1, 2, "identity", seed=12)
    x = _rand(400, 2, seed=13)
    want = jmle.fit_ar_mle(jnp.asarray(x), 1, n_steps=5, block_size=4096, step_size=0.3,
                           seed_A=jnp.asarray(A))
    got = tmle.fit_ar_mle(torch.from_numpy(x), 1, n_steps=5, block_size=4096, step_size=0.3,
                          seed_A=torch.from_numpy(A))
    _close(got.A, want.A)
    _close(got.nll_trace, want.nll_trace)


@pytest.mark.parametrize("p,d", [(1, 2), (3, 3)])
def test_minibatch_nll_and_gradient_match_the_reference_kernel(p, d):
    """One SGD step's loss on the same starts: the reference's minibatch
    loss is the mean of its per-window `_nll_kernel` over the windows
    x[s : s + p + 1] (mle.py:198-203)."""
    A, P, x = _case(p, d, "spd", seed=20 + p)
    starts = np.random.default_rng(21).integers(0, N - p, 64)

    def jloss(a):
        wins = jax.vmap(lambda s: jax.lax.dynamic_slice_in_dim(jnp.asarray(x), s, p + 1))(
            jnp.asarray(starts))
        return jnp.mean(jax.vmap(lambda w: jmle._nll_kernel(a, jnp.asarray(P), w)[0])(wins))

    want_v, want_g = jax.value_and_grad(jloss)(jnp.asarray(A))
    tA = torch.from_numpy(A).requires_grad_(True)
    got = tmle._minibatch_nll(tA, torch.from_numpy(P), torch.from_numpy(x),
                              torch.from_numpy(starts))
    (g,) = torch.autograd.grad(got, tA)
    _close(got, want_v)
    _close(g, want_g)


def test_fit_ar_sgd_trace_and_draws():
    """The trace keeps every max(1, n // 100)-th step; the starts come from
    the generator, so the same seed gives the same fit."""
    x = torch.from_numpy(_rand(2000, 2, seed=30))
    a = tmle.fit_ar_sgd(x, 1, n_steps=250, batch=16, generator=torch.Generator().manual_seed(1))
    b = tmle.fit_ar_sgd(x, 1, n_steps=250, batch=16, generator=torch.Generator().manual_seed(1))
    assert a.nll_trace.shape == (125,)
    assert torch.equal(a.A, b.A) and torch.equal(a.precision, torch.eye(2))
    assert tmle.fit_ar_sgd(x, 2, n_steps=7, batch=4).nll_trace.shape == (7,)


def test_fit_ar_sgd_converges():
    """tests/test_estimators.py:143-147 on the port's generator."""
    g = torch.Generator().manual_seed(14)
    A = random_stable_var(g, 1, 2, radius=0.6, device="cpu")
    xs = simulate_var(g, A, 30_000, device="cpu")
    res = tmle.fit_ar_sgd(xs, 1, n_steps=1200, batch=256, generator=g)
    assert float((res.A - A).abs().max()) < 0.05


def test_fit_ar_mle_matches_least_squares():
    """tests/test_estimators.py:133-140 on the port's generator."""
    g = torch.Generator().manual_seed(12)
    A = random_stable_var(g, 1, 3, radius=0.6, device="cpu")
    xs = simulate_var(g, A, 30_000, device="cpu")
    res = tmle.fit_ar_mle(xs, 1, n_steps=150, block_size=4096)
    assert float((res.A - A).abs().max()) < 0.03
    t = res.nll_trace.numpy()
    assert (np.diff(t) < 1e-6).mean() > 0.95
