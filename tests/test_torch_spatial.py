"""The port's §6 banded spatial AR path held against the JAX reference.

Kernel 7 (the banded matvec) with its autograd backward, the spatial
estimators and the eager fit, at small sizes on the CPU, where the kernel
wrapper runs its plain version.  The JAX side runs ``JnpBackend`` and
``PallasBackend`` in interpret mode; inputs come from numpy with a seed.
Tolerances are those of the reference's own tests (cited per case).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JnpBackend, PallasBackend
from repro.core.estimators import spatial as jsp
from repro.kernels.banded_matvec import ops as jbm
from repro_torch.core.backend import CudaBackend, TorchBackend
from repro_torch.core.estimators import spatial as tsp
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.banded_matvec import ops as bm, ref as bmr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

JNP = JnpBackend()
PALLAS = PallasBackend(interpret=True)
PORT = {"cuda": CudaBackend(), "torch": TorchBackend()}


def _rand(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().float().numpy()


def _valid(d, b):
    cols = np.arange(d)[:, None] + np.arange(-b, b + 1)[None, :]
    return (cols >= 0) & (cols < d)


# ------------------------------------------------- kernel 7: the product
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nrhs", [0, 4])  # 0: a 1-D vector
def test_banded_matvec_matches_reference_backends(backend, dtype, nrhs):
    """tests/test_backend.py:125-137: random diagonals (off-matrix slots
    included), x (d,) or (nrhs, d); atol 1e-5, 1e-2 for bf16."""
    d, b = 70, 3
    diags = _rand(d, 2 * b + 1, seed=3)
    x = _rand(d, seed=4) if nrhs == 0 else _rand(nrhs, d, seed=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JNP.banded_matvec(jnp.asarray(diags, jdt), jnp.asarray(x, jdt))
    pal = PALLAS.banded_matvec(jnp.asarray(diags, jdt), jnp.asarray(x, jdt))
    got = PORT[backend].banded_matvec(_t(diags).to(tdt), _t(x).to(tdt))
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    atol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol)
    np.testing.assert_allclose(_np(got), np.asarray(pal), atol=atol)


@pytest.mark.parametrize("nrhs", [0, 1, 5])
def test_ops_banded_matvec_keeps_the_reference_contract(nrhs):
    """ops.banded_matvec takes x (d,) or (d, nrhs), as the reference's
    wrapper, and agrees with its Pallas kernel (interpret mode) and the
    dense product."""
    d, b = 37, 2
    diags = _rand(d, 2 * b + 1, seed=5) * _valid(d, b)
    x = _rand(d, seed=6) if nrhs == 0 else _rand(d, nrhs, seed=6)
    want = jbm.banded_matvec(jnp.asarray(diags), jnp.asarray(x), block_rows=16, interpret=True)
    got = bm.banded_matvec(_t(diags), _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    dense = _np(tsp.banded_to_dense(_t(diags)))
    np.testing.assert_allclose(_np(got), dense @ x, atol=1e-4)


@pytest.mark.parametrize("d,b", [(37, 2), (5, 7), (1, 0), (9, 0)])
def test_band_transpose_and_dense_round_trip_match_reference(d, b):
    diags = _rand(d, 2 * b + 1, seed=22)
    np.testing.assert_array_equal(_np(bmr.band_transpose(_t(diags))),
                                  np.asarray(jbm.band_transpose(jnp.asarray(diags))))
    dense = _np(tsp.banded_to_dense(_t(diags)))
    np.testing.assert_allclose(dense, np.asarray(jsp.banded_to_dense(jnp.asarray(diags))),
                               atol=1e-6)
    np.testing.assert_allclose(_np(tsp.dense_to_banded(_t(dense), b)),
                               np.asarray(jsp.dense_to_banded(jnp.asarray(dense), b)),
                               atol=1e-6)


def test_off_matrix_slots_change_nothing():
    """Off-matrix diagonal slots may hold anything: y ignores them and their
    gradient is 0."""
    d, b = 20, 3
    diags = _t(_rand(d, 2 * b + 1, seed=7))
    x = _t(_rand(3, d, seed=8))
    valid = _t(_valid(d, b))
    clean = torch.where(valid, diags, 0.0)
    np.testing.assert_array_equal(_np(bm.banded_matvec_rows(diags, x)),
                                  _np(bm.banded_matvec_rows(clean, x)))
    dg = diags.clone().requires_grad_(True)
    bm.banded_matvec_rows(dg, x).square().sum().backward()
    assert torch.all(dg.grad[~valid] == 0)


# --------------------------------------- kernel 7: the backward (custom VJP)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_both_gradients_match_jax_grad(backend):
    """tests/test_backend.py:418-432: d/d diags and d/d x of
    sum(sin(banded_predict)^2) against jax.grad through the reference
    (its jnp oracle and its Pallas custom VJP); atol 1e-4."""
    d, b, T = 48, 2, 6
    diags = 0.1 * _rand(d, 2 * b + 1, seed=23)
    X = _rand(T, d, seed=24)

    def jloss(be):
        return lambda dg, xx: jnp.sum(jnp.sin(jsp.banded_predict(dg, xx, backend=be)) ** 2)

    gj_d, gj_x = jax.grad(jloss("jnp"), argnums=(0, 1))(jnp.asarray(diags), jnp.asarray(X))
    gp_d, gp_x = jax.grad(jloss(PALLAS), argnums=(0, 1))(jnp.asarray(diags), jnp.asarray(X))
    dg, xx = _t(diags).requires_grad_(True), _t(X).requires_grad_(True)
    loss = torch.sum(torch.sin(tsp.banded_predict(dg, xx, backend=backend)) ** 2)
    g_d, g_x = torch.autograd.grad(loss, (dg, xx))
    for got, want in ((g_d, gj_d), (g_x, gj_x), (g_d, gp_d), (g_x, gp_x)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("d,b,m", [(9, 2, 3), (4, 5, 2), (6, 0, 1)])
def test_gradcheck_float64(d, b, m):
    """Finite differences in float64: the plain version (autograd) and the
    autograd Function of the kernel wrapper (its plain forward on the CPU,
    the transposed-band and shifted-product backward)."""
    g = torch.Generator().manual_seed(d + b)
    diags = torch.randn(d, 2 * b + 1, generator=g, dtype=torch.float64, requires_grad=True)
    x = torch.randn(m, d, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(bmr.banded_matvec_ref, (diags, x))
    assert torch.autograd.gradcheck(bm.BandedMatvec.apply, (diags, x))


def test_fit_differentiates_only_the_diagonals(monkeypatch):
    """The fit's backward never takes the x branch (the kernel's second
    launch on the card): x needs no gradient there."""
    calls = []
    real = bm._matvec
    monkeypatch.setattr(bm, "_matvec",
                        lambda dg, x, *t: calls.append(tuple(x.shape)) or real(dg, x, *t))
    tsp.fit_banded_ar(_t(_rand(30, 8, seed=9)), 1, n_steps=2, step_size=0.5)
    assert calls == [(29, 8), (29, 8)]  # one forward per step, no A^T g
    calls.clear()
    xx = _t(_rand(5, 8, seed=10)).requires_grad_(True)
    tsp.banded_predict(_t(_rand(8, 3, seed=11)), xx).sum().backward()
    assert calls == [(5, 8), (5, 8)]  # the forward and A^T g


# ------------------------------------------------------- estimators (§6)
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_partitioned_predictor_matches_full(parts):
    """tests/test_spatial_graphs.py:48-56: rtol = atol = 1e-5."""
    d, b = 64, 2
    diags, x = _t(_rand(d, 2 * b + 1, seed=2) * 0.2), _t(_rand(d, seed=3))
    part = tsp.SpatialPartition(d=d, num_parts=parts, bandwidth=b)
    full = tsp.banded_predict(diags, x)
    np.testing.assert_allclose(_np(tsp.banded_predict_partitioned(diags, x, part)), _np(full),
                               rtol=1e-5, atol=1e-5)
    jpart = jsp.SpatialPartition(d=d, num_parts=parts, bandwidth=b)
    want = jsp.banded_predict_partitioned(jnp.asarray(_np(diags)), jnp.asarray(_np(x)), jpart)
    np.testing.assert_allclose(_np(tsp.banded_predict_partitioned(diags, x, part)),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(part.padded_indices(), jpart.padded_indices())


@pytest.mark.parametrize("with_precisions", [False, True])
def test_banded_nll_matches_reference(with_precisions):
    d, b, T, P = 32, 1, 100, 4
    diags = _rand(d, 2 * b + 1, seed=4) * 0.2
    x = _rand(T, d, seed=5)
    prec = None
    if with_precisions:
        a = _rand(P, d // P, d // P, seed=6) * 0.1
        prec = np.eye(d // P, dtype=np.float32)[None] + a @ np.swapaxes(a, 1, 2)
    jpart = jsp.SpatialPartition(d=d, num_parts=P, bandwidth=b)
    want = jsp.banded_nll(jnp.asarray(diags), jnp.asarray(x),
                          None if prec is None else jnp.asarray(prec), jpart)
    for backend in ("cuda", "torch"):
        got = tsp.banded_nll(_t(diags), _t(x), None if prec is None else _t(prec),
                             tsp.SpatialPartition(d=d, num_parts=P, bandwidth=b),
                             backend=backend)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_fit_banded_ar_matches_reference(backend):
    """tests/test_backend.py:435-443: 5 steps from the default step size;
    diags atol 1e-4, NLL trace rtol 1e-5."""
    xs = _rand(200, 16, seed=25)
    want = jsp.fit_banded_ar(jnp.asarray(xs), 2, n_steps=5, backend="jnp")
    got = tsp.fit_banded_ar(_t(xs), 2, n_steps=5, backend=backend)
    np.testing.assert_allclose(_np(got.diags), np.asarray(want.diags), atol=1e-4)
    np.testing.assert_allclose(_np(got.nll_trace), np.asarray(want.nll_trace), rtol=1e-5)


def test_fit_with_parts_and_precisions_matches_reference():
    xs = _rand(120, 12, seed=26)
    prec = np.stack([np.eye(4, dtype=np.float32) * s for s in (1.0, 2.0, 0.5)])
    want = jsp.fit_banded_ar(jnp.asarray(xs), 1, n_steps=4, step_size=0.3, num_parts=3,
                             block_precisions=jnp.asarray(prec), backend="jnp")
    got = tsp.fit_banded_ar(_t(xs), 1, n_steps=4, step_size=0.3, num_parts=3,
                            block_precisions=_t(prec))
    np.testing.assert_allclose(_np(got.diags), np.asarray(want.diags), atol=1e-4)
    np.testing.assert_allclose(_np(got.nll_trace), np.asarray(want.nll_trace), rtol=1e-5)


def test_reference_weights_carried_into_the_port():
    """The reference's fitted diagonals, as numpy, go into the port's model:
    both predict the same and score the same NLL on the same inputs."""
    xs = _rand(150, 24, seed=27)
    fit = jsp.fit_banded_ar(jnp.asarray(xs), 2, n_steps=10, backend="jnp")
    model = tsp.BandedARModel.from_numpy(np.asarray(fit.diags), device="cpu")
    assert (model.d, model.bandwidth) == (24, 2)
    np.testing.assert_array_equal(model.to_numpy(), np.asarray(fit.diags))
    probe = _rand(7, 24, seed=28)
    np.testing.assert_allclose(_np(tsp.banded_predict(model.diags, _t(probe))),
                               np.asarray(jsp.banded_predict(fit.diags, jnp.asarray(probe))),
                               atol=1e-5)
    np.testing.assert_allclose(float(tsp.banded_nll(model.diags, _t(xs))),
                               float(jsp.banded_nll(fit.diags, jnp.asarray(xs))), rtol=1e-5)


def test_cpu_runs_count_no_launches():
    reset_launch_counts()
    tsp.fit_banded_ar(_t(_rand(30, 8, seed=12)), 1, n_steps=2, step_size=0.5)
    assert launch_counts()["banded_matvec"] == 0  # the CPU runs the plain version


def test_wrapper_validation():
    with pytest.raises(ValueError, match="2b\\+1"):
        bm.banded_matvec_rows(torch.zeros(5, 4), torch.zeros(5))
    with pytest.raises(ValueError, match="end in d"):
        bm.banded_matvec_rows(torch.zeros(5, 3), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="shape"):
        bm.prepare_banded_matvec(torch.zeros(3, 5), torch.zeros(2, 4))
