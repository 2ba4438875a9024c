"""The port's streaming estimator front-ends, recursions, prediction and
generator against the reference's.

Engines (`lag_sum_engine`, `moment_engine`, `welch_engine`, the per-window
``kernel=`` engine), their ``streaming_*`` finalizers, `StreamingEstimator`,
Levinson / block Levinson / PACF, AR and ARMA prediction and the VAR / VMA /
VARMA generator of `repro_torch` against `repro.core.estimators` and
`repro.timeseries`.  The same numpy inputs, made from a seed, go through
both; the port on the CPU (``device="cpu"``: every kernel wrapper runs its
plain version), the reference on "jnp" (and "pallas" in interpret mode for
the lag-sum engine).  Tolerances are the reference's own tests'
(tests/test_streaming.py, tests/test_estimators.py): 1e-5 for lag sums, 1e-4
for the fits and Welch; the generator's recursion fed the reference's noise
rtol 1e-5, atol 1e-5; companion matrices and spectral radii exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimators import arma as rarma, prediction as rpred, spectral as rspec
from repro.core.estimators import stats as rstats
from repro.core.mapreduce import serial_window_map_reduce
from repro.timeseries import StreamingEstimator as RefEstimator, TimeSeriesStore as RefStore
from repro.timeseries import generator as rgen, irregular as rirr
from repro_torch.core.estimators import arma, prediction, spectral, stats
from repro_torch.core.frame import SeriesFrame
from repro_torch.core.streaming import StreamingEngine
from repro_torch.timeseries import StreamingEstimator, TimeSeriesStore, generator, irregular

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

# the packages re-export the function yule_walker under its module's name
yw = importlib.import_module("repro_torch.core.estimators.yule_walker")
ryw = importlib.import_module("repro.core.estimators.yule_walker")
UNEVEN = [1, 7, 229, 13, 501, 64, 185]  # sums to 1000; includes size 1
CPU = "cpu"


def _series(n=1000, d=2, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stream(engine, x, splits, t=torch.from_numpy):
    assert sum(splits) == x.shape[0]
    st, off = engine.init(), 0
    for c in splits:
        st = engine.update(st, t(x[off: off + c]))
        off += c
    return st


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo mesh in this process (the distribution layer at
    world 1; tests/test_torch_mesh.py runs worlds 1-8 in rank processes)."""
    import torch.distributed as dist

    from repro_torch.parallel import data_mesh

    mesh = data_mesh(1, 0, "file://" + str(tmp_path / "rendezvous"), device="cpu")
    yield mesh
    dist.destroy_process_group()


def _states_close(a, b, rtol=1e-5, atol=1e-5):
    for u, v in zip(a.flatten(), b.flatten()):
        np.testing.assert_allclose(_np(u), _np(v), rtol=rtol, atol=atol)


# ------------------------------------------------------------ equivalence
@pytest.mark.parametrize("normalization", ["paper", "standard"])
def test_autocovariance_strategies_agree(normalization, mesh1):
    """serial = blocked (one batched launch) = streamed = sharded on a
    one-rank mesh (bitwise blocked) in the port, each equal to the
    reference's serial estimator to 1e-5."""
    x = _series()
    H = 5
    want = np.asarray(rstats.autocovariance(jnp.asarray(x), H, normalization=normalization))
    xt = torch.from_numpy(x)
    engine = stats.lag_sum_engine(H, 2, device=CPU)
    for got in (stats.autocovariance(xt, H, normalization=normalization),
                stats.autocovariance_blocked(xt, H, 128, normalization=normalization),
                stats.streaming_autocovariance(engine, _stream(engine, x, UNEVEN),
                                               normalization)):
        _close(got, want, 1e-5, 1e-5)
    store = TimeSeriesStore.from_series(x, 128, 0, H, mesh=mesh1, device=CPU)
    sharded = stats.autocovariance_sharded(store.blocks, store.spec, H, mesh1,
                                           normalization=normalization)
    _close(sharded, want, 1e-5, 1e-5)
    assert torch.equal(sharded, stats.autocovariance_blocked(xt, H, 128,
                                                             normalization=normalization))


def test_block_lag_sums_is_one_batched_call_equal_to_reference():
    x = _series(700, 3, seed=1)
    from repro.core.overlap import OverlapSpec as RSpec, make_overlapping_blocks as rmake
    from repro_torch.core.overlap import OverlapSpec, make_overlapping_blocks

    spec = OverlapSpec(700, 96, 0, 9)
    blocks, _ = make_overlapping_blocks(torch.from_numpy(x), spec)
    got = stats.block_lag_sums(blocks, spec, 6)
    rblocks, _ = rmake(jnp.asarray(x), RSpec(700, 96, 0, 9))
    want = rstats.block_lag_sums(rblocks, RSpec(700, 96, 0, 9), 6)
    assert got.shape == (spec.num_blocks, 7, 3, 3)
    _close(got, want, 1e-5, 1e-4)
    _close(stats.raw_lag_sums(torch.from_numpy(x), 6), rstats.raw_lag_sums(jnp.asarray(x), 6),
           1e-5, 1e-4)
    with pytest.raises(ValueError, match="h_right"):
        stats.block_lag_sums(blocks, spec, 12)


@pytest.mark.parametrize("splits", [[1000], [500, 500], [999, 1], [1, 999], UNEVEN],
                         ids=["mono", "halves", "tail1", "head1", "uneven"])
def test_streaming_autocov_chunking_invariant(splits):
    x = _series(seed=1)
    engine = stats.lag_sum_engine(6, 2, device=CPU)
    _close(stats.streaming_autocovariance(engine, _stream(engine, x, splits)),
           rstats.autocovariance(jnp.asarray(x), 6), 1e-5, 1e-5)


def test_streaming_yule_walker_and_arma_equal_reference():
    x = _series(seed=2, d=3)
    engine, rengine = stats.lag_sum_engine(8, 3, device=CPU), rstats.lag_sum_engine(8, 3)
    st, rst = _stream(engine, x, UNEVEN), _stream(rengine, x, UNEVEN, jnp.asarray)
    for got, want in zip(yw.streaming_yule_walker(engine, st, 3),
                         ryw.streaming_yule_walker(rengine, rst, 3)):
        _close(got, want, 1e-4, 1e-5)
    for got, want in zip(arma.fit_arma_streaming(engine, st, 1, 1, m=8),
                         rarma.fit_arma_streaming(rengine, rst, 1, 1, m=8)):
        _close(got, want, 1e-4, 1e-4)
    with pytest.raises(ValueError, match="lags"):
        yw.streaming_yule_walker(engine, st, 9)
    with pytest.raises(ValueError, match="lags"):
        arma.fit_arma_streaming(engine, st, 5, 4)


@pytest.mark.parametrize("nperseg,overlap", [(32, None), (32, 24), (16, 0)])
def test_streaming_welch_equals_welch_psd(nperseg, overlap):
    """Strided windows survive chunk boundaries and merges: the stream
    equals the port's and the reference's batch Welch."""
    x = _series(seed=4)
    engine = spectral.welch_engine(nperseg=nperseg, overlap=overlap, d=2, device=CPU)
    f_s, p_s = spectral.streaming_welch(engine, _stream(engine, x, UNEVEN))
    f_b, p_b = rspec.welch_psd(jnp.asarray(x), nperseg=nperseg, overlap=overlap)
    _close(f_s, f_b, 0, 0)
    _close(p_s, p_b, 1e-4, 1e-5)
    _close(p_s, spectral.welch_psd(torch.from_numpy(x), nperseg, overlap)[1], 1e-4, 1e-5)


def test_moment_engine_equals_reference():
    x = _series(seed=5, d=3)
    engine, rengine = stats.moment_engine(16, 3, device=CPU), rstats.moment_engine(16, 3)
    got = stats.streaming_window_moments(engine, _stream(engine, x, UNEVEN))
    want = rstats.streaming_window_moments(rengine, _stream(rengine, x, UNEVEN, jnp.asarray))
    for key in ("mean", "var", "count"):
        _close(got[key], want[key], 1e-5, 1e-5)
    st = _stream(engine, x, UNEVEN)
    _close(stats.streaming_mean(st), x.mean(0), 1e-5, 1e-5)


@pytest.mark.parametrize("hl,hr", [(0, 0), (3, 0), (0, 4), (2, 5)])
def test_per_window_kernel_engine_any_halo(hl, hr):
    """StreamingEngine(kernel=...): the chunk kernel built from an unfold of
    the padded chunk and a vmap of the window kernel, at every halo, equal
    to the reference's serial map-reduce."""
    x = _series(n=311, seed=5)
    kern = lambda w: {"sq": (w * w).sum(), "edge": torch.outer(w[0], w[-1])}
    rkern = lambda w: {"sq": jnp.sum(w * w), "edge": jnp.outer(w[0], w[-1])}
    engine = StreamingEngine(d=2, h_left=hl, h_right=hr, kernel=kern, device=CPU)
    st = _stream(engine, x, [1, 17, 130, 7, 156])
    oracle = serial_window_map_reduce(rkern, jnp.asarray(x), hl, hr)
    _close(st.stat["sq"], oracle["sq"], 1e-5, 1e-4)
    _close(st.stat["edge"], oracle["edge"], 1e-5, 1e-4)
    # three series at once: one batched update each, nested vmaps
    xb = torch.from_numpy(np.stack([x, 2 * x, -x]))
    batched = engine.init_batch(3)
    for lo, hi in ((0, 18), (18, 148), (148, 311)):
        batched = engine.update_batch(batched, xb[:, lo:hi])
    for i, scale in enumerate((1.0, 2.0, -1.0)):
        _close(batched.stat["edge"][i], scale**2 * np.asarray(oracle["edge"]), 1e-5, 1e-4)
    with pytest.raises(ValueError, match="kernel"):
        StreamingEngine(d=2, device=CPU)
    with pytest.raises(ValueError, match="offset"):
        StreamingEngine(d=2, kernel=kern, kernel_takes_offset=True, device=CPU)


# ------------------------------------------------------------ monoid laws
ENGINES = {"lag_sums": lambda: stats.lag_sum_engine(4, 2, device=CPU),
           "welch": lambda: spectral.welch_engine(nperseg=16, overlap=8, d=2, device=CPU),
           "moments": lambda: stats.moment_engine(6, 2, device=CPU)}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_merge_associative_commutative_neutral(name):
    engine = ENGINES[name]()
    x = torch.from_numpy(_series(seed=6))
    cuts = [0, 230, 237, 1000]  # a middle segment narrower than the carry
    a, b, c = (engine.update(engine.init(t0=cuts[i]), x[cuts[i]: cuts[i + 1]], t0=cuts[i])
               for i in range(3))
    _states_close(engine.merge(engine.merge(a, b), c), engine.merge(a, engine.merge(b, c)))
    left = engine.update(engine.init(), x[:400])
    right = engine.update(engine.init(t0=400), x[400:], t0=400)
    _states_close(engine.merge(left, right), engine.merge(right, left), 0, 0)
    for e in (engine.init(), engine.init(t0=123)):
        _states_close(engine.merge(e, right), right, 0, 0)
        _states_close(engine.merge(right, e), right, 0, 0)


def test_chunk_size_invariance_one_prime_n():
    n = 221
    x = _series(n=n, seed=9)
    engine = stats.lag_sum_engine(4, 2, device=CPU)
    outs = []
    for size in (1, 13, n):
        splits = [size] * (n // size) + ([n % size] if n % size else [])
        outs.append(stats.streaming_autocovariance(engine, _stream(engine, x, splits)))
    _close(outs[0], _np(outs[2]), 1e-5, 1e-5)
    _close(outs[1], _np(outs[2]), 1e-5, 1e-5)


def test_batched_estimator_matches_per_series_loop():
    """A batched StreamingEstimator (states with a leading series axis, one
    update for all series) equals the per-series loop state for state, and
    its finalize maps over the series: one vmap for the autocovariance, the
    Yule-Walker fit and Welch, one call per series for a finalizer vmap
    cannot take (here one that reads the state's length on the host)."""
    B, n, d = 6, 300, 2
    xb = np.random.default_rng(10).standard_normal((B, n, d)).astype(np.float32)
    engine = stats.lag_sum_engine(3, d, device=CPU)
    est = StreamingEstimator(engine, batch=B)
    for off in range(0, n, 100):
        est.ingest(xb[:, off: off + 100])
    g = est.finalize(stats.streaming_autocovariance)
    A, _ = est.finalize(yw.streaming_yule_walker, 2)
    mu = est.finalize(lambda e, s: s.sample_sum / int(s.length))  # .item(): no vmap
    assert g.shape == (B, 4, d, d) and A.shape == (B, 2, d, d)
    for i in range(B):
        st = _stream(engine, xb[i], [100, 100, 100])
        _states_close(st.unflatten([leaf[i] for leaf in est.state.flatten()]), st)
        _close(g[i], rstats.autocovariance(jnp.asarray(xb[i]), 3), 1e-5, 1e-5)
        _close(A[i], _np(yw.streaming_yule_walker(engine, st, 2)[0]), 1e-5, 1e-5)
        _close(mu[i], xb[i].mean(0), 1e-5, 1e-5)
    assert est.length.tolist() == [n] * B
    wengine = spectral.welch_engine(nperseg=32, overlap=16, d=d, device=CPU)
    west = StreamingEstimator(wengine, batch=B).consume(
        np.stack([xb[:, :150], xb[:, 150:]]))
    freqs, psd = west.finalize(spectral.streaming_welch)
    assert psd.shape == (B, 17, d)
    for i in range(B):
        _close(psd[i], rspec.welch_psd(jnp.asarray(xb[i]), 32, 16)[1], 1e-4, 1e-5)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_streaming_estimator_from_store_merge_and_consume(backend):
    x = _series(seed=11)
    store = TimeSeriesStore.from_series(x, 128, 0, 4, device=CPU)
    est = StreamingEstimator.from_store(stats.lag_sum_engine(4, 2, device=CPU), store, 333)
    ref = RefEstimator.from_store(rstats.lag_sum_engine(4, 2, backend=backend),
                                  RefStore.from_series(jnp.asarray(x), 128, 0, 4), 333)
    assert int(est.length) == int(ref.length) == 1000
    want = ref.finalize(rstats.streaming_autocovariance)
    _close(est.finalize(stats.streaming_autocovariance), want, 1e-5, 1e-5)
    engine = stats.lag_sum_engine(4, 2, device=CPU)
    left = StreamingEstimator(engine).consume(x[:600].reshape(3, 200, 2))
    right = StreamingEstimator(engine, t0=600).ingest_iter([x[600:900], x[900:]])
    _close(right.merge_from(left).finalize(stats.streaming_autocovariance), want, 1e-5, 1e-5)
    assert est.backend is est.engine.backend


def test_engine_mode_frame_contract():
    frame = SeriesFrame.from_engine(stats.lag_sum_engine(2, 2, device=CPU))
    with pytest.raises(ValueError, match="engine-mode"):
        frame.autocovariance(2)
    with pytest.raises(ValueError, match="finalize_with"):
        frame.collect()
    with pytest.raises(ValueError, match="engine mode"):
        SeriesFrame.from_array(_series(10), device=CPU).state


# -------------------------------------------------- recursions and helpers
def _var2_gamma(d=3, n=20000, lags=6):
    """gamma of a stable VAR(2), from the port's generator on the CPU."""
    A = generator.random_stable_var(_gen(3), 2, d, radius=0.6, device=CPU)
    xs = generator.simulate_var(_gen(4), A, n, device=CPU)
    return stats.autocovariance(xs, lags, normalization="standard")


def test_block_levinson_and_pacf_equal_reference_and_dense():
    g = _var2_gamma()
    rg = jnp.asarray(_np(g))
    A_lev, s_lev, pacf = yw.block_levinson(g, 4)
    rA, rs, rpacf = ryw.block_levinson(rg, 4)
    for got, want in ((A_lev, rA), (s_lev, rs), (pacf, rpacf)):
        _close(got, want, 1e-3, 1e-5)
    A_dense, s_dense = yw.yule_walker(g[:5], 4)
    _close(A_lev, _np(A_dense), 1e-3, 1e-5)
    _close(s_lev, _np(s_dense), 1e-3, 1e-5)
    _close(stats.partial_autocorrelation(g, 5), rstats.partial_autocorrelation(rg, 5),
           1e-3, 1e-5)
    assert float(stats.partial_autocorrelation(g, 5)[2:].abs().max()) < 0.05
    _close(stats.autocorrelation(g), rstats.autocorrelation(rg), 1e-5, 1e-6)
    with pytest.raises(ValueError, match="lag"):
        stats.partial_autocorrelation(g, 7)


def test_levinson_durbin_equals_reference():
    A = np.array([0.5, -0.3], np.float32).reshape(2, 1, 1)
    x = generator.simulate_var(_gen(5), A, 50000, device=CPU)
    g = stats.autocovariance(x, 3, normalization="standard")[:, 0, 0]
    for got, want in zip(yw.levinson_durbin(g, 3), ryw.levinson_durbin(jnp.asarray(_np(g)), 3)):
        _close(got, want, 1e-5, 1e-6)
    phi, v, _ = yw.levinson_durbin(g, 2)
    np.testing.assert_allclose(_np(phi), [0.5, -0.3], atol=0.03)


def test_psi_weights_equal_reference():
    A = generator.random_stable_var(_gen(1), 2, 3, device=CPU)
    B = generator.random_invertible_ma(_gen(2), 1, 3, device=CPU)
    _close(arma.arma_psi_weights(A, B, 6),
           rarma.arma_psi_weights(jnp.asarray(_np(A)), jnp.asarray(_np(B)), 6), 1e-6, 1e-6)


@pytest.mark.parametrize("p,q", [(0, 0), (0, 2), (1, 0), (2, 1), (3, 2)])
def test_prediction_equals_reference(p, q):
    """AR and ARMA one-step, filter and multi-step forecasts, the p = 0
    (pure noise) model included: it forecasts zero from no lags."""
    rng = np.random.default_rng(p * 10 + q)
    d = 2
    A = (0.3 * rng.standard_normal((p, d, d))).astype(np.float32)
    B = (0.3 * rng.standard_normal((q, d, d))).astype(np.float32)
    x = rng.standard_normal((40, d)).astype(np.float32)
    At, Bt, xt = (torch.from_numpy(a) for a in (A, B, x))
    Aj, Bj, xj = (jnp.asarray(a) for a in (A, B, x))
    _close(prediction.ar_one_step(At, xt), rpred.ar_one_step(Aj, xj), 1e-5, 1e-6)
    _close(prediction.ar_forecast(At, xt, 7), rpred.ar_forecast(Aj, xj, 7), 1e-5, 1e-6)
    for got, want in zip(prediction.arma_innovations_filter(At, Bt, xt),
                         rpred.arma_innovations_filter(Aj, Bj, xj)):
        _close(got, want, 1e-5, 1e-5)
    _close(prediction.arma_forecast(At, Bt, xt, 5), rpred.arma_forecast(Aj, Bj, xj, 5),
           1e-5, 1e-5)
    if p == 0:
        assert prediction.ar_forecast(At, xt, 3).abs().max() == 0


# -------------------------------------------------------------- generator
@pytest.mark.parametrize("p", [1, 2, 3])
def test_companion_and_spectral_radius_exact(p):
    A = (np.random.default_rng(p).standard_normal((p, 3, 3)) / 3).astype(np.float32)
    np.testing.assert_array_equal(_np(generator.companion_matrix(torch.from_numpy(A))),
                                  rgen.companion_matrix(A))
    assert generator.spectral_radius(torch.from_numpy(A)) == rgen.spectral_radius(A)
    stable = generator.random_stable_var(_gen(p), p, 3, radius=0.7, device=CPU)
    assert generator.spectral_radius(stable) == pytest.approx(0.7, abs=1e-5)
    assert generator.spectral_radius(generator.random_invertible_ma(
        _gen(p), p, 3, device=CPU)) == pytest.approx(0.5, abs=1e-5)


@pytest.mark.parametrize("kind", ["var", "vma", "varma", "var_sigma"])
def test_recursion_fed_the_reference_noise(kind):
    """The log-step scan over the companion matrix equals the reference's
    sequential lax.scan on the same noise (rtol 1e-5, atol 1e-5)."""
    d, n, burn = 3, 700, 64
    key = jax.random.PRNGKey(7)
    A = rgen.random_stable_var(jax.random.PRNGKey(1), 2, d, radius=0.8)
    B = rgen.random_invertible_ma(jax.random.PRNGKey(2), 2, d)
    sigma = jnp.asarray([[1.0, 0.3, 0.0], [0.3, 2.0, 0.1], [0.0, 0.1, 0.5]])
    empty = torch.zeros((0, d, d))
    At, Bt = torch.from_numpy(np.array(A)), torch.from_numpy(np.array(B))
    if kind == "var":
        want = rgen.simulate_var(key, A, n, burn_in=burn)
        eps, args = rgen._noise(key, n + burn, d, None), (At, empty)
    elif kind == "var_sigma":
        want = rgen.simulate_var(key, A, n, sigma=sigma, burn_in=burn)
        eps, args = rgen._noise(key, n + burn, d, sigma), (At, empty)
    elif kind == "vma":
        want, burn = rgen.simulate_vma(key, B, n), 0
        eps, args = rgen._noise(key, n + 2, d, None), (empty, Bt)
    else:
        want = rgen.simulate_varma(key, A, B, n, burn_in=burn)
        eps, args = rgen._noise(key, n + burn + 2, d, None), (At, Bt)
    got = generator._simulate_from_noise(*args, torch.from_numpy(np.array(eps)), burn)
    assert got.shape == (n, d) and got.dtype == torch.float32
    _close(got, want, 1e-5, 1e-5)


def test_simulators_shapes_and_seeds():
    A = generator.random_stable_var(_gen(0), 2, 2, device=CPU)
    B = generator.random_invertible_ma(_gen(1), 1, 2, device=CPU)
    one, two = (generator.simulate_varma(_gen(3), A, B, 500, sigma=np.eye(2), device=CPU)
                for _ in range(2))
    assert one.shape == (500, 2) and torch.isfinite(one).all() and torch.equal(one, two)
    assert generator.simulate_vma(_gen(0), B, 64, device=CPU).shape == (64, 2)


@pytest.mark.parametrize("method", ["locf", "linear"])
def test_regularize_equals_reference(method):
    rng = np.random.default_rng(3)
    t = np.cumsum(rng.uniform(0.1, 1.0, 50)).astype(np.float32)
    x = rng.standard_normal((50, 2)).astype(np.float32)
    grid = np.linspace(t[0], t[-1], 80).astype(np.float32)
    got = irregular.regularize(torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(grid),
                               method)
    _close(got, rirr.regularize(jnp.asarray(t), jnp.asarray(x), jnp.asarray(grid), method),
           1e-6, 1e-6)


def test_ar1_theoretical_psd_equals_reference():
    for nperseg in (16, 15):
        freqs = np.fft.rfftfreq(nperseg).astype(np.float32)
        _close(spectral.ar1_theoretical_psd(0.6, 1.5, torch.from_numpy(freqs)),
               rspec.ar1_theoretical_psd(0.6, 1.5, jnp.asarray(freqs)), 1e-6, 1e-6)
