"""The port's forecasts and anomaly scores against `repro.core.forecast`.

The same numpy series, made from a seed, go through the reference's frames
and sessions (backend "jnp", and "pallas", which runs its kernels in
interpret mode on the CPU) and the port's (``device="cpu"``: every kernel
wrapper runs its plain version).  ``pred``, ``sigma``, ``z`` and ``score``
are held within rtol 1e-4 / atol 1e-5 (the reference's own session
tolerance, tests/test_forecast.py); ``period`` and ``valid`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

from repro.core import forecast as jf
from repro.core.frame import FrameSession as RefSession
from repro.core.frame import SeriesFrame as RefFrame
from repro.core.plan import StatPlan as RefPlan
from repro.core.estimators.prediction import arma_innovations_filter as ref_filter
from repro_torch import FrameSession, SeriesFrame, StatPlan
from repro_torch.core import forecast as tf
from repro_torch.core import plan as tplan
from repro_torch.core.backend import TorchBackend
from repro_torch.core.estimators.prediction import (ar_forecast, arma_forecast,
                                                    arma_innovations_filter)
from repro_torch.core.estimators.yule_walker import yule_walker

D = 2
TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = ("period", "valid")


def _series(n, seed, period=8, d=D):
    """A stable AR(1) plus a sinusoid of ``period`` samples."""
    rng = np.random.default_rng(seed)
    e = 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    x = np.zeros_like(e)
    for t in range(1, n):
        x[t] = 0.5 * x[t - 1] + e[t]
    return (x + np.sin(2 * np.pi * np.arange(n) / period)[:, None]).astype(np.float32)


def _declare(f):
    """Every model of both kinds, with the Welch member ``auto`` reads."""
    f.autocovariance(3)
    f.welch(32, 16)
    f.forecast(5, model="ar", p=3)
    f.forecast(4, model="arma", p=1, q=1)
    f.forecast(6, model="auto", p=2, max_period=12)
    f.anomaly_scores(model="ar", p=2)
    f.anomaly_scores(model="arma", p=1, q=1, m=4)
    f.anomaly_scores(model="auto", p=2, max_period=12)
    return f


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_members(got, want, index=None):
    """Every forecast / anomaly leaf of a port result against the
    reference's; ``index`` picks one tenant of a batched result (on the
    port's side only when ``want`` is a per-tenant result)."""
    names = [k for k in want if k.startswith(("forecast", "anomaly"))]
    assert names and set(names) <= set(got)
    for name in names:
        assert set(got[name]) == set(want[name]), name
        for key, w in want[name].items():
            g = _np(got[name][key])
            g = g if index is None else g[index]
            w = np.asarray(w)
            assert g.shape == w.shape, (name, key)
            if key in EXACT:
                assert g.dtype == w.dtype, (name, key)
                np.testing.assert_array_equal(g, w, err_msg=f"{name}/{key}")
            else:
                np.testing.assert_allclose(g, w, **TOL, err_msg=f"{name}/{key}")


def _host_members(result):
    """A port result's forecast and anomaly members as numpy (the shape
    ``_assert_members`` takes as its reference)."""
    return {k: {a: _np(b) for a, b in v.items()} for k, v in result.items()
            if k.startswith(("forecast", "anomaly"))}


# ------------------------------------------------------------ placements
def _port_frame(placement, x):
    if placement == "array":
        return _declare(SeriesFrame.from_array(x, device="cpu")).collect()
    if placement == "chunks":
        return _declare(SeriesFrame.from_chunks([x[i: i + 96] for i in range(0, len(x), 96)],
                                                device="cpu")).collect()
    if placement == "store":
        return _declare(SeriesFrame.from_sharded(x, block_size=128, device="cpu")).collect()
    plan = StatPlan(_declare(_Recorder(tplan)).requests, d=D, device="cpu")
    frame = SeriesFrame.from_engine(plan.engine)
    frame.consume(torch.from_numpy(x.reshape(-1, 100, D)))
    return frame.finalize_with(lambda engine, state: plan.finalize((state,), cache=False))


def _ref_frame(placement, x, backend):
    if placement == "array":
        return _declare(RefFrame.from_array(jnp.asarray(x), backend=backend)).collect()
    if placement == "chunks":
        return _declare(RefFrame.from_chunks([x[i: i + 96] for i in range(0, len(x), 96)],
                                             backend=backend)).collect()
    if placement == "store":
        return _declare(RefFrame.from_sharded(jnp.asarray(x), block_size=128,
                                              backend=backend)).collect()
    from repro.core import plan as jplan

    plan = RefPlan(_declare(_Recorder(jplan)).requests, d=D, backend=backend)
    frame = RefFrame.from_engine(plan.engine)
    frame.consume(jnp.asarray(x.reshape(-1, 100, D)))
    return frame.finalize_with(lambda engine, state: plan.finalize((state,), cache=False))


class _Recorder:
    """The deferred-request methods of a frame, recording requests of one
    package's plan module (the engine placement compiles them itself)."""

    def __init__(self, mod):
        self.mod, self.requests = mod, []

    def _add(self, req):
        self.requests.append(req)

    def autocovariance(self, h):
        self._add(self.mod.autocovariance_request(h))

    def welch(self, nperseg, overlap):
        self._add(self.mod.welch_request(nperseg, overlap))

    def forecast(self, horizon, **kw):
        self._add(self.mod.forecast_request(horizon, **kw))

    def anomaly_scores(self, **kw):
        self._add(self.mod.anomaly_request(**kw))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("placement", ["array", "chunks", "store", "engine"])
def test_placements_match_reference(placement, backend):
    """Forecasts and anomaly scores of every model on every placement of
    the port against the reference's same placement."""
    x = _series(600, 1)
    _assert_members(_port_frame(placement, x), _ref_frame(placement, x, backend))


def test_placements_agree_with_each_other():
    """The four placements of the port serve the same forecasts (each
    traversal sums the lag products in its own order)."""
    x = _series(600, 2, period=6)
    want = _port_frame("array", x)
    for placement in ("chunks", "store", "engine"):
        _assert_members(_port_frame(placement, x), _host_members(want))


def test_append_then_collect_matches_a_fresh_frame():
    """A forecast after ``append`` reads the new tail: equal to a frame
    built over the whole series."""
    x = _series(500, 3)
    f = _declare(SeriesFrame.from_array(x[:400], device="cpu"))
    f.collect()
    f.append(x[400:])
    got = f.collect()
    want = _declare(SeriesFrame.from_array(x, device="cpu")).collect()
    _assert_members(got, _host_members(want))


# ------------------------------------------------------------- sessions
@pytest.mark.parametrize("window", [None, 160])  # growing; a ring of 4 buckets of 40
def test_query_batch_matches_reference_and_per_tenant(window):
    """A session of 5 tenants with different periods: ``query_batch`` and
    ``query`` against the reference session's, growing and over the
    eviction ring; in growing mode each tenant also against the port's own
    per-tenant frame."""
    N, c = 5, 40
    periods = [6, 8, 10, 5, 7]
    streams = [_series(280, 10 + u, periods[u]) for u in range(N)]
    kw = {} if window is None else dict(window=window, num_buckets=4)
    port = _declare(FrameSession(d=D, num_users=N, device="cpu", **kw))
    ref = _declare(RefSession(d=D, num_users=N, backend="jnp", **kw))
    for lo in range(0, 280, c):
        chunk = np.stack([s[lo: lo + c] for s in streams])
        port.ingest(np.arange(N), chunk)
        ref.ingest(jnp.arange(N), jnp.asarray(chunk))
    got, want = port.query_batch(np.arange(N)), ref.query_batch(jnp.arange(N))
    _assert_members(got, want)
    for u in range(N):
        _assert_members(port.query(u), ref.query(u))
        if window is None:
            own = _declare(SeriesFrame.from_array(streams[u], device="cpu")).collect()
            _assert_members(got, _host_members(own), index=u)


def test_auto_periods_vary_per_tenant_in_one_batch():
    """The reference's tests/test_forecast.py pin: two tenants with periods
    6 and 12 get their own periods from one batched finalize."""
    sess = FrameSession(d=D, num_users=2, device="cpu")
    sess.welch(48, overlap=24)
    sess.forecast(4, model="auto", p=2, max_period=24)
    chunks = np.stack([_series(192, 20 + i, pp) for i, pp in enumerate((6, 12))])
    sess.ingest(np.arange(2), chunks)
    out = sess.query_batch(np.arange(2))
    assert out["forecast"]["period"].dtype == torch.int32
    assert out["forecast"]["period"].tolist() == [6, 12]


class _CountingBackend:
    def __init__(self):
        self.inner, self.name, self.calls = TorchBackend(), "counting", []

    def __getattr__(self, item):
        fn = getattr(self.inner, item)

        def call(*args, **kwargs):
            self.calls.append(item)
            return fn(*args, **kwargs)

        return call


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_batched_finalize_calls_do_not_grow_with_tenants():
    """The port-side counterpart of tests/test_forecast.py:170: a query of 1
    and of 37 tenants make the same backend calls (a lag tail for the lag
    family, the Welch tail twice: the member and the ``auto`` members' read)
    and the same torch operations, in the same order."""
    traces = {}
    for users in (1, 37):
        be = _CountingBackend()
        sess = _declare(FrameSession(d=D, num_users=users, backend=be, device="cpu"))
        sess.moments(40)  # a carry of 39 rows: the Welch member's tail needs correcting
        sess.ingest(np.arange(users), np.stack([_series(64, 40 + u) for u in range(users)]))
        be.calls.clear()
        with _OpCount() as ops:
            sess.query_batch(np.arange(users))
        traces[users] = (list(be.calls), ops.ops)
    assert traces[1][0] == traces[37][0]
    assert traces[1][1] == traces[37][1]
    calls = traces[37][0]
    # autocovariance + 6 forecast / anomaly members: one lag tail each; the
    # Welch member's tail and one re-read per auto member
    assert calls.count("masked_lagged_sums") == 7
    assert calls.count("segment_fft_power") == 3


# ------------------------------------------------------------- functions
def test_detect_period_matches_reference_bitwise():
    """First index of the maximum, DC masked, round half to even of
    nperseg / k in float32, then the clip; int32, batched."""
    rng = np.random.default_rng(5)
    psd = rng.random((64, 33, 3)).astype(np.float32)
    psd[0, 5] = psd[0, 7] = 50.0          # a tie: the first bin wins
    psd[1, 0] = 1e6                        # DC ignored
    psd[2, 1] = 50.0                       # period 64 clipped to max
    psd[3, 20] = 50.0                      # 64 / 20 = 3.2 clipped to min
    psd[4, 24] = 50.0                      # 64 / 24 = 2.67 -> 3
    for nperseg in (64, 40):               # 40 / 16 = 2.5: half to even
        got = tf.detect_period(torch.from_numpy(psd), nperseg, 3, 16)
        want = np.stack([np.asarray(jf.detect_period(jnp.asarray(p), nperseg, 3, 16))
                         for p in psd])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(tf.detect_period(torch.from_numpy(psd[0]), 64, 3, 16)) == 13


def test_fit_seasonal_ar_batched_lags():
    """Per-series lags in one batched solve: each series equals its own
    unbatched solve, contiguous lags give Yule-Walker, and the reference's
    solve agrees."""
    from repro_torch.core.estimators.stats import autocovariance

    xs = [torch.from_numpy(_series(400, 30 + i, 5 + i)) for i in range(3)]
    gamma = torch.stack([autocovariance(x, 9, normalization="standard") for x in xs])
    lags = torch.tensor([[1, 2, 5], [1, 2, 7], [1, 2, 3]], dtype=torch.int32)
    A, sigma = tf.fit_seasonal_ar(gamma, lags)
    for i in range(3):
        a1, s1 = tf.fit_seasonal_ar(gamma[i], lags[i])
        np.testing.assert_allclose(A[i].numpy(), a1.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sigma[i].numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)
        ja, js = jf.fit_seasonal_ar(jnp.asarray(gamma[i].numpy()), jnp.asarray(lags[i].numpy()))
        np.testing.assert_allclose(A[i].numpy(), np.asarray(ja), **TOL)
        np.testing.assert_allclose(sigma[i].numpy(), np.asarray(js), **TOL)
    a_yw, s_yw = yule_walker(gamma[2], 3)
    np.testing.assert_allclose(A[2].numpy(), a_yw.numpy(), **TOL)
    np.testing.assert_allclose(sigma[2].numpy(), s_yw.numpy(), **TOL)


def test_lagged_forecast_equals_the_oracles_on_padded_layouts():
    """Zero-padded Phi rows add exact zeros: the plan's layout stays on
    ``ar_forecast`` / ``arma_forecast``'s numbers, batched or not."""
    x = torch.from_numpy(_series(300, 7))
    from repro_torch.core.estimators.arma import fit_arma
    from repro_torch.core.estimators.stats import autocovariance

    gamma = autocovariance(x, 3, normalization="standard")
    A, _ = yule_walker(gamma, 2)
    L = 5
    Phi = torch.cat([A, torch.zeros(L - 2, D, D)])
    xlag = x[-L:].flip(0)
    got = tf.lagged_forecast(Phi, torch.zeros(0, D, D), xlag, torch.zeros(0, D), 4)
    assert torch.equal(got, ar_forecast(A, x, 4))
    batched = tf.lagged_forecast(Phi.expand(3, L, D, D), torch.zeros(3, 0, D, D),
                                 xlag.expand(3, L, D), torch.zeros(3, 0, D), 4)
    assert all(torch.equal(b, got) for b in batched)
    A2, B2, _ = fit_arma(gamma, 1, 1, 2)
    Phi2 = torch.cat([A2, torch.zeros(L - 1, D, D)])
    _, innov = arma_innovations_filter(A2, B2, x)
    _, innov_pad = arma_innovations_filter(Phi2, B2, x)
    assert torch.equal(innov_pad, innov)
    want = arma_forecast(A2, B2, x, 3)
    got = tf.lagged_forecast(Phi2, B2, x[-L:].flip(0), innov[-1:].flip(0), 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_innovations_filter_batched_and_against_reference():
    """The batched filter ("...pij,...pj->...i") gives each series its
    unbatched result bit for bit, and the reference's within float
    round-off."""
    rng = np.random.default_rng(9)
    A = (0.2 * rng.standard_normal((4, 2, D, D))).astype(np.float32)
    B = (0.2 * rng.standard_normal((4, 1, D, D))).astype(np.float32)
    x = rng.standard_normal((4, 50, D)).astype(np.float32)
    preds, innov = arma_innovations_filter(*(torch.from_numpy(a) for a in (A, B, x)))
    for i in range(4):
        p1, e1 = arma_innovations_filter(*(torch.from_numpy(a[i]) for a in (A, B, x)))
        assert torch.equal(preds[i], p1) and torch.equal(innov[i], e1)
        jp, je = ref_filter(jnp.asarray(A[i]), jnp.asarray(B[i]), jnp.asarray(x[i]))
        np.testing.assert_allclose(p1.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(e1.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)


def test_standardized_innovations_match_reference():
    rng = np.random.default_rng(11)
    A = (0.3 * rng.standard_normal((2, D, D))).astype(np.float32)
    x = rng.standard_normal((40, D)).astype(np.float32)
    sigma = np.array([[1.0, 0.3], [0.3, 0.5]], np.float32)
    z, score = tf.standardized_innovations(torch.from_numpy(A), torch.zeros(0, D, D),
                                           torch.from_numpy(x), torch.from_numpy(sigma))
    jz, js = jf.standardized_innovations(jnp.asarray(A), jnp.zeros((0, D, D)), jnp.asarray(x),
                                         jnp.asarray(sigma))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(js), **TOL)


def test_anomaly_scores_flag_a_spike_and_mask_the_prefix():
    x = _series(512, 4)
    x[-10] += 8.0
    res = SeriesFrame.from_array(x, device="cpu")
    res.moments(32)  # widens the carried tail to 31 rows
    res.anomaly_scores(model="ar", p=4)
    out = res.collect()["anomaly"]
    scores = out["score"].numpy()
    assert out["valid"].all() and len(scores) == 31
    assert int(np.argmax(scores)) == 31 - 10 and scores[21] > 4 * np.median(scores)
    sess = FrameSession(d=D, num_users=1, device="cpu")
    sess.anomaly_scores(model="ar", p=4)
    sess.ingest([0], x[None, :3])
    short = sess.query(0)["anomaly"]
    assert short["valid"].sum() == 3 and not short["valid"][:-3].any()
    assert (short["score"][~short["valid"]] == 0).all()


def test_requests_and_specs_match_reference():
    """Requests carry the reference's params, specs its lag spans, and the
    port raises the reference's errors."""
    assert tf.MODELS == jf.MODELS and tf.DEFAULT_MAX_PERIOD == jf.DEFAULT_MAX_PERIOD
    assert tf.ARMA_RIDGE == jf.ARMA_RIDGE
    for args in [("ar", 3, 1, None, None), ("arma", 2, 1, None, None), ("arma", 1, 1, 5, None),
                 ("auto", 2, 0, None, None), ("auto", 4, 1, None, 16)]:
        assert dataclasses_tuple(tf.resolve_model_spec(*args)) == \
            dataclasses_tuple(jf.resolve_model_spec(*args))
    assert tf.forecast_request(6, "arma", 2, 1).params == jf.forecast_request(6, "arma", 2, 1).params
    assert tf.anomaly_request("auto", 2).params == jf.anomaly_request("auto", 2).params
    assert tplan.forecast_request is tf.forecast_request
    for bad, match in [(lambda m: m.forecast_request(0), "horizon"),
                       (lambda m: m.forecast_request(4, model="lstm"), "model"),
                       (lambda m: m.forecast_request(4, model="ar", p=0), "p >= 1"),
                       (lambda m: m.forecast_request(4, model="auto", p=8, max_period=8),
                        "max_period"),
                       (lambda m: m.anomaly_request(model="nope"), "model")]:
        for mod in (tf, jf):
            with pytest.raises(ValueError, match=match):
                bad(mod)
    f = SeriesFrame.from_array(_series(200, 5), device="cpu")
    f.forecast(4, model="auto", p=2, max_period=16)
    with pytest.raises(ValueError, match="[Ww]elch"):
        f.collect()


def dataclasses_tuple(spec):
    return (spec.model, spec.p, spec.q, spec.m, spec.lag_span, spec.needs_welch)
