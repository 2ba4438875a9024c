"""The port's multi-tenant FrameSession against `repro.core.frame.FrameSession`.

The same numpy chunks, made from a seed, go through the reference session
(backend "jnp", and "pallas", which runs its kernels in interpret mode on
the CPU) and the port's (``device="cpu"``: every kernel wrapper runs its
plain version).  Tolerances are those of the reference's own session tests
(tests/test_frame.py): autocovariance 1e-4, Yule-Walker 1e-3 relative and
1e-4 absolute, moments 1e-5, Welch 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integrity as jintegrity
from repro.core.frame import FrameSession as RefSession
from repro.core.streaming import PartialState as RefState
from repro_torch import FrameSession, SeriesFrame, session_state_from_numpy, session_state_to_numpy
from repro_torch.core import integrity as tintegrity
from repro_torch.core.backend import TorchBackend

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

D = 3
TOL = {"autocovariance": dict(rtol=1e-4, atol=1e-4), "yule_walker": dict(rtol=1e-3, atol=1e-4),
       "arma": dict(rtol=1e-3, atol=1e-4), "moments": dict(rtol=1e-5, atol=1e-5),
       "welch": dict(rtol=1e-4, atol=1e-4)}


def _series(n, seed, d=D):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    x = np.zeros_like(e)
    for t in range(1, n):
        x[t] = 0.6 * x[t - 1] + e[t]
    return x + np.sin(2 * np.pi * np.arange(n) / 25)[:, None].astype(np.float32)


def _declare(sess, arma=True):
    sess.autocovariance(4)
    sess.yule_walker(2)
    if arma:
        sess.arma(1, 1)
    sess.moments(8)
    sess.moments(3)
    sess.welch(nperseg=16, overlap=8)
    return sess


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_results(got, want, index=None):
    """Every member of a port result against the reference's; ``index``
    picks one user of a batched result on both sides."""
    pick = (lambda a: _np(a)) if index is None else (lambda a: _np(a)[index])
    assert set(got) == set(want)
    for name, w in want.items():
        tol = TOL["yule_walker" if name.startswith("yule") else name.split("_")[0]]
        g = got[name]
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_allclose(pick(g[k]), pick(w[k]), **tol)
        else:
            for a, b in zip(g, w):
                np.testing.assert_allclose(pick(a), pick(b), **tol)


def _pair(backend="jnp", arma=True, **kw):
    return (_declare(FrameSession(d=D, device="cpu", **kw), arma),
            _declare(RefSession(d=D, backend=backend, **kw), arma))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_session_equals_reference(num_shards, backend):
    """Growing mode, streams split across two ingest lanes in contiguous
    segments (``t0`` on the second lane): query and query_batch."""
    streams = [_series(400, 10 + u) for u in range(3)]
    port, ref = _pair(backend, num_users=3, num_shards=num_shards)
    for lo in range(0, 400, 80):
        shard = 0 if (lo < 200 or num_shards == 1) else 1
        t0 = None if shard == 0 else np.full((3,), lo, np.int32)
        chunk = np.stack([s[lo: lo + 80] for s in streams])
        port.ingest(np.arange(3), chunk, shard=shard, t0=t0)
        ref.ingest(jnp.arange(3), jnp.asarray(chunk), shard=shard,
                   t0=None if t0 is None else jnp.asarray(t0))
    got_b, want_b = port.query_batch([0, 1, 2]), ref.query_batch(jnp.arange(3))
    for u in range(3):
        _assert_results(port.query(u), ref.query(u))
        _assert_results(got_b, want_b, index=u)
    np.testing.assert_array_equal(_np(port.lengths()), np.asarray(ref.lengths()))
    # the batched read has the reference's shapes (vmap: a leading user axis)
    assert tuple(got_b["welch"][0].shape) == tuple(want_b["welch"][0].shape)
    assert tuple(got_b["moments"]["count"].shape) == (3,)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_session_eviction_equals_reference(backend):
    """Eviction mode before the ring wraps and after it has wrapped several
    times, with one user falling behind (the reference's own scenario)."""
    port, ref = _pair(backend, num_users=2, window=240, num_buckets=4, arma=False)
    s0, s1 = _series(600, 20), _series(270, 21)
    for lo in range(0, 600, 30):
        ids = [0, 1] if lo < 270 else [0]
        chunk = np.stack([s[lo: lo + 30] for s in (s0, s1)[: len(ids)]])
        port.ingest(np.asarray(ids), chunk)
        ref.ingest(jnp.asarray(ids), jnp.asarray(chunk))
        if lo in (120, 570):  # not yet wrapped; wrapped several times
            np.testing.assert_array_equal(_np(port.retained_lengths()),
                                          np.asarray(ref.retained_lengths()))
            got_b, want_b = port.query_batch([0, 1]), ref.query_batch(jnp.asarray([0, 1]))
            for u in range(2):
                _assert_results(port.query(u), ref.query(u))
                _assert_results(got_b, want_b, index=u)
    assert _np(port.retained_lengths()).tolist() == [240, 210]
    assert _np(port.lengths()).tolist() == [600, 270]


def test_eviction_equals_retained_recompute():
    """Eviction ≡ recomputing from ONLY the retained window, with the same
    global offsets (the semantics the card's session phase checks)."""
    port = _declare(FrameSession(d=D, num_users=1, window=160, num_buckets=4, device="cpu"),
                    arma=False)
    x = _series(500, 22)
    for lo in range(0, 500, 20):
        port.ingest([0], x[None, lo: lo + 20])
    kept = int(_np(port.retained_lengths())[0])
    assert kept == 140
    plan = port.plan
    want = plan.finalize(plan.from_chunk(torch.from_numpy(x[500 - kept:]), t0=500 - kept),
                         cache=False)
    _assert_results(port.query(0), want)


def test_query_matches_a_per_user_series_frame():
    port = _declare(FrameSession(d=D, num_users=2, device="cpu"))
    streams = [_series(300, 30 + u) for u in range(2)]
    for lo in range(0, 300, 60):
        port.ingest([1, 0], np.stack([streams[1][lo: lo + 60], streams[0][lo: lo + 60]]))
    for u in range(2):
        frame = _declare(SeriesFrame.from_chunks([streams[u][lo: lo + 60]
                                                  for lo in range(0, 300, 60)], device="cpu"))
        _assert_results(port.query(u), frame.collect())


def test_partials_batch_is_what_query_batch_finalizes():
    port = _declare(FrameSession(d=D, num_users=3, device="cpu"))
    _ingest_some(port)
    merged = port.partials_batch([2, 0])
    assert len(merged) == len(port.plan.groups)
    for k, u in enumerate((2, 0)):
        one = port.partials_batch([u])
        for a, b in zip([x for st in merged for x in st.flatten()],
                        [x for st in one for x in st.flatten()]):
            assert torch.equal(a[k], b[0])
    for x, y in zip(jax.tree_util.tree_leaves(_as_tree(port.plan.finalize_batch(merged))),
                    jax.tree_util.tree_leaves(_as_tree(port.query_batch([2, 0])))):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- snapshots
def _ingest_some(*sessions, users=3, n=240, chunk=60, seed=40):
    streams = [_series(n, seed + u) for u in range(users)]
    for lo in range(0, n, chunk):
        batch = np.stack([s[lo: lo + chunk] for s in streams])
        for sess in sessions:
            sess.ingest(np.arange(users), batch)


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.flatten(), b.flatten()))


def test_reference_snapshot_carried_in_answers_as_the_reference():
    port, ref = _pair(num_users=3)
    _ingest_some(ref)
    port.import_state(session_state_from_numpy(jax.device_get(ref.export_state()),
                                               device="cpu"))
    got_b, want_b = port.query_batch([0, 1, 2]), ref.query_batch(jnp.arange(3))
    for u in range(3):
        _assert_results(port.query(u), ref.query(u))
        _assert_results(got_b, want_b, index=u)
    # and back: the port's snapshot restores into the reference
    back = session_state_to_numpy(port.export_state())
    fresh = _declare(RefSession(d=D, num_users=3, backend="jnp"))
    fresh.import_state({g: {"lanes": RefState(**e["lanes"]), "counts": e["counts"]}
                        for g, e in back.items()})
    _assert_results(port.query(2), fresh.query(2))


def test_export_import_round_trip_is_bitwise():
    a = _declare(FrameSession(d=D, num_users=3, device="cpu"))
    _ingest_some(a)
    snap = a.export_state()
    b = _declare(FrameSession(d=D, num_users=3, device="cpu"))
    b.import_state(snap)
    for x, y in zip(jax.tree_util.tree_leaves(_as_tree(a.query_batch([2, 0]))),
                    jax.tree_util.tree_leaves(_as_tree(b.query_batch([2, 0])))):
        assert torch.equal(x, y)
    # both keep serving alike: the same tick into each gives the same lanes
    tick = np.stack([_series(60, 50 + u) for u in range(3)])
    a.ingest(np.arange(3), tick)
    b.ingest(np.arange(3), tick)
    assert _leaves_equal(a._services[0].state_template()["lanes"],
                         b._services[0].state_template()["lanes"])
    # a snapshot is a copy: later ingests leave it as it was
    assert not _leaves_equal(snap["group_0"]["lanes"], a.export_state()["group_0"]["lanes"])


def _as_tree(result):
    """A result dict as nested lists of tensors (for a leaf walk)."""
    if isinstance(result, dict):
        return [_as_tree(result[k]) for k in sorted(result)]
    if isinstance(result, (tuple, list)):
        return [_as_tree(v) for v in result]
    return result


def test_tenant_export_import_and_slice():
    a = _declare(FrameSession(d=D, num_users=3, device="cpu"))
    _ingest_some(a)
    full = a.export_state()
    one = a.export_tenant(1)
    sliced = a.tenant_slice(full, 1)
    for x, y in zip(one["group_0"]["lanes"].flatten(), sliced["group_0"]["lanes"].flatten()):
        assert torch.equal(x, y)
    b = _declare(FrameSession(d=D, num_users=3, device="cpu"))
    b.import_tenant(1, one)
    for x, y in zip(jax.tree_util.tree_leaves(_as_tree(a.query(1))),
                    jax.tree_util.tree_leaves(_as_tree(b.query(1)))):
        assert torch.equal(x, y)
    assert _np(b.lengths()).tolist() == [0, 240, 0]


def test_tenant_axes_match_the_reference_keys():
    port, ref = _pair(num_users=2)
    _ingest_some(port, ref, users=2)
    assert port.tenant_axes() == ref.tenant_axes()


def test_snapshot_from_another_plan_is_refused():
    a = _declare(FrameSession(d=D, num_users=2, device="cpu"))
    b = FrameSession(d=D, num_users=2, device="cpu")
    b.autocovariance(4)
    with pytest.raises(ValueError, match="structure"):
        b.import_state(a.export_state())
    with pytest.raises(ValueError, match="groups"):
        b.import_state({"group_0": a.export_state()["group_0"], "group_1": {}})
    bad = a.export_state()
    bad["group_0"]["lanes"].length = bad["group_0"]["lanes"].length.float()
    with pytest.raises(ValueError, match="kind change"):
        a.import_state(bad)


# ----------------------------------------------------------- validation
def test_reference_validation_errors():
    sess = _declare(FrameSession(d=1, num_users=3, device="cpu"), arma=False)
    with pytest.raises(ValueError, match="distinct"):
        sess.ingest([0, 0], np.ones((2, 5, 1), np.float32))
    with pytest.raises(ValueError, match="lie in"):
        sess.ingest([0, 3], np.ones((2, 5, 1), np.float32))
    with pytest.raises(ValueError, match="lie in"):
        sess.ingest([-1], np.ones((1, 5, 1), np.float32))
    with pytest.raises(ValueError, match="shard"):
        sess.ingest([0], np.ones((1, 5, 1), np.float32), shard=1)
    with pytest.raises(ValueError, match="before ingesting"):
        sess.moments(4)
    ev = FrameSession(d=1, num_users=1, window=40, num_buckets=4, device="cpu")
    ev.moments(4)
    ev.ingest([0], np.ones((1, 5, 1), np.float32))
    with pytest.raises(ValueError, match="straddle"):
        ev.ingest([0], np.ones((1, 10, 1), np.float32))
    with pytest.raises(ValueError, match="bucket span"):
        ev.ingest([0], np.ones((1, 11, 1), np.float32))
    with pytest.raises(ValueError, match="cursor"):
        ev.ingest([0], np.ones((1, 5, 1), np.float32), t0=np.asarray([7]))
    with pytest.raises(ValueError, match="at least one"):
        FrameSession(d=1, num_users=1, device="cpu").ingest([0], np.ones((1, 2, 1)))


def test_zero_length_chunk_is_a_noop_in_eviction_mode():
    """An empty arrival at a bucket boundary must not fire the reset."""
    sess = FrameSession(d=1, num_users=1, window=16, num_buckets=4, device="cpu")
    sess.moments(1)
    x = np.arange(20.0, dtype=np.float32)[:, None]
    for lo in range(0, 20, 4):
        sess.ingest([0], x[None, lo: lo + 4])
    before = float(sess.query(0)["moments"]["mean"][0])
    sess.ingest([0], np.zeros((1, 0, 1), np.float32))  # cursor on a boundary
    after = float(sess.query(0)["moments"]["mean"][0])
    assert before == after == np.mean(np.arange(4, 20))
    assert int(sess.retained_lengths()[0]) == 16


# ----------------------------------------------------------- integrity
def test_sentinel_scan_matches_the_reference():
    batch = np.random.default_rng(3).standard_normal((4, 6, 2)).astype(np.float32)
    batch[1, 2, 0] = np.nan
    batch[3, 0, 1] = np.inf
    want_v, want_c = jintegrity.sentinel_scan(batch)
    got_v, got_c = tintegrity.sentinel_scan(torch.from_numpy(batch))
    assert isinstance(got_v, np.ndarray) and got_v.tolist() == want_v.tolist() \
        == [True, False, True, False]
    np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))
    clean = batch[[0, 2]]
    _, same = tintegrity.sentinel_scan(torch.from_numpy(clean))
    assert torch.equal(same, torch.from_numpy(clean))


def test_audit_flags_exactly_the_poisoned_tenant():
    port, ref = _pair(num_users=4, num_shards=2)
    batch = np.stack([_series(40, 60 + u) for u in range(4)])
    batch[2, 7, 1] = np.nan
    for s in (port, ref):
        s.ingest(np.arange(4), batch, shard=1)
    got, want = port.audit(), ref.audit()
    assert got.tolist() == np.asarray(want).tolist() == [True, True, False, True]
    assert port.lane_health.tolist() == [[True] * 4, [True, True, False, True]]
    assert port._services[0].lane_health.tolist() == port.lane_health.tolist()
    lanes = port.state_template()["group_0"]["lanes"]
    np.testing.assert_array_equal(_np(tintegrity.lane_health(lanes)),
                                  np.asarray(jintegrity.lane_health(
                                      ref.state_template()["group_0"]["lanes"])))
    # the tenant's clean snapshot restores it
    clean = _declare(FrameSession(d=D, num_users=4, num_shards=2, device="cpu"))
    ok = batch.copy()
    ok[2, 7, 1] = 0.0
    clean.ingest(np.arange(4), ok, shard=1)
    port.import_tenant(2, clean.export_tenant(2))
    assert port.lane_health[:, 2].all()
    assert port.audit().all()


# ----------------------------------------------------------- calls
class CountingBackend:
    """Records (primitive, leading shape) of every call, delegating to the
    plain backend (the reference's CountingBackend, tests/test_plan.py)."""

    name = "counting"

    def __init__(self):
        self.inner = TorchBackend()
        self.calls = []

    def __getattr__(self, prim):
        fn = getattr(self.inner, prim)

        def call(*args, **kwargs):
            self.calls.append(prim)
            return fn(*args, **kwargs)

        return call


@pytest.mark.parametrize("window", [None, 64])  # growing; a ring of 4 buckets of 16
def test_ingest_and_query_calls_do_not_grow_with_the_batch(window, monkeypatch):
    """One ingest of B = 1 and one of B = 37 make the same primitive calls
    (one fused_plan_update for the chunks, one for the merge boundary), a
    batched query the same calls as a one-user query, and ingest never
    copies from the device to the host (.item / .cpu / .tolist raise)."""
    def session(users):
        be = CountingBackend()
        # the card's session plan, scaled down: moments(20) sets the carry at
        # 19, so moments(8) and Welch(16) each need their tail correction
        sess = FrameSession(d=D, num_users=users, window=window, num_buckets=window and 4,
                            backend=be, device="cpu")
        sess.autocovariance(4)
        sess.yule_walker(2)
        sess.moments(8)
        sess.moments(20)
        sess.welch(nperseg=16, overlap=8)
        return sess, be

    traces = {}
    for users in (1, 37):
        sess, be = session(users)
        chunk = np.stack([_series(16, 70 + u) for u in range(users)])
        sess.ingest(np.arange(users), chunk)  # compiles the plan
        be.calls.clear()
        with monkeypatch.context() as m:
            for attr in ("item", "cpu", "tolist"):
                m.setattr(torch.Tensor, attr, _forbidden(attr))
            sess.ingest(np.arange(users), chunk)
        ingest = list(be.calls)
        be.calls.clear()
        sess.query_batch(np.arange(users))
        traces[users] = (ingest, list(be.calls))
    assert traces[1] == traces[37]
    assert traces[37][0] == ["fused_plan_update", "fused_plan_update"]
    # autocovariance and yule_walker: one lag tail each; moments(8) and
    # Welch(16): one tail each (kernels 2, 2, 3 and 4 on the card)
    query = traces[37][1]
    assert query.count("masked_lagged_sums") == 2
    assert query.count("fused_lagged_moments") == 1
    assert query.count("segment_fft_power") == 1


def _forbidden(attr):
    def raise_(*_, **__):
        raise AssertionError(f"Tensor.{attr} on the ingest path")
    return raise_


# ------------------------------------------------- batch entry points
def test_batch_entry_points_match_the_reference():
    """update_batch / merge_batch / consume_batch of a fused plan against the
    reference's vmapped entry points, leaf by leaf."""
    from repro.core import plan as jplan
    from repro_torch.core import plan as tplan

    reqs = lambda m: [m.autocovariance_request(3), m.moments_request(5),
                      m.welch_request(8, 4)]
    jeng = jplan.StatPlan(reqs(jplan), d=2, backend="jnp").engine
    teng = tplan.StatPlan(reqs(tplan), d=2, device="cpu").engine
    xb = np.stack([_series(90, 80 + b, d=2) for b in range(4)])
    t0 = np.asarray([0, 5, 0, 9], np.int32)
    js = jeng.update_batch(jeng.init_batch(4, jnp.asarray(t0)), jnp.asarray(xb[:, :40]))
    ts = teng.update_batch(teng.init_batch(4, t0), torch.from_numpy(xb[:, :40]))
    js = jeng.consume_batch(js, jnp.asarray(np.stack([xb[:, 40:65], xb[:, 65:90]])))
    ts = teng.consume_batch(ts, torch.from_numpy(np.stack([xb[:, 40:65], xb[:, 65:90]])))
    jb = jeng.update_batch(jeng.init_batch(4, jnp.asarray(t0 + 90)), jnp.asarray(xb[:, :30]))
    tb = teng.update_batch(teng.init_batch(4, t0 + 90), torch.from_numpy(xb[:, :30]))
    jm, tm = jeng.merge_batch(jb, js), teng.merge_batch(tb, ts)
    for got, want in ((ts, js), (tm, jm)):
        for g, w in zip(got.flatten(), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-4)
    assert _np(tm.length).tolist() == [120] * 4 and _np(tm.t0).tolist() == t0.tolist()
