"""The port's StatsGateway against `repro.serving.gateway`.

Both gateways serve a session of the same requests on the CPU (the port's
``device="cpu"``: every kernel wrapper runs its plain version; the
reference's backend "jnp") and are driven by one seeded schedule of
submissions; their answers agree within the reference tests' tolerances
(rtol 1e-4 / atol 1e-5; ``period`` and ``valid`` exactly).  The port's own
gateway is then pinned bitwise as the reference's tests pin theirs: kill
and restart (tests/test_gateway.py:174, :343), a poisoned tenant isolated
and rebuilt (tests/test_integrity.py:176), and the admission rejections.
Each package's chaos module holds its own schedule: a test arms the one
its gateway reads.
"""
import asyncio
import time

import numpy as np
import pytest
import torch

from repro.core.frame import FrameSession as RefSession
from repro.runtime import chaos as jchaos
from repro.serving import gateway as jg
from repro_torch import FrameSession, SeriesFrame
from repro_torch.core.backend import TorchBackend
from repro_torch.core.mapreduce import tree_map
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import FaultInjector
from repro_torch.serving import gateway as tg
from repro_torch.serving.gateway import (Degraded, GatewayConfig, PoisonedChunk, QueueFull,
                                         RateClass, RateLimited, StatsGateway)

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

D = 2
N = 4
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    chaos.clear()
    jchaos.clear()


def _declare(sess):
    """Two statistic families and a forecast (the served plan shape of the
    reference's integrity tests), plus an anomaly member."""
    sess.autocovariance(3)
    sess.moments(8)
    sess.forecast(4, model="ar", p=2)
    sess.anomaly_scores(model="arma", p=1, q=1)
    return sess


def _session(users=N, **kw):
    return _declare(FrameSession(d=D, num_users=users, device="cpu", **kw))


def _chunks(tick, users=N, c=32, seed=0):
    """Per tenant a stable AR(1) plus a sinusoid, a fresh stretch a tick."""
    rng = np.random.RandomState(seed + tick)
    out = {}
    for u in range(users):
        e = 0.3 * rng.randn(c, D).astype(np.float32)
        x = np.zeros_like(e)
        for t in range(1, c):
            x[t] = 0.5 * x[t - 1] + e[t]
        out[u] = (x + np.sin(2 * np.pi * (np.arange(c) + tick * c) / (5 + u))[:, None]
                  ).astype(np.float32)
    return out


def run(coro):
    return asyncio.run(coro)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [e for i, x in enumerate(tree) for e in _leaves(x, path + (i,))]
    return [(path, np.asarray(tree))]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


def _assert_close(got, want):
    lg, lw = _leaves(got), _leaves(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (p, g), (_, w) in zip(lg, lw):
        assert isinstance(g, np.ndarray) and g.shape == w.shape, p
        if p[-1] in ("period", "valid", "count"):
            np.testing.assert_array_equal(g, w, err_msg=str(p))
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=str(p))


# ------------------------------------------------------------------ parity
def _schedule(seed, ticks=6):
    """A seeded schedule: per tick the tenants that ingest (in a shuffled
    order, some twice: carried to the next tick) and the tenants queried."""
    rng = np.random.RandomState(seed)
    plan = []
    for _ in range(ticks):
        ing = list(rng.permutation(N)[: rng.randint(1, N + 1)])
        if rng.rand() < 0.5:
            ing.append(ing[0])  # same tenant twice: the second waits a tick
        plan.append((ing, list(rng.choice(N, rng.randint(1, N + 1), replace=False))))
    return plan


async def _drive(gw, plan, seed=0):
    answers, waiting = [], []
    for t, (ing, qry) in enumerate(plan):
        chunks = _chunks(t, seed=seed)
        for u in ing:
            try:
                waiting.append((t, gw.submit_ingest(int(u), chunks[int(u)] + 0.01 * len(waiting))))
            except (jg.GatewayRejected, tg.GatewayRejected) as e:
                answers.append(("rejected", t, int(u), type(e).__name__))
        qfuts = [(int(u), gw.submit_query(int(u))) for u in qry]
        await gw.tick()
        while not all(f.done() for _, f in waiting) and t == len(plan) - 1:
            await gw.tick()  # the last carried duplicates land
        for t0, f in [w for w in waiting if w[1].done()]:
            exc = f.exception()
            answers.append(("ingest", t0, f.result() if exc is None else type(exc).__name__))
        waiting = [w for w in waiting if not w[1].done()]  # carried to a later tick
        for u, f in qfuts:
            answers.append((t, u, await f))
    return answers


@pytest.mark.parametrize("seed", [0, 1])
def test_gateway_matches_the_reference_on_one_schedule(seed):
    """Ingests, carried duplicates and queries on one seeded schedule, with
    a chaos schedule poisoning two admitted payloads under the ``reject``
    policy: both gateways admit, reject and answer alike."""
    plan = _schedule(seed)

    def injector(mod):
        return mod.FaultInjector(seed=seed).corrupt("ingest.payload", calls={1, 6})

    port = StatsGateway(_session(), GatewayConfig(sentinel=True))
    ref_sess = _declare(RefSession(d=D, num_users=N, backend="jnp"))
    ref = jg.StatsGateway(ref_sess, jg.GatewayConfig(sentinel=True))
    with chaos.scoped(injector(chaos)) as ti:
        got = run(_drive(port, plan, seed))
    with jchaos.scoped(injector(jchaos)) as ji:
        want = run(_drive(ref, plan, seed))
    assert ti.log == ji.log and len(ti.log) == 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w[-1], dict):
            assert g[:2] == w[:2]
            _assert_close(g[-1], w[-1])
        else:
            assert g == w
    for key in ("rejected_ingest_poisoned", "programs_ingest", "programs_finalize",
                "sentinel_scans", "chaos_poisoned_ingest"):
        assert port.counters[key] == ref.counters[key], key
    np.testing.assert_array_equal(port.session.lengths().numpy(),
                                  np.asarray(ref_sess.lengths()))


def test_gateway_answers_equal_the_direct_session_bitwise():
    """Coalescing changes nothing: the gateway's answers are those of
    ``query_batch`` on a twin session fed the same arrival batches."""
    gw = StatsGateway(_session())
    twin = _session()

    async def scenario():
        for t in range(3):
            chunks = _chunks(t)
            futs = [gw.submit_ingest(u, chunks[u]) for u in range(N)]
            await gw.tick()
            await asyncio.gather(*futs)
            twin.ingest(np.arange(N), np.stack([chunks[u] for u in range(N)]))
        q = [gw.submit_query(u) for u in (2, 0, 3)]
        await gw.tick()
        return await asyncio.gather(*q)

    got = run(scenario())
    want = tg._to_host(twin.query_batch(np.asarray([2, 0, 3])))
    for i, res in enumerate(got):
        _assert_bitwise(res, tree_map(lambda leaf: leaf[i], want))


# ------------------------------------------------------------ coalescing
class _CountingBackend:
    def __init__(self):
        self.inner, self.name, self.calls = TorchBackend(), "counting", []

    def __getattr__(self, item):
        fn = getattr(self.inner, item)

        def call(*args, **kwargs):
            self.calls.append(item)
            return fn(*args, **kwargs)

        return call


def test_tick_is_one_ingest_and_one_finalize_with_one_host_copy(monkeypatch):
    """N clients in one tick: one batched ingest (two chunk-kernel calls),
    one batched finalize, ONE device-to-host copy of the whole result;
    every waiter gets numpy views of its slice and the split names every
    stage."""
    be = _CountingBackend()
    gw = StatsGateway(_declare(FrameSession(d=D, num_users=N, backend=be, device="cpu")))
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    async def scenario():
        chunks = _chunks(0)
        futs = [gw.submit_ingest(u, chunks[u]) for u in range(N)]
        qfuts = [gw.submit_query(u) for u in range(N)]
        be.calls.clear()
        monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
        stats = await gw.tick()
        monkeypatch.undo()
        await asyncio.gather(*futs)
        return stats, await asyncio.gather(*qfuts)

    stats, results = run(scenario())
    assert gw.counters["programs_ingest"] == 1 and gw.counters["programs_finalize"] == 1
    assert be.calls.count("fused_plan_update") == 2
    assert len(copies) == 1 and len(copies[0]) == 1  # one flat byte buffer
    assert set(stats["split"]) == set(tg._STAGES) and stats["ingests"] == N
    for res in results:
        assert sorted(res) == ["anomaly", "autocovariance", "forecast", "moments"]
        assert isinstance(res["forecast"]["pred"], np.ndarray)
        assert res["anomaly"]["valid"].dtype == np.bool_
    assert results[0]["forecast"]["pred"].base is not None  # a view, not a copy
    m = gw.metrics()
    assert m["batch_occupancy"]["ingest_mean"] == N and m["batch_occupancy"]["query_mean"] == N


def test_same_tenant_twice_carries_over_in_order_and_only_filters():
    gw = StatsGateway(_session(2))
    first, second = _chunks(0)[0][:16], np.ones((16, D), np.float32)

    async def scenario():
        f1 = gw.submit_ingest(0, first)
        f2 = gw.submit_ingest(0, second)
        await gw.tick()
        assert f1.done() and not f2.done()
        assert gw.metrics()["queue_depth"]["ingest"] == 1
        await gw.tick()
        await asyncio.gather(f1, f2)
        q = gw.submit_query(0, only="forecast")
        await gw.tick()
        return await q

    got = run(scenario())
    assert sorted(got) == ["forecast"]
    ref = SeriesFrame.from_array(np.concatenate([first, second]), device="cpu")
    ref.forecast(4, model="ar", p=2)
    np.testing.assert_allclose(got["forecast"]["pred"], ref.collect()["forecast"]["pred"].numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="unknown query kinds"):
        gw.submit_query(0, only="nope")


# ------------------------------------------------------- kill and restart
@pytest.mark.parametrize("window", [None, 64])
def test_kill_and_restart_serves_identical_forecasts(tmp_path, window):
    """The port's pins of tests/test_gateway.py:174 and :343: a restarted
    gateway resumes after the last durable tick and answers bitwise as
    before the crash, forecasts and anomaly scores included, with zero
    re-ingest; a torn newer generation is walked past."""
    kw = {} if window is None else dict(window=window, num_buckets=4)
    cfg = GatewayConfig(checkpoint_dir=str(tmp_path), snapshot_every=1)
    gw = StatsGateway(_session(**kw), cfg)

    async def before_crash():
        for t in range(2):
            chunks = _chunks(t, c=16)
            futs = [gw.submit_ingest(u, chunks[u]) for u in range(N)]
            await gw.tick()
            await asyncio.gather(*futs)
        q = [gw.submit_query(u) for u in range(N)]
        await gw.tick()
        return await asyncio.gather(*q)

    pre = run(before_crash())
    gw._loop_rt.manager.flush()  # the snapshot reaches the disk; then "crash"
    # a later generation torn mid-write must not be served
    inj = FaultInjector().corrupt("checkpoint.payload", calls={0})
    with chaos.scoped(inj):
        gw._loop_rt.manager.save(gw.session.export_state(), 7,
                                 meta={"tenant_axes": gw.session.tenant_axes()})
        gw._loop_rt.manager.flush()

    gw2 = StatsGateway(_session(**kw), cfg)
    assert gw2.counters["restored_from_snapshot"] == 1
    assert gw2._loop_rt.last_restore_skipped == [7]
    assert gw2._tick == 2  # after the last durable tick (tick 1)

    async def after_restart():
        q = [gw2.submit_query(u) for u in range(N)]
        await gw2.tick()
        return await asyncio.gather(*q)

    post = run(after_restart())
    assert gw2.counters["programs_ingest"] == 0
    np.testing.assert_array_equal(gw2.session.lengths().numpy(), np.full(N, 32))
    for u in range(N):
        _assert_bitwise(pre[u], post[u])
    run(gw2.stop())


def test_snapshot_only_when_dirty(tmp_path):
    gw = StatsGateway(_session(2), GatewayConfig(checkpoint_dir=str(tmp_path), snapshot_every=1))

    async def scenario():
        for _ in range(3):
            await gw.tick()
        f = gw.submit_ingest(0, np.ones((8, D), np.float32))
        stats = await gw.tick()
        await f
        await gw.stop()
        return stats

    stats = run(scenario())
    assert gw.counters["snapshots"] == 1 and stats["split"]["snapshot"] > 0


# ------------------------------------------------------ poisoned tenant
def test_poisoned_tenant_quarantined_others_bitwise_then_rebuilt(tmp_path):
    """The port's pin of tests/test_integrity.py:176: seeded chaos poisons
    tenant 2 at tick 2 under ``quarantine``; every other tenant answers
    bitwise as a fault-free run does; ``rebuild_tenant`` restores tenant 2
    from the newest intact generation, bitwise the state that generation
    held."""
    TICKS, REBUILD_AT = 8, 5

    async def drive(gw, inj):
        answers = {u: [] for u in range(N)}
        rebuilt = None
        ctx = chaos.scoped(inj) if inj is not None else None
        if ctx is not None:
            ctx.__enter__()
        try:
            for t in range(TICKS):
                if t == REBUILD_AT and inj is not None:
                    ctx.__exit__(None, None, None)
                    ctx = None
                    rebuilt = gw.rebuild_tenant(2)
                    qf = gw.submit_query(2)
                    await gw.tick()
                    answers[2].append(("rebuilt", await qf))
                chunks = _chunks(t)
                futs = []
                for u in range(N):
                    try:
                        futs.append(gw.submit_ingest(u, chunks[u]))
                    except PoisonedChunk:
                        pass
                qu = t % N
                try:
                    qfut = gw.submit_query(qu)
                except PoisonedChunk:
                    qfut = None
                await gw.tick()
                for f in futs:
                    try:
                        await f
                    except PoisonedChunk:
                        pass
                if qfut is not None:
                    try:
                        answers[qu].append((t, await qfut))
                    except PoisonedChunk:  # quarantined by this tick's ingest
                        pass
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        return answers, rebuilt

    inj = FaultInjector(seed=7).corrupt("ingest.payload", calls={N * 2 + 2})

    async def faulty():
        gw = StatsGateway(_session(), GatewayConfig(sentinel=True, snapshot_every=2,
                                                    checkpoint_dir=str(tmp_path / "ckpt")))
        gw.set_tenant_policy(2, "quarantine")
        answers, rebuilt = await drive(gw, inj)
        health = gw.health()["integrity"]
        await gw.stop(final_snapshot=False)
        return answers, rebuilt, health

    async def clean():
        gw = StatsGateway(_session(), GatewayConfig(sentinel=True))
        answers, _ = await drive(gw, None)
        await gw.stop(final_snapshot=False)
        return answers

    ans_f, rebuilt, health = run(faulty())
    ans_c = run(clean())
    assert ("ingest.payload", N * 2 + 2, "corrupt") in inj.log
    assert rebuilt["released"] and rebuilt["tenant"] == 2
    assert health["tenants_quarantined"] == 1 and health["tenants_rebuilt"] == 1
    assert health["quarantined"] == [] and "breaker" not in health
    for u in (0, 1, 3):
        assert len(ans_f[u]) == len(ans_c[u]) > 0
        for (tf_, rf), (tc, rc) in zip(ans_f[u], ans_c[u]):
            assert tf_ == tc
            _assert_bitwise(rf, rc)

    async def reference():  # what the rebuilt generation held: ticks 0 and 1
        gw = StatsGateway(_session(), GatewayConfig(sentinel=True))
        for t in range(2):
            chunks = _chunks(t)
            futs = [gw.submit_ingest(u, chunks[u]) for u in range(N)]
            await gw.tick()
            await asyncio.gather(*futs)
        qf = gw.submit_query(2)
        await gw.tick()
        res = await qf
        await gw.stop(final_snapshot=False)
        return res

    tag, got = ans_f[2][0]
    assert tag == "rebuilt"
    _assert_bitwise(got, run(reference()))
    assert any(t >= REBUILD_AT for (t, _r) in ans_f[2][1:] if isinstance(t, int))


def test_audit_finds_in_state_poison_and_rebuild_restores(tmp_path):
    """Sentinel off: the NaN reaches the lanes; ``audit`` quarantines the
    tenant and ``rebuild_tenant`` restores it, the others untouched."""
    gw = StatsGateway(_session(), GatewayConfig(checkpoint_dir=str(tmp_path), snapshot_every=1))

    async def scenario():
        chunks = _chunks(0)
        futs = [gw.submit_ingest(u, chunks[u]) for u in range(N)]
        await gw.tick()
        await asyncio.gather(*futs)
        gw._loop_rt.manager.flush()
        before = [gw.submit_query(u) for u in range(N)]
        await gw.tick()
        before = await asyncio.gather(*before)
        bad = _chunks(1)
        bad[1][3, 0] = np.nan
        futs = [gw.submit_ingest(u, bad[u]) for u in (1,)]
        await gw.tick()
        await asyncio.gather(*futs)
        report = gw.audit()
        with pytest.raises(PoisonedChunk):
            gw.submit_query(1)
        out = gw.rebuild_tenant(1)
        after = [gw.submit_query(u) for u in range(N)]
        await gw.tick()
        return before, report, out, await asyncio.gather(*after)

    before, report, out, after = run(scenario())
    assert report == {"unhealthy": [1], "quarantined": [1]}
    assert out["released"] and out["step"] == 0
    for u in range(N):
        _assert_bitwise(before[u], after[u])
    run(gw.stop(final_snapshot=False))


# ------------------------------------------------------------ rejections
def test_rate_limited_and_queue_full_rejections():
    cfg = GatewayConfig(max_pending_ingest=4, max_pending_query=1, rate_classes={
        "default": RateClass(),
        "limited": RateClass(ingest_per_tick=1, query_per_tick=1, burst=1)})
    gw = StatsGateway(_session(6), cfg)
    gw.set_tenant_class(0, "limited")
    chunk = np.ones((8, D), np.float32)

    async def scenario():
        ok = gw.submit_ingest(0, chunk)
        with pytest.raises(RateLimited):
            gw.submit_ingest(0, chunk)
        others = [gw.submit_ingest(u, chunk) for u in (1, 2, 3)]
        with pytest.raises(QueueFull):
            gw.submit_ingest(4, chunk)
        q = gw.submit_query(0)
        with pytest.raises(QueueFull):
            gw.submit_query(1)
        await gw.tick()
        await asyncio.gather(ok, *others, q)
        f = gw.submit_ingest(0, chunk)  # the bucket refilled
        await gw.tick()
        await f

    run(scenario())
    c = gw.counters
    assert c["rejected_ingest_rate"] == 1 and c["rejected_ingest_queue_full"] == 1
    assert c["rejected_query_queue_full"] == 1 and c["programs_ingest"] == 2
    assert gw.metrics()["ingest"]["count"] == 5
    with pytest.raises(ValueError, match="tenant"):
        gw.submit_ingest(9, chunk)
    with pytest.raises(ValueError, match="chunk"):
        gw.submit_ingest(0, np.ones((4, D + 1), np.float32))
    run(gw.stop())
    with pytest.raises(RuntimeError, match="closed"):
        gw.submit_query(0)


def test_blown_deadline_degrades_sheds_and_recovers():
    cfg = GatewayConfig(tick_deadline=0.05, degraded_recovery=2)
    gw = StatsGateway(_session(3), cfg)
    inj = FaultInjector().stall("gateway.tick", calls={1}, seconds=0.2)

    async def scenario():
        with chaos.scoped(inj):
            await gw.tick()
            assert gw.health()["state"] == "ok"
            await gw.tick()  # stalled: over budget
        assert gw.health()["state"] == "degraded"
        with pytest.raises(Degraded):
            gw.submit_query(0)
        fut = asyncio.get_running_loop().create_future()
        gw._query_q.append(tg._Pending(0, fut, time.perf_counter()))
        await gw.tick()
        with pytest.raises(Degraded, match="shed"):
            await fut
        await gw.tick()
        assert gw.health()["state"] == "ok"
        gw.config.tick_deadline = 0.0
        q = gw.submit_query(0)
        await gw.tick()
        return await q

    res = run(scenario())
    assert sorted(res) == ["anomaly", "autocovariance", "forecast", "moments"]
    h = gw.health()
    assert h["deadline"]["blown"] == 1 and h["deadline"]["shed"] == 2
    assert gw.counters["degraded_entries"] == 1 and gw.counters["degraded_recoveries"] == 1


def test_serve_forever_background_loop():
    gw = StatsGateway(_session(2), GatewayConfig(tick_interval=0.001))
    chunk = np.ones((8, D), np.float32)

    async def scenario():
        gw.start()
        got = await asyncio.wait_for(asyncio.gather(gw.ingest(0, chunk), gw.query(0)),
                                     timeout=30.0)
        await gw.stop()
        return got

    _, res = run(scenario())
    assert sorted(res) == ["anomaly", "autocovariance", "forecast", "moments"]
    assert gw.metrics()["ticks"] >= 1 and gw.health()["state"] == "draining"


def test_config_and_exceptions_mirror_the_reference():
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(jg.GatewayConfig)
           if f.default is not dataclasses.MISSING}
    port = {f.name: f.default for f in dataclasses.fields(GatewayConfig)
            if f.default is not dataclasses.MISSING}
    assert ref == port
    assert GatewayConfig().rate_classes == {"default": RateClass()}
    for name in ("QueueFull", "RateLimited", "Degraded", "PoisonedChunk"):
        assert issubclass(getattr(tg, name), tg.GatewayRejected)
    with pytest.raises(ValueError, match="sentinel_policy"):
        StatsGateway(_session(2), GatewayConfig(sentinel_policy="ignore"))
    with pytest.raises(ValueError, match="default_class"):
        StatsGateway(_session(2), GatewayConfig(default_class="gold"))
