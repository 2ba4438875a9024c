"""The port's CircuitBreakerBackend against the reference's.

Ports tests/test_chaos.py's breaker tests (:187-270: trips and recovers, a
failed probe reopens, the open state skips the primary, the default
primary against the oracle, the validation) and :551 (``health()``
surfaces the breaker) on the CPU, where the port's backends run the plain
versions.  Then the port against the reference: the same call sequence and
fault schedule drive the reference's breaker over (jnp, jnp) and the
port's over (torch, torch), and the two ``breaker_metrics()`` agree field
by field (the ``last_error`` strings aside).  Last, the port's pin of
tests/test_chaos.py:602: one schedule -- every ``backend.fused_plan_update``
call fails, checkpoint generation 1 is torn, tick 2 stalls -- through the
port's gateway with kill and restart and walk-back, every answer bitwise
the port's fault-free run and within tests/test_backend.py's tolerances of
the reference's.  Each package's chaos module holds its own schedule.
"""
import asyncio
import os

import numpy as np
import pytest
import torch

from repro.core.backend import CircuitBreakerBackend as RefBreaker
from repro.core.backend import JnpBackend
from repro.core.frame import FrameSession as RefSession
from repro.runtime import chaos as jchaos
from repro.serving import gateway as jg
from repro_torch import FrameSession
from repro_torch.checkpoint.manager import list_steps
from repro_torch.core.backend import (PRIMITIVE_NAMES, CircuitBreakerBackend, CudaBackend,
                                      TorchBackend)
from repro_torch.kernels._build import DeviceFault
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import FaultInjector
from repro_torch.serving.gateway import Degraded, GatewayConfig, StatsGateway

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

D = 2
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_backend.py's f32 lag and moment tolerances


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    chaos.clear()
    jchaos.clear()


def _x(seed=0, n=64):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, D).astype(np.float32))


def _session(num_users, backend="torch"):
    sess = FrameSession(d=D, num_users=num_users, backend=backend, device="cpu")
    sess.autocovariance(3)
    sess.moments(8)
    return sess


def run(coro):
    return asyncio.run(coro)


# ------------------------------------------ ports of tests/test_chaos.py
def test_breaker_trips_to_fallback_and_recovers_after_cooldown():
    br = CircuitBreakerBackend(primary=TorchBackend(), fallback=TorchBackend(),
                               trip_after=2, cooldown_calls=3)
    want = TorchBackend().lagged_sums(_x(), 3)
    inj = FaultInjector().fail("backend.lagged_sums", calls={0, 1})
    with chaos.scoped(inj):
        outs = [br.lagged_sums(_x(), 3) for _ in range(5)]
    for got in outs:  # every call served the oracle value, by primary or fallback
        assert torch.equal(got, want)
    st = br.breaker_metrics()["primitives"]["lagged_sums"]
    # calls 0, 1 fail -> trip; 2, 3 ride the open cooldown; 4 probes and heals
    assert (st["trips"], st["probes"], st["recoveries"], st["state"]) == (1, 1, 1, "closed")
    assert (st["fallback_calls"], st["primary_calls"]) == (4, 1)
    assert "InjectedFault" in st["last_error"]
    m = br.breaker_metrics()
    assert m["trips"] == 1 and m["open"] == []


def test_breaker_failed_probe_reopens():
    br = CircuitBreakerBackend(primary=TorchBackend(), fallback=TorchBackend(),
                               trip_after=1, cooldown_calls=2)
    inj = FaultInjector().fail("backend.lagged_sums", calls={0, 1, 2})
    with chaos.scoped(inj):
        for _ in range(7):
            br.lagged_sums(_x(), 3)
    st = br.breaker_metrics()["primitives"]["lagged_sums"]
    # d0 trips; the probes at d2 and d4 fail and reopen (no new trips); d6 heals
    assert (st["trips"], st["probes"], st["recoveries"], st["state"]) == (1, 3, 1, "closed")


class _Wedged:
    name = "wedged"

    def __init__(self, exc=RuntimeError("kernel build wedged")):
        self.exc = exc

    def __getattr__(self, prim):
        if prim in PRIMITIVE_NAMES:
            def boom(*a, **k):
                raise self.exc
            return boom
        raise AttributeError(prim)


def test_breaker_open_state_skips_primary_entirely():
    br = CircuitBreakerBackend(primary=_Wedged(), fallback=TorchBackend(), trip_after=1,
                               cooldown_calls=4)
    want = TorchBackend().lagged_sums(_x(), 3)
    for _ in range(4):
        assert torch.equal(br.lagged_sums(_x(), 3), want)
    st = br.breaker_metrics()["primitives"]["lagged_sums"]
    assert st["state"] == "open"
    assert st["consecutive_failures"] == 1  # only the tripping call touched the primary
    assert br.breaker_metrics()["open"] == ["lagged_sums"]
    br.reset("lagged_sums")
    assert br.breaker_metrics()["open"] == []


def test_breaker_default_cuda_primary_matches_oracle():
    br = CircuitBreakerBackend()  # "cuda" primary, "torch" fallback
    assert isinstance(br._primary, CudaBackend) and isinstance(br._fallback, TorchBackend)
    x = _x(seed=5, n=48)
    np.testing.assert_allclose(br.lagged_sums(x, 4), TorchBackend().lagged_sums(x, 4),
                               rtol=1e-4, atol=1e-4)
    st = br.breaker_metrics()["primitives"]["lagged_sums"]
    assert st["state"] == "closed" and st["primary_calls"] == 1


def test_breaker_validates_config_and_rejects_unknown_attr():
    with pytest.raises(ValueError):
        CircuitBreakerBackend(trip_after=0)
    with pytest.raises(ValueError):
        CircuitBreakerBackend(cooldown_calls=0)
    br = CircuitBreakerBackend(primary=TorchBackend(), fallback=TorchBackend())
    with pytest.raises(AttributeError):
        br.not_a_primitive


def test_health_surfaces_breaker_and_draining():
    plain = StatsGateway(_session(2))
    assert "breaker" not in plain.health()
    br = CircuitBreakerBackend(primary=TorchBackend(), fallback=TorchBackend())
    gw = StatsGateway(_session(2, backend=br))
    h = gw.health()
    assert h["state"] == "ok" and h["breaker"]["trips"] == 0
    run(gw.stop())
    assert gw.health()["state"] == "draining"
    assert gw.metrics()["health"] == "draining"
    run(plain.stop())


# ------------------------------------------------------ the port's own
@pytest.mark.parametrize("exc", [DeviceFault("fused_plan: CUDA error 700 (sticky)"),
                                 torch.AcceleratorError("CUDA error: an illegal memory access")
                                 if hasattr(torch, "AcceleratorError") else
                                 DeviceFault("CUDA error 719")])
def test_a_sticky_device_fault_propagates_uncounted(exc):
    """A lost CUDA context is not a fault the fallback can serve around: the
    breaker lets it propagate and counts nothing."""
    br = CircuitBreakerBackend(primary=_Wedged(exc), fallback=TorchBackend())
    with pytest.raises(type(exc)):
        br.lagged_sums(_x(), 3)
    st = br.breaker_metrics()["primitives"]["lagged_sums"]
    assert (st["trips"], st["fallback_calls"], st["state"]) == (0, 0, "closed")


def test_a_refused_launch_argument_is_served_by_the_fallback():
    """A non-sticky launch error (the wrapper's refusal, a CUDA error such
    as an invalid configuration) trips the breaker and is served."""
    br = CircuitBreakerBackend(primary=_Wedged(RuntimeError("fused_plan: CUDA error 9 at "
                                                            "launch")),
                               fallback=TorchBackend(), trip_after=1, cooldown_calls=2)
    assert torch.equal(br.lagged_sums(_x(), 3), TorchBackend().lagged_sums(_x(), 3))
    assert br.breaker_metrics()["trips"] == 1


def test_a_torch_fallback_never_serves_tensors_off_the_cpu():
    """The plain versions serve CPU tensors only: with tensors elsewhere
    (meta here, the card's on a GPU) the primary's failure is counted and
    re-raised, the open breaker refuses, and nothing reaches the fallback."""
    br = CircuitBreakerBackend(primary=_Wedged(RuntimeError("kernel build failed")),
                               fallback=TorchBackend(), trip_after=1, cooldown_calls=2)
    x = torch.empty((64, D), device="meta")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        br.lagged_sums(x, 3)
    with pytest.raises(RuntimeError, match="serves CPU tensors only"):
        br.lagged_sums(x, 3)
    m = br.breaker_metrics()
    assert (m["trips"], m["fallback_calls"], m["open"]) == (1, 0, ["lagged_sums"])
    # CPU tensors: the probe fails again and the fallback serves the call
    assert torch.equal(br.lagged_sums(_x(), 3), TorchBackend().lagged_sums(_x(), 3))
    assert br.breaker_metrics()["fallback_calls"] == 1


# ------------------------------------------------- against the reference
SCHEDULES = {
    # (trip_after, cooldown_calls, failing calls per site, dispatches)
    "trip_recover": (2, 3, {"lagged_sums": {0, 1}}, 9),
    "failed_probes": (1, 2, {"lagged_sums": {0, 1, 2}, "windowed_moments": {1}}, 10),
    "two_sites": (1, 3, {"masked_lagged_sums": {0, 2, 3}, "windowed_moments": {0, 4, 5, 6}},
                  12),
    "never_fails": (1, 1, {}, 5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_breaker_metrics_equal_the_reference_under_one_schedule(name):
    """The same call sequence (round-robin over three primitives) and the
    same fault schedule through both breakers: breaker_metrics agree field
    by field, last_error aside, after every dispatch."""
    import jax.numpy as jnp

    trip_after, cooldown, fails, calls = SCHEDULES[name]
    ref = RefBreaker(primary=JnpBackend(), fallback=JnpBackend(), trip_after=trip_after,
                     cooldown_calls=cooldown)
    port = CircuitBreakerBackend(primary=TorchBackend(), fallback=TorchBackend(),
                                 trip_after=trip_after, cooldown_calls=cooldown)
    rinj, pinj = jchaos.FaultInjector(seed=3), FaultInjector(seed=3)
    for prim, idx in fails.items():
        rinj.fail(f"backend.{prim}", calls=idx)
        pinj.fail(f"backend.{prim}", calls=idx)
    x = np.random.RandomState(1).randn(40, D).astype(np.float32)
    y = np.random.RandomState(2).randn(44, D).astype(np.float32)
    mask = np.ones(40, bool)
    seq = [("lagged_sums", (x, 3)), ("masked_lagged_sums", (y, mask, 3)),
           ("windowed_moments", (x, 8))]

    def strip(m):
        return {**m, "primitives": {k: {f: v for f, v in st.items() if f != "last_error"}
                                    for k, st in m["primitives"].items()}}

    with jchaos.scoped(rinj), chaos.scoped(pinj):
        for i in range(calls):
            prim, args = seq[i % len(seq)]
            want = getattr(ref, prim)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                        for a in args))
            got = getattr(port, prim)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                                        else a for a in args))
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
            assert strip(port.breaker_metrics()) == strip(ref.breaker_metrics()), (i, prim)
    assert [e for e in pinj.log] == [e for e in rinj.log]
    errors = {k: st["last_error"] is None for k, st in port.breaker_metrics()["primitives"]
              .items()}
    assert errors == {k: st["last_error"] is None
                      for k, st in ref.breaker_metrics()["primitives"].items()}


# ------------------------------------- the pin of tests/test_chaos.py:602
def _tear(path):
    """Overwrite bytes in the middle of a file (a torn write)."""
    with open(path, "r+b") as f:
        f.seek(max(os.path.getsize(path) // 2, 0))
        f.write(b"\x00TORN\x00")


N = 3
LENGTHS = (16, 24, 32)


def _rounds():
    rng = np.random.RandomState(11)
    return [{u: rng.randn(c, D).astype(np.float32) for u in range(N)} for c in LENGTHS]


async def _drive(gw, do_rounds):
    answers = []
    for chunks in do_rounds:
        futs = [gw.submit_ingest(u, chunks[u]) for u in range(N)]
        qfuts = [gw.submit_query(u) for u in range(N)]
        await gw.tick()
        await asyncio.gather(*futs)
        answers.append(await asyncio.gather(*qfuts))
    return answers


async def _query_all(gw):
    qfuts = [gw.submit_query(u) for u in range(N)]
    await gw.tick()
    return await asyncio.gather(*qfuts)


def _leaves(a):
    return [np.asarray(a["autocovariance"])] + [np.asarray(a["moments"][k])
                                                 for k in ("mean", "var", "count")]


def test_chaos_schedule_end_to_end_matches_fault_free_run(tmp_path):
    """The port's pin of tests/test_chaos.py:602: kernel failure + torn
    checkpoint + stalled tick through the port's gateway on a (torch,
    torch) breaker, with kill-and-restart: every non-rejected answer is
    bitwise the port's fault-free run (and within tolerance of the
    reference's), the breaker trips once, and a second restart walks back
    past both torn generations."""
    rounds = _rounds()
    ref_gw = jg.StatsGateway(RefSession(d=D, num_users=N, backend="jnp"))
    ref_gw.session.autocovariance(3)
    ref_gw.session.moments(8)
    ref = run(_drive(ref_gw, rounds))
    run(ref_gw.stop())
    free_gw = StatsGateway(_session(N))
    free = run(_drive(free_gw, rounds))
    run(free_gw.stop())
    for got_t, want_t in zip(free, ref):
        for g, w in zip(got_t, want_t):
            for a, b in zip(_leaves(g), _leaves(w)):
                np.testing.assert_allclose(a, b, **TOL)

    def check(got, want):
        for g, w in zip(got, want):
            for a, b in zip(_leaves(g), _leaves(w)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)

    cfg = GatewayConfig(checkpoint_dir=str(tmp_path), snapshot_every=1, keep_checkpoints=3,
                        tick_deadline=0.0,  # armed mid-run, past the first ticks
                        degraded_recovery=1)

    def chaos_gateway():
        br = CircuitBreakerBackend(primary=TorchBackend(), fallback=TorchBackend(),
                                   trip_after=1, cooldown_calls=2)
        return StatsGateway(_session(N, backend=br), cfg)

    inj = FaultInjector(seed=42)
    inj.fail("backend.fused_plan_update", calls=range(1000))  # kernel down
    inj.corrupt("checkpoint.payload", calls={1})              # tear generation 1
    inj.stall("gateway.tick", calls={2}, seconds=0.25)        # straggle tick 2

    gw = chaos_gateway()
    with chaos.scoped(inj):
        got = run(_drive(gw, rounds[:2]))  # ticks 0-1 (snapshots 0, 1)
        check(got[0], free[0])
        check(got[1], free[1])
        gw.config.tick_deadline = 0.05  # arm the watchdog
        got2 = run(_drive(gw, rounds[2:]))  # tick 2: stalled but serves
        check(got2[0], free[2])
        assert gw.health()["state"] == "degraded"
        assert gw.counters["snapshots_deferred"] == 1
        with pytest.raises(Degraded):  # shed while degraded: excluded from the comparison
            gw.submit_query(0)

        async def recover():
            await gw.tick()  # tick 3: clean -> ok + snapshot
            assert gw.health()["state"] == "ok"
            return await _query_all(gw)  # tick 4

        check(run(recover()), free[2])
        bm = gw.health()["breaker"]
        assert bm["trips"] == 1 and bm["fallback_calls"] > 0
        assert bm["primitives"]["fused_plan_update"]["primary_calls"] == 0
        assert ("backend.fused_plan_update", 0, "fail") in inj.log
        gw._loop_rt.manager.flush()  # snapshots durable, then "crash"

        # kill and restart: the newest generation (tick 3) is intact
        gw.config.tick_deadline = 0.0
        gw2 = chaos_gateway()
        assert gw2.counters["restored_from_snapshot"] == 1
        assert gw2._loop_rt.last_restore_skipped == []
        check(run(_query_all(gw2)), free[2])
        assert gw2.counters["programs_ingest"] == 0
        run(gw2.stop())

        # tear the newest generation too: the restore walks back past both
        # torn generations (3 now, 1 by the injector) to generation 0
        assert list_steps(str(tmp_path)) == [0, 1, 3]
        _tear(str(tmp_path / "step_0000000003" / "arrays.npz"))
        gw3 = chaos_gateway()
        assert gw3.counters["restored_from_snapshot"] == 1
        assert gw3._loop_rt.last_restore_skipped == [3, 1]
        assert gw3._tick == 1
        check(run(_query_all(gw3)), free[0])
        run(gw3.stop(final_snapshot=False))
