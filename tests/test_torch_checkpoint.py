"""The port's checkpoints, chaos schedules and fault runtime against the
reference's (`repro.checkpoint.manager`, `repro.runtime.chaos`,
`repro.runtime.fault`).

Trees of tensors and numpy leaves are saved and restored on the CPU (a
tensor leaf restores on its template leaf's device and dtype, a numpy leaf
on the host).  A generation written by either package restores in the
other, leaf for leaf, and a session restored from the other package's
generation answers as the exporter did (forecasts within rtol 1e-4 / atol
1e-5, the reference tests' tolerance).  The two chaos modules keep separate
schedules: each test arms and disarms its own.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jm
from repro.core.frame import FrameSession as RefSession
from repro.runtime import chaos as jchaos
from repro_torch import FrameSession
from repro_torch.checkpoint import manager as tm
from repro_torch.checkpoint.manager import (CheckpointCorrupt, CheckpointManager, latest_step,
                                            list_steps, restore_latest_intact, restore_pytree,
                                            restore_tenant_latest_intact, restore_tenant_pytree,
                                            save_pytree, sweep_tmp_dirs)
from repro_torch.core.streaming import PartialState
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import FaultInjector, InjectedFault
from repro_torch.runtime.fault import (FaultTolerantLoop, StragglerMonitor, plan_remesh)

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

D = 2
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    chaos.clear()
    jchaos.clear()


def _tree(seed=0):
    """Tensors (one int32), a numpy leaf, a state dataclass and a None."""
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn(8, 4, generator=g), "b": torch.zeros(4)},
            "step": torch.tensor(7 + seed, dtype=torch.int32),
            "cursor": np.arange(3, dtype=np.int64) + seed,
            "state": PartialState(stat={"lagged": torch.randn(2, 2, 2, generator=g)},
                                  sample_sum=torch.randn(2, generator=g), head=torch.zeros(1, 2),
                                  tail=torch.ones(1, 2), length=torch.tensor(5, dtype=torch.int32),
                                  t0=torch.tensor(0, dtype=torch.int32), stat_err=None)}


def _zeros_like(tree):
    return tm._map_with_path(lambda _, leaf: (torch.zeros_like(leaf)
                                               if isinstance(leaf, torch.Tensor)
                                               else np.zeros_like(leaf)), tree)


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo mesh in this process (the distribution layer at
    world 1; tests/test_torch_mesh.py runs worlds 1-8 in rank processes)."""
    import torch.distributed as dist

    from repro_torch.parallel import data_mesh

    mesh = data_mesh(1, 0, "file://" + str(tmp_path / "rendezvous"), device="cpu")
    yield mesh
    dist.destroy_process_group()


def _assert_tree_equal(a, b):
    ia, ib = tm._items(a), tm._items(b)
    assert [p for p, _ in ia] == [p for p, _ in ib]
    for (p, x), (_, y) in zip(ia, ib):
        assert type(x) is type(y), p
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, p
        np.testing.assert_array_equal(tm._to_host(x), tm._to_host(y), err_msg=str(p))


def _tear(path):
    with open(path, "r+b") as f:
        f.seek(max(os.path.getsize(path) // 2, 0))
        f.write(b"\x00TORN\x00")


# ------------------------------------------------------------ save / restore
def test_save_restore_roundtrip_keys_and_placement(tmp_path):
    t = _tree(1)
    path = save_pytree(t, str(tmp_path), 3)
    assert latest_step(str(tmp_path)) == 3 and path.endswith("step_0000000003")
    back = restore_pytree(_zeros_like(t), str(tmp_path))
    _assert_tree_equal(back, t)
    assert isinstance(back["cursor"], np.ndarray) and back["cursor"].dtype == np.int64
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["keys"] == sorted(manifest["checksums"]) == sorted(
        ["cursor", "layers/b", "layers/w", "state/.head", "state/.length",
         "state/.sample_sum", "state/.stat/lagged", "state/.t0", "state/.tail", "step"])
    assert not any(n.startswith("tmp.") for n in os.listdir(tmp_path))


def test_restore_casts_to_the_template_leaf(tmp_path):
    save_pytree({"x": np.arange(4, dtype=np.float64), "n": np.arange(2, dtype=np.int64)},
                str(tmp_path), 0)
    back = restore_pytree({"x": torch.zeros(4), "n": np.zeros(2, np.int32)}, str(tmp_path))
    assert back["x"].dtype == torch.float32 and back["n"].dtype == np.int32
    assert back["x"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_checksum_is_the_reference_crc32():
    """Same bytes, same crc32 (the port reads a byte view, not a copy)."""
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((64, 33)).astype(np.float32),
                rng.standard_normal((5, 3, 2))[:, ::2],     # non-contiguous
                np.array(3, np.int32), np.zeros((0, 4), np.float32),
                rng.random(17) > 0.5, np.arange(6, dtype=np.int64)):
        assert tm._checksum(arr) == jm._checksum(arr)


def test_restore_shape_mismatch_names_key_and_shapes(tmp_path):
    save_pytree(_tree(), str(tmp_path), 0)
    template = _tree()
    template["layers"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError) as ei:
        restore_pytree(template, str(tmp_path))
    msg = str(ei.value)
    assert "layers/w" in msg and "(8, 4)" in msg and "(4, 4)" in msg


def test_shardings_wait_for_the_distribution_slice(tmp_path, mesh1):
    """Mesh placements at world 1: a DTensor leaf saves whole, ``shardings``
    restores it as Shard(0) or Replicate() (None keeps the template's
    placement) bitwise, a generation without DTensors restores onto the
    mesh, and FaultTolerantLoop.restore_or passes ``shardings`` through."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tree = _tree()
    w = tree["layers"]["w"]
    tree["layers"]["w"] = DTensor.from_local(w, mesh1, [Shard(0)], run_check=False)
    ckdir = str(tmp_path / "ck")
    save_pytree(tree, ckdir, 0)
    plain = restore_pytree(_zeros_like(_tree()), ckdir)  # no shardings: plain tensors
    _assert_tree_equal(plain, _tree())
    shardings = tm._map_with_path(lambda path, leaf: None, _tree())
    for placement in (Shard(0), Replicate()):
        shardings["layers"]["w"] = (mesh1, [placement])
        back = restore_pytree(_zeros_like(_tree()), ckdir, shardings=shardings)
        got = back["layers"]["w"]
        assert isinstance(got, DTensor) and got.placements == (placement,)
        assert torch.equal(got.to_local(), w) and got.shape == w.shape
        back["layers"]["w"] = got.to_local()
        _assert_tree_equal(back, _tree())
    loop = FaultTolerantLoop(ckdir, every=0)
    state, start = loop.restore_or(_zeros_like(_tree()), shardings=shardings)
    loop.close()
    assert start == 1 and torch.equal(state["layers"]["w"].full_tensor(), w)
    with pytest.raises(ValueError, match="by Shard\\(0\\)"):
        shardings["layers"]["w"] = (mesh1, [Shard(1)])
        restore_pytree(_zeros_like(_tree()), ckdir, shardings=shardings)


# --------------------------------------------------- atomicity and debris
def test_async_manager_retention_and_sweep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(_tree(s), s)
    mgr.flush()
    assert list_steps(str(tmp_path)) == [3, 4] and mgr.saved_steps == [0, 1, 2, 3, 4]
    mgr.close()
    for name in ("tmp.7.abcd1234", "trash.1.deadbeef"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "arrays.npz").write_bytes(b"partial garbage")
    CheckpointManager(str(tmp_path), keep=2).close()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]
    _assert_tree_equal(restore_pytree(_zeros_like(_tree()), str(tmp_path)), _tree(4))


def test_manager_save_takes_host_copies(tmp_path):
    """The writer thread sees host arrays only: a tensor changed in place
    after ``save`` of its export does not reach the generation."""
    live = torch.arange(6.0)
    mgr = CheckpointManager(str(tmp_path))
    snapshot = {"x": live.clone()}  # what FrameSession.export_state hands out
    mgr.save(snapshot, 0)
    live.add_(100.0)
    mgr.flush()
    mgr.close()
    assert restore_pytree({"x": torch.zeros(6)}, str(tmp_path))["x"].tolist() == \
        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_crash_mid_write_preserves_previous_generation(tmp_path, monkeypatch):
    save_pytree(_tree(0), str(tmp_path), 5)

    def boom(*a, **k):
        raise OSError("disk died mid-save")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        save_pytree(_tree(1), str(tmp_path), 5)
    monkeypatch.undo()
    _assert_tree_equal(restore_pytree(_zeros_like(_tree()), str(tmp_path), 5), _tree(0))


def test_crash_between_renames_is_recovered_on_sweep(tmp_path, monkeypatch):
    save_pytree(_tree(0), str(tmp_path), 2)
    real_rename, calls = os.rename, {"n": 0}

    def flaky_rename(src, dst):
        calls["n"] += 1  # 1st: final -> trash; 2nd: tmp -> final (the crash)
        if calls["n"] == 2:
            raise OSError("killed between the renames")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", flaky_rename)
    with pytest.raises(OSError):
        save_pytree(_tree(1), str(tmp_path), 2)
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) is None
    recovered = sweep_tmp_dirs(str(tmp_path))
    assert len(recovered) == 1 and recovered[0].endswith("step_0000000002")
    _assert_tree_equal(restore_pytree(_zeros_like(_tree()), str(tmp_path)), _tree(1))
    assert not any(n.startswith(("tmp.", "trash.")) for n in os.listdir(tmp_path))


def test_close_does_not_leak_worker_after_save_error(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def boom(tree, directory, step):
        raise RuntimeError("save exploded")

    monkeypatch.setattr(tm, "save_pytree", boom)
    mgr.save(_tree(), 0)
    with pytest.raises(RuntimeError, match="save exploded"):
        mgr.close()
    mgr._worker.join(timeout=5.0)
    assert not mgr._worker.is_alive()


# --------------------------------------------- verification and walk-back
def _big(seed):
    """A tree whose payload is mostly one leaf's data: the middle of the
    file, where a tear lands, is inside that leaf."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 64, generator=g), "cursor": np.arange(3, dtype=np.int64)}


def test_torn_payload_walk_back_and_cold_start(tmp_path):
    for step in range(3):
        save_pytree(_big(step), str(tmp_path), step)
    _tear(str(tmp_path / "step_0000000002" / "arrays.npz"))
    with pytest.raises(CheckpointCorrupt, match="verification|unreadable"):
        restore_pytree(_big(0), str(tmp_path), 2)
    # verify=False skips the checksums, but a torn zip entry still cannot load
    with pytest.raises(CheckpointCorrupt, match="unreadable"):
        restore_pytree(_big(0), str(tmp_path), 2, verify=False)
    state, step, skipped = restore_latest_intact(_zeros_like(_big(0)), str(tmp_path))
    assert step == 1 and skipped == [2]
    _assert_tree_equal(state, _big(1))
    for s in (0, 1):
        _tear(str(tmp_path / f"step_{s:010d}" / "arrays.npz"))
    with pytest.raises(CheckpointCorrupt, match="every retained"):
        restore_latest_intact(_big(0), str(tmp_path))
    loop = FaultTolerantLoop(str(tmp_path), every=1)
    with pytest.warns(RuntimeWarning, match="starting fresh"):
        got, start = loop.restore_or(_big(5))
    assert start == 0 and loop.last_restore_skipped == [2, 1, 0]
    loop.close()


def _mixed_tree(seed=0):
    """bfloat16, float32 and integer leaves (bf16 with a NaN, an inf, a
    subnormal and -0.0 among them)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(33, 7, generator=g).to(torch.bfloat16)
    w.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), 1e-40, -0.0])
    return {"params": {"w": w, "b": torch.randn(7, generator=g).to(torch.bfloat16)},
            "m": torch.randn(33, 7, generator=g), "step": torch.tensor(3, dtype=torch.int32),
            "cursor": np.arange(5, dtype=np.int64)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_leaves_save_and_restore_bitwise(tmp_path):
    """A bfloat16 leaf is stored as its uint16 bits, named in the
    manifest's ``dtypes``, and restores bit for bit (NaN payload and -0.0
    included), synchronously and through the async manager; float32 and
    integer leaves beside it restore as before."""
    tree = _mixed_tree(1)
    save_pytree(tree, str(tmp_path / "sync"), 0)
    mgr = CheckpointManager(str(tmp_path / "async"))
    mgr.save(tree, 0)
    mgr.close()
    for sub in ("sync", "async"):
        manifest = tm.load_manifest(str(tmp_path / sub), 0)
        assert manifest["dtypes"] == {"params/b": "bfloat16", "params/w": "bfloat16"}
        got = restore_pytree(_zeros_like(_mixed_tree(2)), str(tmp_path / sub), 0)
        for (p, x), (_, y) in zip(tm._items(got), tm._items(tree)):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype, p
                assert torch.equal(_bits(x), _bits(y)), p
            else:
                np.testing.assert_array_equal(x, y)
    # a float32 template takes the bf16 values exactly
    f32 = restore_pytree({"params": {"w": torch.zeros(33, 7), "b": torch.zeros(7)},
                          "m": torch.zeros(33, 7), "step": torch.tensor(0, dtype=torch.int32),
                          "cursor": np.zeros(5, np.int64)}, str(tmp_path / "sync"), 0)
    assert torch.equal(f32["params"]["b"], tree["params"]["b"].float())


def test_corrupt_bf16_payload_is_caught(tmp_path):
    """One flipped bit in a bf16 leaf's stored bits fails its crc32; a torn
    payload fails to load."""
    save_pytree(_mixed_tree(), str(tmp_path), 0)
    payload = str(tmp_path / "step_0000000000" / "arrays.npz")
    with np.load(payload) as data:
        arrays = {k: data[k] for k in data.files}
    assert arrays["params/w"].dtype == np.uint16
    arrays["params/w"].reshape(-1)[7] ^= 1
    np.savez(payload, **arrays)
    with pytest.raises(CheckpointCorrupt, match="params/w.*verification"):
        restore_pytree(_mixed_tree(), str(tmp_path), 0)
    big = {"w": torch.randn(512, 256, generator=torch.Generator().manual_seed(3)).bfloat16()}
    save_pytree(big, str(tmp_path), 1)
    _tear(str(tmp_path / "step_0000000001" / "arrays.npz"))
    with pytest.raises(CheckpointCorrupt, match="verification|unreadable"):
        restore_pytree(big, str(tmp_path), 1)


def test_injected_corruption_and_pre_checksum_generations(tmp_path):
    inj = FaultInjector().corrupt("checkpoint.payload", calls={1})
    with chaos.scoped(inj):
        save_pytree(_tree(1), str(tmp_path), 0)   # call 0: intact
        save_pytree(_tree(2), str(tmp_path), 1)   # call 1: torn on disk
    assert inj.log == [("checkpoint.payload", 1, "corrupt")]
    restore_pytree(_tree(), str(tmp_path), 0)
    with pytest.raises(CheckpointCorrupt, match="verification|unreadable"):
        restore_pytree(_tree(), str(tmp_path), 1)
    man = str(tmp_path / "step_0000000000" / "manifest.json")
    with open(man) as f:
        payload = json.load(f)
    del payload["checksums"]  # a generation from before checksums
    with open(man, "w") as f:
        json.dump(payload, f)
    _assert_tree_equal(restore_pytree(_zeros_like(_tree()), str(tmp_path), 0), _tree(1))


def test_manager_retries_and_surfaces_exhausted_retries(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), retries=2, backoff=0.01)
    with chaos.scoped(FaultInjector().fail("checkpoint.write", calls={0})):
        mgr.save(_tree(3), 0)
        mgr.flush()
    assert mgr.retried_saves == 1 and mgr.saved_steps == [0]
    mgr.close()
    mgr = CheckpointManager(str(tmp_path / "b"), retries=2, backoff=0.01)
    with chaos.scoped(FaultInjector().fail("checkpoint.write", calls={0, 1, 2})):
        mgr.save(_tree(3), 0)
        with pytest.raises(InjectedFault):
            mgr.flush()
    assert mgr.retried_saves == 2 and mgr.latest_step() is None
    with pytest.raises(InjectedFault):
        mgr.close()
    assert not mgr._worker.is_alive()


# ------------------------------------------------------- per-tenant restore
_AXES = {"lanes/stat": 1, "counts": 0}


def _toy_state(value):
    return {"lanes": {"stat": np.full((2, 4, 3), value, np.float32)},
            "counts": np.arange(4, dtype=np.int64) * int(value)}


def test_restore_tenant_extracts_walks_back_and_needs_metadata(tmp_path):
    d = str(tmp_path)
    save_pytree(_toy_state(1.0), d, 1, meta={"tenant_axes": _AXES})
    save_pytree(_toy_state(2.0), d, 2, meta={"tenant_axes": _AXES})
    template = {"lanes": {"stat": torch.zeros(2, 4, 3)}, "counts": np.zeros(4, np.int64)}
    got = restore_tenant_pytree(template, d, tenant=3)
    assert got["lanes"]["stat"].shape == (2, 3) and float(got["lanes"]["stat"][0, 0]) == 2.0
    assert got["counts"] == 6 and isinstance(got["counts"], np.ndarray)
    assert restore_tenant_pytree(template, d, tenant=3, step=1)["counts"] == 3
    with pytest.raises(ValueError):
        restore_tenant_pytree(template, d, tenant=99)
    with open(os.path.join(d, "step_0000000002", "arrays.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad\xbe\xef")
    state, step, skipped = restore_tenant_latest_intact(template, d, tenant=0)
    assert (step, skipped) == (1, [2]) and state["counts"] == 0
    poisoned = _toy_state(3.0)
    poisoned["lanes"]["stat"][0, 2, 1] = np.nan
    save_pytree(poisoned, d, 3, meta={"tenant_axes": _AXES})
    _, step, skipped = restore_tenant_latest_intact(template, d, tenant=2)
    assert step == 1 and 3 in skipped
    assert restore_tenant_latest_intact(template, d, tenant=1)[1] == 3
    save_pytree(_toy_state(1.0), str(tmp_path / "bare"), 1)
    with pytest.raises(CheckpointCorrupt):
        restore_tenant_pytree(template, str(tmp_path / "bare"), tenant=0)


# ------------------------------------------------- the reference's generations
def _declare(sess):
    sess.autocovariance(3)
    sess.moments(8)
    sess.welch(16, 8)
    sess.forecast(4, model="auto", p=2, max_period=8)
    sess.anomaly_scores(model="arma", p=1, q=1)
    return sess


def _ingest_both(port, ref, users=3, seed=0):
    """Three ticks of 24 rows: per tenant a stable AR(1) plus a sinusoid."""
    rng = np.random.default_rng(seed)
    e = 0.3 * rng.standard_normal((users, 72, D)).astype(np.float32)
    x = np.zeros_like(e)
    for t in range(1, 72):
        x[:, t] = 0.5 * x[:, t - 1] + e[:, t]
    x += np.sin(2 * np.pi * np.arange(72) / 6)[None, :, None].astype(np.float32)
    for lo in range(0, 72, 24):
        chunk = np.ascontiguousarray(x[:, lo: lo + 24])
        port.ingest(np.arange(users), chunk)
        ref.ingest(jnp.arange(users), jnp.asarray(chunk))


def _assert_answers(got, want):
    for name in ("forecast", "anomaly"):
        for key, w in want[name].items():
            g = got[name][key].numpy()
            if key in ("period", "valid"):
                np.testing.assert_array_equal(g, np.asarray(w))
            else:
                np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("window", [None, 96])
def test_generations_cross_between_packages(tmp_path, window):
    """A generation the reference's ``save_pytree`` writes of its session's
    ``export_state`` restores in the port (leaves bitwise, answers within
    tolerance), and a port-written one restores in the reference."""
    kw = {} if window is None else dict(window=window, num_buckets=4)
    port = _declare(FrameSession(d=D, num_users=3, device="cpu", **kw))
    ref = _declare(RefSession(d=D, num_users=3, backend="jnp", **kw))
    _ingest_both(port, ref)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jm.save_pytree(jax.device_get(ref.export_state()), jdir, 4,
                   meta={"tenant_axes": ref.tenant_axes()})
    tm.save_pytree(port.export_state(), tdir, 4, meta={"tenant_axes": port.tenant_axes()})
    assert port.tenant_axes() == ref.tenant_axes()
    assert (json.load(open(os.path.join(jdir, "step_0000000004", "manifest.json")))["keys"]
            == json.load(open(os.path.join(tdir, "step_0000000004", "manifest.json")))["keys"])

    fresh = _declare(FrameSession(d=D, num_users=3, device="cpu", **kw))
    state, step, skipped = restore_latest_intact(fresh.state_template(), jdir)
    assert (step, skipped) == (4, [])
    flat = tm._flatten(state)
    for key, arr in jm._flatten(jax.device_get(ref.export_state())).items():
        np.testing.assert_array_equal(flat[key], arr, err_msg=key)
    assert isinstance(state["group_0"]["counts"], np.ndarray)
    fresh.import_state(state)
    _assert_answers(fresh.query_batch([0, 1, 2]), ref.query_batch(jnp.arange(3)))

    ref2 = _declare(RefSession(d=D, num_users=3, backend="jnp", **kw))
    back, step, _ = jm.restore_latest_intact(ref2.state_template(), tdir)
    ref2.import_state(back)
    _assert_answers(port.query_batch([0, 1, 2]), ref2.query_batch(jnp.arange(3)))
    one = restore_tenant_pytree(fresh.state_template(), jdir, tenant=1)
    fresh.import_tenant(1, one)
    _assert_answers(fresh.query_batch([1]), ref.query_batch(jnp.asarray([1])))


# ------------------------------------------------------------ chaos schedules
def _fire_all(mod, inj, site, n):
    out = []
    with mod.scoped(inj):
        for i in range(n):
            try:
                mod.fire(site)
            except mod.InjectedFault:
                out.append(i)
    return out


def test_schedules_replay_the_reference_and_stay_separate():
    """One seed and rule give the reference's firings on every site (the
    ``backend.*`` sites included, accepted though no port code fires them),
    and installing one package's injector leaves the other's hooks idle."""
    for site in ("checkpoint.write", "gateway.tick", "backend.fused_plan_update"):
        a = _fire_all(chaos, chaos.FaultInjector(seed=7).fail(site, rate=0.3), site, 200)
        b = _fire_all(jchaos, jchaos.FaultInjector(seed=7).fail(site, rate=0.3), site, 200)
        assert a == b and 20 < len(a) < 100
    inj = FaultInjector(seed=1).corrupt("ingest.payload", calls={0})
    with chaos.scoped(inj):
        assert jchaos.installed() is None
        assert jchaos.should_corrupt("ingest.payload") is False
        assert chaos.should_corrupt("ingest.payload") is True
    assert chaos.installed() is None


def test_injector_schedules():
    inj = FaultInjector(seed=0).fail("backend.fused_plan_update", calls={2, 3})
    raised = []
    for i in range(6):
        try:
            inj.fire("backend.fused_plan_update")
        except InjectedFault:
            raised.append(i)
    assert raised == [2, 3] and inj.count("backend.fused_plan_update") == 6
    solo = FaultInjector(seed=3).fail("b", rate=0.5)
    both = FaultInjector(seed=3).fail("a", rate=0.5).fail("b", rate=0.5)

    def fires_b(i):
        out = []
        for n in range(64):
            if i is both:
                try:
                    i.fire("a")
                except InjectedFault:
                    pass
            try:
                i.fire("b")
            except InjectedFault:
                out.append(n)
        return out

    assert fires_b(solo) == fires_b(both)
    stall = FaultInjector().stall("s", calls={1}, seconds=0.05).fail("s", calls={1})
    stall.fire("s")
    t0 = time.perf_counter()
    with pytest.raises(InjectedFault, match="call 1"):
        stall.fire("s")
    assert time.perf_counter() - t0 >= 0.04
    assert [a for (_, _, a) in stall.log] == ["stall", "fail"]
    chaos.fire("anything")
    assert chaos.should_corrupt("anything") is False


# ------------------------------------------------------------- fault runtime
def test_fault_loop_resume_and_step_timing(tmp_path):
    loop = FaultTolerantLoop(str(tmp_path), every=2)
    state = {"x": torch.zeros(3)}
    time.sleep(0.2)  # construction time must not count as step 0
    for step in range(5):
        state = {"x": state["x"] + 1}
        loop.after_step(step, state)
    assert len(loop.monitor.times) == 4 and max(loop.monitor.times) < 0.15
    loop.checkpoint_now()
    assert loop.manager.saved_steps == [1, 3, 4]
    loop.checkpoint_now()  # step 4 is saved: nothing new
    loop.manager.flush()
    assert loop.manager.saved_steps == [1, 3, 4]
    loop.close()
    loop2 = FaultTolerantLoop(str(tmp_path), every=2)
    restored, start = loop2.restore_or({"x": torch.zeros(3)})
    assert start == 5 and restored["x"].tolist() == [5.0, 5.0, 5.0]
    loop2.close()


def test_straggler_monitor_edges():
    flagged = []
    mon = StragglerMonitor(threshold=2.0, on_straggle=lambda s, t, m: flagged.append(s))
    for i in range(20):
        mon.record(i, 0.1)
    mon.record(20, 0.5)
    assert flagged == [20] and mon.record(21, 0.1) is False
    short = StragglerMonitor(threshold=2.0, window=4)
    for step in range(3):
        assert short.record(step, 0.01) is False
    assert short.record(3, 0.1) is True
    exact = StragglerMonitor(threshold=2.0, window=16)
    for step in range(8):
        exact.record(step, 1.0)
    assert exact.record(8, 2.0) is False and exact.record(9, 2.0 + 1e-6) is True
    with pytest.raises(ValueError):
        StragglerMonitor(window=0)


def test_plan_remesh_matches_reference():
    from repro.runtime.fault import plan_remesh as ref_plan

    for n in (512, 500, 7, 1, 33, 4):
        a, b = plan_remesh(n), ref_plan(n)
        assert (a.data, a.model, a.dropped_devices, a.world) == \
            (b.data, b.model, b.dropped_devices, b.world)
    assert plan_remesh(7, prefer_model=4).model == ref_plan(7, prefer_model=4).model
    with pytest.raises(ValueError):
        plan_remesh(0)
