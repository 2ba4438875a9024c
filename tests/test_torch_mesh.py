"""The port's distribution layer on a gloo mesh of CPU ranks, against the
reference's mesh paths.

`repro_torch.parallel` (``psum_tree``), `repro_torch.core.halo`, the mesh
placement of `TimeSeriesStore` (both halo modes), ``sharded_window_map_reduce``,
``autocovariance_sharded``, ``SeriesFrame.from_sharded(mesh=)`` and the
elastic restore of `repro_torch.checkpoint.manager` run in SPMD rank
processes (``sys.executable -c``, never importing jax or repro: each rank
checks) at worlds 1, 2, 4 and 8, meeting through a ``file://`` rendezvous.
Every world starts once, all together, and one rank body covers every
case; each rank writes its results to an ``.npz``.  The references: the
JAX package in this process, mesh-free and on its one-device mesh, and in
subprocesses on 8 host devices (whose mesh results hold the port's world 8)
and mesh-free for the frame, whose plans' compiles take most of the time;
they run side by side with the ranks (about a minute in all).

Tolerances: against the JAX package rtol 1e-4, atol 1e-5 (the float32
tolerances of tests/test_backend.py); bitwise across ranks, exchange
against replicate, world 1 against the port's mesh-free path, the halo
exchange against the overlapping blocks (copies), and a restore against
what was saved.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.manager import save_pytree as ref_save_pytree
from repro.core.backend import get_backend as ref_get_backend
from repro.core.estimators.stats import (autocovariance as ref_autocovariance,
                                         autocovariance_sharded as ref_autocovariance_sharded)
from repro.core.frame import SeriesFrame as RefFrame
from repro.core.halo import halo_exchange as ref_halo_exchange
from repro.core.halo import halo_exchange_grouped as ref_halo_exchange_grouped
from repro.core.mapreduce import (block_window_map_reduce as ref_block_map_reduce,
                                  serial_window_map_reduce as ref_serial_map_reduce,
                                  sharded_window_map_reduce as ref_sharded_map_reduce)
from repro.core.overlap import OverlapSpec as RefSpec, make_overlapping_blocks
from repro.timeseries import TimeSeriesStore as RefStore

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4, 8)
TOL = dict(rtol=1e-4, atol=1e-5)
HALO_N, HALO_L, HALO_R = 8 * 64, 4, 5
SOURCES = ("ref",) + tuple(f"w{w}" for w in WORLDS)  # generations each rank restores


def _series(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# The rank body: every case at one world size.  Results are flattened into
# "<case>/<path>" keys, as _flat does on the reference's side.
RANK = textwrap.dedent(r'''
    import os, sys, time
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, rdv, out, gens, src = (int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
    sys.path.insert(0, src)
    import numpy as np, torch
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import SeriesFrame, TimeSeriesStore
    from repro_torch.checkpoint.manager import restore_pytree, save_pytree
    from repro_torch.core.backend import CudaBackend
    from repro_torch.core.estimators.stats import autocovariance_blocked, autocovariance_sharded
    from repro_torch.core.halo import halo_exchange, halo_exchange_grouped
    from repro_torch.core.mapreduce import block_window_map_reduce, sharded_window_map_reduce
    from repro_torch.core.overlap import OverlapSpec
    from repro_torch.parallel import collective_count, data_mesh, reset_collective_count
    from repro_torch.runtime.fault import FaultTolerantLoop

    mesh = data_mesh(world, rank, "file://" + rdv, device="cpu")
    res = {}
    calls = []

    class Counting(CudaBackend):  # the default backend; on the CPU its plain versions
        def fused_plan_update(self, *a, **k):
            calls.append("fused_plan_update")
            return super().fused_plan_update(*a, **k)

        def masked_lagged_sums(self, *a, **k):
            calls.append("masked_lagged_sums")
            return super().masked_lagged_sums(*a, **k)

    def put(key, tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                put(f"{key}/{k}", tree[k])
        elif isinstance(tree, (tuple, list)):
            for i, t in enumerate(tree):
                put(f"{key}/{i}", t)
        else:
            res[key] = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)

    def series(n, d, seed):
        return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)

    def raises(fn):
        try:
            fn()
        except ValueError:
            return 1
        return 0

    def counted(key, fn):
        reset_collective_count()
        calls.clear()
        put(key, fn())
        res[key + "#collectives"] = collective_count()
        res[key + "#plan_calls"] = calls.count("fused_plan_update")
        res[key + "#lag_calls"] = calls.count("masked_lagged_sums")

    # ---- the store in both halo modes: outer(w[0], w[-1]), halos (2, 3)
    x = series(8 * 128, 3, 0)
    kern = lambda w: torch.outer(w[0], w[-1])
    stores = {}
    for mode in ("replicate", "exchange"):
        st = TimeSeriesStore.from_series(x, 128, 2, 3, mesh=mesh, halo_mode=mode, device="cpu")
        stores[mode] = st
        counted(f"store/{mode}", lambda: st.map_reduce(kern))
        put(f"store/{mode}#shape", np.array(st.blocks.shape))
        put(f"store/{mode}#local_blocks", st.blocks.to_local().shape[0])
        put(f"store/{mode}#dtensor", isinstance(st.blocks, DTensor))
        put(f"store/{mode}#series", st.to_series())
        put(f"store/{mode}#padded", st.padded_blocks_single_host())
        put(f"store/{mode}#chunks", torch.cat(list(st.iter_chunks(300))))
        free = TimeSeriesStore.from_series(x, 128, 2, 3, halo_mode=mode, device="cpu")
        put(f"free/store/{mode}", free.map_reduce(kern))

    # ---- autocovariance_sharded: n = 8 x 256, d = 4, H = 6
    x2 = series(8 * 256, 4, 1)
    st2 = TimeSeriesStore.from_series(x2, 256, 0, 6, mesh=mesh, device="cpu")
    counted("acov", lambda: autocovariance_sharded(st2.blocks, st2.spec, 6, mesh,
                                                   backend=Counting()))
    put("free/acov", autocovariance_blocked(torch.from_numpy(x2), 6, 256))

    # ---- halo exchange: the rank's rows of an (8 x 64, 3) series, halos (4, 5)
    x3 = torch.from_numpy(series(HALO_N, 3, 2))
    rows = HALO_N // world
    local = x3[rank * rows: (rank + 1) * rows]
    counted("halo/line", lambda: halo_exchange(local, HALO_L, HALO_R, mesh))
    put("halo/ring", halo_exchange_grouped(local, HALO_L, HALO_R, mesh, ring=True))
    put("halo/time_axis_1", halo_exchange(local.T, HALO_L, HALO_R, mesh, time_axis=1).T)
    put("halo/too_wide", raises(lambda: halo_exchange(local, rows + 1, 0, mesh)))

    # ---- sharded_window_map_reduce: a chunk kernel and a per-window kernel
    x5 = series(8 * 128, 3, 4)
    st5 = TimeSeriesStore.from_series(x5, 128, 0, 3, mesh=mesh, device="cpu")
    be = Counting()
    ck = lambda y, m: be.masked_lagged_sums(y, m, 3)
    counted("swmr/chunk", lambda: sharded_window_map_reduce(None, st5.blocks, st5.spec, mesh,
                                                            chunk_kernel=ck))
    put("swmr/window", sharded_window_map_reduce(kern, st5.blocks, st5.spec, mesh))
    spec5 = OverlapSpec(8 * 128, 128, 0, 3)
    put("free/swmr/chunk", block_window_map_reduce(None, torch.from_numpy(x5), spec5,
                                                   chunk_kernel=ck))
    put("free/swmr/window", block_window_map_reduce(kern, torch.from_numpy(x5), spec5))

    # ---- from_sharded(mesh=): collect, an append, a replan that widens the halo
    x4, extra = series(4096, 2, 5), series(300, 2, 6)

    def declare(f):
        f.autocovariance(8); f.yule_walker(4); f.moments(32); f.moments(16)
        f.welch(nperseg=64, overlap=32); f.forecast(8, "ar", p=3)
        return f

    def drive(tag, f):
        counted(f"{tag}/collect", declare(f).collect)
        counted(f"{tag}/append", lambda: f.append(extra).collect())
        f.moments(128)
        counted(f"{tag}/replan", f.collect)
        return f

    f = drive("frame", SeriesFrame.from_sharded(x4, mesh=mesh, block_size=512,
                                                backend=Counting(), device="cpu"))
    put("frame#halo", f._store.spec.h_right)
    drive("free/frame", SeriesFrame.from_sharded(x4, block_size=512, device="cpu"))
    st4 = TimeSeriesStore.from_series(x4, 512, 0, 127, mesh=mesh, device="cpu")
    f = drive("caller", SeriesFrame.from_sharded(st4, device="cpu"))
    put("caller#n", st4.spec.n)
    put("caller#pending", len(f._pending))
    one_device = TimeSeriesStore.from_series(x4, 512, 0, 127, device="cpu")
    drive("free/caller", SeriesFrame.from_sharded(one_device, device="cpu"))

    # ---- the errors
    put("err/indivisible", raises(lambda: TimeSeriesStore.from_series(
        series(3 * 64, 2, 7), 64, 0, 2, mesh=mesh, device="cpu")))
    if world > 1:  # 3 blocks divide over one rank
        put("err/indivisible_swmr", raises(lambda: sharded_window_map_reduce(
            kern, st5.blocks, OverlapSpec(3 * 64, 64, 0, 3), mesh)))
    put("err/append_rows", raises(lambda: stores["replicate"].append_rows(x[:4])))
    put("err/mixed_store", raises(lambda: SeriesFrame.from_sharded(one_device, mesh=mesh,
                                                                   device="cpu")))
    put("err/mixed_device", raises(lambda: SeriesFrame.from_sharded(x4, mesh=mesh,
                                                                    device="meta")))

    # ---- elastic restore: the replicate store's blocks, written at this world,
    # restored from every world's generation and the reference's
    st = stores["replicate"]
    mine = os.path.join(gens, f"w{world}")
    save_pytree({"blocks": st.blocks, "n": np.array([st.spec.n])}, mine, 0)
    template = {"blocks": st.blocks, "n": np.zeros(1, np.int64)}
    shard = {"blocks": (mesh, [Shard(0)]), "n": None}
    for name in SOURCES:
        gen = os.path.join(gens, name)
        deadline = time.monotonic() + 420
        while not os.path.isdir(os.path.join(gen, "step_0000000000")):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no generation from {name}")
            time.sleep(0.05)
        back = restore_pytree(template, gen, shardings=shard)
        whole = restore_pytree(template, gen,
                               shardings={"blocks": (mesh, [Replicate()]), "n": None})
        res[f"restore/{name}"] = np.array([
            isinstance(back["blocks"], DTensor) and back["blocks"].shape == st.blocks.shape,
            torch.equal(back["blocks"].to_local(), st.blocks.to_local()),
            torch.equal(whole["blocks"].to_local(), st.blocks.full_tensor()),
            int(back["n"][0]) == st.spec.n])
    loop = FaultTolerantLoop(mine, every=0)
    state, start = loop.restore_or(template, shardings=shard)
    loop.close()
    res["restore/loop"] = np.array([start == 1, torch.equal(state["blocks"].to_local(),
                                                             st.blocks.to_local())])

    put("isolated", not any(m == "jax" or m.startswith(("jax.", "repro."))
                            for m in sys.modules if sys.modules[m] is not None))
    np.savez(os.path.join(out, f"w{world}_r{rank}.npz"), **res)
    torch.distributed.destroy_process_group()
''')


def _flat(key, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{key}/{k}", tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            _flat(f"{key}/{i}", t, out)
    else:
        out[key] = np.asarray(tree)
    return out


def reference(mesh, part: str) -> dict:
    """The reference's results of the rank body's cases, on its mesh or
    mesh-free (``mesh=None``; the halo exchange is then held against the
    overlapping blocks).  ``part``: "data" (the store, autocovariance,
    map-reduce and halo cases), "frame" (the frame's collect and the
    collect after an append) or "replan" (a frame that declares the
    replan's seven requests from the start: the replan's statistics with
    the append, in a process of its own).  The frame's plans take most of
    the file's time in their compiles, so the parts run side by side."""
    out = {}
    if part == "data":
        _reference_data(mesh, out)
    x4, extra = jnp.asarray(_series(4096, 2, 5)), jnp.asarray(_series(300, 2, 6))
    f = RefFrame.from_sharded(x4, mesh=mesh, block_size=512)
    f.autocovariance(8), f.yule_walker(4), f.moments(32), f.moments(16)
    f.welch(nperseg=64, overlap=32), f.forecast(8, "ar", p=3)
    if part == "frame":
        _flat("frame/collect", f.collect(), out)
        f.append(extra)
        _flat("frame/append", f.collect(), out)
    elif part == "replan":
        f.moments(128)
        f.collect()
        f.append(extra)
        _flat("frame/replan", f.collect(), out)
    return out


def _reference_data(mesh, out):
    x = jnp.asarray(_series(8 * 128, 3, 0))
    kern = lambda w: jnp.outer(w[0], w[-1])
    for mode in ("replicate", "exchange"):
        st = RefStore.from_series(x, 128, 2, 3, mesh=mesh, halo_mode=mode)
        _flat(f"store/{mode}", st.map_reduce(kern), out)
    _flat("serial/store", ref_serial_map_reduce(kern, x, 2, 3), out)
    x2 = jnp.asarray(_series(8 * 256, 4, 1))
    if mesh is None:
        _flat("acov", ref_autocovariance(x2, 6), out)
    else:
        st2 = RefStore.from_series(x2, 256, 0, 6, mesh=mesh)
        _flat("acov", ref_autocovariance_sharded(st2.blocks, st2.spec, 6, mesh), out)
    x5 = jnp.asarray(_series(8 * 128, 3, 4))
    jnp_be = ref_get_backend("jnp")
    ck = lambda y, m: jnp_be.masked_lagged_sums(y, m, 3)
    if mesh is None:
        spec5 = RefSpec(8 * 128, 128, 0, 3)
        _flat("swmr/chunk", ref_block_map_reduce(None, x5, spec5, chunk_kernel=ck), out)
        _flat("swmr/window", ref_block_map_reduce(kern, x5, spec5), out)
        return
    st5 = RefStore.from_series(x5, 128, 0, 3, mesh=mesh)
    _flat("swmr/chunk", ref_sharded_map_reduce(None, st5.blocks, st5.spec, mesh,
                                               chunk_kernel=ck), out)
    _flat("swmr/window", ref_sharded_map_reduce(kern, st5.blocks, st5.spec, mesh), out)
    from jax.sharding import PartitionSpec as P

    from repro.parallel.sharding import shard_map_compat

    x3 = jnp.asarray(_series(HALO_N, 3, 2))
    for name, fn in (("line", ref_halo_exchange),
                     ("ring", lambda *a: ref_halo_exchange_grouped(*a, ring=True))):
        padded = jax.jit(shard_map_compat(lambda v: fn(v, HALO_L, HALO_R, "data"), mesh,
                                          in_specs=P("data"), out_specs=P("data")))(x3)
        out[f"halo/{name}"] = np.asarray(padded)


# A part of the reference in a subprocess (the test process keeps its one
# device): argv = out.npz, src, tests, devices (0: mesh-free), part.
REF = textwrap.dedent('''
    import sys
    sys.path[:0] = [sys.argv[2], sys.argv[3]]
    import jax, numpy as np
    import test_torch_mesh as t
    mesh = (jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
            if sys.argv[4] == "8" else None)
    np.savez(sys.argv[1], **t.reference(mesh, sys.argv[5]))
''')
# the parts run in subprocesses: (devices, part)
REF_PARTS = ((8, "data"), (8, "frame"), (8, "replan"), (0, "frame"), (0, "replan"))


def _start(code, args, log, env=None):
    with open(log, "w") as f:  # a file, not a pipe: no rank blocks on a full pipe
        return subprocess.Popen([sys.executable, "-c", code, *map(str, args)], env=env,
                                stdout=f, stderr=subprocess.STDOUT)


def _finish(proc, log, what):
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, f"{what}: rc {proc.returncode}\n{log.read_text()[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks and the 8-device reference started together, and
    meanwhile the reference in this process, mesh-free and on its one-device
    mesh: {"ranks": {world: [rank results]}, "mesh8", "free", "mesh1": the
    reference's results}."""
    tmp = tmp_path_factory.mktemp("mesh")
    gens, outs = tmp / "gens", tmp / "out"
    gens.mkdir()
    outs.mkdir()
    ref_store = RefStore.from_series(jnp.asarray(_series(8 * 128, 3, 0)), 128, 2, 3)
    ref_save_pytree({"blocks": ref_store.blocks, "n": np.array([8 * 128])}, str(gens / "ref"),
                    0)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    started = []
    for devices, part in REF_PARTS:
        log = tmp / f"ref{devices}_{part}.log"
        started.append((_start(REF, [tmp / f"ref{devices}_{part}.npz", ROOT / "src",
                                     ROOT / "tests", devices, part], log, env),
                        log, f"the reference's {part} on {devices or 'no'} mesh"))
    code = f"HALO_N, HALO_L, HALO_R, SOURCES = {HALO_N}, {HALO_L}, {HALO_R}, {SOURCES!r}\n" + RANK
    for w in WORLDS:
        for r in range(w):
            log = tmp / f"w{w}_r{r}.log"
            started.append((_start(code, [r, w, tmp / f"rdv{w}", outs, gens, ROOT / "src"], log),
                            log, f"world {w} rank {r}"))
    try:
        mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        refs = {"free": reference(None, "data"), "mesh1": reference(mesh1, "data")}
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    load = lambda p: dict(np.load(p))
    for devices, part in REF_PARTS:
        refs.setdefault("mesh8" if devices else "free", {}).update(
            load(tmp / f"ref{devices}_{part}.npz"))
    return {"ranks": {w: [load(outs / f"w{w}_r{r}.npz") for r in range(w)] for w in WORLDS},
            **refs}


def _keys(res, prefix):
    return sorted(k for k in res if (k == prefix or k.startswith(prefix + "/")) and "#" not in k)


def _check(runs, world, prefix, ref_prefix=None):
    """``prefix``'s results: every rank bitwise rank 0's; rank 0 within TOL
    of the reference's ``ref_prefix`` results mesh-free, on one device
    (where it ran them) and (world 8) on 8 devices; at world 1 bitwise the
    port's mesh-free path."""
    ranks = runs["ranks"][world]
    keys = _keys(ranks[0], prefix)
    assert keys
    for res in ranks[1:]:
        assert _keys(res, prefix) == keys
        for k in keys:
            np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)
    ref_prefix = ref_prefix or prefix
    ref_keys = [ref_prefix + k[len(prefix):] for k in keys]
    wants = [runs["free"]] + ([runs["mesh1"]] if ref_keys[0] in runs["mesh1"] else [])
    for want in wants + ([runs["mesh8"]] if world == 8 else []):
        assert _keys(want, ref_prefix) == ref_keys
        for k, rk in zip(keys, ref_keys):
            np.testing.assert_allclose(ranks[0][k], want[rk], err_msg=k, **TOL)
    if world == 1:
        for k in keys:
            # a one-device frame scatters an append into its store, where a
            # mesh frame keeps it and replays it after a replan's walk, as a
            # frame over a caller's store does
            free = "free/" + k.replace("frame/replan", "caller/replan")
            np.testing.assert_array_equal(ranks[0][k], ranks[0][free], err_msg=k)
    return ranks


@pytest.mark.parametrize("world", WORLDS)
def test_store_in_both_halo_modes(runs, world):
    """map_reduce of outer(w[0], w[-1]) over a mesh store (n = 8 x 128, d =
    3, halos (2, 3)) in replicate and exchange mode: one collective, exchange
    bitwise replicate, the global views bitwise the series."""
    ranks = _check(runs, world, "store")
    x = _series(8 * 128, 3, 0)
    padded, _ = make_overlapping_blocks(jnp.asarray(x), RefSpec(8 * 128, 128, 2, 3))
    for res in ranks:
        np.testing.assert_array_equal(res["store/replicate"], res["store/exchange"])
        np.testing.assert_allclose(res["store/replicate"], runs["free"]["serial/store"], **TOL)
        for mode, width in (("replicate", 133), ("exchange", 128)):
            assert res[f"store/{mode}#collectives"] == 1 and res[f"store/{mode}#dtensor"]
            assert tuple(res[f"store/{mode}#shape"]) == (8, width, 3)
            assert res[f"store/{mode}#local_blocks"] == 8 // world
            np.testing.assert_array_equal(res[f"store/{mode}#series"], x)
            np.testing.assert_array_equal(res[f"store/{mode}#chunks"], x)
            np.testing.assert_array_equal(res[f"store/{mode}#padded"], np.asarray(padded))


@pytest.mark.parametrize("world", WORLDS)
def test_autocovariance_sharded(runs, world):
    """n = 8 x 256, d = 4, H = 6: one batched lag-sum call on a rank's
    blocks and one collective, within TOL of the reference's serial and
    sharded autocovariance; world 1 bitwise ``autocovariance_blocked``."""
    ranks = _check(runs, world, "acov")
    for res in ranks:
        assert res["acov#collectives"] == 1 and res["acov#lag_calls"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_halo_exchange(runs, world):
    """halo_exchange of each rank's rows with halos (4, 5) is bitwise the
    rank's block of make_overlapping_blocks (zeros at the line's ends), the
    ring variant wraps around, a transposed view (time_axis 1) exchanges the
    same rows, and a halo wider than the local rows raises."""
    x = _series(HALO_N, 3, 2)
    rows = HALO_N // world
    blocks, _ = make_overlapping_blocks(jnp.asarray(x), RefSpec(HALO_N, rows, HALO_L, HALO_R))
    width = HALO_L + rows + HALO_R
    for r, res in enumerate(runs["ranks"][world]):
        ring = np.take(x, np.arange(r * rows - HALO_L, r * rows + rows + HALO_R) % HALO_N, 0)
        np.testing.assert_array_equal(res["halo/line"], np.asarray(blocks[r]))
        np.testing.assert_array_equal(res["halo/ring"], ring)
        np.testing.assert_array_equal(res["halo/time_axis_1"], res["halo/line"])
        assert res["halo/too_wide"] == 1
        assert res["halo/line#collectives"] == 0  # point-to-point, never psum_tree
        if world == 8:
            for name in ("line", "ring"):
                want = runs["mesh8"][f"halo/{name}"][r * width: (r + 1) * width]
                np.testing.assert_array_equal(res[f"halo/{name}"], want)
        if world == 1:
            for name in ("line", "ring"):
                np.testing.assert_array_equal(res[f"halo/{name}"], runs["mesh1"][f"halo/{name}"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_window_map_reduce(runs, world):
    """A chunk kernel (the backend's masked lag sums, one call on a rank's
    blocks) and a per-window kernel over a mesh store's blocks: one
    collective each, within TOL of the reference's block and sharded paths."""
    ranks = _check(runs, world, "swmr")
    for res in ranks:
        assert res["swmr/chunk#collectives"] == 1 and res["swmr/chunk#lag_calls"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_from_sharded_on_a_mesh(runs, world):
    """The five requests of tests/test_frame.py::_defer_all and a forecast
    over ``from_sharded(x, mesh=)`` and over a caller's mesh store: the
    collect (one fused-plan call on a rank's blocks, one collective), an
    append after it (one update, no collective, no traversal), a replan
    that widens the halo (the store re-placed through to_series, the kept
    append replayed); the caller's store is never mutated."""
    ranks = _check(runs, world, "frame")
    _check(runs, world, "caller", "frame")
    for res in ranks:
        for tag in ("frame", "caller"):
            assert res[f"{tag}/collect#collectives"] == 1
            assert res[f"{tag}/append#collectives"] == 0
            assert res[f"{tag}/replan#collectives"] == 1
        assert res["frame/collect#plan_calls"] == 1
        assert res["frame/append#plan_calls"] == 2  # the chunk and its merge boundary
        assert res["frame/replan#plan_calls"] == 3  # the blocks, then the kept append
        assert res["frame#halo"] == 127
        assert res["caller#n"] == 4096 and res["caller#pending"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_errors(runs, world):
    """Blocks that do not divide over the mesh raise (from_series and
    sharded_window_map_reduce; 3 blocks divide over one rank), as do
    append_rows on a mesh store, a one-device store given a mesh, and a
    mesh frame asked for another device type."""
    for res in runs["ranks"][world]:
        assert res["err/indivisible"] == (world > 1)
        assert world == 1 or res["err/indivisible_swmr"] == 1
        assert res["err/append_rows"] == res["err/mixed_store"] == res["err/mixed_device"] == 1
        assert res["isolated"]


@pytest.mark.parametrize("world", WORLDS)
def test_elastic_restore(runs, world):
    """A mesh store's blocks saved at this world restore bitwise from the
    generations written at every world (1, 2, 4, 8) and by the reference's
    save_pytree, as Shard(0) DTensors of the global shape and as
    Replicate(); FaultTolerantLoop.restore_or(shardings=) resumes from this
    world's own."""
    for res in runs["ranks"][world]:
        for name in SOURCES:
            assert res[f"restore/{name}"].all(), name
        assert res["restore/loop"].all()
