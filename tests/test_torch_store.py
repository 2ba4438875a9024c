"""The port's overlapping block store against the reference's.

`repro_torch.core.overlap`, `repro_torch.core.mapreduce`,
`repro_torch.timeseries.TimeSeriesStore` and the sharded placement of
`SeriesFrame` against `repro.core.overlap`, `repro.core.mapreduce`,
`repro.timeseries.TimeSeriesStore` and `repro.core.frame.SeriesFrame`: the
same numpy inputs, made from a seed, through both; the port on the CPU
(``device="cpu"``: every kernel wrapper runs its plain version), the
reference on "jnp" and, for the plan, "pallas" in interpret mode.

Tolerances: block placement, reconstruction and ``append_rows`` bitwise
(they only copy); map-reduce rtol 2e-5, atol 2e-4 (the reference's
tests/test_mapreduce.py); plan members rtol 1e-5, atol 1e-4 (autocovariance,
moments, Welch; tests/test_frame.py), the fits rtol 1e-3, atol 1e-4.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapreduce as rmr, overlap as rov
from repro.core.frame import SeriesFrame as RefFrame
from repro.timeseries import TimeSeriesStore as RefStore
from repro_torch import SeriesFrame, TimeSeriesStore
from repro_torch.core import mapreduce as tmr, overlap as tov
from repro_torch.core.backend import TorchBackend
from repro_torch.core.estimators.stats import autocovariance

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = {"autocovariance": dict(rtol=1e-5, atol=1e-4), "moments": dict(rtol=1e-5, atol=1e-4),
       "welch": dict(rtol=1e-5, atol=1e-4), "yule_walker": dict(rtol=1e-3, atol=1e-4),
       "arma": dict(rtol=1e-3, atol=1e-4), "g": dict(rtol=1e-5, atol=1e-4)}


def _series(n, d=2, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    """(path, numpy leaf) of a result, dict keys sorted, as both sides nest."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in ((f"{k}/{p}", v) for p, v in _leaves(tree[k]))]
    if isinstance(tree, (tuple, list)):
        return [e for i, t in enumerate(tree) for e in ((f"{i}/{p}", v) for p, v in _leaves(t))]
    return [("", _np(tree))]


def _assert_tree(got, want, rtol, atol):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)


def _assert_results(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        _assert_tree(got[name], w, **TOL[re.sub(r"_\d+$", "", name)])


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo mesh in this process (the distribution layer at
    world 1; tests/test_torch_mesh.py runs worlds 1-8 in rank processes)."""
    import torch.distributed as dist

    from repro_torch.parallel import data_mesh

    mesh = data_mesh(1, 0, "file://" + str(tmp_path / "rendezvous"), device="cpu")
    yield mesh
    dist.destroy_process_group()


# ----------------------------------------------------------------- overlap
GEOMETRIES = [(100, 10, 3, 5), (97, 16, 0, 7), (64, 64, 2, 2), (10, 3, 4, 4),
              (5, 8, 0, 2), (5, 64, 3, 3), (40, 4, 6, 9), (40, 4, 4, 4), (7, 11, 13, 17)]


@pytest.mark.parametrize("n,bs,hl,hr", GEOMETRIES)
def test_blocks_mask_and_roundtrip_equal_reference(n, bs, hl, hr):
    """Blocks, slot mask, core mask, centre indices and the reconstruction
    are the reference's, bitwise, for ordinary and degenerate geometries
    (block > n, halo > block)."""
    x = _series(n, 3, seed=n * 31 + bs)
    spec, rspec = tov.OverlapSpec(n, bs, hl, hr), rov.OverlapSpec(n, bs, hl, hr)
    blocks, mask = tov.make_overlapping_blocks(torch.from_numpy(x), spec)
    rblocks, rmask = rov.make_overlapping_blocks(jnp.asarray(x), rspec)
    assert (spec.num_blocks, spec.padded_width, spec.window) == (
        rspec.num_blocks, rspec.padded_width, rspec.window)
    np.testing.assert_array_equal(_np(blocks), np.asarray(rblocks))
    np.testing.assert_array_equal(_np(mask), np.asarray(rmask))
    np.testing.assert_array_equal(_np(blocks)[~_np(mask)], 0.0)
    np.testing.assert_array_equal(_np(tov.reconstruct(blocks, spec)), x)
    np.testing.assert_array_equal(_np(tov.block_core(blocks, spec)),
                                  np.asarray(rov.block_core(rblocks, rspec)))
    np.testing.assert_array_equal(tov.core_mask(spec), rov.core_mask(rspec))
    np.testing.assert_array_equal(tov.center_global_index(spec), rov.center_global_index(rspec))
    assert tov.replication_overhead(spec) == rov.replication_overhead(rspec)
    assert tov.num_blocks(n, bs) == rov.num_blocks(n, bs)


def test_halo_slots_are_replicas():
    n, bs, h = 64, 16, 4
    spec = tov.OverlapSpec(n=n, block_size=bs, h_left=h, h_right=h)
    blocks, _ = tov.make_overlapping_blocks(torch.from_numpy(_series(n, seed=1)), spec)
    for i in range(1, spec.num_blocks):
        assert torch.equal(blocks[i, :h], blocks[i - 1, bs: h + bs])
    wide = tov.OverlapSpec(n=24, block_size=3, h_left=7, h_right=7)
    x = _series(24, seed=3)
    wblocks, _ = tov.make_overlapping_blocks(torch.from_numpy(x), wide)
    np.testing.assert_array_equal(_np(wblocks[3]), x[3 * 3 - 7: 4 * 3 + 7])


def test_boundary_zero_fill_and_single_block():
    spec = tov.OverlapSpec(n=20, block_size=5, h_left=2, h_right=3)
    blocks, mask = tov.make_overlapping_blocks(torch.ones(20, 1), spec)
    assert blocks[0, :2].sum() == 0 and blocks[-1, -3:].sum() == 0
    assert not mask[0, 0] and mask[0, 2]
    one = tov.OverlapSpec(n=5, block_size=8, h_left=0, h_right=2)
    blocks, mask = tov.make_overlapping_blocks(torch.arange(5.0), one)
    assert one.num_blocks == 1
    np.testing.assert_array_equal(_np(blocks[0, :5, 0]), np.arange(5.0))
    assert blocks[0, 5:].abs().sum() == 0 and not mask[0, 5]


def test_replication_overhead_formula_and_monotonicity():
    assert tov.replication_overhead(tov.OverlapSpec(1000, 100, 5, 5)) == pytest.approx(
        10 * 110 / 1000 - 1.0)
    ovs = [tov.replication_overhead(tov.OverlapSpec(4096, 64, h, h)) for h in range(0, 33, 4)]
    assert all(b > a for a, b in zip(ovs, ovs[1:]))
    ovs = [tov.replication_overhead(tov.OverlapSpec(4096, bs, 8, 8))
           for bs in (16, 32, 64, 128, 256)]
    assert all(b < a for a, b in zip(ovs, ovs[1:]))
    assert tov.replication_overhead(tov.OverlapSpec(4096, 64, 0, 0)) == 0.0
    # the full-width store of chip_smoke.py's store phase
    spec = tov.OverlapSpec(n=2**22, block_size=8192, h_left=0, h_right=1023)
    assert (spec.num_blocks, spec.padded_width) == (512, 9215)
    assert tov.replication_overhead(spec) == pytest.approx(0.12488, abs=1e-5)


def test_core_mask_tail_padding():
    m = tov.core_mask(tov.OverlapSpec(n=10, block_size=4, h_left=1, h_right=1))
    assert m.shape == (3, 4) and m[:2].all() and list(m[2]) == [True, True, False, False]


@pytest.mark.parametrize("kw", [dict(n=0, block_size=4, h_left=0, h_right=0),
                                dict(n=10, block_size=0, h_left=0, h_right=0),
                                dict(n=10, block_size=4, h_left=-1, h_right=0)])
def test_invalid_specs_raise(kw):
    with pytest.raises(ValueError):
        tov.OverlapSpec(**kw)
    with pytest.raises(ValueError):
        rov.OverlapSpec(**kw)


# ---------------------------------------------------------------- map-reduce
def _kernels(lib):
    if lib is jnp:
        return {"outer": lambda w: jnp.outer(w[0], w[-1]),
                "nonlinear": lambda w: jnp.sum(jnp.tanh(w)) ** 2,
                "pytree": lambda w: {"a": jnp.sum(w), "b": (w[0] * w[-1], jnp.max(w))}}
    return {"outer": lambda w: torch.outer(w[0], w[-1]),
            "nonlinear": lambda w: torch.tanh(w).sum() ** 2,
            "pytree": lambda w: {"a": w.sum(), "b": (w[0] * w[-1], w.max())}}


@pytest.mark.parametrize("name", ["outer", "nonlinear", "pytree"])
@pytest.mark.parametrize("n,bs,hl,hr", [(500, 64, 2, 3), (500, 100, 0, 8), (333, 50, 5, 0)])
def test_blocked_scan_and_serial_equal_reference(name, n, bs, hl, hr):
    """blocked = scan = serial in the port, and each = the reference's serial
    (rtol 2e-5, atol 2e-4)."""
    x = _series(n, 3, seed=n + bs)
    kern, rkern = _kernels(torch)[name], _kernels(jnp)[name]
    spec = tov.OverlapSpec(n=n, block_size=bs, h_left=hl, h_right=hr)
    xt = torch.from_numpy(x)
    want = rmr.serial_window_map_reduce(rkern, jnp.asarray(x), hl, hr)
    for got in (tmr.serial_window_map_reduce(kern, xt, hl, hr),
                tmr.block_window_map_reduce(kern, xt, spec),
                tmr.scan_window_map_reduce(kern, xt, spec)):
        _assert_tree(got, want, rtol=2e-5, atol=2e-4)


def test_chunk_kernel_takes_every_block_at_once():
    """block_partials with a chunk kernel: ONE call over the whole (P, width,
    d) stack with a (P, block_size) mask, equal per block to the per-window
    path and to the reference's vmapped chunk kernel; the scan path calls
    the kernel once per block."""
    x = _series(700, 2, seed=4)
    spec = tov.OverlapSpec(n=700, block_size=64, h_left=0, h_right=5)
    be, calls = TorchBackend(), []

    def ck(y, mask):
        calls.append(tuple(y.shape))
        return be.masked_lagged_sums(y, mask, 5)

    blocks, _ = tov.make_overlapping_blocks(torch.from_numpy(x), spec)
    partials = tmr.block_partials(None, blocks, spec, chunk_kernel=ck)
    assert calls == [(spec.num_blocks, spec.padded_width, 2)]
    lag = lambda w: torch.stack([torch.outer(w[0], w[h]) for h in range(6)])
    np.testing.assert_allclose(_np(partials), _np(tmr.block_partials(lag, blocks, spec)),
                               rtol=1e-5, atol=1e-4)
    from repro.core.backend import get_backend as ref_backend

    rbe = ref_backend("jnp")
    rspec = rov.OverlapSpec(700, 64, 0, 5)
    rblocks, _ = rov.make_overlapping_blocks(jnp.asarray(x), rspec)
    want = rmr.block_partials(None, rblocks, rspec,
                              chunk_kernel=lambda y, m: rbe.masked_lagged_sums(y, m, 5))
    np.testing.assert_allclose(_np(partials), np.asarray(want), rtol=1e-5, atol=1e-4)
    calls.clear()
    total = tmr.scan_window_map_reduce(None, torch.from_numpy(x), spec, chunk_kernel=ck)
    assert len(calls) == spec.num_blocks
    np.testing.assert_allclose(_np(total), _np(partials.sum(0)), rtol=1e-5, atol=1e-4)


def test_gradient_flows_through_blocked_path():
    """d/dA of the blocked reduction equals the serial one's and the
    reference's jax.grad (rtol 1e-5, atol 1e-4)."""
    x = _series(300, 2, seed=2)
    spec = tov.OverlapSpec(n=300, block_size=64, h_left=2, h_right=0)

    def grad(fn):
        a = (torch.eye(2) * 0.3).requires_grad_()
        (g,) = torch.autograd.grad(fn(lambda w: ((w[-1] - a @ w[0]) ** 2).sum()), a)
        return _np(g)

    g_block = grad(lambda k: tmr.block_window_map_reduce(k, torch.from_numpy(x), spec))
    g_serial = grad(lambda k: tmr.serial_window_map_reduce(k, torch.from_numpy(x), 2, 0))

    def obj(a):
        return rmr.serial_window_map_reduce(lambda w: jnp.sum((w[-1] - a @ w[0]) ** 2),
                                            jnp.asarray(x), 2, 0)

    want = np.asarray(jax.grad(obj)(jnp.eye(2) * 0.3))
    np.testing.assert_allclose(g_block, g_serial, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g_block, want, rtol=1e-5, atol=1e-4)


def test_sharded_map_reduce_waits_for_distribution(mesh1):
    """The mesh path at world 1: a chunk kernel and a per-window kernel
    over a mesh store's ``Shard(0)`` blocks, each one collective, bitwise
    the one-device block path and within the map-reduce tolerance of the
    reference's."""
    from repro_torch.parallel import collective_count, reset_collective_count

    x = _series(1000, 3, seed=21)
    store = TimeSeriesStore.from_series(x, 128, 0, 3, mesh=mesh1, device="cpu")
    spec = tov.OverlapSpec(1000, 128, 0, 3)
    be = TorchBackend()
    ck = lambda y, m: be.masked_lagged_sums(y, m, 3)
    kern = lambda w: torch.outer(w[0], w[-1])
    rkern = lambda w: jnp.outer(w[0], w[-1])
    want = rmr.block_window_map_reduce(rkern, jnp.asarray(x), rov.OverlapSpec(1000, 128, 0, 3))
    for k, c in ((None, ck), (kern, None)):
        reset_collective_count()
        got = tmr.sharded_window_map_reduce(k, store.blocks, store.spec, mesh1, chunk_kernel=c)
        assert collective_count() == 1
        assert torch.equal(got, tmr.block_window_map_reduce(k, torch.from_numpy(x), spec,
                                                            chunk_kernel=c))
    _assert_tree(got, want, rtol=2e-5, atol=2e-4)


# ------------------------------------------------------------------- store
@pytest.mark.parametrize("halo_mode", ["replicate", "exchange"])
def test_store_views_equal_reference(halo_mode):
    """blocks, padded view, to_series, iter_chunks, map_reduce and the
    overhead in both halo modes."""
    x = _series(1000, 2, seed=5)
    store = TimeSeriesStore.from_series(x, 96, 2, 5, halo_mode=halo_mode, device="cpu")
    ref = RefStore.from_series(jnp.asarray(x), 96, 2, 5, halo_mode=halo_mode)
    np.testing.assert_array_equal(_np(store.blocks), np.asarray(ref.blocks))
    np.testing.assert_array_equal(_np(store.padded_blocks_single_host()),
                                  np.asarray(ref.padded_blocks_single_host()))
    np.testing.assert_array_equal(_np(store.to_series()), x)
    chunks = list(store.iter_chunks(333))
    assert [c.shape[0] for c in chunks] == [c.shape[0] for c in ref.iter_chunks(333)]
    np.testing.assert_array_equal(np.concatenate([_np(c) for c in chunks]), x)
    assert store.replication_overhead == ref.replication_overhead
    kern = lambda w: {"sq": (w * w).sum(), "edge": torch.outer(w[0], w[-1])}
    rkern = lambda w: {"sq": jnp.sum(w * w), "edge": jnp.outer(w[0], w[-1])}
    _assert_tree(store.map_reduce(kern), ref.map_reduce(rkern), rtol=2e-5, atol=2e-4)
    with pytest.raises(ValueError):
        next(store.iter_chunks(0))


@pytest.mark.parametrize("B,hr", [(64, 7), (32, 50), (128, 0)])
def test_append_rows_equals_replacement(B, hr):
    """append_rows = from_series on the concatenated series, bitwise, across
    halo widths (h_right > block_size included) and growth boundaries; the
    capacity at least doubles and its trailing blocks are zeros; the
    reference's append_rows gives the same blocks."""
    x, extra = _series(333, seed=16), _series(415, seed=17)
    store = TimeSeriesStore.from_series(x, B, 0, hr, device="cpu")
    ref = RefStore.from_series(jnp.asarray(x), B, 0, hr)
    caps = [store.blocks.shape[0]]
    for lo in range(0, extra.shape[0], 111):
        store.append_rows(extra[lo: lo + 111])
        ref.append_rows(jnp.asarray(extra[lo: lo + 111]))
        caps.append(store.blocks.shape[0])
    fresh = TimeSeriesStore.from_series(np.concatenate([x, extra]), B, 0, hr, device="cpu")
    assert store.spec == fresh.spec
    view = store.padded_blocks_single_host()
    assert torch.equal(view, fresh.blocks)
    np.testing.assert_array_equal(_np(view), np.asarray(ref.padded_blocks_single_host()))
    assert all(b == a or b >= 2 * a for a, b in zip(caps, caps[1:])) and caps[-1] > caps[0]
    assert store.blocks[store.spec.num_blocks:].abs().sum() == 0
    store.append_rows(np.zeros((0, 2), np.float32))
    assert store.spec == fresh.spec


def test_append_rows_contract(mesh1):
    x = _series(100, seed=1)
    with pytest.raises(ValueError, match="replicate"):
        TimeSeriesStore.from_series(x, 16, 0, 3, halo_mode="exchange",
                                    device="cpu").append_rows(x[:4])
    with pytest.raises(ValueError, match="causal"):
        TimeSeriesStore.from_series(x, 16, 2, 3, device="cpu").append_rows(x[:4])
    with pytest.raises(ValueError, match="d="):
        TimeSeriesStore.from_series(x, 16, 0, 3, device="cpu").append_rows(_series(4, 3))
    with pytest.raises(ValueError, match="single-device"):
        TimeSeriesStore.from_series(x, 16, 0, 3, mesh=mesh1, device="cpu").append_rows(x[:4])
    with pytest.raises(ValueError, match="mesh lies on cpu"):
        TimeSeriesStore.from_series(x, 16, 0, 3, mesh=mesh1, device="meta")
    store = TimeSeriesStore.from_series(x, 16, 0, 3, device="cpu")
    assert store.padded_blocks_local(store.blocks) is store.blocks  # replicate: the halos are in


# ---------------------------------------------------------- sharded frames
def _declare(frame):
    frame.autocovariance(6)
    frame.yule_walker(3)
    frame.arma(2, 1)
    frame.moments(8)
    frame.moments(40)
    frame.welch(nperseg=32, overlap=16)
    return frame


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_from_sharded_equals_reference(backend):
    """The six-member plan over a raw series: collect, append, collect, a
    replan after the append; every stage against the reference's frame."""
    x, extra = _series(1400, seed=8), _series(150, seed=9)
    port = _declare(SeriesFrame.from_sharded(x, block_size=256, device="cpu"))
    ref = _declare(RefFrame.from_sharded(jnp.asarray(x), block_size=256, backend=backend))
    _assert_results(port.collect(), ref.collect())
    assert port._store.spec.h_right == 39 and port._store.spec.num_blocks == 6
    port.append(extra)
    ref.append(jnp.asarray(extra))
    _assert_results(port.collect(), ref.collect())
    port.moments(16)
    ref.moments(16)
    _assert_results(port.collect(), ref.collect())


def test_store_collect_is_one_kernel_call_per_group():
    """The sharded collect calls the fused plan's primitive ONCE for every
    block (a (P, B + carry, d) stack, (P, B) mask, (P,) offsets), and an
    append one update's two calls, as on the card the megakernel launches."""
    calls = []

    class Counting(TorchBackend):
        def fused_plan_update(self, y, mask, z0, *args, **kw):
            calls.append((tuple(y.shape), tuple(mask.shape), tuple(torch.as_tensor(z0).shape)))
            return super().fused_plan_update(y, mask, z0, *args, **kw)

    x = _series(1400, seed=8)
    frame = _declare(SeriesFrame.from_sharded(x, block_size=256, backend=Counting(),
                                              device="cpu"))
    frame.collect()
    assert calls == [((6, 256 + 39, 2), (6, 256), (6,))]
    calls.clear()
    frame.append(_series(100, seed=3))
    assert len(calls) == 2  # the chunk and its merge boundary


def test_prebuilt_store_halo_validation_and_pending_appends(mesh1):
    """A caller's store serves a plan whose window fits its halo, is never
    mutated by appends (they replay on replans), and a narrow one raises."""
    x, extra = _series(2000, seed=8), _series(64, seed=19)
    store = TimeSeriesStore.from_series(x, 256, 0, 40, device="cpu")
    rstore = RefStore.from_series(jnp.asarray(x), 256, 0, 40)
    port, ref = SeriesFrame.from_sharded(store, device="cpu"), RefFrame.from_sharded(rstore)
    for f in (port, ref):
        f.autocovariance(8)
        f.moments(32)
    _assert_results(port.collect(), ref.collect())
    port.append(extra)
    ref.append(jnp.asarray(extra))
    assert len(port._pending) == 1 and store.spec.n == 2000
    port.welch(nperseg=16, overlap=8)
    ref.welch(nperseg=16, overlap=8)
    _assert_results(port.collect(), ref.collect())
    narrow = SeriesFrame.from_sharded(TimeSeriesStore.from_series(x, 256, 0, 2, device="cpu"),
                                      device="cpu")
    narrow.moments(32)
    with pytest.raises(ValueError, match="halo"):
        narrow.collect()
    with pytest.raises(ValueError, match="not placed on the frame's mesh"):
        SeriesFrame.from_sharded(store, mesh=mesh1, device="cpu")


def test_appends_before_and_after_collect_scatter_into_store():
    """Appends before the first collect are kept, then move into the
    frame-built store; appends after it scatter in place; a replan re-reads
    the complete store, equal to a fresh placement of the whole series."""
    x = _series(1500, seed=13)
    extra = [_series(97, seed=14), _series(256, seed=15), _series(33, seed=16)]
    port = SeriesFrame.from_sharded(x, block_size=256, device="cpu")
    ref = RefFrame.from_sharded(jnp.asarray(x), block_size=256, backend="jnp")
    for f in (port, ref):
        f.autocovariance(8)
    port.append(extra[0])
    ref.append(jnp.asarray(extra[0]))
    _assert_results(port.collect(), ref.collect())
    assert port._pending == []
    for chunk in extra[1:]:
        port.append(chunk)
        ref.append(jnp.asarray(chunk))
    full = np.concatenate([x] + extra)
    assert port._pending == [] and port._store.spec.n == full.shape[0] == port.length
    _assert_results(port.collect(), ref.collect())
    np.testing.assert_array_equal(_np(port._store.to_series()), full)
    np.testing.assert_array_equal(_np(port._store.padded_blocks_single_host()), _np(
        TimeSeriesStore.from_series(full, 256, 0, 8, device="cpu").blocks))
    for f in (port, ref):
        f.moments(16)
    _assert_results(port.collect(), ref.collect())


def test_multi_group_sharded_plan_and_append():
    """A strided generic kernel that is not offset-aware gets its own group:
    each group runs once over the blocks, and appends fold into both."""
    x, extra = _series(1500, seed=18), _series(64, seed=19)
    w = 9

    def ck(y, mask):  # batched operands: y (..., rows, d), mask (..., L)
        L = mask.shape[-1]
        per = (y[..., :L, :] * y[..., w - 1: w - 1 + L, :]).sum(-1)
        return torch.where(mask, per, 0.0).sum(-1)

    frame = SeriesFrame.from_sharded(x, block_size=256, device="cpu")
    frame.autocovariance(4)
    frame.map_reduce(ck, h_right=w - 1, stride=3, name="g")
    assert frame.num_traversals == 2
    frame.collect()
    frame.append(extra)
    frame.append(extra)
    got = frame.collect()
    full = np.concatenate([x, extra, extra])
    np.testing.assert_allclose(_np(got["autocovariance"]),
                               _np(autocovariance(torch.from_numpy(full), 4)),
                               rtol=1e-5, atol=1e-4)
    want = sum(float(np.dot(full[s], full[s + w - 1])) for s in range(0, full.shape[0] - w + 1, 3))
    np.testing.assert_allclose(float(got["g"]), want, rtol=1e-4)


def test_from_chunks_streams_a_store():
    x = _series(2000, seed=7)
    store = TimeSeriesStore.from_series(x, 256, 0, 8, device="cpu")
    port = SeriesFrame.from_chunks(store, chunk_size=333, device="cpu")
    ref = RefFrame.from_chunks(RefStore.from_series(jnp.asarray(x), 256, 0, 8), chunk_size=333)
    for f in (port, ref):
        f.autocovariance(8)
        f.welch(nperseg=32, overlap=16)
    _assert_results(port.collect(), ref.collect())
    assert port.length == 2000
