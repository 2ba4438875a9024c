"""The port's §9-11 graph module held against `repro.core.graphs`.

Graph, k-hop and partition arrays are host numpy and must be equal; the
map-reduce and the traffic DBN run on the CPU on the same seeded numpy
inputs, within rtol 1e-4 / atol 1e-5 (float32 sums over a few dozen
vertices in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jg
from repro_torch.core import graphs as tg
from repro_torch.core.mapreduce import tree_leaves

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

RTOL, ATOL = 1e-4, 1e-5


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


GRAPHS = [("line", (1,)), ("line", (2,)), ("line", (24,)), ("grid", (1, 5)), ("grid", (4, 6)),
          ("grid", (5, 7)), ("grid", (6, 8))]


def _graphs(kind, args):
    return (jg.line_graph(*args), tg.line_graph(*args)) if kind == "line" else (
        jg.grid_graph(*args), tg.grid_graph(*args))


@pytest.mark.parametrize("kind,args", GRAPHS)
def test_graph_arrays_equal(kind, args):
    jgr, tgr = _graphs(kind, args)
    assert tgr.nbrs.dtype == np.int32 and np.array_equal(tgr.nbrs, jgr.nbrs)
    assert tgr.num_vertices == jgr.num_vertices
    seeds = np.array([0, tgr.num_vertices // 2])
    for k in range(4):
        assert np.array_equal(tg.k_hop_neighbors(tgr, seeds, k), jg.k_hop_neighbors(jgr, seeds, k))


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("kind,args,parts", [("line", (24,), 3), ("grid", (6, 8), 4),
                                             ("grid", (5, 7), 5), ("grid", (4, 6), 1)])
def test_partition_arrays_equal(kind, args, parts, k):
    jgr, tgr = _graphs(kind, args)
    want, got = jg.make_graph_partition(jgr, parts, k), tg.make_graph_partition(tgr, parts, k)
    for field in ("own", "padded", "local_nbrs"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    # own_local: the reference's per-call dict walk (graphs.py:154-158)
    for i in range(parts):
        g2l = {int(gv): li for li, gv in enumerate(want.padded[i]) if gv >= 0}
        assert got.own_local[i].tolist() == [g2l[int(v)] for v in want.own[i]]


def test_partition_refuses_an_uneven_split():
    for mod in (jg, tg):
        with pytest.raises(ValueError, match="must divide into 5 parts"):
            mod.make_graph_partition(mod.grid_graph(4, 6), 5, 1)


def test_a_partition_built_by_hand_gets_its_own_local_slots():
    part = tg.make_graph_partition(tg.grid_graph(4, 6), 4, 1)
    hand = tg.GraphPartition(own=part.own, padded=part.padded, local_nbrs=part.local_nbrs)
    assert np.array_equal(hand.own_local, part.own_local)
    with pytest.raises(TypeError):  # derived, never given
        tg.GraphPartition(own=part.own, padded=part.padded, local_nbrs=part.local_nbrs,
                          own_local=part.own_local)


def _scalar(mod):
    where, s = (jnp.where, jnp.sum) if mod is jnp else (torch.where, torch.sum)
    return lambda xc, nb, m: s(xc ** 2) + s(where(m[:, None], nb, 0.0) * xc)


def _matrix(mod):
    where = jnp.where if mod is jnp else torch.where
    outer = jnp.outer if mod is jnp else torch.outer
    return lambda xc, nb, m: outer(xc, where(m[:, None], nb, 0.0).sum(0))


def _pair(mod):
    where = jnp.where if mod is jnp else torch.where
    return lambda xc, nb, m: ((xc * xc).sum(), {"nb": where(m[:, None], nb, 0.0).sum(0),
                                                "deg": m.sum() * 1.0})


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("kernel", [_scalar, _matrix, _pair])
def test_graph_map_reduce_matches(kernel, k):
    """Scalar, (d, d) and tuple-of-dict statistics; at k = 0 no neighbour
    lies in a part, so every neighbour slot reads zero with its mask off."""
    jgr, tgr = _graphs("grid", (6, 8))
    x = _rand(48, 3, seed=k)
    want = jg.graph_window_map_reduce(kernel(jnp), jnp.asarray(x), jgr,
                                      jg.make_graph_partition(jgr, 4, k))
    got = tg.graph_window_map_reduce(kernel(torch), torch.from_numpy(x), tgr,
                                     tg.make_graph_partition(tgr, 4, k))
    want, got = jax.tree.leaves(want), tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_graph_map_reduce_of_a_series_per_vertex():
    """examples/traffic_graph.py's statistic: x (V, T), each vertex's series."""
    jgr, tgr = _graphs("line", (24,))
    x = _rand(24, 40, seed=3)

    def jk(xc, nb, mask):
        nbm = jnp.sum(jnp.where(mask[:, None], nb, 0.0), axis=0) / jnp.maximum(jnp.sum(mask), 1)
        return jnp.sum(xc * nbm)

    def tk(xc, nb, mask):
        nbm = torch.where(mask[:, None], nb, 0.0).sum(0) / torch.clamp(mask.sum(), min=1)
        return (xc * nbm).sum()

    want = jg.graph_window_map_reduce(jk, jnp.asarray(x), jgr, jg.make_graph_partition(jgr, 8, 1))
    got = tg.graph_window_map_reduce(tk, torch.from_numpy(x), tgr,
                                     tg.make_graph_partition(tgr, 8, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_traffic_dbn_step_matches():
    g = tg.line_graph(50)
    x = np.random.default_rng(4).uniform(0, 1, 50).astype(np.float32)
    inflow = (np.random.default_rng(5).uniform(0, 0.1, 50) * (g.nbrs[:, 0] < 0)).astype(np.float32)
    want = jg.traffic_dbn_step(jnp.asarray(x), jnp.asarray(g.nbrs), jnp.asarray(inflow))
    got = tg.traffic_dbn_step(torch.from_numpy(x), torch.from_numpy(g.nbrs).long(),
                              torch.from_numpy(inflow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    got = tg.traffic_dbn_step(torch.from_numpy(x), torch.from_numpy(g.nbrs).long(), 0.0,
                              capacity=0.8, send_rate=0.5)
    want = jg.traffic_dbn_step(jnp.asarray(x), jnp.asarray(g.nbrs), 0.0, capacity=0.8,
                               send_rate=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_simulate_traffic_dbn_without_inflow_matches():
    g = tg.line_graph(30)
    x0 = np.random.default_rng(6).uniform(0, 1, 30).astype(np.float32)
    want = jg.simulate_traffic_dbn(jg.line_graph(30), jnp.asarray(x0), 100,
                                   jax.random.PRNGKey(9), inflow_scale=0.0)
    got = tg.simulate_traffic_dbn(g, torch.from_numpy(x0), 100, inflow_scale=0.0, device="cpu")
    assert got.shape == (101, 30) and torch.equal(got[0], torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # without inflow the mass is conserved up to rounding (the reference's check)
    mass = got.double().sum(1).numpy()
    assert (np.diff(mass) <= 1e-5).all() and bool(((got >= 0) & (got <= 1)).all())


def test_simulate_traffic_dbn_with_inflow_replays_through_the_reference_step():
    """The port draws its (steps, V) uniforms in one call before the loop:
    the same generator seed regenerates them, and the reference's step
    replayed with them gives the port's trajectory."""
    steps, v, scale = 60, 40, 0.08
    g = tg.line_graph(v)
    x0 = np.full(v, 0.4, np.float32)
    got = tg.simulate_traffic_dbn(g, torch.from_numpy(x0), steps,
                                  generator=torch.Generator().manual_seed(7), inflow_scale=scale,
                                  device="cpu")
    u = torch.rand((steps, v), generator=torch.Generator().manual_seed(7)).numpy()
    nbrs = jnp.asarray(g.nbrs)
    x, traj = jnp.asarray(x0), [x0]
    for t in range(steps):
        x = jg.traffic_dbn_step(x, nbrs, scale * jnp.asarray(u[t]) * (nbrs[:, 0] < 0))
        traj.append(np.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.stack(traj), rtol=RTOL, atol=ATOL)
    assert float(got[1, 0]) > 0.4 * (1 - 0.3)  # the boundary link received demand


def test_simulate_traffic_dbn_float64_follows_x0():
    g = tg.line_graph(8)
    out = tg.simulate_traffic_dbn(g, torch.full((8,), 0.4, dtype=torch.float64), 5,
                                  inflow_scale=0.0, device="cpu")
    assert out.dtype == torch.float64 and out.shape == (6, 8)
