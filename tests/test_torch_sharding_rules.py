"""The port's logical-axis rule tables (`repro_torch.parallel.sharding`)
and meshes (`repro_torch.launch.mesh`) against the reference's
`repro.parallel.sharding` and `repro.launch.mesh`.

On the reference's ``abstract_mesh`` and the port's at (2, 2), (16, 16) and
(2, 16, 16), with the SP switch off and on: ``logical_to_spec`` on every
logical axis of the rules over shapes that do and do not divide;
``param_pspecs`` and ``zero1_pspecs`` leaf by leaf over every arch's tree
at full width -- the reference's from ``jax.eval_shape`` of its
``init_params``, the port's the stacked tree of its model on the ``meta``
device (``param_tree``) -- and the per-device parameter and optimizer
bytes summed over the tree, equal to the byte.  A leaf per layer would
place ZeRO-1's data axes on another dimension than the stacked leaf's
layer axis: the per-layer check below shows the bytes it would give
differ, which is why the rules resolve on the stacked tree.  The
divisibility property of tests/test_property_hypothesis.py, on the port.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import init_params as ref_init_params
from repro.parallel import sharding as ref_shr
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.costing import meta_model
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh, mesh_device_count
from repro_torch.parallel import sharding as shr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = [None, "batch", "heads", "kv", "ff", "experts", "vocab", "embed", "seq", "seq_sp",
           "seq_tp", ("data",), ("pod", "data"), ("model", "data"), "unknown"]


@pytest.fixture(params=[False, True], ids=["dp", "sp"])
def sp(request):
    shr.set_sp_mode(request.param)
    ref_shr.set_sp_mode(request.param)
    yield request.param
    shr.set_sp_mode(False)
    ref_shr.set_sp_mode(False)


def _meshes(name):
    shape, axes = MESHES[name]
    return ref_shr.abstract_mesh(shape, axes), shr.abstract_mesh(shape, axes)


def _entries(spec, ndim):
    """A reference PartitionSpec as the port's tuple (one entry a dim)."""
    out = tuple(spec)
    return out + (None,) * (ndim - len(out))


def test_sp_switch():
    assert not shr.sp_mode_enabled()
    shr.set_sp_mode(True)
    try:
        assert shr.sp_mode_enabled()
    finally:
        shr.set_sp_mode(False)
    assert shr._RULES == ref_shr._RULES
    assert shr._PARAM_RULES == ref_shr._PARAM_RULES


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_to_spec_matches_reference(mesh_name, sp):
    ref_mesh, mesh = _meshes(mesh_name)
    rng = np.random.default_rng(len(mesh_name) + sp)
    dims = [1, 2, 3, 4, 6, 8, 16, 30, 32, 48, 64, 512, 1000, 1024]
    for _ in range(400):
        n = int(rng.integers(1, 5))
        axes = [LOGICAL[i] for i in rng.integers(0, len(LOGICAL), n)]
        shape = [int(d) for d in rng.choice(dims, n)]
        want = _entries(ref_shr.logical_to_spec(axes, shape, ref_mesh), n)
        assert shr.logical_to_spec(axes, shape, mesh) == want, (axes, shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_axis_size_matches_reference(mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for names in [(), ("data",), ("model",), ("pod", "data"), ("pod", "data", "model"),
                  ("absent",)]:
        assert shr.mesh_axis_size(mesh, names) == ref_shr.mesh_axis_size(ref_mesh, names)


def test_meshes():
    m = make_production_mesh()
    assert (m.shape, m.axis_names) == ((16, 16), ("data", "model"))
    assert mesh_device_count(m) == 256
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert mesh_device_count(m) == 512
    m = make_test_mesh(4, 1)
    assert (m.shape, m.axis_names) == ((4, 1), ("data", "model"))
    assert mesh_device_count(m) == 4 and mesh_device_count(make_test_mesh()) == 8


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(the reference's params tree of ShapeDtypeStructs, the port's stacked
    tree of meta tensors) at full width and depth."""
    ref = jax.eval_shape(functools.partial(ref_init_params, cfg=ref_get_arch(arch),
                                           dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    return ref, shr.param_tree(meta_model(get_arch(arch)))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _itemsize(dtype) -> int:
    return np.dtype(dtype).itemsize if not hasattr(dtype, "itemsize") else dtype.itemsize


def _ref_bytes(leaf, spec, mesh, itemsize=None) -> int:
    n = 1
    for i, dim in enumerate(leaf.shape):
        e = spec[i] if i < len(spec) else None
        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        n *= dim // ref_shr.mesh_axis_size(mesh, names)
    return n * (itemsize or _itemsize(leaf.dtype))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_zero1_specs_match_reference(arch):
    ref_tree, tree = _trees(arch)
    ref_flat, flat = _flat(ref_tree), _flat(tree)
    assert set(flat) == set(ref_flat)
    for path, leaf in flat.items():
        assert tuple(leaf.shape) == tuple(ref_flat[path].shape), path
    for name in MESHES:
        ref_mesh, mesh = _meshes(name)
        for sp_on in (False, True):
            shr.set_sp_mode(sp_on)
            ref_shr.set_sp_mode(sp_on)
            try:
                for port_fn, ref_fn in ((shr.param_pspecs, ref_shr.param_pspecs),
                                        (shr.zero1_pspecs, ref_shr.zero1_pspecs)):
                    ref_specs = _flat(ref_fn(ref_tree, ref_mesh))
                    specs = _flat(port_fn(tree, mesh))
                    for path, leaf in flat.items():
                        want = _entries(ref_specs[path], len(leaf.shape))
                        assert specs[path] == want, (arch, name, path, port_fn.__name__)
                # per-device bytes over the tree, to the byte: the
                # parameters at their dtype, the moments at float32
                ref_p = ref_shr.param_pspecs(ref_tree, ref_mesh)
                ref_z = ref_shr.zero1_pspecs(ref_tree, ref_mesh)
                want_p = sum(_ref_bytes(ref_flat[k], s, ref_mesh)
                             for k, s in _flat(ref_p).items())
                want_z = sum(_ref_bytes(ref_flat[k], s, ref_mesh, 4)
                             for k, s in _flat(ref_z).items())
                assert shr.tree_shard_bytes(tree, shr.param_pspecs(tree, mesh), mesh) == want_p
                assert shr.tree_shard_bytes(tree, shr.zero1_pspecs(tree, mesh), mesh,
                                            torch.float32) == want_z
            finally:
                shr.set_sp_mode(False)
                ref_shr.set_sp_mode(False)


def _per_layer_zero1_bytes(model, mesh) -> int:
    """ZeRO-1 moment bytes with the rules resolved on each of the model's
    own tensors (one a layer, named by their module: a norm's weight by
    its norm), not on the stacked tree."""
    total = 0
    for k, p in model.named_parameters():
        parts = k.split(".")
        leaf = parts[-2] if parts[-1] == "weight" else parts[-1]
        total += shr.shard_bytes(p, shr.zero1_pspecs({leaf: p}, mesh)[leaf], mesh,
                                 torch.float32)
    return total


def test_rules_resolve_on_the_stacked_tree():
    """The port's model keeps a tensor per layer; the reference's rules see
    leaves stacked over layers, and ZeRO-1 puts the data axes on the first
    unsharded divisible dimension, which can be the layer axis.  On xlstm
    at (16, 16) the rules resolved per layer give other bytes than the
    reference's; the port resolves on the stacked tree (the model passed
    in is stacked first) and gives the reference's."""
    ref_mesh, mesh = _meshes("16x16")
    model = meta_model(get_arch("xlstm"))
    tree = shr.param_tree(model)
    ref_tree = _trees("xlstm")[0]
    ref_flat = _flat(ref_tree)
    want = sum(_ref_bytes(ref_flat[k], s, ref_mesh, 4)
               for k, s in _flat(ref_shr.zero1_pspecs(ref_tree, ref_mesh)).items())
    assert shr.tree_shard_bytes(tree, shr.zero1_pspecs(model, mesh), mesh,
                                torch.float32) == want
    assert _per_layer_zero1_bytes(model, mesh) != want
    assert shr.param_pspecs(model, mesh) == shr.param_pspecs(tree, mesh)


def test_shard_shape_and_bytes():
    mesh = shr.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert shr.shard_shape((64, 32, 7), (("pod", "data"), "model", None), mesh) == (2, 2, 7)
    t = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    assert shr.shard_bytes(t, (("pod", "data"), "model"), mesh) == 2 * 2 * 2
    assert shr.shard_bytes(t, (None, None), mesh, torch.float32) == 64 * 32 * 4


@given(dims=st.lists(st.sampled_from([2, 3, 4, 6, 8, 16, 30]), min_size=1, max_size=3))
@settings(max_examples=25, deadline=None)
def test_logical_spec_divisibility_fallback(dims):
    """logical_to_spec never produces a spec whose mesh axes don't divide
    (tests/test_property_hypothesis.py:88 on the port)."""
    mesh = shr.abstract_mesh((2, 2), ("data", "model"))
    spec = shr.logical_to_spec(["batch", "heads", "ff"][: len(dims)], dims, mesh)
    assert len(spec) == len(dims)
    for dim, entry in zip(dims, spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        assert dim % shr.mesh_axis_size(mesh, names) == 0
    assert math.prod(shr.shard_shape(dims, spec, mesh)) * shr.mesh_axis_size(
        mesh, [n for e in spec if e for n in ((e,) if isinstance(e, str) else e)]) == \
        math.prod(dims)
