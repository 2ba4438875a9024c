"""The mesh and its one collective (port of `repro.parallel.sharding`'s
statistics half).

The process model is SPMD: one process per card, each holding its shard of
the block axis.  The mesh is a 1-D `torch.distributed.device_mesh.
DeviceMesh` whose dimension is named ``"data"``: NCCL on the card, gloo on
the CPU.  A mesh-placed array is a `torch.distributed.tensor.DTensor` --
``Shard(0)`` on the block axis is the reference's ``NamedSharding(mesh,
P("data"))``, ``Replicate()`` its ``P()`` -- that keeps the reference's
global shape; every computation reads its ``.to_local()``.

The reference's ``shard_map_compat`` has no counterpart: each SPMD rank runs
the per-shard body directly on its local blocks.  Its logical-axis rules
are here as data (:data:`_RULES`, :data:`_PARAM_RULES`,
:func:`logical_to_spec`, :func:`param_pspecs`, :func:`zero1_pspecs`, the SP
switch :func:`set_sp_mode`): they resolve against a mesh of names and sizes
(:func:`abstract_mesh`, no devices, no process group; or a ``DeviceMesh``)
and give each leaf's per-dimension mesh axes, from which
:func:`shard_shape` / :func:`tree_shard_bytes` give its per-device bytes.
The dry run (`launch.dryrun`) reads them.  The tensor-parallel step of
the dense family (`parallel.tensor`) places its weights by the same rules
wherever the split is head-aligned, and holds whole heads where the rules
would cut one.  A spec is a tuple
with one entry a dimension: None (replicated), a mesh-axis name, or a tuple
of names -- the reference's ``PartitionSpec`` entries.

:func:`psum_tree` is the cluster-level merge of the weak-memory monoid: the
per-shard partial statistics of halo-complete blocks already hold every
window a shard owns, so the global merge is ONE reduction of the (tiny)
sufficient statistics, never of the data.  It gathers every rank's partials
(one ``all_gather`` per dtype of the leaves) and sums them in rank order on
every rank, so the result is bitwise the same on every rank and from run to
run, and at world 1 bitwise the local partial.  A plain ``all_reduce``
gives neither: NCCL picks its reduction order by message size.
:func:`collective_count` counts the collectives (these and the model-axis
ones of `parallel.tensor`), as a kernel wrapper counts its launches,
:func:`collective_counts` by kind, and :func:`collective_bytes` their
payload bytes by kind
(the reference's ``launch.roofline.CollectiveStats`` convention: an
all-gather's payload is its gathered output).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.backend import resolve_device
from ..core.mapreduce import tree_leaves, tree_map

__all__ = ["data_mesh", "mesh_axis_size", "mesh_rank", "mesh_device", "gather_tree",
           "psum_tree", "sum_ranks", "BUCKET", "buckets", "axis_world", "collective_count",
           "collective_counts", "collective_bytes",
           "record_collective", "reset_collective_count", "collective_stage", "collective_stages",
           "STAGES", "AbstractMesh", "abstract_mesh",
           "set_sp_mode", "sp_mode_enabled", "logical_to_spec", "param_pspecs", "zero1_pspecs",
           "shard_shape", "shard_bytes", "tree_shard_bytes", "param_tree"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_counts: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
_payload: Dict[str, float] = dict.fromkeys(COLLECTIVES, 0.0)
# the collectives the function needs at least (see record_collective)
_fn_counts: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
_fn_payload: Dict[str, float] = dict.fromkeys(COLLECTIVES, 0.0)
# the stages of a train step that the executed collectives are counted by:
# the forward, remat's recompute inside the backward, the backward's own,
# the gradient combine, the global norm and the ZeRO-1 parameter gather
STAGES = ("forward", "recompute", "backward", "combine", "norm", "zero1")
_stage = "forward"
_stage_counts: Dict[str, int] = dict.fromkeys(STAGES, 0)
_stage_payload: Dict[str, float] = dict.fromkeys(STAGES, 0.0)


def record_collective(kind: str, nbytes: float,
                      function: Optional[Tuple[str, float]] = None,
                      stage: Optional[str] = None) -> None:
    """Count one collective of ``kind`` moving ``nbytes`` of payload.
    ``function`` is the (kind, payload) of the collective that computes the
    same function, where the executed one moves more (the rank-ordered
    reduction gathers every rank's partial; its function is an all-reduce
    of the one partial); by default the executed one.  ``stage``: the
    train step's stage it belongs to (default: :func:`collective_stage`'s)."""
    _counts[kind] += 1
    _payload[kind] += nbytes
    fn_kind, fn_bytes = function or (kind, nbytes)
    _fn_counts[fn_kind] += 1
    _fn_payload[fn_kind] += fn_bytes
    stage = stage or _stage
    _stage_counts[stage] += 1
    _stage_payload[stage] += nbytes


@contextlib.contextmanager
def collective_stage(name: str):
    """Count the collectives made inside as the stage ``name`` of
    :data:`STAGES` (a train step's forward is the default)."""
    global _stage
    if name not in STAGES:
        raise ValueError(f"stage {name!r} is not one of {STAGES}")
    saved, _stage = _stage, name
    try:
        yield
    finally:
        _stage = saved


def collective_stages() -> Dict[str, Tuple[int, float]]:
    """{stage: (executed collectives, their payload bytes)} since the last
    reset, for each stage that made one."""
    return {s: (_stage_counts[s], _stage_payload[s]) for s in STAGES if _stage_counts[s]}


def collective_count() -> int:
    """Collectives made since the last reset: by :func:`gather_tree` /
    :func:`psum_tree` and by the model-axis collectives of
    `parallel.tensor` (counted alike on a counting mesh)."""
    return sum(_counts.values())


def collective_counts(function: bool = False) -> Dict[str, int]:
    """Those collectives by kind; ``function``: the function's (see
    :func:`record_collective`)."""
    return dict(_fn_counts if function else _counts)


def collective_bytes(function: bool = False) -> Dict[str, float]:
    """Payload bytes of those collectives by kind since the last reset, per
    rank: an all-gather's is its gathered output (world x its input), an
    all-reduce's its input.  ``function``: the function's."""
    return dict(_fn_payload if function else _payload)


def reset_collective_count() -> None:
    for k in COLLECTIVES:
        _counts[k] = _fn_counts[k] = 0
        _payload[k] = _fn_payload[k] = 0.0
    for s in STAGES:
        _stage_counts[s] = 0
        _stage_payload[s] = 0.0


def data_mesh(world_size: int, rank: int, init_method: str, device="cuda",
              axis: str = "data"):
    """Join the process group and build the 1-D mesh named ``axis``.

    On the card: the process's card is ``cuda:<rank mod cards>`` (set before
    the NCCL group is made, or its point-to-point calls can hang) and the
    backend is NCCL, which must be present; a mesh on the card never runs
    gloo.  On the CPU (``device="cpu"``): gloo.  ``init_method`` is the
    rendezvous (``file://<path>`` or ``tcp://host:port``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)  # raises on "cuda" without a GPU
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on the card needs NCCL, and this PyTorch has none")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; a {dev.type} mesh "
                           f"needs {backend}")
    return init_device_mesh(dev.type, (world_size,), mesh_dim_names=(axis,))


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    dims = mesh.mesh_dim_names or ()
    return {n: mesh.size(i) for i, n in enumerate(dims)}


def mesh_axis_size(mesh, names: Sequence[str]) -> int:
    """Ranks along the mesh dimensions ``names`` (1 for a name it lacks), of
    an :class:`AbstractMesh` or a ``DeviceMesh``."""
    sizes = _axis_sizes(mesh)
    return math.prod(sizes.get(n, 1) for n in names)


def mesh_rank(mesh, axis: str = "data") -> int:
    """This process's index along ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh) -> torch.device:
    """Where this rank's shard lives: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# the most elements one gather of a tree carries (a larger leaf goes
# alone): the transient buffers of a gradient combine or of the ZeRO-1
# parameter gather stay a few hundred MB a rank
BUCKET = 1 << 26


def buckets(names, named) -> list:
    """Runs of consecutive indices into ``names`` of one dtype and at most
    :data:`BUCKET` elements together (a larger tensor alone), in order."""
    out, run, n = [], [], 0
    for i, k in enumerate(names):
        t = named[k]
        if run and (n + t.numel() > BUCKET or t.dtype != named[names[run[0]]].dtype):
            out.append(run)
            run, n = [], 0
        run.append(i)
        n += t.numel()
    return out + [run] if run else out


def axis_world(mesh, axis: str) -> int:
    """Ranks along ``axis`` (``"data"`` takes in a counting mesh's
    ``"pod"`` axis too, as the rule tables' batch does)."""
    if isinstance(mesh, AbstractMesh):
        return mesh_axis_size(mesh, ("pod", "data") if axis == "data" else (axis,))
    return mesh.get_group(axis).size()


def _gathers(leaves, mesh, axis: str, reduce: bool):
    """(indices into ``leaves``, their flat buffers gathered (world, n)) for
    each buffer of one dtype (or :func:`buckets` of it), one ``all_gather``
    each, counted (``reduce``: its function is an all-reduce of the
    buffer); on an :class:`AbstractMesh` only counted, empty."""
    world = axis_world(mesh, axis)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idx in by_dtype.values():
        for run in buckets(idx, leaves):
            run = [idx[j] for j in run]
            flat = torch.cat([leaves[i].reshape(-1) for i in run])
            nbytes = flat.numel() * flat.element_size()
            record_collective("all-gather", world * nbytes,
                              function=("all-reduce", nbytes) if reduce else None)
            gathered = flat.new_empty((world, flat.numel()))
            if not isinstance(mesh, AbstractMesh):
                dist.all_gather(list(gathered.unbind(0)), flat, group=mesh.get_group(axis))
            yield run, gathered


def _unflatten(tree: Any, leaves, parts) -> Any:
    """``tree`` with each leaf replaced by ``parts``' slices of the flat
    buffers of :func:`_gathers` (the last dimension), each shaped as
    (lead..., leaf's shape)."""
    out = [None] * len(leaves)
    for run, buf in parts:
        start = 0
        for i in run:
            size = leaves[i].numel()
            out[i] = buf[..., start:start + size].reshape(buf.shape[:-1] + leaves[i].shape)
            start += size
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def gather_tree(tree: Any, mesh, axis: str = "data") -> Any:
    """Every rank's copy of ``tree``, stacked: each leaf gains a leading
    (world,) axis in rank order.  The leaves are flattened into one buffer
    per dtype (per :func:`buckets` of it) and gathered with one
    ``all_gather`` each; on an :class:`AbstractMesh` nothing is exchanged,
    the result only has the right shape."""
    leaves = tree_leaves(tree)
    return _unflatten(tree, leaves, list(_gathers(leaves, mesh, axis, reduce=False)))


def sum_ranks(stacked: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The (world, ...) partials summed in rank order (rank 0 first), in
    float32 for a narrower float, cast to ``dtype`` (default the
    partials')."""
    acc_dtype = torch.float32 if stacked.element_size() < 4 and stacked.is_floating_point() \
        else stacked.dtype
    acc = stacked[0].to(acc_dtype)
    for r in range(1, stacked.shape[0]):
        acc = acc + stacked[r].to(acc_dtype)
    return acc.to(dtype or stacked.dtype)


def psum_tree(tree: Any, mesh, axis: str = "data") -> Any:
    """The sum over the mesh dimension ``axis`` of every rank's ``tree`` of
    partial statistics: one collective per dtype (per :func:`buckets` of
    it, each summed before the next is gathered), the world's partials
    added in rank order on every rank (bitwise alike on every rank; at
    world 1 bitwise the local partial)."""
    leaves = tree_leaves(tree)
    return _unflatten(tree, leaves, ((run, sum_ranks(buf))
                                     for run, buf in _gathers(leaves, mesh, axis, reduce=True)))


# ------------------------------------------------ logical-axis rules ----
# The reference's rules (DESIGN.md section 6), as data:
#   batch   -> ("pod", "data")   data parallelism (pod = outer pure-DP axis)
#   heads   -> "model"           tensor parallelism over (kv-grouped) heads
#   ff      -> "model"           tensor parallelism over MLP hidden
#   experts -> "model"           expert parallelism
#   vocab   -> "model"           embedding / logits sharding
#   seq     -> "data" in SP mode sequence/context parallelism (long_500k)

LogicalAxis = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]

_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": (),
    "seq": (),  # overridden in SP mode
    "seq_sp": ("data",),
    "seq_tp": ("model",),  # Megatron-SP residual sharding
}

_SP_MODE = False


def set_sp_mode(enabled: bool) -> None:
    """Sequence-parallel mode: 'seq' -> data axis, 'batch' -> replicated."""
    global _SP_MODE
    _SP_MODE = enabled


def sp_mode_enabled() -> bool:
    return _SP_MODE


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes only: no devices, no process group."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """The mesh ``shape`` over ``axis_names`` (the reference's AbstractMesh)."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axis names")
    return AbstractMesh(shape, axis_names)


def _mesh_names(mesh) -> Tuple[str, ...]:
    return tuple(_axis_sizes(mesh))


def _resolve(logical: LogicalAxis, mesh) -> Tuple[str, ...]:
    if logical is None:
        return ()
    if isinstance(logical, tuple):
        names: Tuple[str, ...] = logical
    else:
        if logical == "batch" and _SP_MODE:
            return ()
        if logical == "seq" and _SP_MODE:
            names = _RULES["seq_sp"]
        else:
            names = _RULES.get(logical, (logical,))
    present = _mesh_names(mesh)
    return tuple(n for n in names if n in present)


def logical_to_spec(axes: Sequence[LogicalAxis], shape: Sequence[int], mesh) -> Spec:
    """Resolve logical names per dimension with divisibility fallback: a
    dimension whose mesh axes do not divide it (or are taken by an earlier
    dimension) is replicated.  Returns one entry a dimension of ``shape``
    that ``axes`` names (None, a name, or a tuple of names)."""
    entries = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        names = tuple(n for n in _resolve(logical, mesh) if n not in used)
        if names and dim % mesh_axis_size(mesh, names) == 0:
            used.update(names)
            entries.append(names if len(names) > 1 else names[0])
        else:
            entries.append(None)
    return tuple(entries)


# Leaf-name -> logical axes (per dimension).  Matched by the *last* path
# component; falls back to replicated.  Divisibility fallback applies per
# dim, so e.g. a 4-head test model simply replicates its head axis.
_PARAM_RULES: Dict[str, Tuple[LogicalAxis, ...]] = {
    # attention
    "wq": (None, "heads"),
    "wk": (None, "kv"),
    "wv": (None, "kv"),
    "wo": ("heads", None),
    # MLA
    "w_dq": (None, None),
    "w_uq": (None, "heads"),
    "w_dkv": (None, None),
    "w_uk": (None, "heads"),
    "w_uv": (None, "heads"),
    "w_kr": (None, None),
    # MLP
    "w_gate": (None, "ff"),
    "w_up": (None, "ff"),
    "w_down": ("ff", None),
    # MoE (leading expert axis)
    "router": (None, None),
    "e_gate": ("experts", None, None),
    "e_up": ("experts", None, None),
    "e_down": ("experts", None, None),
    # embeddings / head
    "embed": ("vocab", "embed"),
    "lm_head": (None, "vocab"),
    "patch_proj": (None, None),
    # mamba2
    "in_proj": (None, "ff"),
    "conv_w": (None, "ff"),
    "conv_b": ("ff",),
    "out_proj": ("ff", None),
    "A_log": ("ff",),
    "D": ("ff",),
    "dt_bias": ("ff",),
    # xlstm
    "w_qkv": (None, "ff"),
    "w_if": (None, "heads"),
    "w_o_gate": (None, "ff"),
    "up_proj": (None, "ff"),
    "down_proj": ("ff", None),
    "w_gates": (None, "heads"),
    "r_gates": (None, "heads"),
}


def _leaf_rule(path: Tuple[str, ...], leaf) -> Tuple[LogicalAxis, ...]:
    """The logical axes of the leaf at ``path`` (its keys, outermost
    first), by its last name: the rule, led by None for a stacked-over-
    layers leaf (one more dimension than the rule), else all None."""
    ndim = len(leaf.shape)
    rule = _PARAM_RULES.get(path[-1] if path else "", None)
    if rule is None:
        return (None,) * ndim
    if len(rule) == ndim:
        return rule
    if len(rule) + 1 == ndim:
        return (None,) + rule
    return (None,) * ndim


def param_tree(params) -> Dict[str, Any]:
    """``params`` in the reference's layout, the tree every rule resolves
    on: a model (an ``nn.Module`` of `models`) becomes its params tree, each
    layer leaf stacked on a leading (L, ...) axis (``params_to_tree``; on
    the ``meta`` device the stack allocates nothing); a tree (a nest of
    dicts of tensors or TensorSpecs) is returned as it is.  The rules must
    see the stacked tree: ``zero1_pspecs`` puts the data axes on the first
    unsharded divisible dimension, which can be the layer axis, so a leaf
    per layer would be split along another dimension, with other
    per-device bytes."""
    if isinstance(params, dict):
        return params
    from ..models.model_zoo import params_to_tree

    return params_to_tree(params)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params: Any, mesh) -> Any:
    """The spec of every leaf of ``params`` (a model or a tree of tensors or
    TensorSpecs, see :func:`param_tree`)."""
    return _map_with_path(
        lambda path, leaf: logical_to_spec(_leaf_rule(path, leaf), leaf.shape, mesh),
        param_tree(params))


def zero1_pspecs(params: Any, mesh) -> Any:
    """ZeRO-1 optimizer-state specs: the param spec PLUS the data(+pod) axes
    on the first still-unsharded divisible dimension (the plain param spec
    when no dimension divides).  Optimizer moments are only touched at the
    update, so a reduce-scatter / all-gather there buys an N_data-fold
    memory reduction."""
    present = _mesh_names(mesh)
    dp_axes = tuple(n for n in ("pod", "data") if n in present)
    dp = mesh_axis_size(mesh, dp_axes)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = logical_to_spec(_leaf_rule(path, leaf), shape, mesh)
        if dp <= 1:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim % dp == 0:
                entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                return tuple(entries)
        return spec

    return _map_with_path(one, param_tree(params))


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` under ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        out.append(dim // mesh_axis_size(mesh, names))
    return tuple(out)


def shard_bytes(leaf, spec: Spec, mesh, dtype=None) -> int:
    """Per-device bytes of ``leaf`` (a tensor or TensorSpec) under ``spec``,
    at ``dtype`` (default: the leaf's)."""
    itemsize = torch.empty((), dtype=dtype or leaf.dtype).element_size()
    return math.prod(shard_shape(leaf.shape, spec, mesh)) * itemsize


def tree_shard_bytes(tree: Any, specs: Any, mesh, dtype: Optional[torch.dtype] = None) -> int:
    """Per-device bytes of every leaf of ``tree`` under the matching
    ``specs`` tree (each leaf at ``dtype``, or its own)."""
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(v, specs[k], mesh, dtype) for k, v in tree.items())
    return shard_bytes(tree, specs, mesh, dtype)
