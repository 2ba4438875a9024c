"""Per-cell step functions: (arch x shape) -> the step function of the
cell's kind and the specs of its inputs (port of `repro.launch.steps`).

A cell is one architecture at one shape of the matrix (`configs.SHAPES`):
``train`` cells step ``training.make_train_step``, ``prefill`` cells
``models.prefill`` and ``decode`` cells ``models.decode_step``.  The
reference also builds pjit sharding trees for each cell; the port is SPMD
(one process a rank), so a cell on a mesh is what one rank runs.  What
carries over is the cell's kind and inputs (``models.input_specs``), the
sequence-parallel decision (a global batch that the data ranks do not
divide takes the sequence axis instead), and ``_CACHE_RULES``: the logical
axes of each decode-cache leaf, as data (:func:`cache_axes`).

``build_cell(..., mesh=)`` with a ``("data", "model")`` mesh (a
``DeviceMesh`` of `parallel.tensor.model_mesh`, or an ``AbstractMesh`` to
count on) gives a rank's cell: its share of the batch, and with a model
axis above 1 the tensor-parallel step of the dense family (the rank's
shard of the model, ``parallel.tensor.shard_params``): the train step
(``make_train_step(mesh=)``, its state from ``training.init_state``),
the prefill and decode (its vocab shard of the logits, its KV heads'
cache) and the forward-only loss (``Cell.loss``).  Another family on a
model axis and the sequence-parallel layout raise until their slices
come.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from ..configs import SHAPES_BY_NAME, ArchConfig, ShapeConfig, cell_is_runnable, get_arch
from ..models import decode_step, input_specs, prefill
from ..models.attention import TensorSpec
from ..models.layers import DTYPE
from ..parallel import tensor as tp
from ..training.train_step import loss_fn, make_train_step

__all__ = ["Cell", "build_cell", "cache_axes", "use_sequence_parallel"]

# leaf name -> logical axes, EXCLUDING a leading stacked-layer axis
_CACHE_RULES: Dict[str, Tuple[Any, ...]] = {
    "k": ("batch", "seq", "kv", None),
    "v": ("batch", "seq", "kv", None),
    "lat": ("batch", "seq", None),
    "pos": (None,),
    "ssd": ("batch", "heads", None, None),
    "conv": ("batch", None, "ff"),
    "C": ("batch", "heads", None, None),
    "n": ("batch", "heads", None),
    "m": ("batch", "heads"),
    "h": ("batch", "heads", None),
    "c": ("batch", "heads", None),
}


def cache_axes(cache: Any, name: Optional[str] = None) -> Any:
    """The logical axes of every leaf of a decode cache (a nest of dicts of
    tensors or TensorSpecs), by the leaf's name: the rule's axes, led by
    None for a stacked (layer or application) axis; all None for a leaf the
    rules do not name or whose rank fits neither."""
    if isinstance(cache, dict):
        return {k: cache_axes(v, k) for k, v in cache.items()}
    ndim = len(cache.shape)
    axes = _CACHE_RULES.get(name or "")
    if axes is None:
        return (None,) * ndim
    if len(axes) + 1 == ndim:
        return (None,) + tuple(axes)
    return tuple(axes) if len(axes) == ndim else (None,) * ndim


def use_sequence_parallel(shape: ShapeConfig, data_ranks: int) -> bool:
    """A global batch the data ranks do not divide (or smaller than them)
    shards the sequence axis instead of the batch."""
    return shape.global_batch % data_ranks != 0 or shape.global_batch < data_ranks


@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell: its step function and its inputs' specs.

    ``fn``: ``train`` -> ``step(model, opt_state, batch)``; ``prefill`` ->
    ``fn(model, batch)``; ``decode`` -> ``fn(model, cache, batch)``.
    ``inputs`` holds the batch's specs (a decode cell's ``cache`` spec
    under ``"cache"``), ``cache_axes`` a decode cell's cache axes, ``loss``
    a prefill or decode cell's ``loss(model, batch)``, the forward-only
    ``training.loss_fn`` of its model.  On a mesh: one rank's inputs, and
    the loss of the whole batch from the rank's rows."""

    cfg: ArchConfig
    shape: ShapeConfig
    fn: Callable
    inputs: Dict[str, Any]
    sp_mode: bool
    cache_axes: Any = None
    loss: Optional[Callable] = None


def build_cell(arch, shape, *, data_ranks: int = 1, dtype=DTYPE, accum: int = 1,
               fused_loss: bool = False, mesh: Any = None) -> Cell:
    """The cell of ``arch`` (a name or an ArchConfig) at ``shape`` (a name
    or a ShapeConfig); raises ``ValueError`` for a cell the matrix skips.
    ``mesh``: a ``("data", "model")`` mesh (its data axes set
    ``data_ranks``); the cell is then one rank's."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({cfg.name} x {shape.name}) skipped: {why}")
    model_axis = 1
    if mesh is not None:
        data_ranks, model_axis = tp.data_size(mesh), tp.model_size(mesh)
    sp = use_sequence_parallel(shape, data_ranks)
    if mesh is not None and sp:
        raise NotImplementedError(f"cell ({cfg.name} x {shape.name}): sequence parallelism "
                                  f"waits for a later slice")
    if model_axis > 1:
        tp.check_layout(cfg, model_axis)
    specs = input_specs(cfg, shape, mesh)
    if shape.kind != "decode":
        specs = {k: (TensorSpec(s.shape, dtype) if s.dtype.is_floating_point else s)
                 for k, s in specs.items()}
    if shape.kind == "train":
        fn = make_train_step(cfg, accum=accum, fused_loss=fused_loss, mesh=mesh)
        return Cell(cfg, shape, fn, specs, sp)
    kw = {} if mesh is None else {"mesh": mesh}

    def loss(params, batch):
        return loss_fn(params, batch, cfg, fused=fused_loss, mesh=mesh)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return prefill(params, batch, cfg, **kw)

        return Cell(cfg, shape, prefill_step, specs, sp, loss=loss)

    def decode_fn(params, cache, batch):
        return decode_step(params, cache, batch, cfg, **kw)

    return Cell(cfg, shape, decode_fn, specs, sp, cache_axes=cache_axes(specs["cache"]),
                loss=loss)
