"""Per-cell step functions: (arch x shape) -> the step function of the
cell's kind and the specs of its inputs (port of `repro.launch.steps`).

A cell is one architecture at one shape of the matrix (`configs.SHAPES`):
``train`` cells step ``training.make_train_step``, ``prefill`` cells
``models.prefill`` and ``decode`` cells ``models.decode_step``.  The
reference also builds pjit sharding trees for each cell; those have no
twin here (one process a card, no pjit).  What carries over is the
cell's kind and inputs (``models.input_specs``), the sequence-parallel
decision (a global batch that the data ranks do not divide takes the
sequence axis instead), and ``_CACHE_RULES``: the logical axes of each
decode-cache leaf, as data (:func:`cache_axes`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from ..configs import SHAPES_BY_NAME, ArchConfig, ShapeConfig, cell_is_runnable, get_arch
from ..models import decode_step, input_specs, prefill
from ..models.attention import TensorSpec
from ..models.layers import DTYPE
from ..training.train_step import make_train_step

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
    under ``"cache"``), ``cache_axes`` a decode cell's cache axes."""

    cfg: ArchConfig
    shape: ShapeConfig
    fn: Callable
    inputs: Dict[str, Any]
    sp_mode: bool
    cache_axes: Any = None


def build_cell(arch, shape, *, data_ranks: int = 1, dtype=DTYPE, accum: int = 1,
               fused_loss: bool = False) -> Cell:
    """The cell of ``arch`` (a name or an ArchConfig) at ``shape`` (a name
    or a ShapeConfig); raises ``ValueError`` for a cell the matrix skips."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({cfg.name} x {shape.name}) skipped: {why}")
    sp = use_sequence_parallel(shape, data_ranks)
    specs = input_specs(cfg, shape)
    if shape.kind != "decode":
        specs = {k: (TensorSpec(s.shape, dtype) if s.dtype.is_floating_point else s)
                 for k, s in specs.items()}
    if shape.kind == "train":
        fn = make_train_step(cfg, accum=accum, fused_loss=fused_loss)
        return Cell(cfg, shape, fn, specs, sp)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return prefill(params, batch, cfg)

        return Cell(cfg, shape, prefill_step, specs, sp)

    def decode_fn(params, cache, batch):
        return decode_step(params, cache, batch, cfg)

    return Cell(cfg, shape, decode_fn, specs, sp, cache_axes=cache_axes(specs["cache"]))
