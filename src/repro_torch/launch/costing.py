"""Counted FLOPs, bytes, peak memory and collectives of a cell's step, and
the depth calibration (port of `repro.launch.costing`).

The reference lowers a cell with XLA and reads ``cost_analysis()``; the
port runs the cell's step (`launch.steps.build_cell`) on the ``meta``
device under :class:`CountingMode`, a ``TorchDispatchMode`` that sees
every aten op and allocates nothing, so a full-width, full-depth cell
costs host time only.  Per op it adds:

  * executed FLOPs by dtype, from ``torch.utils.flop_counter``'s formulas
    (the matrix products, convolutions and fused attentions);
  * the function's FLOPs (`launch.roofline`'s convention): the same
    products, counted only outside the backward (a train cell's forward
    counts three times, for the forward and the backward's two; remat's
    recompute, which runs inside the backward, not at all);
  * executed bytes: each op's tensor inputs read and outputs written
    (views and allocations move nothing);
  * live bytes by storage (a view shares its base's storage and is not
    counted twice; autograd's saved tensors hold theirs), and their peak.

At the attention boundary (:func:`attention_boundaries`) the function's
work is counted by formula, not by descending into the plain path:

  * kernel 8 (``kernels.swa_attention.ops.swa_attention``, the default
    causal attention of every prefill): its wrapper runs the chunked plain
    version off the card, which computes whole (chunk, S) squares; the
    trace counts the kernel's work instead, 2 (D + DV) a causal (or
    windowed) (query, key) pair of each head, for both the function and
    the executed count, and allocates only its output, as the kernel does;
  * the plain causal attention of the training forward
    (``swa_attention_chunked``): the function counts its causal pairs, the
    executed count descends into the chunks, whose whole squares the card
    really computes;
  * the encoder-decoder's bidirectional ``full_attention`` is not a
    boundary: its whole square is the real work, in both counts.

On a mesh with a model axis above 1 (`parallel.tensor`), the trace is one
rank's tensor-parallel step: the model is the rank's shard
(``shard_params`` of the meta model, on the counting ``AbstractMesh``),
the batch its share, a train step's moments its ZeRO-1 slices, and every
collective is counted by kind and payload (``sharding.collective_counts``
/ ``collective_bytes``), and a train step's by stage (the forward, remat's
recompute, the backward, the gradient combine, the norm, the ZeRO-1
gather), without exchanging anything.

The depth calibration (:func:`calibrated_cost`) traces the cell at two
reduced depths and extrapolates linearly, as the reference does; its
reason here is host time (xlstm's serial sLSTM steps and zamba2's 81
layers make full-depth traces slow), not XLA's loop counting.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional, Tuple
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import SHAPES_BY_NAME, ArchConfig, ShapeConfig, get_arch
from ..models.layers import DTYPE
from .steps import build_cell

__all__ = ["CountingMode", "attention_boundaries", "attention_pairs", "meta_model",
           "meta_inputs", "param_read_bytes", "serve_bytes", "CellTrace", "trace_cell",
           "CalibratedCost", "calibrated_cost", "dp_gather_payload"]

_aten = torch.ops.aten
# ops that allocate or alias without moving data
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.detach.default, _aten.alias.default,
               _aten.lift_fresh.default, _aten.empty_like.default}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _forward() -> bool:
    """True outside the autograd engine's backward (where remat recomputes)."""
    return torch._C._current_graph_task_id() == -1


class CountingMode(TorchDispatchMode):
    """Counts a step's FLOPs, bytes and live storage on the ``meta`` device
    (or any device: it only reads shapes).  ``train`` makes the function's
    count of a forward product three times its FLOPs."""

    def __init__(self, train: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.train = train
        self.function_flops: Dict[str, float] = defaultdict(float)
        self.executed_flops: Dict[str, float] = defaultdict(float)
        self.executed_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Any] = {}
        self.read: set = set()  # storages some op has read
        self._formula = 0  # > 0 inside an attention boundary counted by formula

    # -- counts
    def reset_counts(self, peak: bool = True) -> None:
        """Zero the FLOPs and bytes and forget what was read; with
        ``peak`` the peak restarts from what is live."""
        self.function_flops.clear()
        self.executed_flops.clear()
        self.executed_bytes = 0.0
        self.read.clear()
        if peak:
            self.peak = self.live

    def add_flops(self, dtype: str, function: float, executed: float) -> None:
        if function:
            self.function_flops[dtype] += function
        if executed:
            self.executed_flops[dtype] += executed

    @contextlib.contextmanager
    def by_formula(self) -> Iterator[None]:
        """Ops inside count as executed only: the caller counts the
        function's work by formula."""
        self._formula += 1
        try:
            yield
        finally:
            self._formula -= 1

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = _storage_key(t)
        if key in self._storages:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(st, freed)

    # -- the dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in self._registry:
            flops = self._registry[packet](*args, **kwargs, out_val=out)
            first = next(t for t in tree_flatten((args, kwargs))[0]
                         if isinstance(t, torch.Tensor))
            dt = _dtype_name(first)
            self.executed_flops[dt] += flops
            if not self._formula and _forward():
                self.function_flops[dt] += flops * (3 if self.train else 1)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        # a view or an in-place result shares a storage that is already
        # counted, or one made outside the mode (a weight the caller holds)
        aliasing = func.is_view or any(r.alias_info is not None for r in func._schema.returns)
        if not func.is_view and func not in _NO_TRAFFIC:
            written = {i for i, a in enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write}
            ins = [t for i, a in enumerate(args) if i not in written
                   for t in tree_flatten(a)[0] if isinstance(t, torch.Tensor)]
            ins += [t for k, v in kwargs.items() if k != "out"
                    for t in tree_flatten(v)[0] if isinstance(t, torch.Tensor)]
            self.read.update(_storage_key(t) for t in ins)
            self.executed_bytes += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        if not aliasing:
            for t in outs:
                self.track(t)
        return out


def attention_pairs(s: int, sk: int, window: Optional[int], q_pos0: int = 0,
                    causal: bool = True) -> int:
    """Unmasked (query, key) pairs of one head: queries at q_pos0 + [0, s)
    against keys [0, sk), a query at p seeing keys in (p - window, p]
    (causal), or every key (not causal)."""
    if not causal:
        return s * sk
    pos = q_pos0 + np.arange(s, dtype=np.int64)
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    hi = np.minimum(pos, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attention_flops(q, v, pairs: int) -> int:
    """2 (D + DV) a (query, key) pair of each query head."""
    b, _, h, d = q.shape
    return 2 * (d + v.shape[-1]) * pairs * b * h


@contextlib.contextmanager
def attention_boundaries(mode: CountingMode) -> Iterator[None]:
    """Count kernel 8's and the training attention's work by formula while
    ``mode`` traces (see the module's docstring): the models' module-level
    attention functions are swapped for counting ones and put back."""
    from ..kernels.swa_attention.ref import swa_attention_chunked
    from ..models import attention, encdec, transformer, zamba

    def kernel8(q, k, v, window, *, scale=None):
        b, s, h, _ = q.shape
        flops = _attention_flops(q, v, attention_pairs(s, k.shape[1], window))
        mode.add_flops(_dtype_name(q), flops, flops)
        out = q.new_empty((b, s, h, v.shape[-1]))
        mode.executed_bytes += q.nbytes + k.nbytes + v.nbytes + out.nbytes
        return out

    def plain(q, k, v, window=None, *, scale=None, chunk=512, q_pos0=0, causal=True):
        if _forward() and not mode._formula:
            pairs = attention_pairs(q.shape[1], k.shape[1], window, q_pos0, causal)
            mode.add_flops(_dtype_name(q),
                           _attention_flops(q, v, pairs) * (3 if mode.train else 1), 0)
        with mode.by_formula():
            return swa_attention_chunked(q, k, v, window, scale=scale, chunk=chunk,
                                         q_pos0=q_pos0, causal=causal)

    swaps = [(attention, "swa_attention", kernel8), (encdec, "swa_attention", kernel8),
             (transformer, "swa_attention_chunked", plain),
             (zamba, "swa_attention_chunked", plain),
             (encdec, "swa_attention_chunked", plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def meta_model(cfg: ArchConfig, dtype=DTYPE):
    """The model of ``cfg`` on the ``meta`` device: shapes and dtypes,
    nothing drawn or allocated."""
    from ..models import init_params

    return init_params(cfg, generator=torch.Generator(), dtype=dtype, device="meta")


def meta_inputs(spec: Any) -> Any:
    """Meta tensors for a nest of dicts of TensorSpecs."""
    if isinstance(spec, dict):
        return {k: meta_inputs(v) for k, v in spec.items()}
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _nbytes(tree: Any) -> int:
    return sum(t.nbytes for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _decode_writes(cache: Dict[str, Any], axes: Dict[str, Any]) -> int:
    """Bytes a decode step writes into ``cache``: one position of each
    sequence-long leaf (its axes name "seq"; ``pos`` holds one entry a
    position), the whole of a state."""
    total = 0
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            total += _decode_writes(leaf, axes[name])
        elif "seq" in axes[name]:
            total += leaf.nbytes // leaf.shape[axes[name].index("seq")]
        elif name == "pos":
            total += leaf.nbytes // leaf.shape[-1]
        else:
            total += leaf.nbytes
    return total


def param_read_bytes(model, cfg, tokens: int, mode: CountingMode) -> int:
    """The parameter bytes a step must read: each parameter some op read
    (a decode step reads no encoder weight), of the embedding table its
    gathered rows only, unless lm_head ties to it."""
    read = sum(p.nbytes for p in model.parameters() if _storage_key(p) in mode.read)
    embed = model.embed
    if not cfg.tie_embeddings:
        read -= embed.nbytes - min(tokens, embed.shape[0]) * embed.shape[1] * embed.element_size()
    return read


def serve_bytes(cfg, model, mode: CountingMode, batch: Dict[str, Any], out,
                cache_read: Optional[int] = None) -> int:
    """The compulsory bytes of a served step traced under ``mode`` (since
    its last ``reset_counts``): a prefill (``cache_read`` None) reads the
    parameters it used and its ``batch`` and writes ``out``, its last
    logits and its cache; a decode step reads the parameters it used, its
    tokens and the whole cache (``cache_read`` bytes) and writes its logits
    and the cache's new entries (:func:`_decode_writes`)."""
    from .steps import cache_axes

    tokens = batch["tokens"]
    read = param_read_bytes(model, cfg, tokens.numel(), mode)
    if cache_read is None:
        return read + _nbytes(batch) + _nbytes(out)
    logits, cache = out
    return (read + tokens.nbytes + cache_read + _decode_writes(cache, cache_axes(cache))
            + logits.nbytes)


def dp_gather_payload(named: Dict[str, torch.Tensor], world: int,
                      accum: int = 1) -> Tuple[int, int]:
    """(all-gathers, payload bytes per rank) of a data-parallel train
    step's collectives (`training.train_step`): each microbatch's loss
    gathers the ranks' float32 (cross-entropy, the label count of each of
    the ``accum`` microbatches, lb_loss, z_loss), then the gradients are
    summed with one all-gather per dtype (per ``sharding.buckets`` of it:
    the parameters' dtype at ``accum`` 1, float32 above), each gathering
    ``world`` times its input."""
    from ..parallel.sharding import buckets

    dtype = lambda p: p.dtype if accum == 1 else torch.float32  # noqa: E731
    grads = {k: torch.empty(p.shape, dtype=dtype(p), device="meta") for k, p in named.items()}
    by_dtype: Dict[torch.dtype, list] = defaultdict(list)
    for k, g in grads.items():
        by_dtype[g.dtype].append(k)
    gathers = sum(len(buckets(keys, grads)) for keys in by_dtype.values())
    grad_bytes = sum(g.numel() * g.element_size() for g in grads.values())
    return accum + gathers, world * (accum * (3 + accum) * 4 + grad_bytes)


@dataclasses.dataclass
class CellTrace:
    """One traced step of a cell (per device, at the batch it was traced
    at): the function's FLOPs by dtype and compulsory bytes, the executed
    FLOPs and bytes, the peak of live bytes, ``temp_bytes`` the peak above
    what was live when the step began (the parameters, the optimizer
    state, the inputs and a decode step's cache), and the bytes it holds.
    ``collective_*``: the collectives the function needs (what the bound
    reads); ``executed_collective_*``: those the port's step runs (on a
    model axis, the rank-ordered reduction's all-gathers; else the same);
    ``executed_collective_stages``: those by the train step's stage
    (``sharding.STAGES``), as ``<stage>.count`` and ``<stage>.bytes``."""

    function_flops: Dict[str, float]
    function_bytes: float
    executed_flops: float
    executed_bytes: float
    peak_bytes: float
    temp_bytes: float
    param_bytes: float
    opt_bytes: float
    cache_bytes: float
    input_bytes: float
    collective_counts: Dict[str, float]
    collective_payload: Dict[str, float]
    executed_collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    executed_collective_payload: Dict[str, float] = dataclasses.field(default_factory=dict)
    executed_collective_stages: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return float(sum(self.function_flops.values()))

    def scalars(self) -> Dict[str, float]:
        """Every number of the trace by name (FLOPs by dtype as
        ``function_flops.<dtype>``)."""
        out = {}
        for name, v in dataclasses.asdict(self).items():
            if isinstance(v, dict):
                out.update({f"{name}.{k}": float(x) for k, x in v.items()})
            else:
                out[name] = float(v)
        return out

    @classmethod
    def from_scalars(cls, s: Dict[str, float]) -> "CellTrace":
        def group(prefix):
            return {k[len(prefix):]: v for k, v in s.items() if k.startswith(prefix)}

        groups = ("function_flops", "collective_counts", "collective_payload",
                  "executed_collective_counts", "executed_collective_payload",
                  "executed_collective_stages")
        kw = {f.name: group(f.name + ".") if f.name in groups else s[f.name]
              for f in dataclasses.fields(cls) if f.name in groups or f.name in s}
        return cls(**kw)


def trace_cell(arch, shape, *, batch: Optional[int] = None, world: int = 1, accum: int = 1,
               fused_loss: bool = False, dtype=DTYPE,
               inputs: Optional[Dict[str, Any]] = None, mesh=None) -> CellTrace:
    """Trace one step of the cell of ``arch`` at ``shape`` on the ``meta``
    device.  ``batch`` overrides the global batch (a data-parallel rank's
    share); ``world`` > 1 adds the data-parallel mean's all-gathers of a
    train step (:func:`dp_gather_payload`); ``inputs`` (TensorSpecs, a
    decode cell's cache under "cache") replaces the cell's own, such as an
    encoder-decoder's frames at another length than its tokens.  A decode
    cell steps at the last position of its cache.  ``mesh`` (an
    ``AbstractMesh`` with a model axis above 1): one tensor-parallel rank's
    train, prefill or decode step at its share of the global batch, its
    collectives counted (a train step's by stage, its ZeRO-1 moments held:
    ``opt_bytes`` the rank's)."""
    from ..parallel import sharding, tensor

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    cell = build_cell(cfg, shape, dtype=dtype, accum=accum, fused_loss=fused_loss, mesh=mesh)
    if inputs is not None:
        cell.inputs = inputs
    train = shape.kind == "train"
    mode = CountingMode(train=train)
    counts: Dict[str, float] = {}
    payload: Dict[str, float] = {}
    whole = None if mesh is None else meta_model(cfg, dtype)  # outside the count
    before = [sharding.collective_counts(fn) for fn in (True, False)] + [
        sharding.collective_bytes(fn) for fn in (True, False)]
    stages_before = sharding.collective_stages()
    with attention_boundaries(mode), mode:
        model = meta_model(cfg, dtype) if mesh is None else tensor.shard_params(whole, mesh)
        del whole
        inputs = meta_inputs(cell.inputs)
        opt_bytes = cache_bytes = 0
        if train:
            from ..models import trainable
            from ..training import init_state, named_parameters

            named = named_parameters(trainable(model))
            opt = init_state(model, cfg, mesh)
            opt_bytes = _nbytes((opt.m, opt.v))
            mode.reset_counts()
            held = mode.live
            _, _, metrics = cell.fn(model, opt, inputs)
            param_bytes = _nbytes(named)
            # the optimizer's pass: parameters read and written, the
            # gradient read (in the parameters' dtype at accum 1), the
            # float32 moments read and written
            grad_bytes = param_bytes if accum == 1 else opt_bytes // 2
            function_bytes = 2 * param_bytes + grad_bytes + 2 * opt_bytes
            if world > 1:
                n, pay = dp_gather_payload(named, world, accum)
                counts, payload = {"all-gather": n}, {"all-gather": pay}
            del metrics, opt
        elif shape.kind == "prefill":
            mode.reset_counts()
            held = mode.live
            with torch.no_grad():
                out = cell.fn(model, inputs)
            param_bytes = _nbytes(list(model.parameters()))
            cache_bytes = _nbytes(out[1])
            function_bytes = serve_bytes(cfg, model, mode, inputs, out)
            del out
        else:
            cache = inputs.pop("cache")
            cache_bytes = _nbytes(cache)
            inputs["pos"] = shape.seq_len - 1
            mode.reset_counts()
            held = mode.live
            with torch.no_grad():
                out = cell.fn(model, cache, inputs)
            param_bytes = _nbytes(list(model.parameters()))
            function_bytes = serve_bytes(cfg, model, mode, inputs, out, cache_bytes)
            del out, cache
        input_bytes = _nbytes(inputs)
    executed = counts, payload
    stages: Dict[str, float] = {}
    if mesh is not None:
        for name, (n, nbytes) in sharding.collective_stages().items():
            n0, b0 = stages_before.get(name, (0, 0.0))
            if n > n0:
                stages.update({f"{name}.count": float(n - n0), f"{name}.bytes": nbytes - b0})
        after = [sharding.collective_counts(fn) for fn in (True, False)] + [
            sharding.collective_bytes(fn) for fn in (True, False)]
        counts, executed_counts, payload, executed_payload = (
            {k: float(v - b[k]) for k, v in a.items() if v > b[k]}
            for a, b in zip(after, before))
        executed = executed_counts, executed_payload
    return CellTrace(
        function_flops=dict(mode.function_flops), function_bytes=float(function_bytes),
        executed_flops=float(sum(mode.executed_flops.values())),
        executed_bytes=float(mode.executed_bytes), peak_bytes=float(mode.peak),
        temp_bytes=float(mode.peak - held),
        param_bytes=float(param_bytes), opt_bytes=float(opt_bytes),
        cache_bytes=float(cache_bytes), input_bytes=float(input_bytes),
        collective_counts=counts, collective_payload=payload,
        executed_collective_counts=executed[0], executed_collective_payload=executed[1],
        executed_collective_stages=stages)


# ------------------------------------------------------ depth calibration --


def _calib_depths(cfg: ArchConfig) -> Tuple[int, int]:
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return k, 2 * k  # one vs two shared-attn applications
    if cfg.family == "ssm" and cfg.slstm_every:
        return 2, 4  # one vs two (mLSTM, sLSTM) pairs
    return 2, 4


def _reduced(cfg: ArchConfig, L: int) -> ArchConfig:
    r = dataclasses.replace(cfg, n_layers=L, unroll_layers=True)
    if cfg.family == "encdec":
        r = dataclasses.replace(r, enc_layers=L)
    return r


def _depth_units(cfg: ArchConfig) -> int:
    """How many calibration units the full config has (== n_layers; whisper's
    enc depth co-scales so n_layers is still the unit count)."""
    return cfg.n_layers


@dataclasses.dataclass
class CalibratedCost:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    collective_counts: Dict[str, float]
    raw: Dict[str, Any]
    trace: CellTrace = None

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.pop("trace")
        return d


def calibrated_cost(cfg: ArchConfig, shape: ShapeConfig, mesh=None, **kw) -> CalibratedCost:
    """Trace the cell at two reduced depths and extrapolate every count
    linearly to the full depth.  ``kw`` goes to :func:`trace_cell`
    (``batch``, ``world``, ``accum``, ``fused_loss``); ``mesh`` with a model
    axis above 1 traces one tensor-parallel rank (see :func:`trace_cell`),
    else it is unused (the trace is one data-parallel rank's, at ``batch``)."""
    from ..parallel.tensor import model_size
    from .roofline import collective_stats

    if mesh is not None and model_size(mesh) > 1:
        kw["mesh"] = mesh
    l1, l2 = _calib_depths(cfg)
    f1 = trace_cell(_reduced(cfg, l1), shape, **kw).scalars()
    f2 = trace_cell(_reduced(cfg, l2), shape, **kw).scalars()
    L = _depth_units(cfg)

    def extrap(a, b):
        per = (b - a) / (l2 - l1)
        return a + per * (L - l1)

    full = CellTrace.from_scalars({k: extrap(f1.get(k, 0.0), f2.get(k, 0.0))
                                   for k in set(f1) | set(f2)})
    coll = collective_stats(full.collective_counts, full.collective_payload)
    return CalibratedCost(
        flops=full.flops,
        hbm_bytes=full.function_bytes,
        wire_bytes=coll.wire_bytes,
        collective_counts=coll.counts,
        raw={"depths": [l1, l2], "flops": [f1["executed_flops"], f2["executed_flops"]],
             "function_flops": [sum(v for k, v in f.items() if k.startswith("function_flops."))
                                for f in (f1, f2)],
             "hbm": [f1["function_bytes"], f2["function_bytes"]],
             "peak": [f1["peak_bytes"], f2["peak_bytes"]]},
        trace=full)
