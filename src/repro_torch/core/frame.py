"""SeriesFrame and FrameSession -- the lazy front doors to every read path
(port of `repro.core.frame`: the array, chunk and sharded placements, the
engine mode and the multi-tenant session).

A :class:`SeriesFrame` holds a data placement (a materialized array, a
stream of chunks, or the overlapping blocks of a `TimeSeriesStore`) plus
deferred estimator requests.  ``.autocovariance``, ``.yule_walker``,
``.arma``, ``.moments``, ``.welch``, ``.forecast``, ``.anomaly_scores`` and
``.map_reduce`` each return a :class:`Deferred` handle and read nothing;
``.collect()`` compiles everything pending into ONE fused `StatPlan` and
walks the data once; ``.append(chunk)`` folds new samples into the carried
state, so a re-collect costs one walk of the new samples only.  Results are memoized
until the next append.

The sharded placement is the paper's overlapping block store, on one
device or on a mesh (`repro_torch.parallel`).  Built from a raw series, the
store is placed at the first ``collect()``, when the plan knows its widest
window, so the halo is exactly ``W_fused - 1``.  A collect then runs each
plan group's chunk kernel ONCE on the whole (P, B + carry, d) block stack
(one megakernel launch for every block on the card), with a (P, B) start
mask and each block's global start as a (P,) offset, and sums the
per-block partials over the block axis in a fixed order (``torch.sum``, no
atomics).  On a mesh each rank does so over its own blocks, and the sums,
the sample sum and the carried head and tail ride ONE `psum_tree`.  Appends
scatter into a one-device store in place (a mesh frame keeps them for
replans) and fold into the carried state.

The engine mode (:meth:`SeriesFrame.from_engine`) carries one
`StreamingEngine`'s state: the core that `repro_torch.timeseries.
StreamingEstimator` is a shim over.

A :class:`FrameSession` serves the same requests for many users at once:
one plan compiled at the first ingest, one stacked per-user state in a
`repro_torch.serving.rolling.RollingStatsService` per plan group, every
arrival batch ingested by one batched update (one megakernel launch for the
chunks and one for the merge boundary, whatever the number of users), and a
batched query finalized by `StatPlan.finalize_batch`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .backend import BackendSpec, get_backend, resolve_device
from .plan import (StatPlan, StatRequest, anomaly_request, arma_request,
                   autocovariance_request, forecast_request, kernel_request, moments_request,
                   welch_request, yule_walker_request)
from .mapreduce import tree_map
from .streaming import _FIELDS, PartialState, StreamingEngine, state_from_numpy, state_to_numpy

__all__ = ["SeriesFrame", "FrameSession", "Deferred", "as_series", "session_state_from_numpy",
           "session_state_to_numpy"]


def as_series(x, device="cuda") -> torch.Tensor:
    """(n,) or (n, d) data -- numpy, list or tensor -- as an (n, d) float32
    tensor on ``device`` (float64 input narrows, as in the reference)."""
    dev = resolve_device(device)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(device=dev, dtype=torch.float32)
    return t[:, None] if t.ndim == 1 else t


@dataclasses.dataclass(frozen=True, eq=False)
class Deferred:
    """Handle to one pending request of a frame; ``result()`` triggers the
    frame's (memoized) ``collect()``."""

    frame: "SeriesFrame"
    name: str

    def result(self) -> Any:
        return self.frame.collect()[self.name]


class _DeferredRequests:
    """The deferred-request surface: each method records one request."""

    def _defer(self, req: StatRequest):
        raise NotImplementedError

    def _unique_name(self, base: str) -> str:
        counts = self._name_counts
        counts[base] = counts.get(base, 0) + 1
        return base if counts[base] == 1 else f"{base}_{counts[base]}"

    def autocovariance(self, max_lag: int, normalization: str = "paper",
                       name: Optional[str] = None):
        """Defer gamma(0..max_lag)."""
        return self._defer(autocovariance_request(max_lag, normalization, name))

    def yule_walker(self, p: int, normalization: str = "standard", name: Optional[str] = None):
        """Defer an order-p AR fit (A, Sigma)."""
        return self._defer(yule_walker_request(p, normalization, name))

    def arma(self, p: int, q: int, m: Optional[int] = None, name: Optional[str] = None):
        """Defer an ARMA(p, q) fit (A, B, Sigma)."""
        return self._defer(arma_request(p, q, m, name))

    def moments(self, window: int, name: Optional[str] = None):
        """Defer aggregate windowed moments {"mean", "var", "count"}."""
        return self._defer(moments_request(window, name))

    def welch(self, nperseg: int = 256, overlap: Optional[int] = None, fs: float = 1.0,
              name: Optional[str] = None):
        """Defer a Welch PSD (freqs, psd)."""
        return self._defer(welch_request(nperseg, overlap, fs, name))

    def forecast(self, horizon: int, model: str = "ar", p: int = 4, q: int = 1,
                 m: Optional[int] = None, max_period: Optional[int] = None,
                 name: Optional[str] = None):
        """Defer a multi-horizon forecast from the plan's carried lag state:
        ``{"pred": (horizon, d), "sigma": (d, d)}`` (plus ``"period"`` for
        ``model="auto"``, which also needs a deferred ``.welch(...)``).  See
        `repro_torch.core.forecast.forecast_request`."""
        return self._defer(forecast_request(horizon, model, p, q, m, max_period, name))

    def anomaly_scores(self, model: str = "ar", p: int = 4, q: int = 1,
                       m: Optional[int] = None, max_period: Optional[int] = None,
                       name: Optional[str] = None):
        """Defer standardized innovation residuals over the carried tail
        (per-channel ``z``, a Mahalanobis ``score``, a ``valid`` mask).  See
        `repro_torch.core.forecast.anomaly_request`."""
        return self._defer(anomaly_request(model, p, q, m, max_period, name))

    def map_reduce(self, chunk_kernel: Callable, h_right: int, h_left: int = 0,
                   stride: int = 1, takes_offset: bool = False,
                   finalizer: Optional[Callable] = None, name: str = "map_reduce"):
        """Defer a generic weak-memory member (see `plan.kernel_request`)."""
        return self._defer(kernel_request(name, chunk_kernel, h_right, h_left, stride,
                                          takes_offset, finalizer))


class SeriesFrame(_DeferredRequests):
    """Lazy session over one series: defer, collect, append.

    Build with :meth:`from_array`, :meth:`from_chunks`, :meth:`from_sharded`
    (or :meth:`from_engine` for the raw-engine mode).
    """

    def __init__(self, placement: str, d: Optional[int], backend: BackendSpec, device):
        self._placement = placement
        self._device = resolve_device(device)
        self._d = d
        self._backend = get_backend(backend, self._device)
        self._recorded: list = []
        self._name_counts: dict = {}
        self._new_requests = False
        self._plan: Optional[StatPlan] = None
        self._states: Optional[tuple] = None
        self._results: Optional[dict] = None
        self._x: Optional[torch.Tensor] = None  # array placement
        self._appended: list = []               # array appends (concatenated lazily)
        self._chunk_source = None               # chunks: (undrained source, chunk_size)
        self._chunk_list: Optional[list] = None  # chunks: drained, not yet folded
        self._store = None                      # sharded: TimeSeriesStore
        self._mesh = None                       # sharded: the DeviceMesh, or None
        self._axis = "data"
        self._block_size = 8192
        self._store_owned = False               # the frame built the store
        self._pending: list = []                # sharded appends kept for replans
        self._replayable = True
        self._n = 0

    # ------------------------------------------------------------ builders
    @classmethod
    def from_array(cls, x, backend: BackendSpec = None, device="cuda") -> "SeriesFrame":
        """Frame over a fully materialized (n,) or (n, d) series: collect is
        one traversal of the whole array, and new requests after a collect
        replan over the retained array."""
        x = as_series(x, device)
        frame = cls("array", x.shape[1], backend, device)
        frame._x = x
        frame._n = x.shape[0]
        return frame

    @classmethod
    def from_chunks(cls, chunks, backend: BackendSpec = None, chunk_size: int = 4096,
                    device="cuda") -> "SeriesFrame":
        """Frame over an iterable of time-ordered (c, d) chunks, or a
        `TimeSeriesStore` streamed through ``iter_chunks(chunk_size)``.
        Nothing is read until ``collect()``, which folds the chunks one
        update each and then drops them (weak memory): declare every request
        up front."""
        frame = cls("chunks", None, backend, device)
        frame._chunk_source = (chunks, chunk_size)
        return frame

    @classmethod
    def from_sharded(cls, data, mesh=None, axis: str = "data", block_size: int = 8192,
                     backend: BackendSpec = None, device="cuda") -> "SeriesFrame":
        """Frame over the overlapping blocks of a series (paper §10).

        ``data`` is a raw series -- placed at the first ``collect()`` with
        blocks of ``block_size`` rows and the plan's exact halo -- or a
        `TimeSeriesStore` on ``device`` (``h_left`` 0, ``h_right`` covering
        the plan's widest window).  A collect is one chunk-kernel call per
        plan group over every block at once, and one sum over the blocks.
        With a ``mesh`` (a raw series: every rank passes the whole series
        and the same appends) or a mesh store, each rank walks its own
        blocks and the partials merge in one `psum_tree`; ``device`` must
        name the mesh's device type.  A one-device store with a mesh, or a
        store on another mesh, raises.
        """
        frame = cls("sharded", None, backend, device)
        is_store = hasattr(data, "spec") and hasattr(data, "blocks")  # TimeSeriesStore
        if is_store and mesh is not None and data.mesh is not mesh:
            raise ValueError("the store is not placed on the frame's mesh; build it with "
                             "TimeSeriesStore.from_series(..., mesh=mesh) or pass no mesh")
        mesh = data.mesh if is_store else mesh
        if mesh is not None:
            from ..parallel.sharding import mesh_device

            if frame._device.type != mesh.device_type:
                raise ValueError(f"the mesh lies on {mesh.device_type}, the frame computes on "
                                 f"{frame._device}; pass device={mesh.device_type!r}")
            frame._device = mesh_device(mesh)
            frame._mesh, frame._axis = mesh, data.axis if is_store else axis
        if is_store:
            blocks = data.blocks if mesh is None else data.blocks.to_local()
            if blocks.device != frame._device:
                raise ValueError(f"the store lies on {blocks.device}, the frame computes "
                                 f"on {frame._device}; pass device={str(blocks.device)!r}")
            frame._store = data
            frame._d = data.blocks.shape[-1]
            frame._n = data.spec.n
        else:
            x = as_series(data, device)
            frame._x = x
            frame._d = x.shape[1]
            frame._n = x.shape[0]
            frame._block_size = block_size
        return frame

    @classmethod
    def from_engine(cls, engine: StreamingEngine, batch: Optional[int] = None,
                    t0=0) -> "SeriesFrame":
        """Raw-engine mode: the frame carries ONE engine's `PartialState`
        (``batch`` independent series with a leading axis on every leaf when
        given) and offers update (``append``), ``consume``, ``merge_state``
        and :meth:`finalize_with`."""
        frame = cls("engine", engine.d, engine.backend, engine.device)
        frame._engine = engine
        frame._batch = batch
        if batch is None:
            frame._e_state = engine.init(t0)
            frame._e_update, frame._e_merge = engine.update, engine.merge
            frame._e_consume = engine.consume
        else:
            frame._e_state = engine.init_batch(batch, t0)
            frame._e_update, frame._e_merge = engine.update_batch, engine.merge_batch
            frame._e_consume = engine.consume_batch
        return frame

    # ------------------------------------------------------- request intake
    def _defer(self, req: StatRequest) -> Deferred:
        if self._placement == "engine":
            raise ValueError("engine-mode frames carry a raw StreamingEngine state; deferred "
                             "requests need a data placement (from_array / from_chunks / "
                             "from_sharded)")
        if not isinstance(req, StatRequest):
            raise TypeError(f"requests must be StatRequest (see the *_request "
                            f"factories), got {type(req).__name__}")
        name = self._unique_name(req.name or req.default_name())
        self._recorded.append(dataclasses.replace(req, name=name))
        self._new_requests = True
        return Deferred(self, name)

    # -------------------------------------------------------------- collect
    def collect(self) -> dict:
        """Run (or read back) every deferred request: ``{name: result}``."""
        if self._placement == "engine":
            raise ValueError("engine-mode frames finalize with finalize_with()")
        if not self._recorded:
            raise ValueError("nothing to collect -- defer at least one request first "
                             "(.autocovariance / .yule_walker / .arma / .moments / "
                             ".welch / .forecast / .anomaly_scores / .map_reduce)")
        if self._plan is not None and not self._new_requests:
            if self._results is None:
                self._results = self._plan.finalize(self._states)
            return dict(self._results)
        if self._plan is not None and not self._replayable:
            raise ValueError("new requests after the first collect need the history, but "
                             "this placement discarded it (weak memory); declare every "
                             "request before collecting, or build with from_array")
        plan = StatPlan(list(self._recorded), d=self._require_d(), backend=self._backend,
                        device=self._device)
        self._states = self._traverse(plan)
        self._plan = plan
        self._new_requests = False
        self._results = plan.finalize(self._states)
        return dict(self._results)

    @property
    def num_traversals(self) -> int:
        """Traversal groups one evaluation costs (1 unless non-offset-aware
        strided generic kernels force grouped sub-plans)."""
        if self._plan is None:
            return StatPlan(list(self._recorded), d=self._require_d(), backend=self._backend,
                            device=self._device).num_traversals
        return self._plan.num_traversals

    # --------------------------------------------------------------- append
    def append(self, chunk) -> "SeriesFrame":
        """Absorb new samples at the end of the series.  With a compiled
        plan the chunk folds into the carried state (history is never
        re-read); the memoized results are invalidated.  A frame-built
        store takes the rows in place (`TimeSeriesStore.append_rows`), so
        a replan re-reads the whole series; other sharded frames keep the
        chunk for replans.  Engine mode: one engine update."""
        if self._placement == "engine":
            chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self._device)
            self._e_state = self._e_update(self._e_state, chunk)
            return self
        chunk = as_series(chunk, self._device)
        if self._d is not None and chunk.shape[1] != self._d:
            raise ValueError(f"chunk has d={chunk.shape[1]}, frame has d={self._d}")
        self._results = None
        if self._placement == "array":
            self._appended.append(chunk)
        elif self._placement == "chunks":
            if self._plan is None:
                self._tail_chunks().append(chunk)
        elif self._can_scatter_append():
            self._store.append_rows(chunk)
        else:  # sharded before the first collect, or a caller's store
            self._pending.append(chunk)
        if self._plan is not None:
            self._states = self._plan.update_donated(self._states, chunk)
        self._n += chunk.shape[0]
        return self

    def _can_scatter_append(self) -> bool:
        """Sharded appends scatter into the store when the frame built it on
        one device (replicate mode, causal halos: the `append_rows`
        contract); a caller's store is not mutated, and a mesh store would
        need a re-sharding per growth step."""
        return (self._store is not None and self._store_owned and self._store.mesh is None
                and self._store.halo_mode == "replicate" and self._store.spec.h_left == 0)

    @property
    def length(self):
        """Samples ingested so far (engine mode: the carried state's
        length, per series when batched)."""
        if self._placement == "engine":
            return self._e_state.length
        return self._n

    @property
    def backend(self):
        return self._backend

    # ----------------------------------------------------- engine-mode API
    @property
    def state(self) -> PartialState:
        """The carried PartialState (engine mode)."""
        self._require_engine()
        return self._e_state

    @state.setter
    def state(self, value: PartialState) -> None:
        self._require_engine()
        self._e_state = value

    def consume(self, chunk_stack) -> "SeriesFrame":
        """Fold a (k, c, d) stack of chunks -- (k, batch, c, d) when batched
        -- one update each (engine mode)."""
        self._require_engine()
        stack = torch.as_tensor(chunk_stack, dtype=torch.float32, device=self._device)
        self._e_state = self._e_consume(self._e_state, stack)
        return self

    def merge_state(self, other: PartialState) -> "SeriesFrame":
        """Merge a peer's PartialState into this frame's (engine mode)."""
        self._require_engine()
        self._e_state = self._e_merge(self._e_state, other)
        return self

    def finalize_with(self, finalizer: Callable, *args, **kwargs) -> Any:
        """``finalizer(engine, state, *args, **kwargs)`` on the carried state
        (engine mode).  Batched frames map it over the series axis: one
        ``torch.func.vmap`` where the finalizer allows it, else one call per
        series (a kernel launch, for one, needs real storage), the results
        stacked."""
        self._require_engine()
        engine, state = self._engine, self._e_state
        if self._batch is None:
            return finalizer(engine, state, *args, **kwargs)
        leaves = state.flatten()

        def one(*series_leaves):
            return finalizer(engine, state.unflatten(series_leaves), *args, **kwargs)

        try:
            return torch.func.vmap(one)(*leaves)
        except (RuntimeError, ValueError):
            outs = [one(*(leaf[i] for leaf in leaves)) for i in range(self._batch)]
            return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])

    def _require_engine(self):
        if self._placement != "engine":
            raise ValueError("this frame is not in engine mode (from_engine)")

    # ------------------------------------------------------------ internals
    def _require_d(self) -> int:
        if self._d is None:
            self._drain_chunks()
        if self._d is None:
            raise ValueError("cannot infer the series dimension from an empty chunk "
                             "source; ingest at least one chunk")
        return self._d

    def _tail_chunks(self) -> list:
        if self._chunk_list is None:
            self._chunk_list = []
        return self._chunk_list

    def _drain_chunks(self) -> list:
        """Materialize the chunk source exactly once."""
        if self._chunk_source is not None:
            source, chunk_size = self._chunk_source
            if hasattr(source, "iter_chunks"):  # TimeSeriesStore
                source = source.iter_chunks(chunk_size)
            drained = [as_series(c, self._device) for c in source]
            self._chunk_list = drained + (self._chunk_list or [])
            self._chunk_source = None
            self._n += sum(c.shape[0] for c in drained)
            if self._chunk_list:
                self._d = self._chunk_list[0].shape[1]
        return self._chunk_list or []

    def _traverse(self, plan: StatPlan) -> tuple:
        if self._placement == "array":
            if self._appended:
                self._x = torch.cat([self._x] + self._appended)
                self._appended = []
            return plan.from_chunk(self._x)
        if self._placement == "sharded":
            return self._traverse_sharded(plan)
        chunks = [c for c in self._drain_chunks() if c.shape[0] > 0]
        states = plan.consume(plan.init(), chunks)
        self._chunk_list = []  # weak memory: the raw chunks are gone once folded
        self._replayable = False
        return states

    # -- sharded placement -------------------------------------------------
    def _ensure_store(self, plan: StatPlan):
        from ..timeseries.dataset import TimeSeriesStore

        carry_max = max(g.engine.carry for g in plan.groups)
        if self._store is not None:
            spec = self._store.spec
            if spec.h_left != 0 or spec.h_right < carry_max:
                if not self._store_owned:
                    raise ValueError(
                        f"the supplied store's halo (h_left={spec.h_left}, "
                        f"h_right={spec.h_right}) cannot serve the plan's widest window "
                        f"({carry_max + 1}); rebuild it with h_left=0, h_right>={carry_max}")
                # a frame-built store of an earlier, narrower plan: re-place it
                # with the exact halo (a replan is a full traversal anyway)
                self._x = self._store.to_series()
                self._store = None
        if self._store is None:
            self._store = TimeSeriesStore.from_series(
                self._x, block_size=min(self._block_size, max(self._x.shape[0], 1)),
                h_left=0, h_right=carry_max, mesh=self._mesh, axis=self._axis,
                device=self._device)
            self._store_owned = True
            self._x = None  # the store owns the data now
        return self._store

    def _traverse_sharded(self, plan: StatPlan) -> tuple:
        """Every plan group's chunk kernel ONCE over the whole block stack:
        y (P, B + carry, d) -- the blocks themselves when the group's carry
        is the store's halo, else a narrower slice (a copy) --, the (P, B)
        mask of the starts whose full group window lies in the series (and
        on the group's stride), and z0 = block id * B as a (P,) int32
        tensor; the per-block partials are then summed over the block axis
        in a fixed order.  On a mesh P is the rank's own blocks (global ids
        from its offset), and the sums, the sample sum and the rank's rows of
        the series' edges ride one `psum_tree`.  The carried head and tail
        come from the block cores; appends kept before the store existed
        (or, on a mesh, since) fold in afterwards."""
        store = self._ensure_store(plan)
        spec = store.spec
        B, n, P = spec.block_size, spec.n, spec.num_blocks
        if store.mesh is None:
            blocks, offset = store.padded_blocks_single_host(), 0
        else:
            from ..parallel.sharding import mesh_rank

            local = store.blocks.to_local()
            blocks = store.padded_blocks_local(local)
            offset = mesh_rank(store.mesh, store.axis) * local.shape[0]
        dev, p_local = blocks.device, blocks.shape[0]
        bid = offset + torch.arange(p_local, device=dev, dtype=torch.int32)
        starts = bid.long()[:, None] * B + torch.arange(B, device=dev)
        z0 = bid * B
        stats = []
        for g in plan.groups:
            mask = starts + g.engine.window <= n
            if g.stride > 1:
                mask = mask & (torch.remainder(starts, g.stride) == 0)
            carry = g.engine.carry
            y = blocks if carry == spec.h_right else blocks[:, : B + carry].contiguous()
            partials = g.engine._call_kernel(y, mask, z0)
            stats.append(tree_map(lambda leaf: leaf.sum(0), partials))
        # slots past the series end hold zeros, but only the last block's
        # valid core rows are summed there (on the rank that owns it)
        last = P - 1 - offset
        if last < p_local:
            sample_sum = blocks[:last, :B].sum(1).sum(0) + blocks[last, : n - (P - 1) * B].sum(0)
        else:
            sample_sum = blocks[:, :B].sum(1).sum(0)

        carry_max = max(g.engine.carry for g in plan.groups)
        if store.mesh is None:
            head_full, tail_full = self._series_edges(store, carry_max)
        else:
            from ..parallel.sharding import gather_tree, sum_ranks

            # the edge rows: each rank gives the ones it owns (zeros
            # elsewhere), and each is then picked from its owner's copy,
            # never summed; an off-series row is rank 0's zeros
            ids = np.concatenate([np.arange(carry_max), n - carry_max + np.arange(carry_max)])
            valid = (ids >= 0) & (ids < n)
            ids = np.where(valid, ids, 0)
            owner = (ids // B) // p_local
            mine = valid & (ids // B - offset >= 0) & (ids // B - offset < p_local)
            mine_t = torch.from_numpy(mine).to(dev)
            rows = local[torch.from_numpy(np.where(mine, ids // B - offset, 0)).to(dev),
                         torch.from_numpy(ids % B).to(dev)]
            edges = torch.where(mine_t[:, None], rows, 0.0)
            stats, sample_sum, edges = gather_tree((stats, sample_sum, edges), store.mesh,
                                                   store.axis)
            stats = tree_map(sum_ranks, stats)
            sample_sum = sum_ranks(sample_sum)
            picked = edges[torch.from_numpy(owner).to(dev), torch.arange(len(ids), device=dev)]
            head_full, tail_full = picked[:carry_max], picked[carry_max:]
        # each group's state owns its buffers (an in-place update of one
        # group must not reach another's)
        own = (lambda t: t) if len(plan.groups) == 1 else torch.clone
        states = []
        for g, stat in zip(plan.groups, stats):
            c = g.engine.carry
            states.append(PartialState(
                stat=stat, sample_sum=own(sample_sum), head=own(head_full[:c]),
                tail=own(tail_full[carry_max - c:]),
                length=torch.tensor(n, dtype=torch.int32, device=dev),
                t0=torch.zeros((), dtype=torch.int32, device=dev),
                stat_err=(tree_map(torch.zeros_like, stat) if g.engine.compensated else None)))
        states = tuple(states)
        for chunk in self._pending:
            states = plan.update(states, chunk)
        if self._pending and self._can_scatter_append():
            # appends kept before the store existed move into it now
            for chunk in self._pending:
                self._store.append_rows(chunk)
            self._pending = []
        return states

    def _series_edges(self, store, carry_max: int) -> tuple:
        """The first and last ``carry_max`` samples of the stored series,
        gathered from the block cores (indices from the host): head
        left-aligned, tail right-aligned, zero where off the series -- the
        `PartialState` halo contract."""
        spec = store.spec
        n, B = spec.n, spec.block_size
        d, dev = store.blocks.shape[-1], store.blocks.device
        rows = np.arange(carry_max)

        def gather(idx):
            ok = (idx >= 0) & (idx < n)
            i = np.clip(idx, 0, n - 1)
            got = store.blocks[torch.from_numpy(i // B).to(dev), torch.from_numpy(i % B).to(dev)]
            return torch.where(torch.from_numpy(ok).to(dev)[:, None], got, 0.0)

        if carry_max == 0:
            empty = torch.zeros((0, d), device=dev)
            return empty, empty
        return gather(rows), gather(n - carry_max + rows)


class FrameSession(_DeferredRequests):
    """Multi-tenant deferred statistics: one fused plan, millions of users.

    The deferred requests compile into ONE `StatPlan` at the first ingest;
    each plan group's per-user states live stacked in a
    `RollingStatsService`.  Every user's statistics ride one batched update
    per arrival batch, and a batched query is a gather, a fold of the lanes
    and one batched finalize.  Per-user results equal a dedicated per-user
    :class:`SeriesFrame` to float round-off.

    Args:
      d: series dimension.
      num_users: number of user series served.
      requests: optional `StatRequest` list; the deferred-request methods
        (``.autocovariance(...)`` etc.) also work until the first ingest.
      num_shards: independent ingest lanes (growing mode only).
      window / num_buckets: sliding-window eviction mode (see
        `RollingStatsService`); queries cover the retained horizon.
      backend: compute backend of every traversal ("cuda" by default).
      compensated: carry Neumaier error companions through every fold
        (snapshots then restore only into a compensated session).
      device: where the states live ("cuda" unless the CPU is asked for).
    """

    def __init__(self, d: int, num_users: int, requests: Optional[Sequence[StatRequest]] = None,
                 num_shards: int = 1, window: Optional[int] = None,
                 num_buckets: Optional[int] = None, backend: BackendSpec = None,
                 compensated: bool = False, device="cuda"):
        self.d = d
        self.num_users = num_users
        self.num_shards = num_shards
        self.window = window
        self._num_buckets = num_buckets
        self._device = resolve_device(device)
        self._backend = get_backend(backend, self._device)
        self.compensated = compensated
        self._recorded: list = []
        self._name_counts: dict = {}
        self._plan: Optional[StatPlan] = None
        self._services: Optional[list] = None
        for req in requests or []:
            self._defer(req)

    def _defer(self, req: StatRequest) -> str:
        if self._plan is not None:
            raise ValueError("the session's fused plan is compiled at the first ingest; "
                             "declare every request before ingesting")
        if not isinstance(req, StatRequest):
            raise TypeError(f"requests must be StatRequest (see the *_request "
                            f"factories), got {type(req).__name__}")
        name = self._unique_name(req.name or req.default_name())
        self._recorded.append(dataclasses.replace(req, name=name))
        return name

    @property
    def plan(self) -> StatPlan:
        self._ensure_plan()
        return self._plan

    @property
    def request_names(self) -> tuple:
        """Names of every deferred request, in declaration order (the keys of
        ``query`` / ``query_batch`` results)."""
        return tuple(r.name for r in self._recorded)

    def _ensure_plan(self):
        if self._plan is not None:
            return
        if not self._recorded:
            raise ValueError("a session needs at least one deferred request")
        from ..serving.rolling import RollingStatsService

        self._plan = StatPlan(list(self._recorded), d=self.d, backend=self._backend,
                              compensated=self.compensated, device=self._device)
        self._services = [RollingStatsService(g.engine, self.num_users,
                                              num_shards=self.num_shards, window=self.window,
                                              num_buckets=self._num_buckets)
                          for g in self._plan.groups]

    def _check_groups(self, state: dict, what: str) -> None:
        keys = {f"group_{i}" for i in range(len(self._services))}
        if set(state) != keys:
            raise ValueError(f"{what} has groups {sorted(state)} but this session's plan "
                             f"compiled {sorted(keys)}; the deferred requests must match "
                             f"the exporter's")

    # -- write path -----------------------------------------------------------
    def ingest(self, user_ids, chunks, shard: int = 0, t0=None) -> None:
        """Absorb one arrival batch: ``chunks[i]`` ((k, c, d)) extends user
        ``user_ids[i]``'s series (see `RollingStatsService.ingest`).  Built-in
        requests compile to one plan group: one batched update, two
        megakernel launches on the card, however many users and
        statistics."""
        self._ensure_plan()
        chunks = torch.as_tensor(chunks, dtype=torch.float32, device=self._device)
        for svc in self._services:
            svc.ingest(user_ids, chunks, shard=shard, t0=t0)

    # -- read path ------------------------------------------------------------
    def query(self, user_id: int) -> dict:
        """Every deferred statistic of one user, ``{request_name: result}``,
        equal to a dedicated per-user SeriesFrame's ``collect()``."""
        self._ensure_plan()
        states = tuple(svc.partial(user_id) for svc in self._services)
        return self._plan.finalize(states, cache=False)

    def partials_batch(self, user_ids) -> tuple:
        """Per plan group, the merged `PartialState` of every user in
        ``user_ids`` (one gather and lane fold per group), each leaf with a
        leading ``len(user_ids)`` axis: what :meth:`query_batch` finalizes."""
        self._ensure_plan()
        return tuple(svc.partials_batch(user_ids) for svc in self._services)

    def query_batch(self, user_ids) -> dict:
        """Many users at once: one gather and lane fold per plan group, then
        ONE batched finalize (each tail correction one kernel launch for all
        of them); every result has a leading ``len(user_ids)`` axis."""
        merged = self.partials_batch(user_ids)
        return self._plan.finalize_batch(merged)

    # -- durability -----------------------------------------------------------
    def export_state(self) -> dict:
        """Host snapshot of everything the session serves from: per plan
        group, the stacked lanes (CPU copies) and the eviction cursor.
        :meth:`import_state` on a fresh session with the same requests and
        config then answers bit for bit as this one did."""
        self._ensure_plan()
        return {f"group_{i}": svc.export_state() for i, svc in enumerate(self._services)}

    def import_state(self, state: dict) -> None:
        """Install an :meth:`export_state` snapshot (same requests, same
        num_users / num_shards / window / compensated config); a reference
        snapshot goes through :func:`session_state_from_numpy` first."""
        self._ensure_plan()
        self._check_groups(state, "snapshot")
        for i, svc in enumerate(self._services):
            svc.import_state(state[f"group_{i}"])

    def state_template(self) -> dict:
        """The live state with :meth:`export_state`'s structure, without a
        device-to-host copy."""
        self._ensure_plan()
        return {f"group_{i}": svc.state_template() for i, svc in enumerate(self._services)}

    def tenant_axes(self) -> dict:
        """Flat checkpoint key -> tenant axis of every leaf of
        :meth:`export_state`, keyed as the reference's checkpoints key them:
        lane leaves carry tenants on axis 1, the cursors on axis 0."""
        from ..serving.rolling import state_paths

        self._ensure_plan()
        axes = {}
        for i, svc in enumerate(self._services):
            axes[f"group_{i}/counts"] = 0
            axes.update(dict.fromkeys(state_paths(svc.state_template()["lanes"],
                                                  f"group_{i}/lanes"), 1))
        return axes

    # -- integrity ------------------------------------------------------------
    def audit(self) -> np.ndarray:
        """Finite-sweep every tenant's lanes on the device (one host copy per
        plan group): a host (num_users,) bool, True where every lane of
        every group is healthy."""
        self._ensure_plan()
        healthy = None
        for svc in self._services:
            h = svc.audit()
            healthy = h if healthy is None else healthy & h
        return healthy

    @property
    def lane_health(self) -> np.ndarray:
        """(num_lanes, num_users) health mask of the last :meth:`audit`,
        True where that lane is healthy in every plan group (all True
        before an audit, and for a tenant or state imported since)."""
        self._ensure_plan()
        mask = self._services[0].lane_health
        for svc in self._services[1:]:
            mask &= svc.lane_health
        return mask

    def export_tenant(self, user_id: int) -> dict:
        """Host snapshot of ONE tenant's slice of every group's state."""
        self._ensure_plan()
        return {f"group_{i}": svc.export_tenant(user_id) for i, svc in enumerate(self._services)}

    def import_tenant(self, user_id: int, state: dict) -> None:
        """Restore ONE tenant's lanes from :meth:`export_tenant` (or
        :meth:`tenant_slice`), leaving every other tenant untouched."""
        self._ensure_plan()
        self._check_groups(state, "tenant snapshot")
        for i, svc in enumerate(self._services):
            svc.import_tenant(user_id, state[f"group_{i}"])

    def tenant_slice(self, state: dict, user_id: int) -> dict:
        """ONE tenant's slice of a full :meth:`export_state` snapshot
        (host-side)."""
        self._ensure_plan()
        self._check_groups(state, "snapshot")
        return {f"group_{i}": svc.tenant_slice(state[f"group_{i}"], user_id)
                for i, svc in enumerate(self._services)}

    def lengths(self) -> torch.Tensor:
        """(num_users,) samples ingested per user (evicted ones too)."""
        self._ensure_plan()
        return self._services[0].lengths()

    def retained_lengths(self) -> torch.Tensor:
        """(num_users,) samples a query covers now (= ``lengths`` in growing
        mode; the ring-retained span in eviction mode)."""
        self._ensure_plan()
        return self._services[0].retained_lengths()


def session_state_from_numpy(snapshot: dict, device="cuda") -> dict:
    """A session snapshot of numpy leaves as the port's snapshot, on
    ``device``.  Takes the reference's ``FrameSession.export_state()`` after
    ``jax.device_get`` ({"group_i": {"lanes": PartialState of numpy arrays,
    "counts": ndarray}}) or :func:`session_state_to_numpy`'s output (lanes as
    a dict of fields); :meth:`FrameSession.import_state` then serves the
    exporter's tenants."""
    out = {}
    for group, entry in snapshot.items():
        lanes = entry["lanes"]
        fields = lanes if isinstance(lanes, dict) else {f: getattr(lanes, f) for f in _FIELDS}
        out[group] = {"lanes": state_from_numpy(fields, device),
                      "counts": np.asarray(entry["counts"]).astype(np.int64)}
    return out


def session_state_to_numpy(snapshot: dict) -> dict:
    """The port's session snapshot with numpy leaves: {"group_i": {"lanes":
    {field: arrays}, "counts": ndarray}} (the reference's field names)."""
    return {group: {"lanes": state_to_numpy(entry["lanes"]),
                    "counts": np.asarray(entry["counts"])}
            for group, entry in snapshot.items()}
