"""SeriesFrame and FrameSession -- the lazy front doors to every read path
(port of the array and chunk placements and of the multi-tenant session of
`repro.core.frame`).

A :class:`SeriesFrame` holds a data placement (a materialized array, or a
stream of chunks) plus deferred estimator requests.  ``.autocovariance``,
``.yule_walker``, ``.arma``, ``.moments``, ``.welch`` and ``.map_reduce``
each return a :class:`Deferred` handle and read nothing; ``.collect()``
compiles everything pending into ONE fused `StatPlan` and walks the data
once; ``.append(chunk)`` folds new samples into the carried state, so a
re-collect costs one walk of the new samples only.  Results are memoized
until the next append.

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
from .plan import (StatPlan, StatRequest, arma_request, autocovariance_request,
                   kernel_request, moments_request, welch_request, yule_walker_request)
from .streaming import _FIELDS, state_from_numpy, state_to_numpy

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

    def map_reduce(self, chunk_kernel: Callable, h_right: int, h_left: int = 0,
                   stride: int = 1, takes_offset: bool = False,
                   finalizer: Optional[Callable] = None, name: str = "map_reduce"):
        """Defer a generic weak-memory member (see `plan.kernel_request`)."""
        return self._defer(kernel_request(name, chunk_kernel, h_right, h_left, stride,
                                          takes_offset, finalizer))


class SeriesFrame(_DeferredRequests):
    """Lazy session over one series: defer, collect, append.

    Build with :meth:`from_array` or :meth:`from_chunks`.
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
        self._chunk_source = None               # chunks: undrained source
        self._chunk_list: Optional[list] = None  # chunks: drained, not yet folded
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
    def from_chunks(cls, chunks, backend: BackendSpec = None, device="cuda") -> "SeriesFrame":
        """Frame over an iterable of time-ordered (c, d) chunks.  Nothing is
        read until ``collect()``, which folds the chunks one update each and
        then drops them (weak memory): declare every request up front."""
        frame = cls("chunks", None, backend, device)
        frame._chunk_source = chunks
        return frame

    # ------------------------------------------------------- request intake
    def _defer(self, req: StatRequest) -> Deferred:
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
        if not self._recorded:
            raise ValueError("nothing to collect -- defer at least one request first "
                             "(.autocovariance / .yule_walker / .arma / .moments / "
                             ".welch / .map_reduce)")
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

    # --------------------------------------------------------------- append
    def append(self, chunk) -> "SeriesFrame":
        """Absorb new samples at the end of the series.  With a compiled
        plan the chunk folds into the carried state (history is never
        re-read); the memoized results are invalidated."""
        chunk = as_series(chunk, self._device)
        if self._d is not None and chunk.shape[1] != self._d:
            raise ValueError(f"chunk has d={chunk.shape[1]}, frame has d={self._d}")
        self._results = None
        if self._placement == "array":
            self._appended.append(chunk)
        elif self._plan is None:
            self._tail_chunks().append(chunk)
        if self._plan is not None:
            self._states = self._plan.update_donated(self._states, chunk)
        self._n += chunk.shape[0]
        return self

    @property
    def length(self) -> int:
        """Samples ingested so far."""
        return self._n

    @property
    def backend(self):
        return self._backend

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
            drained = [as_series(c, self._device) for c in self._chunk_source]
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
        chunks = [c for c in self._drain_chunks() if c.shape[0] > 0]
        states = plan.consume(plan.init(), chunks)
        self._chunk_list = []  # weak memory: the raw chunks are gone once folded
        self._replayable = False
        return states


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


def session_state_from_numpy(snapshot: dict, device="cpu") -> dict:
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
