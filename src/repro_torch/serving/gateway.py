"""Async serving gateway over `repro_torch.core.frame.FrameSession` (port of
`repro.serving.gateway`).

Weak-memory statistics are mergeable partials, which is what makes them
servable: per-tenant state is a fixed-size stacked state, ingest a
scatter of updates, a query a gather, a fold and a finalize.  The gateway
is the concurrency front door:

  * clients call ``await gateway.ingest(tenant, chunk)`` and
    ``await gateway.query(tenant)`` from any number of asyncio tasks;
  * the gateway **coalesces per tick**: every admitted ingest of a tick is
    stacked into one arrival batch, copied to the session's device once and
    absorbed by ONE batched session ingest (kernel 1 twice on the card,
    whatever the number of tenants); every admitted query rides ONE
    batched ``query_batch`` (one finalize for all tenants, forecasts and
    anomaly scores included), whose whole result goes to the host in ONE
    device-to-host copy, each waiter then getting numpy views of its slice.
    Same-tenant ingests in one tick are ordered: the later ones carry over
    to the next tick, so the scatter never sees a duplicate id;
  * **admission control**: bounded queues (reject, don't buffer) and
    per-tenant token-bucket rate classes refilled per tick;
  * **metrics**: p50/p99 ingest and query latency, queue depths, batch
    occupancy, rejection counters, straggler ticks;
  * **durability**: every ``snapshot_every`` ticks the session's host
    export (`FrameSession.export_state`: CPU copies taken in the tick, so
    the checkpoint writer thread never sees the device and the next tick's
    in-place ingest cannot tear it) is saved through
    `repro_torch.checkpoint.manager.CheckpointManager`, and a restarted
    gateway resumes through `repro_torch.runtime.fault.FaultTolerantLoop.
    restore_or` from the newest intact generation;
  * **data-plane integrity** (`repro_torch.core.integrity`): with
    ``GatewayConfig(sentinel=True)`` each coalesced batch gets ONE
    all-finite verdict on the device before it touches session state (the
    verdict is the only host copy; the sanitized batch stays on the
    device).  A poisoned chunk follows its tenant's policy: ``reject``,
    ``sanitize`` or ``quarantine`` (fenced off from ingest and query until
    :meth:`StatsGateway.rebuild_tenant` restores it from the newest intact
    generation).  The ``ingest.payload`` chaos site poisons payloads on a
    seeded schedule; :meth:`StatsGateway.audit` sweeps the lanes;
  * **degraded mode**: with ``tick_deadline`` set, a tick over budget
    (the ``gateway.tick`` chaos site fires inside the timed window) sheds
    the lowest-priority queries with :class:`Degraded` and defers
    snapshots until ``degraded_recovery`` in-budget ticks.

The tick does not synchronise with the device: an ingest future resolves
when its kernels are queued, so ingest latencies are host latencies, as
in the reference.  A query's device-to-host copy waits for everything
queued before it.  ``tick()`` returns the host seconds of each stage of the
tick under ``"split"``.  When the session runs on a
`repro_torch.core.backend.CircuitBreakerBackend`, :meth:`StatsGateway.health`
reports its trips, recoveries and fallback calls under ``"breaker"``.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import time
from typing import Any, Deque, Dict, Optional

import numpy as np
import torch

from ..core.frame import FrameSession
from ..core.integrity import SENTINEL_POLICIES, sentinel_scan
from ..core.mapreduce import tree_leaves, tree_map
from ..runtime import chaos

__all__ = [
    "Degraded",
    "GatewayConfig",
    "GatewayRejected",
    "PoisonedChunk",
    "QueueFull",
    "RateClass",
    "RateLimited",
    "StatsGateway",
]


class GatewayRejected(RuntimeError):
    """Base class for admission-control rejections (backpressure)."""


class QueueFull(GatewayRejected):
    """The bounded request queue is at capacity — shed load upstream."""


class RateLimited(GatewayRejected):
    """The tenant's rate class has no tokens left this tick."""


class Degraded(GatewayRejected):
    """Shed because the gateway is over its tick deadline and dropping
    lowest-priority queries to recover.  Distinct from :class:`RateLimited`:
    the tenant did nothing wrong — back off instead of retrying at rate."""


class PoisonedChunk(GatewayRejected):
    """The ingest sentinel found non-finite values in the payload (or the
    tenant is quarantined from an earlier poisoning).  Retrying the same
    bytes will fail the same way — fix the producer, or ask the operator
    to :meth:`StatsGateway.rebuild_tenant` a quarantined tenant."""


@dataclasses.dataclass(frozen=True)
class RateClass:
    """Token-bucket admission limits, refilled once per tick.

    ``inf`` rates disable the limit.  ``burst`` caps the bucket (defaults
    to 2× the per-tick rate, min 1), so an idle tenant can catch up a
    little but can never dump an unbounded backlog into one tick.
    ``priority`` orders classes for degraded-mode shedding: when the
    gateway is over its tick deadline, queries from the lowest-priority
    class(es) are dropped first.
    """

    name: str = "default"
    ingest_per_tick: float = math.inf
    query_per_tick: float = math.inf
    burst: Optional[float] = None
    priority: int = 0

    def bucket_cap(self, rate: float) -> float:
        if self.burst is not None:
            return self.burst
        if math.isinf(rate):
            return math.inf
        return max(2.0 * rate, 1.0)


@dataclasses.dataclass
class GatewayConfig:
    tick_interval: float = 0.005           # serve_forever pacing (seconds)
    max_pending_ingest: int = 4096         # bounded queues: reject beyond
    max_pending_query: int = 4096
    snapshot_every: int = 0                # ticks between snapshots (0=off)
    checkpoint_dir: Optional[str] = None   # durability off when None
    keep_checkpoints: int = 3
    rate_classes: Dict[str, RateClass] = dataclasses.field(
        default_factory=lambda: {"default": RateClass()}
    )
    default_class: str = "default"
    latency_window: int = 16384            # latency samples kept per kind
    straggler_threshold: float = 4.0       # tick-time straggler flagging
    tick_deadline: float = 0.0             # per-tick wall budget (s, 0=off)
    degraded_recovery: int = 2             # in-budget ticks to leave degraded
    bucket_idle_ticks: int = 512           # evict buckets idle this long (0=off)
    sentinel: bool = False                 # all-finite verdict per ingest batch
    sentinel_policy: str = "reject"        # default: reject|sanitize|quarantine


# The stages of a tick, each timed on the host (tick()["split"]).
_STAGES = ("stack_h2d", "sentinel", "ingest", "query", "d2h", "resolve", "snapshot")


def _to_host(results: Any) -> Any:
    """A batched query result (dicts and tuples of tensors) as numpy arrays,
    through ONE device-to-host copy: every leaf's bytes are packed into one
    device buffer, copied once, and the host leaves are views of it."""
    tensors = tree_leaves(results)
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.uint8)
    views, off = [], 0
    for t, raw in zip(tensors, flat):
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        views.append(host[off: off + raw.numel()].view(dtype).reshape(tuple(t.shape)))
        off += raw.numel()
    it = iter(views)
    return tree_map(lambda _: next(it), results)


def _event_loop() -> asyncio.AbstractEventLoop:
    try:
        return asyncio.get_running_loop()
    except RuntimeError:  # submit from sync setup code, pre-loop
        return asyncio.get_event_loop_policy().get_event_loop()


@dataclasses.dataclass
class _Pending:
    tenant: int
    future: asyncio.Future
    t_submit: float
    chunk: Optional[np.ndarray] = None     # ingest only
    only: Optional[tuple] = None           # query only: request-name filter


class _TokenBuckets:
    """Per-tenant token buckets with lazy per-tick refill."""

    def __init__(self, rate_of, cap_of):
        self._rate_of = rate_of            # tenant -> tokens per tick
        self._cap_of = cap_of              # tenant -> bucket cap
        self._state: Dict[int, tuple] = {}  # tenant -> (tokens, tick)

    def admit(self, tenant: int, tick: int) -> bool:
        rate = self._rate_of(tenant)
        if math.isinf(rate):
            return True
        tokens, last = self._state.get(tenant, (self._cap_of(tenant), tick))
        tokens = min(self._cap_of(tenant), tokens + rate * (tick - last))
        if tokens < 1.0:
            self._state[tenant] = (tokens, tick)
            return False
        self._state[tenant] = (tokens - 1.0, tick)
        return True

    def evict_idle(self, tick: int, idle_ticks: int) -> int:
        """Drop buckets untouched for ``idle_ticks`` ticks; returns the
        eviction count.  A bucket that idle has (almost always) refilled
        to cap, so re-creating it lazily at full cap on the tenant's next
        request is the same state — this just bounds the map to tenants
        actually active in the last N ticks instead of every tenant ever
        seen.  (Lossless whenever ``idle_ticks >= cap / rate``; a
        pathologically slow-refill class trades a one-off full bucket for
        the memory bound.)"""
        stale = [t for t, (_, last) in self._state.items()
                 if tick - last >= idle_ticks]
        for t in stale:
            del self._state[t]
        return len(stale)

    def __len__(self) -> int:
        return len(self._state)


class StatsGateway:
    """Asyncio request engine serving one multi-tenant `FrameSession`.

    Args:
      session: the FrameSession to serve.  Its deferred requests must be
        declared before the gateway is constructed (the durability restore
        compiles the plan).
      config: see :class:`GatewayConfig`.

    Drive it either with :meth:`serve_forever` (background ticking at
    ``tick_interval``) or by awaiting :meth:`tick` directly (deterministic
    — what the tests and benchmark do).
    """

    def __init__(self, session: FrameSession, config: Optional[GatewayConfig] = None):
        self.session = session
        self.config = config or GatewayConfig()
        cfg = self.config
        if cfg.default_class not in cfg.rate_classes:
            raise ValueError(
                f"default_class {cfg.default_class!r} is not one of the "
                f"configured rate classes {sorted(cfg.rate_classes)}"
            )
        if cfg.sentinel_policy not in SENTINEL_POLICIES:
            raise ValueError(
                f"sentinel_policy {cfg.sentinel_policy!r} is not one of "
                f"{list(SENTINEL_POLICIES)}"
            )
        self._tenant_class: Dict[int, str] = {}
        # -- integrity -------------------------------------------------------
        self._tenant_policy: Dict[int, str] = {}  # per-tenant overrides
        self.quarantined: set = set()
        self._ingest_buckets = _TokenBuckets(
            lambda t: self._class_of(t).ingest_per_tick,
            lambda t: self._class_of(t).bucket_cap(
                self._class_of(t).ingest_per_tick),
        )
        self._query_buckets = _TokenBuckets(
            lambda t: self._class_of(t).query_per_tick,
            lambda t: self._class_of(t).bucket_cap(
                self._class_of(t).query_per_tick),
        )
        self._ingest_q: Deque[_Pending] = collections.deque()
        self._query_q: Deque[_Pending] = collections.deque()
        self._tick_lock = asyncio.Lock()
        self._serve_task: Optional[asyncio.Task] = None
        self._closed = False
        self._draining = False

        # -- health ----------------------------------------------------------
        self._health = "ok"
        self._healthy_streak = 0
        self._snapshot_deferred = False

        # -- metrics ---------------------------------------------------------
        self._lat_ingest: Deque[float] = collections.deque(
            maxlen=cfg.latency_window)
        self._lat_query: Deque[float] = collections.deque(
            maxlen=cfg.latency_window)
        self._occ_ingest: Deque[int] = collections.deque(maxlen=4096)
        self._occ_query: Deque[int] = collections.deque(maxlen=4096)
        self.counters = collections.Counter()     # monotonic — never reset
        self._counter_base = collections.Counter()  # reset_metrics() window

        # -- durability ------------------------------------------------------
        self._loop_rt = None
        self._tick = 0
        self._device = session._device
        self._split = dict.fromkeys(_STAGES, 0.0)  # the current tick's stage times
        self._dirty = False
        if cfg.checkpoint_dir is not None:
            from ..runtime.fault import FaultTolerantLoop

            # every=0: the gateway owns the snapshot cadence (a fresh host
            # export must be taken at exactly the saving tick); the loop
            # contributes restore-resume, the async manager, and the
            # straggler monitor.
            self._loop_rt = FaultTolerantLoop(
                cfg.checkpoint_dir,
                every=0,
                keep=cfg.keep_checkpoints,
                straggler_threshold=cfg.straggler_threshold,
            )
            # the template only supplies structure/shapes/dtypes — the
            # zero-copy view skips a full device→host export at startup
            template = session.state_template()
            state, start_tick = self._loop_rt.restore_or(template)
            if start_tick > 0:
                session.import_state(state)
                self.counters["restored_from_snapshot"] += 1
            self._tick = start_tick
            self.monitor = self._loop_rt.monitor
        else:
            from ..runtime.fault import StragglerMonitor

            self.monitor = StragglerMonitor(threshold=cfg.straggler_threshold)

    # ------------------------------------------------------------ admission
    def _class_of(self, tenant: int) -> RateClass:
        name = self._tenant_class.get(tenant, self.config.default_class)
        return self.config.rate_classes[name]

    def _min_priority(self) -> int:
        return min(rc.priority for rc in self.config.rate_classes.values())

    def set_tenant_class(self, tenant: int, class_name: str) -> None:
        if class_name not in self.config.rate_classes:
            raise ValueError(
                f"unknown rate class {class_name!r}; configured: "
                f"{sorted(self.config.rate_classes)}"
            )
        self._tenant_class[int(tenant)] = class_name

    def set_tenant_policy(self, tenant: int, policy: str) -> None:
        """Override the sentinel policy for one tenant (the config's
        ``sentinel_policy`` applies to everyone else)."""
        if policy not in SENTINEL_POLICIES:
            raise ValueError(
                f"unknown sentinel policy {policy!r}; one of "
                f"{list(SENTINEL_POLICIES)}"
            )
        self._tenant_policy[self._check_tenant(tenant)] = policy

    def _policy_of(self, tenant: int) -> str:
        return self._tenant_policy.get(tenant, self.config.sentinel_policy)

    def _check_tenant(self, tenant: int) -> int:
        tenant = int(tenant)
        if not 0 <= tenant < self.session.num_users:
            raise ValueError(
                f"tenant {tenant} out of range [0, {self.session.num_users})"
            )
        return tenant

    def submit_ingest(self, tenant: int, chunk) -> asyncio.Future:
        """Admit one ingest request; resolves after the absorbing tick.

        Raises :class:`QueueFull` / :class:`RateLimited` immediately when
        admission fails (the rejection is the backpressure signal), and
        :class:`PoisonedChunk` for a quarantined tenant.
        """
        if self._closed:
            raise RuntimeError("gateway is closed")
        tenant = self._check_tenant(tenant)
        if tenant in self.quarantined:
            self.counters["rejected_ingest_quarantined"] += 1
            raise PoisonedChunk(
                f"tenant {tenant} is quarantined (poisoned state); "
                "rebuild_tenant() restores service"
            )
        chunk = np.asarray(chunk)
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        if chunk.ndim != 2 or chunk.shape[1] != self.session.d:
            raise ValueError(
                f"chunk must be (c, {self.session.d}), got {chunk.shape}"
            )
        if len(self._ingest_q) >= self.config.max_pending_ingest:
            self.counters["rejected_ingest_queue_full"] += 1
            raise QueueFull(
                f"ingest queue at capacity ({self.config.max_pending_ingest})"
            )
        if not self._ingest_buckets.admit(tenant, self._tick):
            self.counters["rejected_ingest_rate"] += 1
            raise RateLimited(
                f"tenant {tenant} over its "
                f"{self._tenant_class.get(tenant, self.config.default_class)!r}"
                " ingest rate"
            )
        if chaos.should_corrupt("ingest.payload"):
            # seeded data-plane poisoning: the payload arrives torn (NaN)
            # exactly as a buggy producer or a bit-flipped wire would
            # deliver it — drawn once per admitted submission, so a given
            # (seed, calls) schedule replays the same poisoned arrivals
            chunk = np.array(chunk, dtype=(
                chunk.dtype if np.issubdtype(chunk.dtype, np.floating)
                else np.float32
            ))
            chunk[0, 0] = np.nan
            self.counters["chaos_poisoned_ingest"] += 1
        fut = _event_loop().create_future()
        self._ingest_q.append(
            _Pending(tenant, fut, time.perf_counter(), chunk=chunk)
        )
        return fut

    def submit_query(self, tenant: int, only=None) -> asyncio.Future:
        """Admit one query request; resolves to ``{request_name: result}``
        (this tenant's slice of the tick's batched read).

        ``only`` — a request name or iterable of names (e.g. a forecast or
        anomaly member) — narrows the resolved dict to those query kinds.
        The filter is applied host-side to the tenant's slice: every admitted
        query still rides the SAME one-per-tick batched finalize, so asking
        for just the forecast costs no extra device program.
        """
        if self._closed:
            raise RuntimeError("gateway is closed")
        tenant = self._check_tenant(tenant)
        if tenant in self.quarantined:
            self.counters["rejected_query_quarantined"] += 1
            raise PoisonedChunk(
                f"tenant {tenant} is quarantined (poisoned state); its "
                "answers would be garbage — rebuild_tenant() restores service"
            )
        if only is not None:
            only = (only,) if isinstance(only, str) else tuple(only)
            unknown = set(only) - set(self.session.request_names)
            if unknown:
                raise ValueError(
                    f"unknown query kinds {sorted(unknown)}; this session "
                    f"serves {list(self.session.request_names)}"
                )
        if (
            self._health == "degraded"
            and self._class_of(tenant).priority <= self._min_priority()
        ):
            self.counters["rejected_query_degraded"] += 1
            raise Degraded(
                f"gateway degraded (tick over {self.config.tick_deadline}s "
                f"budget); shedding lowest-priority queries"
            )
        if len(self._query_q) >= self.config.max_pending_query:
            self.counters["rejected_query_queue_full"] += 1
            raise QueueFull(
                f"query queue at capacity ({self.config.max_pending_query})"
            )
        if not self._query_buckets.admit(tenant, self._tick):
            self.counters["rejected_query_rate"] += 1
            raise RateLimited(
                f"tenant {tenant} over its "
                f"{self._tenant_class.get(tenant, self.config.default_class)!r}"
                " query rate"
            )
        fut = _event_loop().create_future()
        self._query_q.append(
            _Pending(tenant, fut, time.perf_counter(), only=only)
        )
        return fut

    async def ingest(self, tenant: int, chunk) -> int:
        """Coroutine front door: admitted, then resolved at the next tick.
        Returns the tick index that absorbed the chunk."""
        return await self.submit_ingest(tenant, chunk)

    async def query(self, tenant: int, only=None) -> dict:
        """Coroutine front door: this tenant's deferred statistics as of
        the resolving tick (optionally narrowed to the ``only`` kinds —
        e.g. ``await gw.query(7, only="forecast")``)."""
        return await self.submit_query(tenant, only=only)

    # ------------------------------------------------------------- the tick
    async def tick(self) -> dict:
        """Run one coalescing round: drain the queues, launch the batched
        ingest and query, resolve futures, maybe snapshot.  Returns per-tick
        stats; ``"split"`` holds the host seconds of each stage (stack and
        host-to-device copy, sentinel, ingest launches, query launches and
        finalize, device-to-host copy, resolving the futures, snapshot)."""
        async with self._tick_lock:
            t_start = time.perf_counter()
            self._split = dict.fromkeys(_STAGES, 0.0)
            shed = self._shed_if_degraded()
            # the gateway.tick chaos site lives INSIDE the timed window: an
            # injected stall looks exactly like a straggler device to the
            # deadline watchdog; an injected fail is a survivable tick-level
            # fault (counted, the tick still serves)
            try:
                chaos.fire("gateway.tick")
            except Exception:
                self.counters["tick_faults"] += 1
            n_ing = self._run_ingests()
            n_qry = self._run_queries()
            tick = self._tick
            self._tick += 1
            dt = time.perf_counter() - t_start
            self._update_health(tick, dt)
            self._maybe_snapshot(tick)
            if n_ing or n_qry:
                self.monitor.record(tick, dt)
            self.counters["ticks"] += 1
            idle = self.config.bucket_idle_ticks
            if idle and tick and tick % idle == 0:
                evicted = self._ingest_buckets.evict_idle(tick, idle)
                evicted += self._query_buckets.evict_idle(tick, idle)
                self.counters["buckets_evicted"] += evicted
        # hand control back so awaiting clients observe their futures
        await asyncio.sleep(0)
        return {"tick": tick, "ingests": n_ing, "queries": n_qry,
                "shed": shed, "seconds": dt, "split": dict(self._split)}

    def _shed_if_degraded(self) -> int:
        """In degraded mode, drop queued queries of the lowest-priority
        rate class before doing any work this tick (with a single class,
        every pending query is lowest).  Ingests are never shed — dropping
        reads costs a retry, dropping writes loses data."""
        if self._health != "degraded" or not self._query_q:
            return 0
        floor = self._min_priority()
        keep: list = []
        shed = 0
        for req in self._query_q:
            if self._class_of(req.tenant).priority <= floor:
                if not req.future.done():
                    req.future.set_exception(Degraded(
                        f"query shed at tick {self._tick}: gateway degraded"
                    ))
                shed += 1
            else:
                keep.append(req)
        self._query_q.clear()
        self._query_q.extend(keep)
        self.counters["shed_query_degraded"] += shed
        return shed

    def _update_health(self, tick: int, dt: float) -> None:
        deadline = self.config.tick_deadline
        if not deadline:
            return
        if dt > deadline:
            self.counters["ticks_deadline_blown"] += 1
            self._healthy_streak = 0
            if self._health != "degraded":
                self._health = "degraded"
                self.counters["degraded_entries"] += 1
        elif self._health == "degraded":
            self._healthy_streak += 1
            if self._healthy_streak >= self.config.degraded_recovery:
                self._health = "ok"
                self.counters["degraded_recoveries"] += 1
                if (self._snapshot_deferred and self._loop_rt is not None
                        and self._dirty):
                    self._snapshot(tick)
                self._snapshot_deferred = False

    def _run_ingests(self) -> int:
        """Coalesce the admitted ingest backlog into the fewest possible
        batched ingests: one per run of equal chunk lengths, duplicate
        tenants deferred to the next tick (a scatter must see distinct
        ids, and a tenant's chunks must land in arrival order).  With the
        sentinel enabled, each coalesced batch gets one all-finite verdict
        before it can touch session state."""
        pending = list(self._ingest_q)
        self._ingest_q.clear()
        carry: list = []
        seen: set = set()
        groups: Dict[int, list] = {}
        for req in pending:
            if req.tenant in self.quarantined:
                # quarantined between admission and this tick (a carried
                # request, or an audit() ran mid-backlog)
                if not req.future.done():
                    req.future.set_exception(PoisonedChunk(
                        f"tenant {req.tenant} is quarantined; "
                        "rebuild_tenant() restores service"
                    ))
                self.counters["rejected_ingest_quarantined"] += 1
                continue
            if req.tenant in seen:
                carry.append(req)       # next tick: ordering + distinctness
                continue
            seen.add(req.tenant)
            groups.setdefault(req.chunk.shape[0], []).append(req)
        self._ingest_q.extend(carry)
        done = 0
        for length, reqs in sorted(groups.items()):
            if length == 0:
                for r in reqs:          # empty chunk: a no-op, resolve now
                    self._resolve(r, self._tick, self._lat_ingest)
                continue
            ids = np.asarray([r.tenant for r in reqs], np.int32)
            t0 = time.perf_counter()
            # one host stack and ONE host-to-device copy for the whole batch
            batch = torch.from_numpy(np.stack([r.chunk for r in reqs])).to(
                device=self._device, dtype=torch.float32)
            t1 = time.perf_counter()
            self._split["stack_h2d"] += t1 - t0
            if self.config.sentinel:
                # one verdict and sanitized copy together on the device; the
                # verdict is the only host copy, and the clean batch
                # (bit-identical when everything is finite) stays on the
                # device for the ingest below
                verdict, clean = sentinel_scan(batch)
                self.counters["sentinel_scans"] += 1
                if not verdict.all():
                    keep = self._apply_sentinel(reqs, verdict)
                    if not keep:
                        self._split["sentinel"] += time.perf_counter() - t1
                        continue
                    if len(keep) < len(reqs):
                        sel = np.asarray(keep)
                        reqs = [reqs[i] for i in keep]
                        ids = ids[sel]
                        clean = clean[torch.as_tensor(sel, device=clean.device)]
                batch = clean
            t2 = time.perf_counter()
            self._split["sentinel"] += t2 - t1
            try:
                self.session.ingest(ids, batch)
            except Exception as e:
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                self.counters["failed_ingest"] += len(reqs)
                continue
            t3 = time.perf_counter()
            self._split["ingest"] += t3 - t2
            self.counters["programs_ingest"] += 1
            self._occ_ingest.append(len(reqs))
            self._dirty = True
            for r in reqs:
                self._resolve(r, self._tick, self._lat_ingest)
            self._split["resolve"] += time.perf_counter() - t3
            done += len(reqs)
        return done

    def _apply_sentinel(self, reqs, verdict) -> list:
        """Dispatch each poisoned chunk to its tenant's policy; returns the
        indices of requests that still ingest (finite ones, plus sanitized
        poisoned ones)."""
        keep: list = []
        for i, r in enumerate(reqs):
            if verdict[i]:
                keep.append(i)
                continue
            policy = self._policy_of(r.tenant)
            if policy == "sanitize":
                # the sanitized device row (non-finite → 0) ingests
                self.counters["sanitized_chunks"] += 1
                keep.append(i)
                continue
            self.counters["rejected_ingest_poisoned"] += 1
            if policy == "quarantine":
                self.quarantined.add(r.tenant)
                self.counters["tenants_quarantined"] += 1
                msg = (
                    f"tenant {r.tenant} quarantined: non-finite values in "
                    "ingest payload; rebuild_tenant() restores service"
                )
            else:  # reject
                msg = (
                    f"ingest rejected: non-finite values in tenant "
                    f"{r.tenant}'s chunk"
                )
            if not r.future.done():
                r.future.set_exception(PoisonedChunk(msg))
        return keep

    def _run_queries(self) -> int:
        """Coalesce the admitted query backlog into ONE batched read:
        distinct tenants gathered once, every waiter handed its slice."""
        pending = list(self._query_q)
        self._query_q.clear()
        if self.quarantined:
            alive = []
            for req in pending:
                if req.tenant in self.quarantined:
                    if not req.future.done():
                        req.future.set_exception(PoisonedChunk(
                            f"tenant {req.tenant} is quarantined; "
                            "rebuild_tenant() restores service"
                        ))
                    self.counters["rejected_query_quarantined"] += 1
                else:
                    alive.append(req)
            pending = alive
        if not pending:
            return 0
        order: Dict[int, int] = {}
        for req in pending:
            order.setdefault(req.tenant, len(order))
        ids = np.fromiter(order.keys(), np.int32, len(order))
        t0 = time.perf_counter()
        try:
            results = self.session.query_batch(ids)
        except Exception as e:
            for r in pending:
                if not r.future.done():
                    r.future.set_exception(e)
            self.counters["failed_query"] += len(pending)
            return 0
        t1 = time.perf_counter()
        self._split["query"] += t1 - t0
        self.counters["programs_finalize"] += 1
        self._occ_query.append(len(order))
        # ONE device-to-host copy for the whole batch; per-waiter slicing is
        # then numpy views, not thousands of tiny device index launches
        host = _to_host(results)
        t2 = time.perf_counter()
        self._split["d2h"] += t2 - t1
        for req in pending:
            pos = order[req.tenant]
            value = tree_map(lambda leaf: leaf[pos], host)
            if req.only is not None:
                value = {k: value[k] for k in req.only}
            self._resolve(req, value, self._lat_query)
        self._split["resolve"] += time.perf_counter() - t2
        return len(pending)

    def _resolve(self, req: _Pending, value: Any, lat: Deque[float]) -> None:
        if not req.future.done():       # client may have given up (cancel)
            req.future.set_result(value)
        lat.append(time.perf_counter() - req.t_submit)

    # ----------------------------------------------------------- durability
    def _maybe_snapshot(self, tick: int) -> None:
        cfg = self.config
        if (
            self._loop_rt is None
            or not cfg.snapshot_every
            or not self._dirty
            or (tick + 1) % cfg.snapshot_every != 0
        ):
            return
        if self._health == "degraded":
            # don't compound an over-budget tick with a state export; the
            # recovery transition takes the deferred snapshot
            self._snapshot_deferred = True
            self.counters["snapshots_deferred"] += 1
            return
        self._snapshot(tick)

    def _snapshot(self, tick: int) -> None:
        # export_state hands out HOST copies, taken here in the tick, so the
        # writer thread never touches the device and the next tick's
        # in-place ingest cannot tear the snapshot.  tenant_axes in the
        # manifest is what lets rebuild_tenant extract ONE tenant later.
        t0 = time.perf_counter()
        self._loop_rt.manager.save(
            self.session.export_state(), tick,
            meta={"tenant_axes": self.session.tenant_axes()},
        )
        self._split["snapshot"] += time.perf_counter() - t0
        self._dirty = False
        self.counters["snapshots"] += 1

    # ------------------------------------------------------------- integrity
    def audit(self, quarantine: bool = True) -> dict:
        """On-device finite sweep of every tenant's lane state (one host
        copy per plan group — see `FrameSession.audit`).

        ``quarantine=True`` (default) fences every unhealthy tenant off
        from ingest and query until :meth:`rebuild_tenant` repairs it.
        Returns ``{"unhealthy": [...], "quarantined": [...newly...]}``.
        """
        healthy = self.session.audit()
        self.counters["audits"] += 1
        unhealthy = [int(t) for t in np.flatnonzero(~healthy)]
        self.counters["audit_unhealthy"] += len(unhealthy)
        newly: list = []
        if quarantine:
            for t in unhealthy:
                if t not in self.quarantined:
                    self.quarantined.add(t)
                    self.counters["tenants_quarantined"] += 1
                    newly.append(t)
        return {"unhealthy": unhealthy, "quarantined": newly}

    def rebuild_tenant(self, tenant: int) -> dict:
        """Surgically restore ONE tenant from the newest checkpoint
        generation whose slice verifies, release its quarantine, and leave
        every other tenant's live state untouched (see
        `RollingStatsService.import_tenant`).

        The restored tenant serves answers as of its last snapshot —
        freshness between that snapshot and the poisoning is lost (state is
        never recomputed; there is no raw data to replay), availability is
        restored.  Returns ``{"tenant", "step", "skipped", "released"}``.
        """
        tenant = self._check_tenant(tenant)
        if self._loop_rt is None:
            raise RuntimeError(
                "rebuild_tenant needs durability — construct the gateway "
                "with GatewayConfig(checkpoint_dir=...)"
            )
        from ..checkpoint.manager import restore_tenant_latest_intact

        # queued async snapshots must land before the newest-intact walk
        self._loop_rt.manager.flush()
        state, step, skipped = restore_tenant_latest_intact(
            self.session.state_template(),
            self._loop_rt.manager.directory,
            tenant,
        )
        self.session.import_tenant(tenant, state)
        released = tenant in self.quarantined
        self.quarantined.discard(tenant)
        self.counters["tenants_rebuilt"] += 1
        return {
            "tenant": tenant,
            "step": step,
            "skipped": skipped,
            "released": released,
        }

    # -------------------------------------------------------------- driving
    async def serve_forever(self) -> None:
        """Tick at ``config.tick_interval`` until :meth:`stop` is called."""
        try:
            while not self._closed:
                await self.tick()
                await asyncio.sleep(self.config.tick_interval)
        except asyncio.CancelledError:
            pass

    def start(self) -> asyncio.Task:
        """Launch :meth:`serve_forever` as a background task."""
        if self._serve_task is None or self._serve_task.done():
            self._serve_task = _event_loop().create_task(self.serve_forever())
        return self._serve_task

    async def stop(self, final_snapshot: bool = True) -> None:
        """Drain one last tick, snapshot if dirty, release the writer."""
        if self._closed:
            return
        self._draining = True
        # drain: carried-over same-tenant duplicates may need extra ticks
        await self.tick()
        while self._ingest_q or self._query_q:
            await self.tick()
        self._closed = True
        if self._serve_task is not None:
            self._serve_task.cancel()
            try:
                await self._serve_task
            except asyncio.CancelledError:
                pass
        for q in (self._ingest_q, self._query_q):
            for req in q:
                if not req.future.done():
                    req.future.set_exception(
                        GatewayRejected("gateway stopped"))
            q.clear()
        if self._loop_rt is not None:
            if final_snapshot and self._dirty:
                self._snapshot(self._tick)
            self._loop_rt.close()

    # -------------------------------------------------------------- metrics
    @staticmethod
    def _pct(samples, q: float) -> float:
        if not samples:
            return 0.0
        return float(np.percentile(np.asarray(samples), q)) * 1e6  # µs

    def health(self) -> dict:
        """Liveness surface: ``ok`` / ``degraded`` / ``draining``, the
        deadline watchdog's tallies, the integrity counters and -- when the
        session's backend is a circuit breaker -- its per-primitive trip
        state under ``"breaker"``."""
        state = ("draining" if (self._draining or self._closed)
                 else self._health)
        out = {
            "state": state,
            "tick": self._tick,
            "deadline": {
                "budget_s": self.config.tick_deadline,
                "blown": self.counters["ticks_deadline_blown"],
                "shed": self.counters["shed_query_degraded"]
                + self.counters["rejected_query_degraded"],
                "snapshot_deferred": self._snapshot_deferred,
                "degraded_entries": self.counters["degraded_entries"],
                "degraded_recoveries": self.counters["degraded_recoveries"],
            },
        }
        breaker = getattr(self.session._backend, "breaker_metrics", None)
        if callable(breaker):
            out["breaker"] = breaker()
        out["integrity"] = {
            "sentinel": self.config.sentinel,
            "default_policy": self.config.sentinel_policy,
            "quarantined": sorted(self.quarantined),
            "poisoned_rejected": self.counters["rejected_ingest_poisoned"],
            "sanitized_chunks": self.counters["sanitized_chunks"],
            "audits": self.counters["audits"],
            "audit_unhealthy": self.counters["audit_unhealthy"],
            "tenants_quarantined": self.counters["tenants_quarantined"],
            "tenants_rebuilt": self.counters["tenants_rebuilt"],
        }
        return out

    def reset_metrics(self) -> None:
        """Start a new observation window: clears the latency/occupancy
        sample windows and re-bases the per-window counter deltas exposed
        under ``metrics()["window"]``.  The totals in ``counters`` are
        monotonic and are never reset — rates come from windows, audits
        from totals."""
        self._lat_ingest.clear()
        self._lat_query.clear()
        self._occ_ingest.clear()
        self._occ_query.clear()
        self._counter_base = collections.Counter(self.counters)

    def metrics(self) -> dict:
        """The serving surface's health in one dict (latencies in µs).
        Rejection/snapshot counts are monotonic totals; ``window`` holds
        the same counters since the last :meth:`reset_metrics`."""
        c = self.counters
        base = self._counter_base
        return {
            "ticks": c["ticks"],
            "tick": self._tick,
            "health": ("draining" if (self._draining or self._closed)
                       else self._health),
            "ingest": {
                "count": len(self._lat_ingest),
                "p50_us": self._pct(self._lat_ingest, 50),
                "p99_us": self._pct(self._lat_ingest, 99),
                "rejected_rate": c["rejected_ingest_rate"],
                "rejected_queue_full": c["rejected_ingest_queue_full"],
                "programs": c["programs_ingest"],
            },
            "query": {
                "count": len(self._lat_query),
                "p50_us": self._pct(self._lat_query, 50),
                "p99_us": self._pct(self._lat_query, 99),
                "rejected_rate": c["rejected_query_rate"],
                "rejected_queue_full": c["rejected_query_queue_full"],
                "rejected_degraded": c["rejected_query_degraded"]
                + c["shed_query_degraded"],
                "programs": c["programs_finalize"],
            },
            "queue_depth": {
                "ingest": len(self._ingest_q),
                "query": len(self._query_q),
            },
            "batch_occupancy": {
                "ingest_mean": float(np.mean(self._occ_ingest))
                if self._occ_ingest else 0.0,
                "query_mean": float(np.mean(self._occ_query))
                if self._occ_query else 0.0,
            },
            "bucket_tenants": len(self._ingest_buckets)
            + len(self._query_buckets),
            "straggler_ticks": list(self.monitor.flagged),
            "snapshots": c["snapshots"],
            "deadline_blown": c["ticks_deadline_blown"],
            "restored_from_snapshot": c["restored_from_snapshot"],
            "window": {k: c[k] - base[k]
                       for k in sorted(set(c) | set(base))},
        }
