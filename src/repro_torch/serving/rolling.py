"""Rolling-statistics serving over per-user partial states (port of
`repro.serving.rolling`).

Millions of user series, each receiving samples over time, each wanting
rolling statistics on demand.  Weak-memory partials form a mergeable monoid
(`repro_torch.core.streaming`), so the service never stores raw series:
only per-user `PartialState`s, held as ONE stacked state whose every leaf
has leading ``(num_lanes, num_users)`` axes.

  * Ingest gathers the arrival batch's users from one lane, updates them
    all with one batched engine update (the reference's ``vmap``: two
    chunk-kernel calls, one megakernel launch each on the card, whatever
    the batch size) and scatters them back IN PLACE with ``index_copy_`` /
    ``index_put_`` -- the counterpart of the reference's donated buffers.
    Ids are validated on a host view: no device-to-host copy per tick.
  * ``num_shards`` independent ingest lanes never coordinate on the write
    path; a query gathers every lane of the requested users and folds the
    lane axis with the batched merge.
  * Sliding-window eviction (``window=``): each user's lanes are a ring of
    ``num_buckets`` window-aligned sub-states.  Ingest lands in the bucket
    owning the chunk's global index (from a HOST cursor), resetting it to
    the neutral element when a new span begins -- the eviction.  A query
    sorts the ring by global start (a stable sort, as ``jnp.argsort``) and
    folds it, so results cover the last ``w`` samples, ``window -
    bucket_len < w <= window``.

Integrity: one non-finite sample folded into a lane poisons that tenant's
answers for good.  :meth:`RollingStatsService.audit` sweeps the stacked
lanes on the device (`repro_torch.core.integrity.lane_health`, one
device-to-host copy) and :meth:`import_tenant` restores one tenant's lanes
from a snapshot without touching the others.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.integrity import lane_health
from ..core.streaming import _FIELDS, PartialState, StreamingEngine, _bcast

__all__ = ["RollingStatsService", "state_paths"]

_INT32_MAX = 2**31 - 1


def state_paths(state: PartialState, prefix: str = "") -> list:
    """The key of every leaf of ``state``, in ``flatten`` order, as the
    reference's checkpoint keys name them ("<prefix>/.stat/lagged", ...)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in walk(tree[k], f"{path}/{k}")]
        return [] if tree is None else [path]

    return [p for f in _FIELDS for p in walk(getattr(state, f), f"{prefix}/.{f}")]


def _kind(dtype: torch.dtype) -> str:
    if dtype == torch.bool:
        return "b"
    if dtype.is_complex:
        return "c"
    return "f" if dtype.is_floating_point else "i"


def _coerce_import_leaf(key: str, cur: torch.Tensor, new) -> torch.Tensor:
    """One snapshot leaf (numpy or tensor) as a tensor of the live leaf's
    dtype on its device.  A same-kind mismatch (a float64 snapshot into a
    float32 service) is cast; a kind change (float, int, complex, bool)
    means another engine's snapshot, and raises."""
    t = new if isinstance(new, torch.Tensor) else torch.as_tensor(np.asarray(new))
    if _kind(t.dtype) != _kind(cur.dtype):
        raise ValueError(f"snapshot leaf {key!r} has dtype {t.dtype} but this service holds "
                         f"{cur.dtype}; a kind change cannot come from a matching exporter "
                         f"config; refusing to cast")
    return t.to(device=cur.device, dtype=cur.dtype)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.to("cpu", copy=True)


class RollingStatsService:
    """Batched per-user rolling statistics with mergeable ingest lanes.

    Args:
      engine: streaming engine of the tracked statistic (a `StatPlan`
        group's engine for a `FrameSession`).
      num_users: number of user series served.
      num_shards: independent ingest lanes.  A user's stream may be split
        across lanes in contiguous time segments (pass ``t0`` at the first
        ingest of a mid-stream lane).
      window: sliding-window eviction mode: retain about the last
        ``window`` samples per user in a ring of ``num_buckets``
        window-aligned sub-states.  One ingest lane; every chunk must tile
        the bucket grid.
      num_buckets: ring size in eviction mode (default 8); it must divide
        ``window``.
    """

    def __init__(self, engine: StreamingEngine, num_users: int, num_shards: int = 1,
                 window: Optional[int] = None, num_buckets: Optional[int] = None):
        if num_users <= 0 or num_shards <= 0:
            raise ValueError("num_users and num_shards must be positive")
        self.engine = engine
        self.device = engine.device
        self.num_users = num_users
        self.num_shards = num_shards
        self.window = window
        if window is None:
            if num_buckets is not None:
                raise ValueError("num_buckets only applies with window= set")
            self.num_buckets = None
            self.bucket_len = None
            num_lanes = num_shards
        else:
            if num_shards != 1:
                raise ValueError("eviction mode is a single ingest lane (num_shards=1); "
                                 "the lane axis is the eviction ring")
            self.num_buckets = 8 if num_buckets is None else num_buckets
            if self.num_buckets < 2:
                raise ValueError("eviction needs at least 2 ring buckets")
            if window <= 0 or window % self.num_buckets != 0:
                raise ValueError(f"window={window} must be a positive multiple of "
                                 f"num_buckets={self.num_buckets}")
            self.bucket_len = window // self.num_buckets
            num_lanes = self.num_buckets
        self._num_lanes = num_lanes
        one = engine.init_batch(num_users)
        self._lanes = one.unflatten([leaf.expand((num_lanes,) + leaf.shape).clone()
                                     for leaf in one.flatten()])
        # Samples ever ingested per user: the eviction ring's global cursor,
        # a HOST array (read for alignment checks and buckets, never synced).
        self._counts = np.zeros((num_users,), np.int64)
        self._lane_health = np.ones((num_lanes, num_users), bool)

    @property
    def backend(self):
        """The compute backend every ingest and query runs through."""
        return self.engine.backend

    def _ids(self, user_ids) -> torch.Tensor:
        return torch.as_tensor(user_ids, device=self.device).long()

    # -- durability ---------------------------------------------------------
    def export_state(self) -> dict:
        """Host snapshot of the full serving state: the stacked lanes (CPU
        copies, safe across later in-place ingests) and the cursor."""
        return {"lanes": self._lanes.unflatten([_host_copy(x) for x in self._lanes.flatten()]),
                "counts": np.array(self._counts)}

    def import_state(self, state: dict) -> None:
        """Install an :meth:`export_state` snapshot of a service with the
        same engine and num_users / num_shards / window: queries then answer
        as the exporter's did, bit for bit, with no re-ingest."""
        lanes = state["lanes"]
        want, got = state_paths(self._lanes), state_paths(lanes)
        if want != got:
            raise ValueError(f"snapshot lane structure {got} does not match this service's "
                             f"{want}; was it exported from a service with a different plan "
                             f"or engine?")
        cur, new = self._lanes.flatten(), lanes.flatten()
        bad = [(tuple(a.shape), tuple(np.shape(b))) for a, b in zip(cur, new)
               if tuple(a.shape) != tuple(np.shape(b))]
        if bad:
            raise ValueError(f"snapshot lane shapes {[b for _, b in bad]} do not match this "
                             f"service's {[a for a, _ in bad]}; num_users / num_shards / "
                             f"window must equal the exporter's")
        vals = [_coerce_import_leaf("lanes" + k, a, b) for k, a, b in zip(want, cur, new)]
        counts = np.asarray(state["counts"])
        if counts.dtype.kind not in "iu":
            raise ValueError(f"snapshot counts must be integer-typed, got {counts.dtype}")
        if counts.shape != self._counts.shape:
            raise ValueError(f"snapshot counts shape {counts.shape} != {self._counts.shape}")
        for a, v in zip(cur, vals):
            a.copy_(v)
        self._counts = counts.astype(np.int64)
        self._lane_health = np.ones((self._num_lanes, self.num_users), bool)

    def state_template(self) -> dict:
        """The live lanes and cursor themselves, with :meth:`export_state`'s
        structure (shapes and dtypes without a device-to-host copy).  Do not
        mutate, and do not keep across an ingest."""
        return {"lanes": self._lanes, "counts": self._counts}

    # -- integrity ----------------------------------------------------------
    def audit(self) -> np.ndarray:
        """Finite-sweep the stacked lanes on the device (one device-to-host
        copy), refresh the per-(lane, user) health mask, and return a host
        (num_users,) bool: True where every lane of the user is healthy."""
        mask = lane_health(self._lanes).cpu().numpy().copy()
        self._lane_health = mask
        return mask.all(axis=0)

    @property
    def lane_health(self) -> np.ndarray:
        """(num_lanes, num_users) health mask of the last :meth:`audit`
        (all True before one, and after an import)."""
        return self._lane_health.copy()

    def _check_user(self, user_id: int) -> int:
        u = int(user_id)
        if not 0 <= u < self.num_users:
            raise ValueError(f"user_id {u} out of range [0, {self.num_users})")
        return u

    def tenant_slice(self, state: dict, user_id: int) -> dict:
        """ONE user's slice of an :meth:`export_state` snapshot: lane leaves
        keep their lane axis and drop the user axis; the cursor becomes a
        scalar.  Host-side."""
        u = self._check_user(user_id)
        lanes = state["lanes"]
        return {"lanes": lanes.unflatten([x[:, u] for x in lanes.flatten()]),
                "counts": np.int64(np.asarray(state["counts"])[u])}

    def export_tenant(self, user_id: int) -> dict:
        """Host snapshot of ONE user's lanes and cursor (the payload of
        :meth:`import_tenant`)."""
        u = self._check_user(user_id)
        return {"lanes": self._lanes.unflatten([_host_copy(x[:, u])
                                                for x in self._lanes.flatten()]),
                "counts": np.int64(self._counts[u])}

    def import_tenant(self, user_id: int, state: dict) -> None:
        """Restore ONE user's lanes from a per-tenant snapshot, in place;
        every other user's state is untouched."""
        u = self._check_user(user_id)
        lanes = state["lanes"]
        keys = state_paths(self._lanes)
        if state_paths(lanes) != keys:
            raise ValueError(f"tenant snapshot lane structure {state_paths(lanes)} does not "
                             f"match this service's {keys}")
        cur, new = self._lanes.flatten(), lanes.flatten()
        vals = []
        for key, a, b in zip(keys, cur, new):
            expect = (a.shape[0],) + tuple(a.shape[2:])
            if tuple(np.shape(b)) != expect:
                raise ValueError(f"tenant snapshot leaf 'lanes{key}' has shape "
                                 f"{tuple(np.shape(b))}, expected {expect}")
            vals.append(_coerce_import_leaf("lanes" + key, a, b))
        count = np.asarray(state["counts"])
        if count.dtype.kind not in "iu" or count.shape != ():
            raise ValueError(f"tenant snapshot counts must be an integer scalar, got "
                             f"{count.dtype} with shape {count.shape}")
        for a, v in zip(cur, vals):
            a[:, u] = v
        self._counts[u] = int(count)
        self._lane_health[:, u] = True

    # -- write path ---------------------------------------------------------
    def ingest(self, user_ids, chunks, shard: int = 0, t0=None) -> None:
        """Absorb one arrival batch: ``chunks[i]`` extends user
        ``user_ids[i]``'s series on lane ``shard``.

        Args:
          user_ids: (k,) distinct ints (host data: validated without a
            device round trip).
          chunks: (k, c, d), one equal-length chunk per user.
          t0: (k,) global starts, used only for users whose lane state is
            still empty (a lane that picks up mid-stream).  Growing mode
            only: the eviction ring owns the global cursor.
        """
        ids = np.asarray(user_ids)
        if ids.dtype.kind != "i":
            ids = ids.astype(np.int64)
        # a scatter keeps only one of two states written to the same user,
        # and an out-of-range id would land on no user or the wrong one
        if np.unique(ids).shape[0] != ids.shape[0]:
            raise ValueError("user_ids must be distinct within one ingest batch")
        if ids.shape[0] and not (0 <= ids.min() and ids.max() < self.num_users):
            raise ValueError(f"user_ids must lie in [0, {self.num_users})")
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.num_shards})")
        chunks = torch.as_tensor(chunks, dtype=torch.float32, device=self.device)
        if chunks.shape[1] == 0:
            # nothing to absorb; in eviction mode a reset here would wipe a
            # retained bucket without moving the cursor
            return
        idx = self._ids(ids)
        engine, lanes = self.engine, self._lanes.flatten()
        if self.window is None:
            if t0 is None:
                t0 = torch.zeros(ids.shape, dtype=torch.int32, device=self.device)
            sub = self._lanes.unflatten([x[shard].index_select(0, idx) for x in lanes])
            new = engine.update_batch(sub, chunks, t0)
            for x, v in zip(lanes, new.flatten()):
                x[shard].index_copy_(0, idx, v)
            return
        if t0 is not None:
            raise ValueError("eviction mode owns the global cursor; t0 is not accepted")
        c = chunks.shape[1]
        if c > self.bucket_len:
            raise ValueError(f"chunk length {c} exceeds the eviction bucket span "
                             f"{self.bucket_len} (= window / num_buckets)")
        starts = self._counts[ids]  # host cursor: no device sync
        if np.any(starts // self.bucket_len != (starts + c - 1) // self.bucket_len):
            raise ValueError("chunk would straddle an eviction bucket boundary; chunks "
                             f"must tile the {self.bucket_len}-sample bucket grid")
        bucket = self._ids((starts // self.bucket_len) % self.num_buckets)
        sub = self._lanes.unflatten([x[bucket, idx] for x in lanes])
        start = torch.as_tensor(starts, dtype=torch.int32, device=self.device)
        # a cursor on a bucket boundary starts a new span: the slot still
        # holds the span from num_buckets spans ago, reset it (the eviction)
        fresh = engine.init_batch(ids.shape[0], t0=start)
        boundary = torch.as_tensor(starts % self.bucket_len == 0, device=self.device)
        cur = sub.unflatten([torch.where(_bcast(boundary, s), f, s)
                             for s, f in zip(sub.flatten(), fresh.flatten())])
        new = engine.update_batch(cur, chunks, start)
        for x, v in zip(lanes, new.flatten()):
            x.index_put_((bucket, idx), v)
        self._counts[ids] += c

    # -- read path ----------------------------------------------------------
    def partial(self, user_id: int) -> PartialState:
        """The user's merged cross-lane PartialState."""
        batched = self.partials_batch([user_id])
        return batched.unflatten([x[0] for x in batched.flatten()])

    def partials_batch(self, user_ids: Sequence[int]) -> PartialState:
        """Merged cross-lane states of many users (a leading
        ``len(user_ids)`` axis): one gather of every lane of every requested
        user, then the lane axis folded by ``num_lanes - 1`` batched merges."""
        idx = self._ids(user_ids)
        stacked = self._lanes.unflatten([x[:, idx] for x in self._lanes.flatten()])
        if self.window is not None:
            # merges combine adjacent segments: order each user's ring slots
            # by global start, empty slots (neutral) last
            key = torch.where(stacked.length > 0, stacked.t0, _INT32_MAX)
            order = torch.argsort(key, dim=0, stable=True)
            stacked = stacked.unflatten([torch.take_along_dim(x, _bcast(order, x), dim=0)
                                         for x in stacked.flatten()])
        lanes = stacked.flatten()
        acc = stacked.unflatten([x[0] for x in lanes])
        for s in range(1, self._num_lanes):
            acc = self.engine.merge_batch(acc, stacked.unflatten([x[s] for x in lanes]))
        return acc

    def query(self, user_id: int, finalizer: Callable, *args, **kwargs) -> Any:
        """One user's estimate: ``finalizer(engine, merged state, ...)``."""
        return finalizer(self.engine, self.partial(user_id), *args, **kwargs)

    def query_batch(self, user_ids: Sequence[int], finalizer: Callable, *args,
                    **kwargs) -> Any:
        """Many users' estimates: ``finalizer(engine, merged states, ...)``,
        the states with a leading user axis (the finalizer must take it, as
        `StatPlan.finalize_batch` does)."""
        return finalizer(self.engine, self.partials_batch(user_ids), *args, **kwargs)

    def lengths(self) -> torch.Tensor:
        """(num_users,) int32 samples ingested per user (evicted ones too)."""
        if self.window is None:
            return self._lanes.length.sum(0, dtype=torch.int32)
        return torch.as_tensor(self._counts, dtype=torch.int32, device=self.device)

    def retained_lengths(self) -> torch.Tensor:
        """(num_users,) samples a query covers now: all in growing mode; in
        eviction mode the ring-retained span (``window - bucket_len < w <=
        window`` once the ring has wrapped)."""
        if self.window is None:
            return self.lengths()
        cnt = self._counts
        evicted = np.maximum((cnt - 1) // self.bucket_len - (self.num_buckets - 1),
                             0) * self.bucket_len
        return torch.as_tensor(np.where(cnt > 0, cnt - evicted, 0), dtype=torch.int32,
                               device=self.device)
