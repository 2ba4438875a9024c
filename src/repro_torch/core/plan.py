"""Fused statistics plans: one data traversal for N weak-memory estimators
(port of `repro.core.plan`).

A :class:`StatPlan` compiles estimator requests into one
:class:`~repro_torch.core.streaming.StreamingEngine` whose chunk kernel
serves every member from the same chunk and whose carried state is the
product monoid of the members' states.  The halo is sized to the widest
member; a narrower member recovers the starts it misses from the carried
tail at finalize (lag, moments and Welch tail recovery below).

Whenever two or more primitive families (lag sums, moment windows, Welch
segments) are members, each chunk-kernel call is ONE ``fused_plan_update``
-- on the "cuda" backend one launch of the megakernel.  Single-family plans
keep the narrower primitives.  ``forecast`` and ``anomaly`` requests arrive
with the port's forecast slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .backend import BackendSpec, get_backend, resolve_device
from .mapreduce import tree_map, tree_sum
from .streaming import PartialState, StreamingEngine

__all__ = ["StatPlan", "fused_engine", "analyze", "autocovariance_request",
           "yule_walker_request", "arma_request", "moments_request", "welch_request",
           "kernel_request", "forecast_request", "anomaly_request"]


# ---------------------------------------------------------------- requests
@dataclasses.dataclass(frozen=True)
class StatRequest:
    """One estimator request inside a plan (see the factory functions)."""

    kind: str
    name: Optional[str] = None
    params: Tuple = ()

    def default_name(self) -> str:
        return self.kind


def autocovariance_request(max_lag: int, normalization: str = "paper",
                           name: Optional[str] = None) -> StatRequest:
    """gamma(0..max_lag) -- shares the plan's lagged-sum entry."""
    return StatRequest("autocovariance", name, (max_lag, normalization))


def yule_walker_request(p: int, normalization: str = "standard",
                        name: Optional[str] = None) -> StatRequest:
    """Order-p AR fit (A, Sigma) -- shares the plan's lagged-sum entry."""
    return StatRequest("yule_walker", name, (p, normalization))


def arma_request(p: int, q: int, m: Optional[int] = None,
                 name: Optional[str] = None) -> StatRequest:
    """ARMA(p, q) fit (A, B, Sigma) from lags up to max(m or p+q, p+q)."""
    return StatRequest("arma", name, (p, q, m))


def moments_request(window: int, name: Optional[str] = None) -> StatRequest:
    """Aggregate windowed moments {"mean", "var", "count"}."""
    return StatRequest("moments", name, (window,))


def welch_request(nperseg: int = 256, overlap: Optional[int] = None, fs: float = 1.0,
                  name: Optional[str] = None) -> StatRequest:
    """Welch PSD (freqs, psd) from stride-aligned segments of the shared
    traversal."""
    return StatRequest("welch", name, (nperseg, overlap, fs))


def kernel_request(name: str, chunk_kernel: Callable, h_right: int, h_left: int = 0,
                   stride: int = 1, takes_offset: bool = False,
                   finalizer: Optional[Callable] = None) -> StatRequest:
    """Generic member: any chunk kernel ``(y_padded, start_mask[, z0])``.
    ``finalizer(member, state, raw_stat)`` may correct for the fused halo;
    by default the raw stat is returned (copied)."""
    return StatRequest("kernel", name,
                       (chunk_kernel, h_right, h_left, stride, takes_offset, finalizer))


def forecast_request(*args, **kwargs) -> StatRequest:
    raise NotImplementedError("forecast members are not ported yet (ROADMAP Queue A item 4)")


def anomaly_request(*args, **kwargs) -> StatRequest:
    raise NotImplementedError("anomaly members are not ported yet (ROADMAP Queue A item 4)")


# ---------------------------------------------------------------- members
@dataclasses.dataclass
class _Member:
    name: str
    window: int
    stride: int
    traverse: Optional[Callable]  # (y, mask, z0) -> stat, or None (shared entry)
    finalize: Optional[Callable]  # state -> result


@dataclasses.dataclass(frozen=True)
class _WelchInfo:
    name: str
    nperseg: int
    step: int
    scale: torch.Tensor
    taper: torch.Tensor


class _PlanGroup:
    """One fused traversal: members compiled onto a shared StreamingEngine."""

    def __init__(self, requests: Sequence[StatRequest], names, d: int, backend,
                 stride: int = 1, stage_dtype: Optional[str] = None,
                 compensated: bool = False, device="cuda"):
        self.backend = backend
        self.d = d
        self.stride = stride
        self.stage_dtype = stage_dtype
        self.compensated = compensated
        self.device = resolve_device(device)
        self.members: list = []
        self._welch_info: list = []

        moment_windows = {}
        traverse_extra = []
        max_lag = 0
        windows = [1]
        for req, name in zip(requests, names):
            if req.kind == "autocovariance":
                H, normalization = req.params
                max_lag = max(max_lag, H)
                windows.append(H + 1)
                self.members.append(
                    _Member(name, H + 1, 1, None, self._autocov_finalizer(H, normalization)))
            elif req.kind == "yule_walker":
                p, normalization = req.params
                max_lag = max(max_lag, p)
                windows.append(p + 1)
                self.members.append(
                    _Member(name, p + 1, 1, None, self._yw_finalizer(p, normalization)))
            elif req.kind == "arma":
                p, q, m = req.params
                m = max(m if m is not None else p + q, p + q)
                max_lag = max(max_lag, m)
                windows.append(m + 1)
                self.members.append(_Member(name, m + 1, 1, None, self._arma_finalizer(p, q, m)))
            elif req.kind == "moments":
                (w,) = req.params
                moment_windows.setdefault(w, f"w{w}")
                windows.append(w)
                self.members.append(_Member(name, w, 1, None, self._moments_finalizer(w)))
            elif req.kind == "welch":
                nperseg, overlap, fs = req.params
                overlap = nperseg // 2 if overlap is None else overlap
                if not 0 <= overlap < nperseg:
                    raise ValueError(f"need 0 <= overlap < nperseg, got {overlap}/{nperseg}")
                windows.append(nperseg)
                member = self._compile_welch(name, nperseg, nperseg - overlap, fs)
                traverse_extra.append(member)
                self.members.append(member)
            elif req.kind == "kernel":
                ck, h_right, h_left, k_stride, takes_offset, finalizer = req.params
                w = h_left + 1 + h_right
                windows.append(w)
                member = self._compile_kernel(name, ck, w, k_stride, takes_offset, finalizer)
                traverse_extra.append(member)
                self.members.append(member)
            else:  # pragma: no cover - guarded by _group_requests
                raise ValueError(f"unknown request kind {req.kind!r}")

        self.window = max(windows)
        self.max_lag = max_lag
        self.has_lagged = any(r.kind in ("autocovariance", "yule_walker", "arma")
                              for r in requests)
        self.moment_windows = dict(sorted(moment_windows.items()))
        self._traverse_extra = traverse_extra
        welch_names = {info.name for info in self._welch_info}
        self._non_welch_extra = [m for m in traverse_extra if m.name not in welch_names]
        # The megakernel engages when >= 2 primitive families share the
        # traversal and the backend implements fused_plan_update.
        families = (int(self.has_lagged) + int(bool(self.moment_windows))
                    + int(bool(self._welch_info)))
        self._use_megakernel = families >= 2 and hasattr(backend, "fused_plan_update")

        self.engine = StreamingEngine(
            d=d, h_left=0, h_right=self.window - 1, chunk_kernel=self._fused_chunk_kernel,
            stride=stride, backend=backend, kernel_takes_offset=True,
            compensated=compensated,
            stat_zeros=None if self._non_welch_extra else self._stat_zeros,
            device=self.device,
        )

    def _stat_zeros(self, device) -> dict:
        """Zeros with the chunk kernel's output structure, derived from the
        members (no kernel call)."""
        z = lambda *s: torch.zeros(s, device=device)
        out = {}
        if self.has_lagged:
            out["lagged"] = z(self.max_lag + 1, self.d, self.d)
        if self.moment_windows:
            out["moments"] = {key: {"sums": z(2, self.d), "count": z()}
                              for key in self.moment_windows.values()}
        for info in self._welch_info:
            out[info.name] = {"psd": z(info.nperseg // 2 + 1, self.d), "n_seg": z()}
        return out

    def _stat_entry(self, state: PartialState, key: str):
        """One member's slot of ``state.stat``, error companion folded in."""
        entry = state.stat[key]
        if state.stat_err is None:
            return entry
        return tree_map(lambda s, e: s + e, entry, state.stat_err[key])

    # -- the one traversal -------------------------------------------------
    def _fused_chunk_kernel(self, y: torch.Tensor, mask: torch.Tensor, z0: torch.Tensor):
        be = self.backend
        out = {}
        if self._use_megakernel:
            # ONE backend call -- one megakernel launch on "cuda" -- serves
            # the lagged entry, every moment window and every Welch member.
            ws = tuple(self.moment_windows)
            lag, mom, psds, n_segs = be.fused_plan_update(
                y, mask, z0, self.max_lag, ws,
                tuple(i.nperseg for i in self._welch_info),
                tuple(i.step for i in self._welch_info),
                tuple(i.taper for i in self._welch_info),
                stage_dtype=self.stage_dtype,
            )
            if self.has_lagged:
                out["lagged"] = lag
            if ws:
                count = mask.float().sum()
                out["moments"] = {key: {"sums": mom[k], "count": count}
                                  for k, key in enumerate(self.moment_windows.values())}
            for info, psd, n_seg in zip(self._welch_info, psds, n_segs):
                out[info.name] = {"psd": psd * info.scale, "n_seg": n_seg}
            for member in self._non_welch_extra:
                out[member.name] = member.traverse(y, mask, z0)
            return out
        if self.moment_windows:
            ws = tuple(self.moment_windows)
            lag, moms = be.fused_lagged_moments(y, mask, self.max_lag, ws)
            count = mask.float().sum()
            if self.has_lagged:
                out["lagged"] = lag
            out["moments"] = {key: {"sums": moms[k], "count": count}
                              for k, key in enumerate(self.moment_windows.values())}
        elif self.has_lagged:
            out["lagged"] = be.masked_lagged_sums(y, mask, self.max_lag)
        for member in self._traverse_extra:
            out[member.name] = member.traverse(y, mask, z0)
        return out

    # -- shared tail recovery ----------------------------------------------
    def _tail_rows(self) -> torch.Tensor:
        return torch.arange(self.engine.carry, device=self.device)

    def _corrected_gamma_sums(self, state: PartialState, H: int) -> torch.Tensor:
        """Serial lag sums S(0..H): the shared entry covers starts with a
        full fused window; the missing pairs start inside the carried tail,
        recovered by one masked contraction."""
        s = self._stat_entry(state, "lagged")[: H + 1]
        carry = self.engine.carry
        if carry > 0:
            ones = torch.ones((carry,), dtype=torch.bool, device=self.device)
            s = s + self.backend.masked_lagged_sums(state.tail, ones, H)
        return s

    def _autocov_finalizer(self, H: int, normalization: str):
        from .estimators.stats import gamma_normalizer

        def fin(state: PartialState):
            s = self._corrected_gamma_sums(state, H)
            return s * gamma_normalizer(state.length, H, normalization)[:, None, None]

        return fin

    def _yw_finalizer(self, p: int, normalization: str):
        from .estimators.stats import gamma_normalizer
        from .estimators.yule_walker import yule_walker

        def fin(state: PartialState):
            s = self._corrected_gamma_sums(state, p)
            return yule_walker(s * gamma_normalizer(state.length, p, normalization)[:, None, None], p)

        return fin

    def _arma_finalizer(self, p: int, q: int, m: int):
        from .estimators.arma import fit_arma
        from .estimators.stats import gamma_normalizer

        def fin(state: PartialState):
            s = self._corrected_gamma_sums(state, m)
            return fit_arma(s * gamma_normalizer(state.length, m, "standard")[:, None, None],
                            p, q, m)

        return fin

    def _moments_finalizer(self, w: int):
        key = f"w{w}"

        def fin(state: PartialState):
            entry = self._stat_entry(state, "moments")[key]
            sums, count = entry["sums"], entry["count"]
            carry = self.engine.carry
            if carry >= w:
                # the last W_fused - w member windows, all inside the tail
                rows = self._tail_rows()
                mask = (rows >= carry - state.length) & (rows <= carry - w)
                _, mom = self.backend.fused_lagged_moments(state.tail, mask, 0, w)
                sums = sums + mom
                count = count + mask.float().sum()
            total = count * w
            m1 = sums[0] / total
            m2 = sums[1] / total
            return {"mean": m1, "var": torch.clamp(m2 - m1 * m1, min=0.0), "count": count}

        return fin

    def _compile_welch(self, name: str, nperseg: int, step: int, fs: float):
        from .estimators.spectral import _one_sided, hann_window, welch_chunk_kernel

        w = hann_window(nperseg, self.device)
        scale = 1.0 / (fs * torch.sum(w**2))
        ck = welch_chunk_kernel(nperseg, step, scale, self.backend, self.device)
        self._welch_info.append(_WelchInfo(name, nperseg, step, scale, w))

        def fin(state: PartialState):
            entry = self._stat_entry(state, name)
            carry = self.engine.carry
            if carry >= nperseg:
                rows = self._tail_rows()
                mask = (rows >= carry - state.length) & (rows <= carry - nperseg)
                z0 = state.t0 + state.length - carry
                entry = tree_sum(entry, ck(state.tail, mask, z0))
            return _one_sided(entry["psd"] / entry["n_seg"], nperseg, fs)

        return _Member(name, nperseg, step, ck, fin)

    def _compile_kernel(self, name, ck, w, stride, takes_offset, finalizer):
        traverse = ck if takes_offset else (lambda y, mask, z0: ck(y, mask))
        member = _Member(name, w, stride, traverse, None)

        def fin(state: PartialState):
            raw = self._stat_entry(state, name)
            if finalizer is None:
                return tree_map(torch.clone, raw)
            return finalizer(member, state, raw)

        member.finalize = fin
        return member

    def finalize(self, state: PartialState) -> dict:
        return {m.name: m.finalize(state) for m in self.members}


def _group_requests(requests: Sequence[StatRequest]):
    """Group 0 holds everything fusable into one traversal; generic kernels
    that are not offset-aware and have stride > 1 get one group per stride."""
    named, seen = [], {}
    for req in requests:
        if not isinstance(req, StatRequest):
            raise TypeError(f"requests must be StatRequest (see the *_request "
                            f"factories), got {type(req).__name__}")
        base = req.name or req.default_name()
        seen[base] = seen.get(base, 0) + 1
        named.append((req, base if seen[base] == 1 else f"{base}_{seen[base]}"))
    groups: dict = {}
    for req, name in named:
        stride = 1
        if req.kind == "kernel":
            _, _, _, k_stride, takes_offset, _ = req.params
            if not takes_offset:
                stride = k_stride
        groups.setdefault(stride, []).append((req, name))
    return [(k, groups[k]) for k in sorted(groups)]


class StatPlan:
    """N estimator requests compiled into (almost always) one traversal.

    The monoid methods mirror `StreamingEngine` over a tuple of group
    states; ``finalize`` returns ``{request_name: result}``.
    """

    def __init__(self, requests: Sequence[StatRequest], d: int, backend: BackendSpec = None,
                 stage_dtype: Optional[str] = None, compensated: bool = False,
                 device="cuda"):
        if not requests:
            raise ValueError("a plan needs at least one request")
        self.device = resolve_device(device)
        self.backend = get_backend(backend, self.device)
        self.d = d
        self.stage_dtype = stage_dtype
        self.compensated = compensated
        self.groups = [
            _PlanGroup([r for r, _ in grp], [n for _, n in grp], d, self.backend, stride,
                       stage_dtype=stage_dtype, compensated=compensated, device=self.device)
            for stride, grp in _group_requests(requests)
        ]
        self._finalize_cache: Optional[Tuple[tuple, dict]] = None

    @property
    def engine(self) -> StreamingEngine:
        """The fused engine of a single-group plan (every built-in request)."""
        if len(self.groups) != 1:
            raise ValueError(f"plan has {len(self.groups)} traversal groups; use the "
                             f"group-tuple API (init/update/merge) instead of .engine")
        return self.groups[0].engine

    @property
    def num_traversals(self) -> int:
        return len(self.groups)

    def init(self, t0=0):
        return tuple(g.engine.init(t0) for g in self.groups)

    def from_chunk(self, chunk: torch.Tensor, t0=0):
        return tuple(g.engine.from_chunk(chunk, t0) for g in self.groups)

    def update(self, states, chunk: torch.Tensor):
        return tuple(g.engine.update(s, chunk) for g, s in zip(self.groups, states))

    def update_donated(self, states, chunk: torch.Tensor):
        """``update`` for a caller that owns ``states`` exclusively: the
        carried states may be updated in place (see
        `StreamingEngine.update_donated`)."""
        return tuple(g.engine.update_donated(s, chunk) for g, s in zip(self.groups, states))

    def merge(self, a, b):
        return tuple(g.engine.merge(x, y) for g, x, y in zip(self.groups, a, b))

    def consume(self, states, chunks):
        """Fold a sequence (or (k, c, d) stack) of chunks, one update each."""
        return tuple(g.engine.consume(s, chunks) for g, s in zip(self.groups, states))

    def finalize(self, states, cache: bool = True) -> dict:
        """``{request_name: result}``; repeated queries against the same
        states tuple return the memoized results (identity-keyed)."""
        if (cache and self._finalize_cache is not None
                and len(self._finalize_cache[0]) == len(states)
                and all(a is b for a, b in zip(self._finalize_cache[0], states))):
            return dict(self._finalize_cache[1])
        out = {}
        for g, s in zip(self.groups, states):
            out.update(g.finalize(s))
        if cache:
            self._finalize_cache = (tuple(states), out)
        return dict(out)


def fused_engine(requests: Sequence[StatRequest], d: int, backend: BackendSpec = None,
                 stage_dtype: Optional[str] = None, compensated: bool = False,
                 device="cuda") -> StatPlan:
    """Compile requests into a fused :class:`StatPlan`."""
    return StatPlan(requests, d, backend, stage_dtype=stage_dtype, compensated=compensated,
                    device=device)


def analyze(series, requests: Sequence[StatRequest], backend: BackendSpec = None,
            chunk_size: Optional[int] = None, device="cuda") -> dict:
    """Serve N estimator requests from one read of ``series`` ((n,) or
    (n, d)): a frame over the array, or over chunks of ``chunk_size`` rows,
    collected in one fused traversal.  Returns {request_name: result}."""
    from .frame import SeriesFrame, as_series

    x = as_series(series, device)
    if chunk_size is None:
        frame = SeriesFrame.from_array(x, backend=backend, device=device)
    else:
        n = x.shape[0]
        chunks = [x[lo: min(lo + chunk_size, n)] for lo in range(0, n, chunk_size)]
        frame = SeriesFrame.from_chunks(chunks, backend=backend, device=device)
    for req in requests:
        frame._defer(req)
    return frame.collect()
