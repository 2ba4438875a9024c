"""SeriesFrame -- the lazy front door to every read path (port of the array
and chunk placements of `repro.core.frame`).

A :class:`SeriesFrame` holds a data placement (a materialized array, or a
stream of chunks) plus deferred estimator requests.  ``.autocovariance``,
``.yule_walker``, ``.arma``, ``.moments``, ``.welch`` and ``.map_reduce``
each return a :class:`Deferred` handle and read nothing; ``.collect()``
compiles everything pending into ONE fused `StatPlan` and walks the data
once; ``.append(chunk)`` folds new samples into the carried state, so a
re-collect costs one walk of the new samples only.  Results are memoized
until the next append.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .backend import BackendSpec, get_backend, resolve_device
from .plan import (StatPlan, StatRequest, arma_request, autocovariance_request,
                   kernel_request, moments_request, welch_request, yule_walker_request)

__all__ = ["SeriesFrame", "Deferred", "as_series"]


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
