"""StreamingEstimator -- chunked ingestion over the weak-memory monoid
(port of `repro.timeseries.streaming`).

Binds a `StreamingEngine` to a stream of chunks (any iterator of (c, d)
arrays: `TimeSeriesStore.iter_chunks`, a socket, a queue) and keeps the
rolling `PartialState`; with ``batch=B`` every operation serves B
independent series at once.  A shim over the engine-mode
`repro_torch.core.frame.SeriesFrame`, which owns the carried state.
Estimates are read through the front-end finalizers
(``streaming_autocovariance``, ``streaming_yule_walker``,
``fit_arma_streaming``, ``streaming_welch``, ...) via :meth:`finalize`.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from ..core.frame import SeriesFrame
from ..core.streaming import PartialState, StreamingEngine

__all__ = ["StreamingEstimator"]


class StreamingEstimator:
    """Stateful estimator: ingest chunks, merge peers, finalize estimates.

    Args:
      engine: the estimator's streaming engine (kernel and halo; its device
        is where the state lives).
      batch: number of independent series (None: one series); batched
        chunks are (batch, c, d).
      t0: global start index (scalar, or per series (batch,)).
    """

    def __init__(self, engine: StreamingEngine, batch: Optional[int] = None, t0=0):
        self.engine = engine
        self.batch = batch
        self._frame = SeriesFrame.from_engine(engine, batch=batch, t0=t0)

    @classmethod
    def from_store(cls, engine: StreamingEngine, store, chunk_size: int) -> "StreamingEstimator":
        """Stream a `TimeSeriesStore` through the engine chunk by chunk."""
        est = cls(engine)
        est.ingest_iter(store.iter_chunks(chunk_size))
        return est

    @property
    def state(self) -> PartialState:
        return self._frame.state

    @state.setter
    def state(self, value: PartialState) -> None:
        self._frame.state = value

    def ingest(self, chunk) -> "StreamingEstimator":
        """Absorb the next chunk ((c, d), or (batch, c, d) when batched)."""
        self._frame.append(chunk)
        return self

    def ingest_iter(self, chunks: Iterable) -> "StreamingEstimator":
        for chunk in chunks:
            self.ingest(chunk)
        return self

    def consume(self, chunk_stack) -> "StreamingEstimator":
        """Absorb a (k, c, d) stack of equal-length chunks ((k, batch, c, d)
        when batched), one update each: ``ingest_iter(chunk_stack)``."""
        self._frame.consume(chunk_stack)
        return self

    def merge_from(self, other: "StreamingEstimator | PartialState") -> "StreamingEstimator":
        """Merge another partial (an adjacent segment, in any order) into
        this one."""
        state = other.state if isinstance(other, StreamingEstimator) else other
        self._frame.merge_state(state)
        return self

    def finalize(self, finalizer: Callable, *args, **kwargs) -> Any:
        """``finalizer(engine, state, *args, **kwargs)`` on the current
        state, e.g. ``est.finalize(streaming_autocovariance,
        normalization="standard")``; mapped over the series when batched."""
        return self._frame.finalize_with(finalizer, *args, **kwargs)

    @property
    def length(self):
        """Samples absorbed so far (per series when batched)."""
        return self._frame.state.length

    @property
    def backend(self):
        """The compute backend the engine's updates run through."""
        return self.engine.backend
