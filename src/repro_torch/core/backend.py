"""Compute-backend registry (port of `repro.core.backend`).

Every weak-memory estimator reduces to a handful of primitive contractions;
a :class:`Backend` supplies one implementation of each (see
:data:`PRIMITIVE_NAMES` and the protocol below).  Backends in the registry:

  ``"cuda"``   the hand-written Hopper kernels (`repro_torch.kernels`) --
               the port of ``PallasBackend`` and the default.  For CPU
               tensors each kernel wrapper runs its plain version; for CUDA
               tensors it launches the kernel or raises.
  ``"torch"``  plain PyTorch on any device -- the port of ``JnpBackend``,
               the in-package oracle.  Segment power and cross-spectra use
               the taper-folded twiddle contraction (as the reference's
               ``ref.py`` oracle), never a library FFT; the banded matvec
               sums shifted products and is differentiated by autograd.

  ``"auto"``   :class:`AutoBackend`: per call, "cuda" from the primitive's
               measured crossover size on (`repro_torch.core.calibrate`),
               "torch" below it.

The default stays ``"cuda"``, where the reference's is ``"auto"``: on the
card the plain versions serve nothing unless a caller asks for them, so
``"auto"`` is opt-in (``backend="auto"`` or :func:`set_default_backend`).
:class:`CircuitBreakerBackend` is the one fallback: opt-in too, it is
never wrapped around a default path, every call it serves by the
fallback is counted (:meth:`CircuitBreakerBackend.breaker_metrics`, which
`repro_torch.serving.gateway.StatsGateway.health` reports), and a "torch"
fallback serves CPU tensors only.
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, Optional, Protocol, Union, runtime_checkable

import torch

from ..kernels._build import DeviceFault
from ..kernels.banded_matvec import ops as bm
from ..kernels.banded_matvec.ref import banded_matvec_ref
from ..kernels.fused_plan import ops as fp
from ..kernels.fused_plan.ref import fused_plan_update_ref
from ..kernels.segment_dft import ops as sd
from ..kernels.segment_dft.ref import segment_csd_ref, segment_dft_power_ref
from ..kernels.window_stats import ops as ws
from ..kernels.window_stats.ref import (fused_lag_moments_ref, lagged_sums_ref,
                                        masked_lagged_sums_ref, window_moments_ref)

__all__ = ["Backend", "TorchBackend", "CudaBackend", "AutoBackend", "CircuitBreakerBackend",
           "PRIMITIVE_NAMES", "register_backend", "get_backend", "list_backends",
           "set_default_backend", "resolve_device"]

BackendSpec = Union[None, str, "Backend"]

PRIMITIVE_NAMES: tuple = (
    "lagged_sums",
    "masked_lagged_sums",
    "windowed_moments",
    "segment_fft_power",
    "segment_csd",
    "banded_matvec",
    "fused_lagged_moments",
    "fused_plan_update",
)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no GPU is
    present -- the port never continues on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


@runtime_checkable
class Backend(Protocol):
    """The primitive contractions every weak-memory estimator reduces to."""

    name: str

    def lagged_sums(self, x: torch.Tensor, max_lag: int) -> torch.Tensor:
        """(n, d) -> (max_lag+1, d, d): S(h) = sum_{k=0}^{n-1-h} x_k x_{k+h}^T."""
        ...

    def masked_lagged_sums(self, y_padded: torch.Tensor, start_mask: torch.Tensor,
                           max_lag: int) -> torch.Tensor:
        """sum_{s: start_mask[s]} y_s y_{s+h}^T -> (max_lag+1, d, d)."""
        ...

    def windowed_moments(self, x: torch.Tensor, window: int) -> torch.Tensor:
        """(n, d) -> (n-window+1, 2, d) of per-window [sum x, sum x^2]."""
        ...

    def segment_fft_power(self, segments: torch.Tensor, taper: torch.Tensor,
                          detrend: bool = True) -> torch.Tensor:
        """(..., S, W, d) segments -> (..., S, W//2+1, d) per-segment
        |rfft|^2; leading axes (tenants) are problems of S segments each."""
        ...

    def segment_csd(self, segments: torch.Tensor, taper: torch.Tensor,
                    detrend: bool = True) -> torch.Tensor:
        """(..., S, W, d) -> (..., S, W//2+1, d, d) complex cross-spectral
        products."""
        ...

    def banded_matvec(self, diags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(d, 2b+1) stacked diagonals, x (..., d) -> A x (..., d)."""
        ...

    def fused_lagged_moments(self, y_padded: torch.Tensor, start_mask: torch.Tensor,
                             max_lag: int, window: "int | tuple") -> tuple:
        """One traversal -> (lag (max_lag+1, d, d), mom (2, d) | (K, 2, d))."""
        ...

    def fused_plan_update(self, y_padded, start_mask, z0, max_lag: int,
                          windows: tuple = (), seg_lens: tuple = (),
                          seg_steps: tuple = (), tapers: tuple = (),
                          detrend: bool = True, stage_dtype=None) -> tuple:
        """Every fused-plan member family from one traversal:
        (lag, mom | None, psds, n_segs)."""
        ...


def _segments_folded(fn, segments, taper, detrend):
    """``fn`` on (S, W, d) segments, with the leading problem axes of
    (..., S, W, d) folded into S for one call and unfolded from its
    output."""
    if segments.ndim <= 3:
        return fn(segments, taper, detrend)
    out = fn(segments.reshape((-1,) + segments.shape[-2:]), taper, detrend)
    return out.reshape(segments.shape[:-2] + out.shape[1:])


class TorchBackend:
    """Plain PyTorch primitives on any device -- the correctness oracle.

    All accumulation happens in float32 whatever the input dtype.
    """

    name = "torch"

    def lagged_sums(self, x, max_lag):
        return lagged_sums_ref(x, max_lag)

    def masked_lagged_sums(self, y_padded, start_mask, max_lag):
        return masked_lagged_sums_ref(y_padded, start_mask, max_lag)

    def windowed_moments(self, x, window):
        """The reference's formula: one float32 cumulative sum."""
        return window_moments_ref(x, window, torch.float32)

    def segment_fft_power(self, segments, taper, detrend=True):
        return _segments_folded(segment_dft_power_ref, segments, taper, detrend)

    def segment_csd(self, segments, taper, detrend=True):
        return _segments_folded(segment_csd_ref, segments, taper, detrend)

    def banded_matvec(self, diags, x):
        return banded_matvec_ref(diags.float(), x.float())

    def fused_lagged_moments(self, y_padded, start_mask, max_lag, window):
        return fused_lag_moments_ref(y_padded, start_mask, max_lag, window)

    def fused_plan_update(self, y_padded, start_mask, z0, max_lag, windows=(),
                          seg_lens=(), seg_steps=(), tapers=(), detrend=True,
                          stage_dtype=None):
        """Composition oracle: the megakernel's contract restated through
        the other primitives; ``stage_dtype`` rounds the series through the
        staging dtype first, as the kernel path does."""
        return fused_plan_update_ref(y_padded, start_mask, z0, max_lag, windows,
                                     seg_lens, seg_steps, tapers, detrend, stage_dtype)


class CudaBackend:
    """The hand-written Hopper kernels (port of ``PallasBackend``).

    Every primitive runs one of the port's CUDA kernels on CUDA tensors:
    ``lagged_sums`` and ``masked_lagged_sums`` the cross-window-stats kernel,
    ``fused_lagged_moments`` and ``fused_plan_update`` their fused kernels,
    ``windowed_moments`` the rolling-moments kernel, ``segment_fft_power``
    and ``segment_csd`` the segment-DFT kernels, and ``banded_matvec`` the
    banded kernel, differentiable through its autograd backward.

    ``block_t`` overrides the megakernel's Welch candidate tile (default:
    the active calibration table's, else the built-in block; see
    `repro_torch.kernels.tiling.resolve_block`) -- the block tuner's handle.
    """

    name = "cuda"

    def __init__(self, block_t: Optional[int] = None):
        self.block_t = block_t

    def lagged_sums(self, x, max_lag):
        return ws.lagged_sums(x, max_lag)

    def masked_lagged_sums(self, y_padded, start_mask, max_lag):
        return ws.masked_lagged_sums(y_padded, start_mask, max_lag)

    def windowed_moments(self, x, window):
        return ws.windowed_moments(x, window)

    def segment_fft_power(self, segments, taper, detrend=True):
        return _segments_folded(sd.segment_fft_power, segments, taper, detrend)

    def segment_csd(self, segments, taper, detrend=True):
        return _segments_folded(sd.segment_csd, segments, taper, detrend)

    def banded_matvec(self, diags, x):
        """x (..., d): the leading axes fold into the kernel's rows, no
        transpose."""
        return bm.banded_matvec_rows(diags, x)

    def fused_lagged_moments(self, y_padded, start_mask, max_lag, window):
        return ws.fused_lagged_moments(y_padded, start_mask, max_lag, window)

    def fused_plan_update(self, y_padded, start_mask, z0, max_lag, windows=(),
                          seg_lens=(), seg_steps=(), tapers=(), detrend=True,
                          stage_dtype=None):
        return fp.fused_plan_update(y_padded, start_mask, z0, max_lag, windows,
                                    seg_lens, seg_steps, tapers, detrend,
                                    stage_dtype=stage_dtype, block_t=self.block_t)


class AutoBackend:
    """Per-call dispatch by *measured* crossover (port of the reference's
    ``AutoBackend``).

    Each primitive routes to "cuda" once its problem size reaches the
    primitive's crossover threshold in the calibration table
    (`repro_torch.core.calibrate`), else to "torch".  A call is sized per
    problem, on its trailing axes -- the port's primitives take leading
    tenant or block axes explicitly, where the reference's see one problem
    under ``vmap``: rows ``start_mask.shape[-1]`` (or ``x.shape[-2]``) for
    the windowed contractions, staged samples ``segments.shape[-3] *
    segments.shape[-2]`` for the segment DFT, the banded dimension
    ``diags.shape[0]`` for the matvec.  A session tick of a few hundred rows
    for each of 65,536 tenants is sized as a few hundred rows.

    The table resolves lazily at the first dispatch: a cached table of this
    platform and card, else a fresh measurement on "cuda" (persisted), else
    the built-in defaults.  ``routes`` counts the dispatches by (primitive,
    backend name, size).  Refresh the policy with
    ``get_backend("auto").set_table(calibrate())``.
    """

    name = "auto"

    def __init__(self, torch_backend: Optional[Backend] = None,
                 cuda_backend: Optional[Backend] = None, table=None):
        self._torch = torch_backend if torch_backend is not None else TorchBackend()
        self._cuda = cuda_backend if cuda_backend is not None else CudaBackend()
        self._table = table
        self.routes: collections.Counter = collections.Counter()

    @property
    def table(self):
        """The `repro_torch.core.calibrate.CalibrationTable` in use (resolved
        on first access: cache > measurement on "cuda" > built-in)."""
        if self._table is None:
            from .calibrate import resolve_table

            self._table = resolve_table()
        return self._table

    def set_table(self, table) -> None:
        """Swap the crossover table (e.g. a fresh ``calibrate()`` result) and
        install it process-wide, so the kernels' tile resolution reads the
        same table the dispatch uses."""
        self._table = table
        from .calibrate import set_active_table

        set_active_table(table)

    def _pick(self, primitive: str, size: int) -> Backend:
        be = self._cuda if size >= self.table.crossover(primitive) else self._torch
        self.routes[(primitive, be.name, int(size))] += 1
        return be

    def lagged_sums(self, x, max_lag):
        return self._pick("lagged_sums", x.shape[-2]).lagged_sums(x, max_lag)

    def masked_lagged_sums(self, y_padded, start_mask, max_lag):
        return self._pick("masked_lagged_sums", start_mask.shape[-1]).masked_lagged_sums(
            y_padded, start_mask, max_lag)

    def windowed_moments(self, x, window):
        return self._pick("windowed_moments", x.shape[-2]).windowed_moments(x, window)

    def segment_fft_power(self, segments, taper, detrend=True):
        staged = segments.shape[-3] * segments.shape[-2]
        return self._pick("segment_fft_power", staged).segment_fft_power(segments, taper,
                                                                         detrend)

    def segment_csd(self, segments, taper, detrend=True):
        staged = segments.shape[-3] * segments.shape[-2]
        return self._pick("segment_csd", staged).segment_csd(segments, taper, detrend)

    def banded_matvec(self, diags, x):
        return self._pick("banded_matvec", diags.shape[0]).banded_matvec(diags, x)

    def fused_lagged_moments(self, y_padded, start_mask, max_lag, window):
        return self._pick("fused_lagged_moments", start_mask.shape[-1]).fused_lagged_moments(
            y_padded, start_mask, max_lag, window)

    def fused_plan_update(self, y_padded, start_mask, z0, max_lag, windows=(),
                          seg_lens=(), seg_steps=(), tapers=(), detrend=True,
                          stage_dtype=None):
        return self._pick("fused_plan_update", start_mask.shape[-1]).fused_plan_update(
            y_padded, start_mask, z0, max_lag, windows, seg_lens, seg_steps, tapers,
            detrend, stage_dtype=stage_dtype)


def _all_on_cpu(tree) -> bool:
    """Every tensor in ``tree`` (nested tuples, lists, dicts) lies on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.device.type == "cpu"
    if isinstance(tree, dict):
        return all(_all_on_cpu(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return all(_all_on_cpu(v) for v in tree)
    return True


def _device_fault(e: Exception) -> bool:
    """A sticky CUDA error: the context is lost and every later call on it
    fails, the fallback's included."""
    return isinstance(e, (DeviceFault, getattr(torch, "AcceleratorError", DeviceFault)))


class CircuitBreakerBackend:
    """Self-healing dispatch: quarantine a raising primitive, keep serving
    (port of the reference's ``CircuitBreakerBackend``).

    Wraps a ``primary`` backend (default "cuda") and a ``fallback`` (default
    "torch").  Each primitive carries its own breaker:

      * **closed** (healthy): dispatch goes to the primary, after the
        ``backend.<primitive>`` chaos site fires (`repro_torch.runtime.
        chaos`).  What the call raises -- a failed kernel build, an
        injected fault, a launch argument the kernel refuses -- is caught,
        the call is served by the fallback, and after ``trip_after``
        consecutive failures the breaker **opens**;
      * **open** (quarantined): the next ``cooldown_calls`` dispatches of the
        primitive go straight to the fallback; the primary is not tried;
      * **half-open** (probing): once the cooldown is spent, one dispatch
        probes the primary.  Success closes the breaker (a recovery);
        failure reopens it for another cooldown.

    The cooldown is counted in dispatch calls, not wall time, so a chaos
    schedule replays deterministically.  Every trip, recovery, probe and
    fallback call is counted per primitive (:meth:`breaker_metrics`);
    `repro_torch.serving.gateway.StatsGateway.health` reports them when the
    served session runs on a breaker.

    A "torch" fallback serves CPU tensors only: the plain versions never
    serve the card's tensors.  With a tensor off the CPU, a failure of the
    primary is counted (it still trips the breaker) and re-raised, and an
    open breaker raises instead of serving; on the card, give a fallback
    that launches kernels (``CudaBackend()``, bitwise the primary) to keep
    serving through a fault.

    A sticky CUDA device fault (an illegal address, a device-side assert,
    a launch failure) is NOT caught: it surfaces at some later
    synchronisation, not necessarily in the call that caused it, and it
    leaves the process's CUDA context unusable, so the fallback on the same
    card would fail too.  It propagates to the caller; the process has to
    restart (and a gateway resumes from its newest intact checkpoint).
    """

    name = "breaker"

    def __init__(self, primary: Optional[Backend] = None, fallback: Optional[Backend] = None,
                 trip_after: int = 1, cooldown_calls: int = 8):
        if trip_after < 1 or cooldown_calls < 1:
            raise ValueError("trip_after and cooldown_calls must be >= 1")
        self._primary = primary if primary is not None else CudaBackend()
        self._fallback = fallback if fallback is not None else TorchBackend()
        self.trip_after = trip_after
        self.cooldown_calls = cooldown_calls
        self._state: Dict[str, dict] = {}

    def _st(self, primitive: str) -> dict:
        st = self._state.get(primitive)
        if st is None:
            st = self._state[primitive] = {
                "state": "closed",
                "consecutive_failures": 0,
                "cooldown_left": 0,
                "trips": 0,
                "recoveries": 0,
                "probes": 0,
                "primary_calls": 0,
                "fallback_calls": 0,
                "last_error": None,
            }
        return st

    def _dispatch(self, primitive: str, *args, **kwargs):
        from ..runtime import chaos

        st = self._st(primitive)
        plain_refused = self._fallback.name == "torch" and not _all_on_cpu((args, kwargs))
        if st["state"] == "open":
            st["cooldown_left"] -= 1
            if st["cooldown_left"] > 0:
                if plain_refused:
                    raise RuntimeError(f"{primitive}: the circuit breaker is open and its "
                                       f"\"torch\" fallback serves CPU tensors only")
                st["fallback_calls"] += 1
                return getattr(self._fallback, primitive)(*args, **kwargs)
            st["state"] = "half-open"  # cooldown spent: this call probes
            st["probes"] += 1
        try:
            chaos.fire(f"backend.{primitive}")
            out = getattr(self._primary, primitive)(*args, **kwargs)
        except Exception as e:
            if _device_fault(e):
                raise
            st["consecutive_failures"] += 1
            st["last_error"] = repr(e)
            if st["state"] == "half-open" or st["consecutive_failures"] >= self.trip_after:
                if st["state"] == "closed":
                    st["trips"] += 1  # count closed -> open transitions only
                st["state"] = "open"
                st["cooldown_left"] = self.cooldown_calls
            if plain_refused:
                raise
            st["fallback_calls"] += 1
            return getattr(self._fallback, primitive)(*args, **kwargs)
        if st["state"] == "half-open":
            st["recoveries"] += 1
        st["state"] = "closed"
        st["consecutive_failures"] = 0
        st["primary_calls"] += 1
        return out

    def __getattr__(self, name: str):
        # one wrapper per primitive, bound lazily: a primitive added to the
        # protocol is covered without touching the breaker
        if name in PRIMITIVE_NAMES:
            fn = functools.partial(self._dispatch, name)
            object.__setattr__(self, name, fn)
            return fn
        raise AttributeError(f"{type(self).__name__!s} object has no attribute {name!r}")

    def breaker_metrics(self) -> dict:
        """Per-primitive breaker state plus totals: trips, recoveries,
        probes, primary and fallback calls, the last primary error."""
        per = {k: dict(v) for k, v in sorted(self._state.items())}
        return {
            "primitives": per,
            "trips": sum(v["trips"] for v in per.values()),
            "recoveries": sum(v["recoveries"] for v in per.values()),
            "fallback_calls": sum(v["fallback_calls"] for v in per.values()),
            "open": sorted(k for k, v in per.items() if v["state"] != "closed"),
        }

    def reset(self, primitive: Optional[str] = None) -> None:
        """Operator override: forget breaker state (one primitive or all)."""
        if primitive is None:
            self._state.clear()
        else:
            self._state.pop(primitive, None)


_REGISTRY: Dict[str, Backend] = {"cuda": CudaBackend(), "torch": TorchBackend(),
                                 "auto": AutoBackend()}
_DEFAULT = "cuda"


def register_backend(name: str, backend: Backend) -> None:
    """Add (or replace) a named backend."""
    _REGISTRY[name] = backend


def list_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


def set_default_backend(name: str) -> None:
    """Change what ``backend=None`` resolves to (deployment-wide policy)."""
    global _DEFAULT
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; registered: {list_backends()}")
    _DEFAULT = name


def get_backend(spec: BackendSpec = None, device="cuda") -> Backend:
    """Resolve ``backend=`` arguments: None -> the default ("cuda"), str ->
    registry lookup, Backend instance -> itself.  ``device`` is where the
    caller will compute; a CUDA device with no GPU present raises."""
    resolve_device(device)
    if spec is None:
        spec = _DEFAULT
    if isinstance(spec, str):
        try:
            return _REGISTRY[spec]
        except KeyError:
            raise KeyError(f"unknown backend {spec!r}; registered: {list_backends()}") from None
    return spec
