"""Compute-backend registry (port of `repro.core.backend`).

Every weak-memory estimator reduces to a handful of primitive contractions;
a :class:`Backend` supplies one implementation of each (see
:data:`PRIMITIVE_NAMES` and the protocol below).  Backends in the registry:

  ``"cuda"``   the hand-written Hopper kernels (`repro_torch.kernels`) --
               the port of ``PallasBackend`` and the default.  For CPU
               tensors each kernel wrapper runs its plain version; for CUDA
               tensors it launches the kernel or raises.
  ``"torch"``  plain PyTorch on any device -- the port of ``JnpBackend``,
               the in-package oracle.  Segment power uses the taper-folded
               twiddle contraction (as the reference's ``ref.py`` oracle),
               never a library FFT.

The reference's ``AutoBackend`` and ``CircuitBreakerBackend`` arrive with
the port's calibration and fault-handling slices.
"""
from __future__ import annotations

from typing import Dict, Protocol, Union, runtime_checkable

import torch

from ..kernels.fused_plan import ops as fp
from ..kernels.fused_plan.ref import fused_plan_update_ref
from ..kernels.segment_dft import ops as sd
from ..kernels.segment_dft.ref import segment_dft_power_ref
from ..kernels.window_stats import ops as ws
from ..kernels.window_stats.ref import (fused_lag_moments_ref, lagged_sums_ref,
                                        masked_lagged_sums_ref)

__all__ = ["Backend", "TorchBackend", "CudaBackend", "PRIMITIVE_NAMES",
           "register_backend", "get_backend", "list_backends", "resolve_device"]

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
        """(S, W, d) segments -> (S, W//2+1, d) per-segment |rfft|^2."""
        ...

    def segment_csd(self, segments: torch.Tensor, taper: torch.Tensor,
                    detrend: bool = True) -> torch.Tensor:
        """(S, W, d) -> (S, W//2+1, d, d) complex cross-spectral products."""
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
        x = (x[:, None] if x.ndim == 1 else x).float()
        n, d = x.shape
        if n - window + 1 < 1:
            raise ValueError(f"series of length {n} has no full window of width {window}")
        zero = x.new_zeros((1, d))
        cs = torch.cat([zero, torch.cumsum(x, 0)])
        cs2 = torch.cat([zero, torch.cumsum(x * x, 0)])
        return torch.stack([cs[window:] - cs[:-window], cs2[window:] - cs2[:-window]], 1)

    def segment_fft_power(self, segments, taper, detrend=True):
        return segment_dft_power_ref(segments, taper, detrend)

    def segment_csd(self, segments, taper, detrend=True):
        raise NotImplementedError(
            "segment_csd is not ported yet (ROADMAP Queue A item 10, welch_csd)")

    def banded_matvec(self, diags, x):
        raise NotImplementedError(
            "banded_matvec is not ported yet (ROADMAP Queue A item 10)")

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

    Four primitives run the port's CUDA kernels; ``windowed_moments``,
    ``segment_csd`` and ``banded_matvec`` raise until their kernels are
    ported (ROADMAP Queue B items 5-7).
    """

    name = "cuda"

    def lagged_sums(self, x, max_lag):
        return ws.lagged_sums(x, max_lag)

    def masked_lagged_sums(self, y_padded, start_mask, max_lag):
        return ws.masked_lagged_sums(y_padded, start_mask, max_lag)

    def windowed_moments(self, x, window):
        raise NotImplementedError(
            "the windowed_moments kernel is not ported yet (ROADMAP Queue B item 5)")

    def segment_fft_power(self, segments, taper, detrend=True):
        return sd.segment_fft_power(segments, taper, detrend)

    def segment_csd(self, segments, taper, detrend=True):
        raise NotImplementedError(
            "the segment_csd kernel is not ported yet (ROADMAP Queue B item 6)")

    def banded_matvec(self, diags, x):
        raise NotImplementedError(
            "the banded_matvec kernel is not ported yet (ROADMAP Queue B item 7)")

    def fused_lagged_moments(self, y_padded, start_mask, max_lag, window):
        return ws.fused_lagged_moments(y_padded, start_mask, max_lag, window)

    def fused_plan_update(self, y_padded, start_mask, z0, max_lag, windows=(),
                          seg_lens=(), seg_steps=(), tapers=(), detrend=True,
                          stage_dtype=None):
        return fp.fused_plan_update(y_padded, start_mask, z0, max_lag, windows,
                                    seg_lens, seg_steps, tapers, detrend,
                                    stage_dtype=stage_dtype)


_REGISTRY: Dict[str, Backend] = {"cuda": CudaBackend(), "torch": TorchBackend()}
_DEFAULT = "cuda"


def register_backend(name: str, backend: Backend) -> None:
    """Add (or replace) a named backend."""
    _REGISTRY[name] = backend


def list_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


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
