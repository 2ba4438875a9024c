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

The reference's ``AutoBackend`` and ``CircuitBreakerBackend`` arrive with
the port's calibration and fault-handling slices.
"""
from __future__ import annotations

from typing import Dict, Protocol, Union, runtime_checkable

import torch

from ..kernels.banded_matvec import ops as bm
from ..kernels.banded_matvec.ref import banded_matvec_ref
from ..kernels.fused_plan import ops as fp
from ..kernels.fused_plan.ref import fused_plan_update_ref
from ..kernels.segment_dft import ops as sd
from ..kernels.segment_dft.ref import segment_csd_ref, segment_dft_power_ref
from ..kernels.window_stats import ops as ws
from ..kernels.window_stats.ref import (fused_lag_moments_ref, lagged_sums_ref,
                                        masked_lagged_sums_ref, window_moments_ref)

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
        """The reference's formula: one float32 cumulative sum."""
        return window_moments_ref(x, window, torch.float32)

    def segment_fft_power(self, segments, taper, detrend=True):
        return segment_dft_power_ref(segments, taper, detrend)

    def segment_csd(self, segments, taper, detrend=True):
        return segment_csd_ref(segments, taper, detrend)

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
    """

    name = "cuda"

    def lagged_sums(self, x, max_lag):
        return ws.lagged_sums(x, max_lag)

    def masked_lagged_sums(self, y_padded, start_mask, max_lag):
        return ws.masked_lagged_sums(y_padded, start_mask, max_lag)

    def windowed_moments(self, x, window):
        return ws.windowed_moments(x, window)

    def segment_fft_power(self, segments, taper, detrend=True):
        return sd.segment_fft_power(segments, taper, detrend)

    def segment_csd(self, segments, taper, detrend=True):
        return sd.segment_csd(segments, taper, detrend)

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
