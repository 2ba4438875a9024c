"""repro_torch -- the PyTorch/CUDA port of the weak-memory time-series engine.

The JAX package `repro` is the reference; this package re-creates its fused
statistics plan, its rolling moments and cross-spectra, its §6 banded
spatial AR fit and its dense-family LM serving path on PyTorch, with each
Pallas kernel on those paths rewritten as a hand-written CUDA kernel for
Hopper (sm_90a).  It imports nothing from `repro` and no JAX.

Entry points run on the card (CUDA tensors, ``device="cuda"``) unless the
caller asks for the CPU (CPU tensors, ``device="cpu"``), where every kernel
wrapper runs its plain PyTorch version:

  SeriesFrame.from_array / from_chunks -> .autocovariance(...) ... .collect()
  analyze(series, requests, device=...)
  StatPlan(requests, d, device=...)
  windowed_moments(x, window)               rolling mean and variance
  welch_csd(x, nperseg, overlap)            cross-spectral density matrix
  banded_predict / banded_nll / fit_banded_ar, BandedARModel
  get_arch(name) -> init_params(cfg, seed=...) -> ServeEngine(...).generate(prompts, n)
"""
import torch

from .core.estimators import (BandedARModel, banded_nll, banded_predict, fit_banded_ar,
                              welch_csd, windowed_moments)
from .core.frame import Deferred, SeriesFrame
from .core.plan import StatPlan, analyze
from .configs import get_arch
from .models import init_params
from .serving import ServeEngine

# The plain versions on the card are full fp32, like the kernels: no TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["SeriesFrame", "Deferred", "StatPlan", "analyze", "windowed_moments", "welch_csd",
           "BandedARModel", "banded_predict", "banded_nll", "fit_banded_ar", "get_arch",
           "init_params", "ServeEngine", "__version__"]
