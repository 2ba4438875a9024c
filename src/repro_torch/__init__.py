"""repro_torch -- the PyTorch/CUDA port of the weak-memory time-series engine.

The JAX package `repro` is the reference; this package re-creates its fused
statistics plan on PyTorch, with each Pallas kernel on that path rewritten
as a hand-written CUDA kernel for Hopper (sm_90a).  It imports nothing from
`repro` and no JAX.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``), where every kernel wrapper runs its plain
PyTorch version:

  SeriesFrame.from_array / from_chunks -> .autocovariance(...) ... .collect()
  analyze(series, requests, device=...)
  StatPlan(requests, d, device=...)
"""
import torch

from .core.frame import Deferred, SeriesFrame
from .core.plan import StatPlan, analyze

# The plain versions on the card are full fp32, like the kernels: no TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["SeriesFrame", "Deferred", "StatPlan", "analyze", "__version__"]
