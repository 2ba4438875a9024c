"""repro_torch -- the PyTorch/CUDA port of the weak-memory time-series engine.

The JAX package `repro` is the reference; this package re-creates its fused
statistics plan with its overlapping block store, its streaming
estimators, its rolling moments and cross-spectra, its §6 banded
spatial AR fit, its forecasts and anomaly scores, its serving gateway
with verified checkpoints, and its dense- and MoE-family LM serving path
on PyTorch, with each
Pallas kernel on those paths rewritten as a hand-written CUDA kernel for
Hopper (sm_90a).  It imports nothing from `repro` and no JAX.

Entry points run on the card (CUDA tensors, ``device="cuda"``) unless the
caller asks for the CPU (CPU tensors, ``device="cpu"``), where every kernel
wrapper runs its plain PyTorch version:

  SeriesFrame.from_array / from_chunks / from_sharded -> .autocovariance(...) ... .collect()
  TimeSeriesStore.from_series(x, block_size, 0, h_right)   the overlapping block store
  StreamingEstimator(engine).ingest(chunk).finalize(...)   lag_sum_engine, welch_engine, ...
  FrameSession(d, num_users, ...) -> .autocovariance(...) ... .ingest(ids, chunks)
      -> .query(user) / .query_batch(users)     many users, one plan
  frame.forecast(horizon, model="ar"|"arma"|"auto") / frame.anomaly_scores(model=...)
  StatsGateway(session, GatewayConfig(...))  await .ingest(t, chunk) / .query(t), per-tick
      coalescing, snapshots through CheckpointManager, kill-and-restart
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
from .core.frame import (Deferred, FrameSession, SeriesFrame, session_state_from_numpy,
                         session_state_to_numpy)
from .core.plan import StatPlan, analyze
from .configs import get_arch
from .models import init_params
from .checkpoint import CheckpointManager
from .serving import GatewayConfig, RollingStatsService, ServeEngine, StatsGateway
from .timeseries import StreamingEstimator, TimeSeriesStore

# The plain versions on the card are full fp32, like the kernels: no TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["SeriesFrame", "Deferred", "FrameSession", "RollingStatsService", "TimeSeriesStore",
           "StatsGateway", "GatewayConfig", "CheckpointManager",
           "StreamingEstimator",
           "session_state_from_numpy", "session_state_to_numpy", "StatPlan", "analyze",
           "windowed_moments", "welch_csd",
           "BandedARModel", "banded_predict", "banded_nll", "fit_banded_ar", "get_arch",
           "init_params", "ServeEngine", "__version__"]
