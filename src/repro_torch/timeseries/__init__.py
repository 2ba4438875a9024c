"""Time-series data of the port (reference: `repro.timeseries`): synthetic
generation, the overlapping block store, the streaming estimator and
irregular-series alignment."""
from .dataset import TimeSeriesStore
from .generator import (companion_matrix, random_invertible_ma, random_stable_var,
                        simulate_var, simulate_varma, simulate_vma, spectral_radius)
from .irregular import regularize
from .streaming import StreamingEstimator

__all__ = ["random_stable_var", "random_invertible_ma", "simulate_var", "simulate_vma",
           "simulate_varma", "companion_matrix", "spectral_radius", "TimeSeriesStore",
           "StreamingEstimator", "regularize"]
