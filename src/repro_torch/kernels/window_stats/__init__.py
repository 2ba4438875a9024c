"""Lagged sums and fused lag + window moments: CUDA kernels and their
plain versions (port of `repro.kernels.window_stats`)."""
from . import ops, ref  # noqa: F401
