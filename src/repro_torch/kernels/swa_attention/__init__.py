"""Sliding-window causal attention: the CUDA kernel and its plain versions
(port of `repro.kernels.swa_attention`)."""
from . import ops, ref  # noqa: F401
