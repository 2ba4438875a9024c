"""Banded matrix times vectors: CUDA kernel, its plain version and its
gradient (port of `repro.kernels.banded_matvec`)."""
from . import ops, ref  # noqa: F401
