"""Segment-DFT power: CUDA kernel and plain version (port of
`repro.kernels.segment_dft`)."""
from . import ops, ref  # noqa: F401
