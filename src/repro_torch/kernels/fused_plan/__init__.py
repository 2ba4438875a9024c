"""The fused-plan megakernel: CUDA kernel and plain version (port of
`repro.kernels.fused_plan`)."""
from . import ops, ref  # noqa: F401
