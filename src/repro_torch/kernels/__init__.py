"""Hand-written Hopper kernels of the port, each beside its plain version.

  window_stats   -- cross_window_stats, fused_lag_moments, window_moments
  segment_dft    -- segment_dft_power, segment_csd
  fused_plan     -- fused_plan_megakernel
  banded_matvec  -- banded_matvec (with its autograd backward)

:data:`KERNELS` maps each kernel's name to its :class:`~._launch.Kernel`,
whose ``launches`` attribute counts its launches.
"""
from ._launch import KERNELS
from . import banded_matvec, fused_plan, segment_dft, window_stats  # noqa: F401  (registers kernels)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
