"""Hand-written Hopper kernels of the port, each beside its plain version.

  window_stats   -- cross_window_stats, fused_lag_moments, window_moments
  segment_dft    -- segment_dft_power, segment_csd
  fused_plan     -- fused_plan_megakernel
  banded_matvec  -- banded_matvec (with its autograd backward)
  swa_attention  -- swa_attention (sliding-window causal attention, forward)

:data:`KERNELS` maps each kernel's name to its :class:`~._launch.Kernel`,
whose ``launches`` attribute counts its launches; the two kernels with
Welch members (segment_dft_power, fused_plan_megakernel) also count their
launches per Welch path ("fft", "twiddle"), and fused_lag_moments per
launch path ("sym", "batched", "two_role"), in ``path_launches``.
"""
from ._launch import KERNELS
from . import (banded_matvec, fused_plan, segment_dft, swa_attention,  # noqa: F401  (registers kernels)
               window_stats)

__all__ = ["KERNELS", "launch_counts", "path_counts", "reset_launch_counts"]


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: k.launches for name, k in KERNELS.items()}


def path_counts() -> dict:
    """{kernel name: {path: launches}} of the kernels that count paths."""
    return {name: dict(k.path_launches) for name, k in KERNELS.items() if k.path_launches}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        for path in k.path_launches:
            k.path_launches[path] = 0
