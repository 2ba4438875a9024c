"""Shared tile plumbing (port of `repro.kernels.tiling`).

``resolve_block`` resolves a kernel's tile size: an explicit override, else
the tuned value of a calibration table installed in the process
(`repro_torch.core.calibrate.set_active_table`), else the built-in default.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["DEFAULT_BLOCKS", "resolve_block", "clamp_block_t", "pad_tiles",
           "pad_to_multiple"]

DEFAULT_BLOCKS: Dict[str, Dict[str, int]] = {
    "lagged_sums": {"block_t": 512},
    "masked_lagged_sums": {"block_t": 512},
    "windowed_moments": {"block_t": 512},
    "fused_lagged_moments": {"block_t": 512},
    "fused_plan_update": {"block_t": 512},
    "segment_fft_power": {"block_s": 8},
    "segment_csd": {"block_s": 8},
    "banded_matvec": {"block_rows": 256},
}


def resolve_block(primitive: str, param: str, override: Optional[int] = None) -> int:
    """``override`` if given, else the installed calibration table's tuned
    value, else the built-in default for ``primitive``.  Never measures and
    never reads a cache file (`repro_torch.core.calibrate.active_blocks`)."""
    if override is not None:
        return int(override)
    # imported here so that the kernels layer stays below core at import time
    from ..core.calibrate import active_blocks

    tuned = active_blocks(primitive).get(param)
    if tuned is not None:
        return int(tuned)
    try:
        return DEFAULT_BLOCKS[primitive][param]
    except KeyError:
        raise KeyError(f"no built-in default for {primitive}.{param}; known: "
                       f"{sorted(DEFAULT_BLOCKS)}") from None


def clamp_block_t(block_t: int, n: int, min_tile: int) -> int:
    """Positive tile size for any series length: at most the series length,
    at least the kernel's per-tile reach, at least 1."""
    return max(min(block_t, max(n, 1)), min_tile, 1)


def pad_tiles(x: torch.Tensor, block_t: int, halo: int = 1) -> torch.Tensor:
    """Zero-pad (n, d) to a multiple of ``block_t``, plus one all-zero halo
    tile when the kernel reaches past its core tile (``halo > 0``)."""
    n = x.shape[0]
    n_pad = -(-max(n, 1) // block_t) * block_t
    if halo > 0:
        n_pad += block_t
    return torch.nn.functional.pad(x.float(), (0, 0, 0, n_pad - n))


def pad_to_multiple(count: int, block: int) -> int:
    """Smallest multiple of ``block`` >= max(count, 1)."""
    return -(-max(count, 1) // block) * block
