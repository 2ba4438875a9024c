"""Wrapper of the fused-plan megakernel (port of
`repro.kernels.fused_plan.ops`).

Handles what the device kernel must not: reach-aware zero-extension, the
per-Welch-member candidate-offset tables (stride alignment against the
chunk's global index ``z0``, a device tensor: no host sync), twiddle
construction and the optional bf16 staging.  CUDA tensors run
``csrc/fused_plan.cu`` in one launch (plus its fixed-order reduction); CPU
tensors run the plain version (``ref.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._launch import (WELCH_GROUP, Kernel, Prepared, add_lag, add_moments, add_welch,
                       new_params, on_cuda, register, require, sm_count)
from ..segment_dft.ref import dft_power_matrices
from ..tiling import clamp_block_t, resolve_block
from ..window_stats.ref import as_2d, extend_rows
from .ref import fused_plan_update_ref, stage

__all__ = ["FUSED_PLAN", "fused_plan_update", "prepare_fused_plan", "candidate_offsets"]

FUSED_PLAN = register(Kernel("fused_plan_megakernel", "rt_fused_plan"))


def candidate_offsets(z0: torch.Tensor, L: int, num_tiles: int, block_t: int,
                      step: int, start_mask: torch.Tensor) -> torch.Tensor:
    """(num_tiles, n_cand) int32 local segment starts per tile, -1 invalid.

    A candidate is a local row c whose global index z0 + c is a multiple of
    ``step`` with c < L and start_mask[c]; entry [i, k] is c - i*block_t.
    n_cand = block_t // step + 1 bounds the aligned starts in one tile.
    """
    dev = start_mask.device
    n_cand = block_t // step + 1
    tile0 = torch.arange(num_tiles, device=dev)[:, None] * block_t
    base = torch.remainder(-(z0.long() + tile0), step)
    c = tile0 + base + torch.arange(n_cand, device=dev)[None, :] * step
    off = c - tile0
    valid = (off < block_t) & (c < L) & start_mask[c.clamp(0, max(L - 1, 0))]
    return torch.where(valid, off, -1).to(torch.int32)


def _check_members(windows, seg_lens, seg_steps, tapers) -> tuple:
    windows = tuple(int(w) for w in windows)
    if len(set(windows)) != len(windows):
        raise ValueError(f"moment windows must be distinct, got {windows}")
    seg_lens = tuple(int(v) for v in seg_lens)
    seg_steps = tuple(int(v) for v in seg_steps)
    tapers = tuple(tapers)
    if not (len(seg_lens) == len(seg_steps) == len(tapers)):
        raise ValueError(f"seg_lens/seg_steps/tapers must align, got lengths "
                         f"{len(seg_lens)}/{len(seg_steps)}/{len(tapers)}")
    if any(s <= 0 for s in seg_steps):
        raise ValueError(f"seg_steps must be positive, got {seg_steps}")
    return windows, seg_lens, seg_steps, tapers


def prepare_fused_plan(y_padded: torch.Tensor, start_mask: torch.Tensor, z0, max_lag: int,
                       windows: Tuple[int, ...] = (), seg_lens: Tuple[int, ...] = (),
                       seg_steps: Tuple[int, ...] = (), tapers: tuple = (),
                       detrend: bool = True, *, stage_dtype: Optional[str] = None,
                       block_t: Optional[int] = None) -> Prepared:
    """The megakernel's launch over CUDA tensors (see :func:`fused_plan_update`
    for the arguments); ``.launch()`` returns (lag, mom, psds, n_segs)."""
    windows, seg_lens, seg_steps, tapers = _check_members(windows, seg_lens, seg_steps,
                                                          tapers)
    y = as_2d(y_padded)
    dev = y.device
    L = start_mask.shape[0]
    reach = max(max_lag, max(windows, default=1) - 1, max(seg_lens, default=1) - 1)
    y = extend_rows(stage(y, stage_dtype), L + reach)[: L + reach].contiguous()
    require(start_mask, "start_mask", (L,), torch.bool)
    z0 = torch.as_tensor(z0, device=dev)

    p = new_params(y, L)
    m = start_mask.float()
    p.m = m.data_ptr()
    p.detrend = int(detrend)
    sms = sm_count(dev)
    lag_part, lag = add_lag(p, max_lag, sms, dev)
    keep = [y, m, lag_part]
    mom = None
    if windows:
        prefix = torch.nn.functional.pad(
            torch.cumsum(start_mask, 0, dtype=torch.int32), (1, 0))
        part, mom = add_moments(p, windows, prefix, L + max(windows) - 1, sms, dev)
        keep += [prefix, part]
    bt = clamp_block_t(resolve_block("fused_plan_update", "block_t", block_t), L,
                       max(reach, 1))
    num_tiles = -(-max(L, 1) // bt)
    psds, n_segs = [], []
    for Lseg, step, taper in zip(seg_lens, seg_steps, tapers):
        offs = candidate_offsets(z0, L, num_tiles, bt, step, start_mask)
        C, S = dft_power_matrices(Lseg, taper.to(dev))
        C, S = C.contiguous(), S.contiguous()
        flat = offs.reshape(-1).contiguous()
        part, out = add_welch(p, C, S, flat, flat.numel(), offs.shape[1], bt,
                              WELCH_GROUP, dev)
        keep += [C, S, flat, part]
        psds.append(out)
        n_segs.append((offs >= 0).float().sum())
    return Prepared(FUSED_PLAN, p, dev, (lag, mom, tuple(psds), tuple(n_segs)), tuple(keep))


def fused_plan_update(y_padded: torch.Tensor, start_mask: torch.Tensor, z0,
                      max_lag: int, windows: Tuple[int, ...] = (),
                      seg_lens: Tuple[int, ...] = (), seg_steps: Tuple[int, ...] = (),
                      tapers: tuple = (), detrend: bool = True, *,
                      stage_dtype: Optional[str] = None,
                      block_t: Optional[int] = None) -> tuple:
    """Every member family of a fused plan from ONE launch over the chunk.

    Args:
      y_padded: (>= L, d) chunk rows (zero-extended to the widest reach).
      start_mask: (L,) bool window-start validity.
      z0: global index of row 0 (int or 0-d device tensor).
      windows: distinct moment windows (may be empty).
      seg_lens / seg_steps / tapers: per Welch member.
      stage_dtype: e.g. "bfloat16" -- the series is rounded through it;
        every sum is still taken in float32.
      block_t: candidate-table tile length (default: the built-in block).

    Returns (lag (H+1, d, d), mom (K, 2, d) | None, psds tuple of
    (seg_lens[j]//2+1, d), n_segs tuple of 0-d float32).
    """
    if not on_cuda(as_2d(y_padded), start_mask):
        windows, seg_lens, seg_steps, tapers = _check_members(windows, seg_lens, seg_steps,
                                                              tapers)
        return fused_plan_update_ref(y_padded, start_mask, z0, max_lag, windows, seg_lens,
                                     seg_steps, tapers, detrend, stage_dtype)
    return prepare_fused_plan(y_padded, start_mask, z0, max_lag, windows, seg_lens,
                              seg_steps, tapers, detrend, stage_dtype=stage_dtype,
                              block_t=block_t).launch()
