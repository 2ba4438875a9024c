"""Launch plumbing shared by the kernel wrappers.

The wrappers (``*/ops.py``) pad and lay out their operands like the
reference's ops modules, then fill a :class:`~._build.PlanParams` here and
launch through a :class:`Kernel`, which counts its launches.  Partials and
outputs are allocated with ``torch.empty`` on the operands' device; the
kernels allocate nothing and launch on the current stream without
synchronising.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from ._build import FREQ_TILE, KC, MAX_WELCH, MAX_WINDOWS, TILE, PlanParams, check, library

__all__ = ["Kernel", "KERNELS", "Prepared", "on_cuda", "require", "new_params", "add_lag",
           "add_moments", "add_welch", "check_window_count", "sm_count", "register"]

# Work per launch is split so the grid holds a few waves of CTAs.
_WAVES = 4
_MIN_SLAB = 256
WELCH_GROUP = 8  # candidate segments per Welch CTA


class Kernel:
    """One hand-written CUDA kernel: its C entry point and its launch count.

    ``launches`` is a plain integer, incremented once per launch of the
    kernel (with its fixed-order reduction, where it has one).
    """

    def __init__(self, name: str, entry: str):
        self.name = name
        self.entry = entry
        self.launches = 0

    def __call__(self, params: PlanParams, device: torch.device) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            code = getattr(library(), self.entry)(ctypes.byref(params), stream)
        check(code, self.name)
        self.launches += 1


@dataclasses.dataclass
class Prepared:
    """One filled launch: the kernel, its params, and every buffer the
    params point into (``keep``), held alive as long as this object."""

    kernel: Kernel
    params: PlanParams
    device: torch.device
    out: Any
    keep: tuple

    def launch(self) -> Any:
        """Launch (again) and return the outputs."""
        self.kernel(self.params, self.device)
        return self.out


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; raises for a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all lie on one CUDA device or all on the "
                     f"CPU, got {sorted(kinds)}")


def require(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels index "
                         f"with 32-bit integers")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"the kernels launch on a CUDA device, got {device}")
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def new_params(y: torch.Tensor, n: int) -> PlanParams:
    """Params over the (rows, d) series ``y`` with ``n`` window starts."""
    p = PlanParams()
    p.y = y.data_ptr()
    p.n = n
    p.d = y.shape[1]
    p.d_tiles = _ceil_div(p.d, TILE)
    p.H = 0
    return p


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _slab(count: int, pieces: int, align: int) -> tuple:
    """(slab length, slab count) splitting ``count`` rows into about
    ``pieces`` slabs of a multiple of ``align`` rows."""
    count = max(count, 1)
    slab = max(_MIN_SLAB, _ceil_div(_ceil_div(count, pieces), align) * align)
    return slab, _ceil_div(count, slab)


def add_lag(p: PlanParams, max_lag: int, sms: int, device: torch.device) -> tuple:
    """Enable the lag family: S(h) = sum_{t<n} a_t y_{t+h}^T, h <= max_lag.
    ``y`` must hold n + max_lag rows.  Returns (partials, output)."""
    per_slab = (max_lag + 1) * p.d_tiles * p.d_tiles
    p.H = max_lag
    p.lag_slab, p.lag_slabs = _slab(p.n, max(1, _ceil_div(_WAVES * sms, per_slab)), KC)
    p.lag_ctas = p.lag_slabs * per_slab
    part = torch.empty((p.lag_slabs, p.H + 1, p.d, p.d), device=device)
    out = torch.empty((p.H + 1, p.d, p.d), device=device)
    p.lag_part, p.lag_out = part.data_ptr(), out.data_ptr()
    return part, out


def check_window_count(windows: tuple) -> None:
    if len(windows) > MAX_WINDOWS:
        raise ValueError(f"the kernels take at most {MAX_WINDOWS} moment windows "
                         f"per launch, got {len(windows)}")


def add_moments(p: PlanParams, windows: tuple, prefix: torch.Tensor, rows: int,
                sms: int, device: torch.device) -> tuple:
    """Enable the moment family over rows [0, rows) of ``y``; ``prefix`` is
    the (n+1,) int32 prefix count of the start mask.  Returns (partials,
    output (K, 2, d))."""
    check_window_count(windows)
    require(prefix, "prefix", (p.n + 1,), torch.int32)
    p.K = len(windows)
    for k, w in enumerate(windows):
        p.windows[k] = int(w)
    p.prefix = prefix.data_ptr()
    p.c_groups = _ceil_div(p.d, 32)
    p.mom_rows = rows
    p.mom_slab, p.mom_slabs = _slab(rows, max(1, _ceil_div(2 * sms, p.c_groups)), 8)
    p.mom_ctas = p.mom_slabs * p.c_groups
    part = torch.empty((p.mom_slabs, p.K, 2, p.d), device=device)
    out = torch.empty((p.K, 2, p.d), device=device)
    p.mom_part, p.mom_out = part.data_ptr(), out.data_ptr()
    return part, out


def add_welch(p: PlanParams, cos: torch.Tensor, sin: torch.Tensor,
              offs: Optional[torch.Tensor], n_entries: int, n_cand: int,
              tile: int, group: int, device: torch.device,
              out: Optional[torch.Tensor] = None) -> tuple:
    """Add one Welch member: entries are candidate starts (``offs``) or, with
    ``offs=None``, contiguous segments of ``y``.  Returns (partials, output).
    With ``out`` given and ``group == 1`` the partials are the output."""
    j = p.n_welch
    if j >= MAX_WELCH:
        raise ValueError(f"the kernels take at most {MAX_WELCH} Welch members "
                         f"per launch")
    L, F = cos.shape
    require(cos, "cos", (L, F))
    require(sin, "sin", (L, F))
    m = p.welch[j]
    m.cos, m.sin = cos.data_ptr(), sin.data_ptr()
    m.offs = 0 if offs is None else offs.data_ptr()
    if offs is not None:
        require(offs, "offsets", (n_entries,), torch.int32)
    m.L, m.F = L, F
    m.n_entries, m.n_cand, m.tile, m.group = n_entries, n_cand, tile, group
    m.n_groups = max(1, _ceil_div(n_entries, group))
    m.f_tiles = _ceil_div(F, FREQ_TILE)
    m.ctas = m.n_groups * m.f_tiles * p.d_tiles
    if out is None:
        part = torch.empty((m.n_groups, F, p.d), device=device)
        out = torch.empty((F, p.d), device=device)
    else:
        part = out
    m.part, m.out = part.data_ptr(), out.data_ptr()
    p.n_welch = j + 1
    return part, out
