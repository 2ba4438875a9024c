"""Launch plumbing shared by the kernel wrappers.

The wrappers (``*/ops.py``) pad and lay out their operands like the
reference's ops modules, then fill a :class:`~._build.PlanParams` here and
launch through a :class:`Kernel`, which counts its launches.  Partials and
outputs are allocated with ``torch.empty`` on the operands' device; the
kernels allocate nothing and launch on the current stream without
synchronising.

A batched launch serves B tenants of one shape (a multi-tenant session's
arrival batch): ``new_params`` takes the (B, rows, d) series, each ``add_*``
gives its partials and outputs a leading tenant axis, and the per-tenant
strides go into the params (see csrc/stats_tiles.cuh).  One launch, and one
count, whatever B.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch

from ._build import (FFT_FLOATS, FFT_MAX_CHAN, FFT_MAX_L, FREQ_TILE, KC, LAG_GROUP, MAX_WELCH,
                     MAX_WINDOWS, MID_TILE, SMALL_LAGS, SMALL_TILE, TILE, PlanParams, check,
                     library)

__all__ = ["Kernel", "KERNELS", "Prepared", "on_cuda", "require", "new_params", "lag_tile",
           "add_lag", "add_moments", "add_welch", "welch_path", "fft_channels",
           "check_window_count", "sm_count", "register"]

# Grid shapes, chosen by timing their variants on the H100
# (tools/kernel_variants/variants_bench.py stats): the lag contraction in
# one wave of about LAG_CTAS_PER_SM CTAs per SM (two fit at once), the
# moment role likewise, and WELCH_GROUP candidate segments per Welch CTA.
_MIN_SLAB = 256
LAG_CTAS_PER_SM = 2
MOM_CTAS_PER_SM = 2
WELCH_GROUP = 2


class Kernel:
    """One hand-written CUDA kernel: its C entry point and its launch count.

    ``launches`` is a plain integer, incremented once per launch of the
    kernel (with its fixed-order reduction, where it has one).  A kernel
    with more than one C entry (kernel 3: its symmetric, batched and
    two-role launches) is called with the entry of its prepared launch,
    counts them all, and counts each in ``path_launches`` under the path its
    prepared launch names.  A kernel with Welch members also counts, in
    ``path_launches``, its launches per Welch path ("fft", "twiddle"): once
    per launch for each path that one of the launch's members took.
    """

    def __init__(self, name: str, entry: str, paths: tuple = ()):
        self.name = name
        self.entry = entry
        self.launches = 0
        self.path_launches: Dict[str, int] = dict.fromkeys(paths, 0)

    def __call__(self, params, device: torch.device, entry: Optional[str] = None,
                 path: Optional[str] = None) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            code = getattr(library(), entry or self.entry)(ctypes.byref(params), stream)
        check(code, self.name)
        self.launches += 1
        if path is not None:
            self.path_launches[path] += 1
        elif self.path_launches:  # PlanParams with Welch members
            for path in {"fft" if params.welch[j].fft else "twiddle"
                         for j in range(params.n_welch)}:
                self.path_launches[path] += 1


@dataclasses.dataclass
class Prepared:
    """One filled launch: the kernel, its params, and every buffer the
    params point into (``keep``), held alive as long as this object;
    ``entry`` names the C entry when it is not the kernel's own, ``path``
    the count of ``kernel.path_launches`` the launch adds to."""

    kernel: Kernel
    params: Any
    device: torch.device
    out: Any
    keep: tuple
    entry: Optional[str] = None
    path: Optional[str] = None

    def launch(self) -> Any:
        """Launch (again) and return the outputs."""
        self.kernel(self.params, self.device, self.entry, self.path)
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


def require(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32,
            lead: tuple = ()) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and shape
    ``lead + shape``: ``lead`` holds the tenant axis of a batched launch,
    which the kernels index with 64-bit offsets, so the 32-bit limit holds
    per problem (``shape``)."""
    shape = tuple(lead) + tuple(shape)
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    per = math.prod(shape[len(lead):])
    if per >= 2**31:
        raise ValueError(f"{name} has {per} elements per problem; the kernels index "
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
    """Params over the (rows, d) series ``y`` -- or B tenants' (B, rows, d)
    series, contiguous -- with ``n`` window starts each.  ``p.lead`` (on the
    Python side only) is the launch's tenant axes: (B,) batched, else ();
    the ``add_*`` functions give their partials and outputs these leading
    axes."""
    p = PlanParams()
    p.lead = tuple(y.shape[:-2])
    p.y = y.data_ptr()
    p.n = n
    p.d = y.shape[-1]
    p.d_tiles = _ceil_div(p.d, TILE)
    p.H = 0
    p.batch = y.shape[0] if p.lead else 1
    p.y_stride = y.shape[1] * y.shape[2] if p.lead else 0
    return p


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _slab(count: int, pieces: int, align: int) -> tuple:
    """(slab length, slab count) splitting ``count`` rows into about
    ``pieces`` slabs of a multiple of ``align`` rows."""
    count = max(count, 1)
    slab = max(_MIN_SLAB, _ceil_div(_ceil_div(count, pieces), align) * align)
    return slab, _ceil_div(count, slab)


def lag_tile(d: int) -> int:
    """The lag role's channel tile that kernels 1 and 2 take at width ``d``
    (stats_tiles.cuh's ``lag_tile``, chosen by d at the C entry): SMALL_TILE
    up to SMALL_TILE channels, MID_TILE up to MID_TILE, else TILE."""
    return SMALL_TILE if d <= SMALL_TILE else MID_TILE if d <= MID_TILE else TILE


def add_lag(p: PlanParams, max_lag: int, sms: int, device: torch.device,
            tile: Optional[int] = None) -> tuple:
    """Enable the lag family: S(h) = sum_{t<n} a_t y_{t+h}^T, h <= max_lag.
    ``y`` must hold n + max_lag rows.  ``tile``: the lag role's channel tile,
    by default :func:`lag_tile` (kernels 1 and 2; kernel 3 passes TILE).  The
    lags split into runs of at most LAG_GROUP (the 64-channel tile,
    ``lag_role``) or SMALL_LAGS (a smaller tile, ``small_lag_role``: one
    channel tile), one CTA staging a slab's rows once for its run (the CTA's
    decomposition is the role's in csrc/stats_tiles.cuh), and the starts into
    slabs for about LAG_CTAS_PER_SM CTAs per SM over the whole batch (so one
    slab a tenant once the batch fills the card).  On a smaller tile with
    one slab the CTAs write the output directly: the partials are the output
    (``p.lag_part == p.lag_out``), and the reduction skips them.  Returns
    (partials, output), with the leading axes ``p.lead``; ``p.lag_tile``
    (Python side only) records the tile."""
    p.H = max_lag
    p.lag_tile = tile or lag_tile(p.d)
    p.lag_groups = _ceil_div(max_lag + 1, LAG_GROUP if p.lag_tile == TILE else SMALL_LAGS)
    tiles = _ceil_div(p.d, p.lag_tile)
    per_slab = p.lag_groups * tiles * tiles
    pieces = max(1, LAG_CTAS_PER_SM * sms // (per_slab * p.batch))
    p.lag_slab, p.lag_slabs = _slab(p.n, pieces, KC)
    p.lag_ctas = p.lag_slabs * per_slab
    out = torch.empty(p.lead + (p.H + 1, p.d, p.d), device=device)
    if p.lag_tile != TILE and p.lag_slabs == 1:
        part = out
    else:
        part = torch.empty(p.lead + (p.lag_slabs, p.H + 1, p.d, p.d), device=device)
    p.lag_part, p.lag_out = part.data_ptr(), out.data_ptr()
    if p.lead:
        p.lag_part_stride, p.lag_out_stride = part[0].numel(), out[0].numel()
    return part, out


def check_window_count(windows: tuple) -> None:
    if len(windows) > MAX_WINDOWS:
        raise ValueError(f"the kernels take at most {MAX_WINDOWS} moment windows "
                         f"per launch, got {len(windows)}")


def add_moments(p: PlanParams, windows: tuple, prefix: torch.Tensor, rows: int,
                sms: int, device: torch.device) -> tuple:
    """Enable the moment family over rows [0, rows) of ``y``; ``prefix`` is
    the (n+1,) int32 prefix count of the start mask, after the leading axes
    ``p.lead``.  Returns (partials, output (K, 2, d)), with the leading axes
    ``p.lead``."""
    check_window_count(windows)
    require(prefix, "prefix", (p.n + 1,), torch.int32, p.lead)
    p.K = len(windows)
    for k, w in enumerate(windows):
        p.windows[k] = int(w)
    p.prefix = prefix.data_ptr()
    p.prefix_stride = p.n + 1 if p.lead else 0
    p.c_groups = _ceil_div(p.d, 32)
    p.mom_rows = rows
    pieces = max(1, _ceil_div(MOM_CTAS_PER_SM * sms, p.c_groups) // p.batch)
    p.mom_slab, p.mom_slabs = _slab(rows, pieces, 8)
    p.mom_ctas = p.mom_slabs * p.c_groups
    part = torch.empty(p.lead + (p.mom_slabs, p.K, 2, p.d), device=device)
    out = torch.empty(p.lead + (p.K, 2, p.d), device=device)
    p.mom_part, p.mom_out = part.data_ptr(), out.data_ptr()
    if p.lead:
        p.mom_part_stride, p.mom_out_stride = part[0].numel(), out[0].numel()
    return part, out


def welch_path(L: int) -> str:
    """The Welch path that serves segments of length ``L``: "fft" for a power
    of two from 2 to FFT_MAX_L, else "twiddle" (the DFT as a contraction)."""
    return "fft" if 2 <= L <= FFT_MAX_L and L & (L - 1) == 0 else "twiddle"


def fft_channels(L: int, d: int) -> int:
    """Channels per CTA of the FFT path: a power of two >= 2 (two channels
    per complex sequence), at most FFT_MAX_CHAN, at most what d needs, and
    at most FFT_FLOATS / L (one (L, chan) tile of shared memory)."""
    need = 1 << max(1, (d - 1).bit_length())
    return max(2, min(FFT_MAX_CHAN, FFT_FLOATS // L, need))


def add_welch(p: PlanParams, taper: torch.Tensor, offs: Optional[torch.Tensor],
              n_entries: int, n_cand: int, tile: int, group: int, device: torch.device,
              out: Optional[torch.Tensor] = None, path: Optional[str] = None) -> tuple:
    """Add one Welch member of segment length ``len(taper)``, on ``path``
    (default :func:`welch_path`): entries are candidate starts (``offs``) or,
    with ``offs=None``, contiguous segments of ``y``, each written on its own
    into ``out`` (S, F, d).  ``group`` entries per CTA (the twiddle path
    writes per entry only with ``group == 1``).  Returns (partials, output,
    operands): the operands are the tensors the launch reads (roots and
    taper, or the twiddle matrices), to be kept alive with it.  Batched
    (``p.lead`` = (B,)): ``offs`` is (B, n_entries), one table per tenant,
    and the partials and output get the leading tenant axis."""
    from .segment_dft.ref import dft_power_matrices, fft_roots

    j = p.n_welch
    if j >= MAX_WELCH:
        raise ValueError(f"the kernels take at most {MAX_WELCH} Welch members "
                         f"per launch")
    L = taper.shape[0]
    F = L // 2 + 1
    path = path or welch_path(L)
    if path == "fft" and welch_path(L) != "fft":
        raise ValueError(f"the FFT path takes L a power of two from 2 to {FFT_MAX_L}, "
                         f"got {L}")
    if offs is not None:
        require(offs, "offsets", (n_entries,), torch.int32, p.lead)
    m = p.welch[j]
    m.offs = 0 if offs is None else offs.data_ptr()
    m.L, m.F = L, F
    m.n_entries, m.n_cand, m.tile, m.group = n_entries, n_cand, tile, group
    m.n_groups = max(1, _ceil_div(n_entries, group))
    if path == "fft":
        taper = taper.to(device=device, dtype=torch.float32).contiguous()
        roots = fft_roots(L, device)
        m.taper, m.roots = taper.data_ptr(), roots.data_ptr()
        m.fft, m.chan = 1, fft_channels(L, p.d)
        m.chan_tiles = _ceil_div(p.d, m.chan)
        m.f_tiles = 1
        m.ctas = m.n_groups * m.chan_tiles
        operands = (taper, roots)
    else:
        cos, sin = (t.contiguous() for t in dft_power_matrices(L, taper.to(device)))
        m.cos, m.sin = cos.data_ptr(), sin.data_ptr()
        m.f_tiles = _ceil_div(F, FREQ_TILE)
        m.ctas = m.n_groups * m.f_tiles * p.d_tiles
        operands = (cos, sin)
    if out is None:
        part = torch.empty(p.lead + (m.n_groups, F, p.d), device=device)
        out = torch.empty(p.lead + (F, p.d), device=device)
    else:
        part = out
    m.part, m.out = part.data_ptr(), out.data_ptr()
    if p.lead:
        m.offs_stride = n_entries
        m.part_stride, m.out_stride = math.prod(part.shape[1:]), math.prod(out.shape[1:])
    p.n_welch = j + 1
    return part, out, operands
