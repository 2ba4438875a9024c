"""Measured backend crossovers: the "auto" policy learns from the card
(port of `repro.core.calibrate`).

The compute-backend registry (`repro_torch.core.backend`) dispatches each
of the eight primitive contractions to plain PyTorch ("torch") or to the
hand-written Hopper kernels ("cuda").  Where the crossover sits -- the
problem size from which the kernel beats the plain version -- is a
property of the card and of the host path in front of it (launch and
wrapper overhead against the plain version's chain of library calls), so
it is measured, never copied from another accelerator:

  * :func:`calibrate` times every primitive on both backends across a grid
    of problem sizes and derives a per-primitive **crossover threshold**:
    the smallest grid size from which "cuda" wins at every larger size, 0
    when it wins at every grid size, ``inf`` when it loses at the largest;
  * the resulting :class:`CalibrationTable` is persisted to a per-platform
    cache file (:func:`save_table` / :func:`load_table`; the path honours
    ``REPRO_TORCH_CALIB_CACHE``), so one calibration pass serves every
    later process on the same machine.  A table records the card's name
    (``torch.cuda.get_device_name()``) and is ignored on another card;
  * `repro_torch.core.backend.AutoBackend` resolves its thresholds lazily
    at the first dispatch through :func:`resolve_table`: a cached table of
    this platform and card if one exists, else -- on "cuda", unless
    ``REPRO_TORCH_AUTO_CALIBRATE`` says otherwise -- a fresh
    :func:`calibrate` run persisted for next time, else the built-in
    :func:`default_table`.

The built-in defaults are a fallback, not a measurement: on "cuda" every
threshold is 0 (``"auto"`` behaves as the default ``"cuda"`` until a table
is measured); on the CPU every threshold is ``inf`` (both backends run the
plain versions there, so there is nothing to cross over to).

The table also carries **tuned tile configurations**: :func:`tune_blocks`
searches :data:`TUNABLE_BLOCKS` -- only the tile knobs the kernels read,
today ``fused_plan_update``'s ``block_t`` (kernel 1's Welch candidate
tile) -- on the "cuda" backend, drops a candidate whose outputs leave the
plain version's tolerance, and records the fastest in
``CalibrationTable.blocks`` only where it beats the built-in block by more
than the spread of their samples.  `repro_torch.kernels.tiling.
resolve_block` reads only a table installed in the process
(:func:`set_active_table`, which :func:`resolve_table` and the "auto"
backend call), never the cache file: a table on disk steers no kernel of
a process that did not ask for it.

The environment variables are the reference's under the port's own names
(``REPRO_TORCH_CALIB_CACHE``, ``REPRO_TORCH_AUTO_CALIBRATE``), so neither
package reads the other's cache.  Run it from the shell::

    python -m repro_torch.core.calibrate --show          # resolved table
    python -m repro_torch.core.calibrate --tune          # crossovers + blocks
    python -m repro_torch.core.calibrate --bless t.json  # install a table file
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "PRIMITIVES",
    "TUNABLE_BLOCKS",
    "CalibrationTable",
    "block_all",
    "default_table",
    "cache_path",
    "load_table",
    "save_table",
    "resolve_table",
    "active_table",
    "active_blocks",
    "set_active_table",
    "calibrate",
    "tune_blocks",
    "main",
]

# The registered primitive contractions (`repro_torch.core.backend.Backend`).
PRIMITIVES: Tuple[str, ...] = (
    "lagged_sums",
    "masked_lagged_sums",
    "windowed_moments",
    "segment_fft_power",
    "segment_csd",
    "banded_matvec",
    "fused_lagged_moments",
    "fused_plan_update",
)

# The tile knobs each primitive's kernel really reads: only the megakernel's
# Welch candidate tile (`repro_torch.kernels.fused_plan.ops`).  The other
# kernels size their launches from the shapes and the card.
TUNABLE_BLOCKS: Dict[str, Tuple[str, ...]] = {
    p: (("block_t",) if p == "fused_plan_update" else ()) for p in PRIMITIVES
}
BLOCK_CANDIDATES: Dict[str, Tuple[int, ...]] = {
    "block_t": (128, 256, 512, 1024),
}

# A tuned candidate must agree with the plain version on the same inputs:
# per output of fused_plan_update (lag, mom, psds, n_segs), max|got - plain|
# <= tol * max|plain| -- chip_smoke.py's TOL for the lag, moment and power
# families, the segment counts exactly.
TUNE_TOL: Tuple[float, ...] = (1e-4, 1e-4, 1e-3, 0.0)


def _platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _device_name(platform: Optional[str] = None) -> Optional[str]:
    """The card's name on "cuda" (None elsewhere)."""
    if (platform or _platform()) == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return None


def _builtin_thresholds(platform: str) -> Dict[str, float]:
    value = 0.0 if platform == "cuda" else math.inf
    return {p: value for p in PRIMITIVES}


@dataclasses.dataclass
class CalibrationTable:
    """Per-primitive crossover thresholds + tuned tile configs, one platform
    and one card.

    ``thresholds[name]`` is the problem size (rows per problem for the
    windowed contractions, the banded dimension for the matvec, staged
    samples S*L per problem for the segment DFT) from which ``"auto"``
    routes that primitive to "cuda"; ``math.inf`` means never.
    ``blocks[name]`` is the tuned tile configuration of that primitive's
    kernel (``{"block_t": 256}``), read through
    `repro_torch.kernels.tiling.resolve_block`.  ``source`` records
    provenance ("default", "measured" or "cache"), ``device`` the card's
    name (None for a table of the CPU or one the reference wrote).
    ``timings`` holds the measurement's medians (seconds) and is not
    persisted.
    """

    platform: str
    thresholds: Dict[str, float]
    source: str = "default"
    blocks: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    device: Optional[str] = None
    timings: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def crossover(self, primitive: str) -> float:
        """Dispatch threshold for ``primitive``; a primitive absent from the
        table (a cache older than the primitive) falls back to the built-in
        default of the table's platform, never to a KeyError."""
        if primitive in self.thresholds:
            return float(self.thresholds[primitive])
        return float(_builtin_thresholds(self.platform).get(primitive, math.inf))

    def block_config(self, primitive: str) -> Dict[str, int]:
        """Tuned tile config for ``primitive`` ({} when never tuned)."""
        return dict(self.blocks.get(primitive, {}))

    def to_json(self) -> dict:
        return {
            "platform": self.platform,
            # inf is not valid JSON: encoded as null
            "thresholds": {k: (None if math.isinf(v) else v)
                           for k, v in self.thresholds.items()},
            "blocks": {k: {p: int(v) for p, v in cfg.items()}
                       for k, cfg in self.blocks.items()},
            "source": self.source,
            "device": self.device,
        }

    @classmethod
    def from_json(cls, payload: dict) -> "CalibrationTable":
        """Reads the port's tables and the reference's (which have no
        ``"device"`` key)."""
        thresholds = {k: (math.inf if v is None else float(v))
                      for k, v in payload.get("thresholds", {}).items()}
        blocks = {k: {p: int(v) for p, v in cfg.items()}
                  for k, cfg in payload.get("blocks", {}).items()}
        device = payload.get("device")
        return cls(platform=payload.get("platform", "unknown"), thresholds=thresholds,
                   source=payload.get("source", "cache"), blocks=blocks,
                   device=None if device is None else str(device))


def default_table(platform: Optional[str] = None) -> CalibrationTable:
    """The built-in fallback table for ``platform`` (default: current)."""
    platform = platform or _platform()
    return CalibrationTable(platform, _builtin_thresholds(platform), source="default",
                            device=_device_name(platform))


def cache_path(platform: Optional[str] = None) -> str:
    """Where the measured table persists: ``$REPRO_TORCH_CALIB_CACHE`` when
    set (one file, platform and card recorded inside), else
    ``$XDG_CACHE_HOME/repro_torch/calibration_<platform>.json`` (``~/.cache``
    without XDG_CACHE_HOME)."""
    env = os.environ.get("REPRO_TORCH_CALIB_CACHE")
    if env:
        return env
    platform = platform or _platform()
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", f"calibration_{platform}.json")


def _foreign(table: CalibrationTable, platform: str) -> bool:
    """A table of another platform, or of another card."""
    return table.platform != platform or (
        table.device is not None and table.device != _device_name(platform))


def load_table(platform: Optional[str] = None) -> Optional[CalibrationTable]:
    """The cached measured table for ``platform``, or None.  A cache written
    on another platform or another card is ignored, never misapplied.  A
    corrupt cache (a torn write, valid JSON of the wrong shape) warns and
    returns None, so the caller degrades to the built-in defaults."""
    platform = platform or _platform()
    path = cache_path(platform)
    try:
        with open(path) as f:
            payload = json.load(f)
        table = CalibrationTable.from_json(payload)
    except OSError:
        return None
    except (ValueError, TypeError, KeyError, AttributeError) as e:
        warnings.warn(
            f"ignoring corrupt calibration cache {path!r} ({type(e).__name__}: {e}); "
            f"using built-in defaults -- delete the file or re-run calibration to "
            f"silence this", RuntimeWarning)
        return None
    if _foreign(table, platform):
        return None
    table.source = "cache"
    return table


def save_table(table: CalibrationTable, path: Optional[str] = None) -> str:
    path = path or cache_path(table.platform)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(table.to_json(), f, indent=2)
        f.write("\n")
    return path


def _autocalibrate_default(platform: str) -> bool:
    env = os.environ.get("REPRO_TORCH_AUTO_CALIBRATE")
    if env is not None:
        return env not in ("", "0", "false", "False")
    # on the card the first use pays one measurement pass and caches it; on
    # the CPU both backends run the plain versions, nothing to measure
    return platform == "cuda"


def resolve_table(platform: Optional[str] = None,
                  autocalibrate: Optional[bool] = None) -> CalibrationTable:
    """The table the ``"auto"`` backend dispatches with, resolved at first
    use: cached measurement > fresh measurement ("cuda", or
    ``REPRO_TORCH_AUTO_CALIBRATE=1``) > built-in default."""
    platform = platform or _platform()
    cached = load_table(platform)
    if cached is not None:
        set_active_table(cached)
        return cached
    if autocalibrate is None:
        autocalibrate = _autocalibrate_default(platform)
    if autocalibrate:
        return calibrate(save=True)
    table = default_table(platform)
    set_active_table(table)
    return table


# The table tile-size resolution reads (`repro_torch.kernels.tiling.
# resolve_block` -> :func:`active_blocks`).  Apart from AutoBackend's lazy
# ``table`` because block resolution must NEVER trigger a measurement: the
# measurement calls the kernels, which resolve their blocks.  ``_ACTIVE`` is
# set only by explicit installs (resolve_table, calibrate, tune_blocks,
# AutoBackend.set_table); until one happens the kernels take the built-in
# blocks, and nothing on the launch path touches the file system.
_ACTIVE: Optional[CalibrationTable] = None


def set_active_table(table: Optional[CalibrationTable]) -> None:
    """Install ``table`` as the process-wide tile/threshold source (None
    uninstalls it: the kernels take the built-in blocks again)."""
    global _ACTIVE
    _ACTIVE = table


def active_table() -> CalibrationTable:
    """The installed table, else the built-in defaults; never measures and
    never reads the cache (:func:`resolve_table` does)."""
    return _ACTIVE if _ACTIVE is not None else default_table()


def active_blocks(primitive: str) -> Dict[str, int]:
    """Tuned tile config for ``primitive`` from the installed table ({}
    when none is installed or it never tuned ``primitive``:
    `repro_torch.kernels.tiling` then applies its defaults)."""
    return {} if _ACTIVE is None else _ACTIVE.block_config(primitive)


# ---------------------------------------------------------------- measurement
def _tensor_leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _tensor_leaves(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _tensor_leaves(v)]
    return []


def block_all(out) -> None:
    """Wait for every CUDA tensor leaf of ``out``: synchronise the device of
    each (once per device).  Kernel launches return before the card
    finishes, so a measurement that does not wait times the enqueue."""
    for dev in {t.device for t in _tensor_leaves(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _samples(fn: Callable, iters: int, warmup: int) -> list:
    """Sorted wall seconds of ``iters`` calls after ``warmup``, each
    synchronised on every output leaf."""
    for _ in range(warmup):
        block_all(fn())
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        block_all(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)


def _time(fn: Callable, iters: int, warmup: int) -> float:
    """Median wall seconds per call, synchronised on every output leaf."""
    times = _samples(fn, iters, warmup)
    return times[len(times) // 2]


def _workloads(n: int, d: int, max_lag: int, window: int, nperseg: int, bandwidth: int,
               device) -> Dict[str, Callable]:
    """One closure per primitive at problem size ``n``: the inputs are made
    once, on ``device``, from a generator seeded with ``n`` (outside the
    timed region); ``loads[p](backend)`` returns the call to time.  Sizes
    are clamped as the reference's so tiny grid points stay valid."""
    g = torch.Generator(device=device)
    g.manual_seed(n)
    H = min(max_lag, max(n - 1, 0))
    w = min(window, n)
    x = torch.randn((n, d), generator=g, device=device)
    y = torch.randn((n + max(H, w - 1, 1), d), generator=g, device=device)
    mask = torch.ones((n,), dtype=torch.bool, device=device)
    L = min(nperseg, n)
    S = max(n // max(L, 1), 1)
    segs = torch.randn((S, L, d), generator=g, device=device)
    taper = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(L, device=device) / max(L, 1))
    b = min(bandwidth, max((n - 1) // 2, 0))
    diags = torch.randn((n, 2 * b + 1), generator=g, device=device)
    v = x[:, 0].contiguous()
    z0 = torch.zeros((), dtype=torch.int32, device=device)
    return {
        "lagged_sums": lambda be: (lambda: be.lagged_sums(x, H)),
        "masked_lagged_sums": lambda be: (lambda: be.masked_lagged_sums(y, mask, H)),
        "windowed_moments": lambda be: (lambda: be.windowed_moments(x, w)),
        "segment_fft_power": lambda be: (lambda: be.segment_fft_power(segs, taper)),
        "segment_csd": lambda be: (lambda: be.segment_csd(segs, taper)),
        "banded_matvec": lambda be: (lambda: be.banded_matvec(diags, v)),
        "fused_lagged_moments": lambda be: (lambda: be.fused_lagged_moments(y, mask, H, w)),
        # the megakernel: a three-family plan chunk update (lag + moments + Welch)
        "fused_plan_update": lambda be: (
            lambda: be.fused_plan_update(y, mask, z0, H, (w,), (L,), (max(L // 2, 1),),
                                         (taper,))),
    }


def calibrate(
    sizes: Sequence[int] = (512, 2048, 8192, 32768),
    d: int = 8,
    max_lag: int = 8,
    window: int = 64,
    nperseg: int = 256,
    bandwidth: int = 8,
    iters: int = 3,
    warmup: int = 1,
    backends: Tuple[str, str] = ("torch", "cuda"),
    save: bool = True,
    path: Optional[str] = None,
    verbose: bool = False,
    tune_blocks: bool = False,
) -> CalibrationTable:
    """Measure per-primitive backend crossovers on THIS machine.

    For every primitive and grid size, times the ``backends`` pair (median
    of ``iters`` after ``warmup``, synchronised on every output leaf) on
    inputs on the current platform's device, and derives the crossover
    (:func:`_crossover`): the smallest grid size from which the second
    backend is at least as fast as the first *and stays so at every larger
    size*; 0 when it wins at every grid size (nothing below the grid was
    measured, and a backend that wins everywhere is not sent sizes below
    the grid on a guess); ``inf`` when it loses at the largest.  The medians are kept in ``table.timings["crossover"]``
    ({primitive: {size: {backend: seconds}}}).

    Returns the measured :class:`CalibrationTable`, installed as the active
    table; with ``save=True`` it is also written to ``path`` (default: the
    platform cache).  ``tune_blocks=True`` also runs the tile search
    (:func:`tune_blocks`) at the largest grid size into the same table.
    """
    from .backend import get_backend

    platform = _platform()
    device = torch.device(platform)
    base_be, alt_be = (get_backend(b, device) for b in backends)
    sizes = sorted(set(int(s) for s in sizes))
    if not sizes:
        raise ValueError("need at least one calibration grid size")

    wins: Dict[str, list] = {p: [] for p in PRIMITIVES}
    medians: Dict[str, dict] = {p: {} for p in PRIMITIVES}
    for n in sizes:
        loads = _workloads(n, d, max_lag, window, nperseg, bandwidth, device)
        for prim in PRIMITIVES:
            t_base = _time(loads[prim](base_be), iters, warmup)
            t_alt = _time(loads[prim](alt_be), iters, warmup)
            wins[prim].append(t_alt <= t_base)
            medians[prim][n] = {backends[0]: t_base, backends[1]: t_alt}
            if verbose:
                print(f"calibrate {prim:<22s} n={n:<8d} {backends[0]}={t_base * 1e6:10.1f}us "
                      f"{backends[1]}={t_alt * 1e6:10.1f}us {'<<' if t_alt <= t_base else ''}")
        del loads

    thresholds = {prim: _crossover(sizes, wins[prim]) for prim in PRIMITIVES}
    table = CalibrationTable(platform, thresholds, source="measured",
                             device=_device_name(platform))
    table.timings["crossover"] = medians
    if tune_blocks:
        _tune_blocks_into(table, n=sizes[-1], d=d, max_lag=max_lag, window=window,
                          nperseg=nperseg, bandwidth=bandwidth, iters=iters, warmup=warmup,
                          verbose=verbose)
    set_active_table(table)
    if save:
        # the table is the product, the cache an optimisation: calibrate can
        # run at the auto backend's first dispatch, which must not crash on
        # an unwritable cache location
        try:
            save_table(table, path)
        except OSError as e:
            warnings.warn(f"calibration succeeded but the cache could not be written "
                          f"({e}); the measured table is used for this process only")
    return table


def _crossover(sizes: Sequence[int], wins: Sequence[bool]) -> float:
    """The smallest of the ascending ``sizes`` from which ``wins`` holds at
    every larger size; 0.0 when it holds at all of them, ``inf`` when it
    fails at the largest."""
    if all(wins):
        return 0.0
    thr = math.inf
    for n, won in zip(reversed(sizes), reversed(wins)):
        if not won:
            break
        thr = float(n)
    return thr


def _within(got, want, tols: Sequence[float]) -> bool:
    """Each output part within its tolerance of the plain version's:
    max|got - want| <= tol * max|want|, non-finite entries in the same
    places."""
    for part_tol, g, w in zip(tols, got, want):
        for a, b in zip(_tensor_leaves(g), _tensor_leaves(w)):
            a, b = a.double(), b.double().to(a.device)
            if a.shape != b.shape or not torch.equal(torch.isfinite(a), torch.isfinite(b)):
                return False
            fin = torch.isfinite(b)
            if not fin.any():
                continue
            err = (a[fin] - b[fin]).abs().max().item()
            if err > part_tol * b[fin].abs().max().item():
                return False
    return True


def _fastest_beyond_spread(samples: Dict[int, list], default: int) -> Optional[int]:
    """The candidate of the lowest median among ``samples`` ({candidate:
    sorted seconds}), when its median beats ``default``'s by more than the
    larger spread (max - min) of the two candidates' samples; else None, and
    the built-in block stays."""
    if default not in samples:
        return None
    med = {c: s[len(s) // 2] for c, s in samples.items()}
    best = min(med, key=med.get)
    spread = max(samples[c][-1] - samples[c][0] for c in (best, default))
    return best if med[default] - med[best] > spread else None


def _tune_blocks_into(table: CalibrationTable, n: int, d: int = 8, max_lag: int = 8,
                      window: int = 64, nperseg: int = 256, bandwidth: int = 8,
                      iters: int = 3, warmup: int = 1, verbose: bool = False) -> None:
    """Search :data:`BLOCK_CANDIDATES` (and the built-in block) for every
    knob of :data:`TUNABLE_BLOCKS` on the "cuda" backend; record a
    candidate in ``table.blocks`` (in place) only where it agrees with the
    plain version and beats the built-in block by more than their samples'
    spread (:func:`_fastest_beyond_spread`).  Each candidate's median goes
    to ``table.timings["blocks"]`` ({primitive: {param: {candidate:
    seconds | "dropped"}}}).

    Each candidate runs on a fresh ``CudaBackend(block_t=candidate)``: the
    explicit override comes first in the resolution chain (override >
    table > default), so the search never reads the table it writes.  A
    candidate outside :data:`TUNE_TOL` is dropped and printed, never
    recorded.
    """
    from ..kernels.tiling import DEFAULT_BLOCKS
    from .backend import CudaBackend, TorchBackend

    device = torch.device(_platform())
    loads = _workloads(n, d, max_lag, window, nperseg, bandwidth, device)
    record = table.timings.setdefault("blocks", {})
    for prim, params in TUNABLE_BLOCKS.items():
        if not params:
            continue
        want = loads[prim](TorchBackend())()
        cfg: Dict[str, int] = {}
        for param in params:
            default = DEFAULT_BLOCKS[prim][param]
            seen = record.setdefault(prim, {}).setdefault(param, {})
            samples: Dict[int, list] = {}
            for cand in dict.fromkeys(BLOCK_CANDIDATES[param] + (default,)):
                call = loads[prim](CudaBackend(**{param: cand}))
                if not _within(call(), want, TUNE_TOL):
                    seen[cand] = "dropped"
                    print(f"tune {prim} {param}={cand}: outputs leave the plain version's "
                          f"tolerance {TUNE_TOL}; dropped")
                    continue
                samples[cand] = _samples(call, iters, warmup)
                seen[cand] = samples[cand][len(samples[cand]) // 2]
                if verbose:
                    print(f"tune {prim:<22s} {param}={cand:<6d} {seen[cand] * 1e6:10.1f}us")
            best = _fastest_beyond_spread(samples, default)
            if best is not None:
                cfg[param] = int(best)
        if cfg:
            table.blocks[prim] = cfg


def tune_blocks(n: int = 32768, iters: int = 3, warmup: int = 1, save: bool = True,
                path: Optional[str] = None, verbose: bool = False) -> CalibrationTable:
    """Tile-size search on top of the installed table, else the cached one,
    else the defaults (never measures the crossovers): the winners merge
    into a copy of it, which is installed and, with ``save=True``,
    persisted.  ``calibrate(tune_blocks=True)`` measures both in one pass."""
    base = _ACTIVE or load_table() or default_table()
    table = CalibrationTable(platform=base.platform, thresholds=dict(base.thresholds),
                             source=base.source,
                             blocks={k: dict(v) for k, v in base.blocks.items()},
                             device=base.device)
    _tune_blocks_into(table, n=n, iters=iters, warmup=warmup, verbose=verbose)
    set_active_table(table)
    if save:
        try:
            save_table(table, path)
        except OSError as e:
            warnings.warn(f"block tuning succeeded but the cache could not be written "
                          f"({e}); the tuned table is used for this process only")
    return table


# ------------------------------------------------------------------------ CLI
def _print_table(table: CalibrationTable) -> None:
    print(f"platform: {table.platform}   device: {table.device}   source: {table.source}")
    print("crossover thresholds (rows; inf = always torch):")
    for prim in PRIMITIVES:
        thr = table.crossover(prim)
        star = "" if prim in table.thresholds else "  (built-in default)"
        print(f"  {prim:<22s} {thr!r:>10}{star}")
    print("tuned tile configs (empty = kernels use built-in defaults):")
    if not table.blocks:
        print("  (none)")
    for prim, cfg in sorted(table.blocks.items()):
        pretty = ", ".join(f"{k}={v}" for k, v in sorted(cfg.items()))
        print(f"  {prim:<22s} {pretty}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.core.calibrate``: inspect, measure or install
    the calibration table.

    ``--show``         print the installed table, else the cached one, else
                       the defaults (default action; never measures)
    ``--tune``         measure crossovers AND tune tile sizes, persist
    ``--tune-blocks``  tile-size search only, on top of the active table
    ``--bless PATH``   install a table JSON file as this platform's cache
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.core.calibrate",
        description="Measure, inspect, or install the backend calibration table "
        "(crossover thresholds + tuned tile configs).")
    parser.add_argument("--show", action="store_true",
                        help="print the cached table, else the defaults (default when no "
                        "action given)")
    parser.add_argument("--tune", action="store_true",
                        help="measure backend crossovers and tune tile sizes, then persist "
                        "to the platform cache")
    parser.add_argument("--tune-blocks", action="store_true",
                        help="run only the tile-size search on top of the active table")
    parser.add_argument("--bless", metavar="PATH", default=None,
                        help="validate the table JSON at PATH and install it as this "
                        "platform's cache file")
    parser.add_argument("--no-save", action="store_true",
                        help="with --tune/--tune-blocks: measure but do not write the cache")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.bless:
        try:
            with open(args.bless) as f:
                table = CalibrationTable.from_json(json.load(f))
        except OSError as e:
            print(f"cannot read {args.bless}: {e}")
            return 1
        except (ValueError, TypeError, KeyError, AttributeError) as e:
            print(f"refusing to bless {args.bless}: not a valid calibration table "
                  f"({type(e).__name__}: {e})")
            return 1
        platform = _platform()
        if _foreign(table, platform):
            print(f"refusing to bless: table platform {table.platform!r} / device "
                  f"{table.device!r} != current platform {platform!r} / device "
                  f"{_device_name(platform)!r}")
            return 1
        dest = save_table(table)
        set_active_table(table)
        print(f"blessed {args.bless} -> {dest}")
        _print_table(table)
        return 0

    if args.tune:
        table = calibrate(save=not args.no_save, verbose=args.verbose, tune_blocks=True)
    elif args.tune_blocks:
        table = tune_blocks(save=not args.no_save, verbose=args.verbose)
    else:
        table = _ACTIVE or resolve_table(autocalibrate=False)
    _print_table(table)
    return 0


if __name__ == "__main__":
    import sys

    # run the package's module, not this __main__ copy, so that the tables
    # installed here are the ones the kernels' tile resolution reads
    from repro_torch.core.calibrate import main as _main

    sys.exit(_main())
