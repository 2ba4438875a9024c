"""Build the port's CUDA kernels and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled into one shared library with a
plain C interface, under ``build/repro_torch/`` at the root of the
checkout, on first use: one ``nvcc -c`` per source, all started together,
then one ``nvcc -shared`` link.  A header-only C interface keeps the build
to seconds (no PyTorch headers are compiled).  The library's file name
carries a hash of the sources and flags, so an edited source never loads a
stale build.

The C entry points take a pointer to a parameter struct (mirrored below:
:class:`PlanParams` from ``csrc/stats_tiles.cuh``, :class:`MomentParams`,
:class:`LagMomParams` and :class:`LagMomBatchParams` from
``window_stats/csrc/window_stats.cu``,
:class:`BandParams` and :class:`BandGradParams` from
``banded_matvec/csrc/banded_matvec.cu``, :class:`SwaParams` from
``swa_attention/csrc/swa_attention.cu``) and the CUDA stream; each returns
``cudaGetLastError()`` after its launches, and :func:`check` raises on a
non-zero code.  The struct sizes and the design constants mirrored below
(``STATS_CONSTANTS``, ``LAGMOM_CONSTANTS``, ``BAND_CONSTANTS``,
``SWA_CONSTANTS``) are checked against the library at load.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["PlanParams", "WelchMember", "MomentParams", "LagMomParams", "LagMomBatchParams",
           "BandParams",
           "BandGradParams",
           "SwaParams", "library",
           "build",
           "check", "DeviceFault", "STICKY_ERRORS",
           "MAX_WINDOWS", "MAX_WELCH", "TILE", "FREQ_TILE", "KC", "LAG_GROUP",
           "FFT_MAX_L", "FFT_FLOATS", "FFT_MAX_CHAN", "SMALL_TILE", "MID_TILE", "SMALL_LAGS",
           "LM_ROWS", "LM_STAGES",
           "LM_MAX_CLUSTER", "LM_MAX_SLAB", "LM_BLK", "LM_PART_FLOATS", "LM_BATCH_SLOT",
           "LM_BATCH_BLK", "BAND_COLS", "BAND_PASS",
           "BAND_MAX_SLABS", "BAND_OFFSETS",
           "SWA_KEYS", "SWA_STAGES", "SWA_CONSUMERS", "SWA_WG_ROWS", "SWA_PANEL", "SWA_MAX_D",
           "SWA_MAX_DV", "SWA_SMEM_MAX",
           "THREADS"]

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# Compile-time constants of csrc/stats_tiles.cuh.
MAX_WINDOWS = 8
MAX_WELCH = 4
TILE = 64
FREQ_TILE = 32
KC = 32
LAG_GROUP = 3
FFT_MAX_L = 4096
FFT_FLOATS = 8192
FFT_MAX_CHAN = 64
THREADS = 256
# The small-width lag role of kernels 1 and 2 (d <= MID_TILE): its tiles
# and most lags a CTA.
SMALL_TILE = 16
MID_TILE = 32
SMALL_LAGS = 17
# Compile-time constants of window_stats/csrc/window_stats.cu, kernel 3 at
# H = 0: rows per ring step, ring steps, most CTAs per cluster, most rows
# per CTA, the register tile's side; and the floats of one CTA's partial.
LM_ROWS = 56
LM_STAGES = 2
LM_MAX_CLUSTER = 16
LM_MAX_SLAB = 512
LM_BLK = 8
LM_PART_FLOATS = TILE * TILE + 2 * MAX_WINDOWS * TILE
# Kernel 3's batched path at H = 0, d <= MID_TILE: the most floats of one
# tenant's staged rows (rows x tile), the register tile's side.
LM_BATCH_SLOT = 16384
LM_BATCH_BLK = 4
# Compile-time constants of banded_matvec/csrc/banded_matvec.cu: the generic
# paths' columns per CTA and most rows staged per pass, the vector
# gradient's most CTAs per cluster, the generic gradient's offsets per thread.
BAND_COLS = 256
BAND_PASS = 8
BAND_MAX_SLABS = 8
BAND_OFFSETS = 17
# Compile-time constants of swa_attention/csrc/swa_attention.cu (bf16 path):
# keys per K/V tile, ring stages (fewer where they do not fit beside Q: 3 at
# D = 192), consumer warpgroups of SWA_WG_ROWS flattened rows, columns per
# shared-memory panel, the widest q/k and v head dims, a block's shared
# memory.
SWA_KEYS = 64
SWA_STAGES = 4
SWA_CONSUMERS = 3
SWA_WG_ROWS = 64
SWA_PANEL = 16
SWA_MAX_D = 192
SWA_MAX_DV = 128
SWA_SMEM_MAX = 232448


class WelchMember(ctypes.Structure):
    _fields_ = [
        ("cos", ctypes.c_void_p),
        ("sin", ctypes.c_void_p),
        ("taper", ctypes.c_void_p),
        ("roots", ctypes.c_void_p),
        ("offs", ctypes.c_void_p),
        ("part", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("L", ctypes.c_int),
        ("F", ctypes.c_int),
        ("n_entries", ctypes.c_int),
        ("n_cand", ctypes.c_int),
        ("tile", ctypes.c_int),
        ("group", ctypes.c_int),
        ("n_groups", ctypes.c_int),
        ("f_tiles", ctypes.c_int),
        ("ctas", ctypes.c_int),
        ("fft", ctypes.c_int),
        ("chan", ctypes.c_int),
        ("chan_tiles", ctypes.c_int),
        ("offs_stride", ctypes.c_longlong),
        ("part_stride", ctypes.c_longlong),
        ("out_stride", ctypes.c_longlong),
    ]


class PlanParams(ctypes.Structure):
    _fields_ = [
        ("y", ctypes.c_void_p),
        ("a", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("d_tiles", ctypes.c_int),
        ("H", ctypes.c_int),
        ("lag_slab", ctypes.c_int),
        ("lag_slabs", ctypes.c_int),
        ("lag_ctas", ctypes.c_int),
        ("lag_groups", ctypes.c_int),
        ("lag_part", ctypes.c_void_p),
        ("lag_out", ctypes.c_void_p),
        ("K", ctypes.c_int),
        ("windows", ctypes.c_int * MAX_WINDOWS),
        ("prefix", ctypes.c_void_p),
        ("mom_rows", ctypes.c_int),
        ("mom_slab", ctypes.c_int),
        ("mom_slabs", ctypes.c_int),
        ("c_groups", ctypes.c_int),
        ("mom_ctas", ctypes.c_int),
        ("mom_part", ctypes.c_void_p),
        ("mom_out", ctypes.c_void_p),
        ("n_welch", ctypes.c_int),
        ("welch", WelchMember * MAX_WELCH),
        ("detrend", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("tenant_ctas", ctypes.c_int),
        ("y_stride", ctypes.c_longlong),
        ("a_stride", ctypes.c_longlong),
        ("m_stride", ctypes.c_longlong),
        ("prefix_stride", ctypes.c_longlong),
        ("lag_part_stride", ctypes.c_longlong),
        ("lag_out_stride", ctypes.c_longlong),
        ("mom_part_stride", ctypes.c_longlong),
        ("mom_out_stride", ctypes.c_longlong),
    ]


class MomentParams(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("w", ctypes.c_int),
        ("n_out", ctypes.c_int),
        ("chain", ctypes.c_int),
        ("ctas", ctypes.c_int),
    ]


class LagMomParams(ctypes.Structure):
    _fields_ = [
        ("y", ctypes.c_void_p),
        ("prefix", ctypes.c_void_p),
        ("part", ctypes.c_void_p),
        ("lag_out", ctypes.c_void_p),
        ("mom_out", ctypes.c_void_p),
        ("arrive", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("K", ctypes.c_int),
        ("windows", ctypes.c_int * MAX_WINDOWS),
        ("d_tiles", ctypes.c_int),
        ("pairs", ctypes.c_int),
        ("slab", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("groups", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


class LagMomBatchParams(ctypes.Structure):
    _fields_ = [
        ("y", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("lag_out", ctypes.c_void_p),
        ("mom_out", ctypes.c_void_p),
        ("batch", ctypes.c_int),
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("K", ctypes.c_int),
        ("windows", ctypes.c_int * MAX_WINDOWS),
        ("tenants", ctypes.c_int),
        ("lanes", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


class BandParams(ctypes.Structure):
    _fields_ = [
        ("diags", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("d", ctypes.c_int),
        ("b", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("transposed", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("rows_per_cta", ctypes.c_int),
        ("rows_per_pass", ctypes.c_int),
        ("col_tiles", ctypes.c_int),
        ("row_slabs", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


class BandGradParams(ctypes.Structure):
    _fields_ = [
        ("g", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("d", ctypes.c_int),
        ("b", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("rows_per_cta", ctypes.c_int),
        ("col_tiles", ctypes.c_int),
        ("row_slabs", ctypes.c_int),
        ("offset_chunks", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


class SwaParams(ctypes.Structure):
    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("B", ctypes.c_int),
        ("S", ctypes.c_int),
        ("H", ctypes.c_int),
        ("KVH", ctypes.c_int),
        ("D", ctypes.c_int),
        ("DV", ctypes.c_int),
        ("G", ctypes.c_int),
        ("window", ctypes.c_int),
        ("dtype", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


ENTRY_POINTS = ("rt_cross_lag_sums", "rt_fused_lag_moments", "rt_lag_moments_sym",
                "rt_lag_moments_batched", "rt_lag_moments_empty", "rt_lag_moments_occupancy", "rt_segment_power",
                "rt_fused_plan", "rt_window_moments", "rt_segment_csd", "rt_banded_matvec",
                "rt_band_gradient", "rt_band_empty", "rt_swa_attention")
STRUCT_SIZES = (("rt_plan_params_size", PlanParams), ("rt_welch_member_size", WelchMember),
                ("rt_moment_params_size", MomentParams),
                ("rt_lagmom_params_size", LagMomParams),
                ("rt_lagmom_batch_params_size", LagMomBatchParams),
                ("rt_band_params_size", BandParams),
                ("rt_band_grad_params_size", BandGradParams),
                ("rt_swa_params_size", SwaParams))
# The constants above that mirror csrc/stats_tiles.cuh: Python name -> C
# macro, in the order rt_stats_constants writes them (checked at load).
STATS_CONSTANTS = {"MAX_WINDOWS": "RT_MAX_WINDOWS", "MAX_WELCH": "RT_MAX_WELCH",
                   "TILE": "RT_TILE", "FREQ_TILE": "RT_FT", "KC": "RT_KC",
                   "LAG_GROUP": "RT_LAG_GROUP", "FFT_MAX_L": "RT_FFT_MAX_L",
                   "FFT_FLOATS": "RT_FFT_FLOATS", "FFT_MAX_CHAN": "RT_FFT_MAX_CHAN",
                   "THREADS": "RT_THREADS", "SMALL_TILE": "RT_SMALL_TILE",
                   "MID_TILE": "RT_MID_TILE", "SMALL_LAGS": "RT_SMALL_LAGS"}
# Those that mirror window_stats.cu, in the order rt_lagmom_constants writes them.
LAGMOM_CONSTANTS = {name: name for name in ("LM_ROWS", "LM_STAGES", "LM_MAX_CLUSTER",
                                            "LM_MAX_SLAB", "LM_BLK", "LM_BATCH_SLOT",
                                            "LM_BATCH_BLK")}
# Those that mirror banded_matvec.cu, in the order rt_band_constants writes them.
BAND_CONSTANTS = {"BAND_COLS": "BM_COLS", "BAND_PASS": "BM_PASS",
                  "BAND_MAX_SLABS": "BG_MAX_SLABS", "BAND_OFFSETS": "BG_OFFSETS"}
# Those that mirror swa_attention.cu, in the order rt_swa_constants writes them.
SWA_CONSTANTS = {name: name for name in ("SWA_KEYS", "SWA_STAGES", "SWA_CONSUMERS", "SWA_WG_ROWS",
                                         "SWA_PANEL", "SWA_MAX_D", "SWA_MAX_DV",
                                         "SWA_SMEM_MAX")}


def sources() -> list:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "with the CUDA toolkit on a machine with the card")
    return nvcc


def build(verbose: bool = False) -> tuple:
    """Compile every ``csrc/*.cu`` into one library; returns (path, seconds,
    compiler output).  Reuses an existing build of the same sources.  The
    sources compile in parallel, one ``nvcc`` each; ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel in the
    compiler output)."""
    srcs = sources()
    headers = sorted(KERNELS_DIR.glob("csrc/*.cuh"))
    digest = hashlib.sha1()
    for path in srcs + headers:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp.so")
    objs = [BUILD_DIR / f"{tag}.{src.parent.parent.name}.{src.stem}.o" for src in srcs]
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    start = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *flags, "-I", str(KERNELS_DIR / "csrc"), "-c",
                               "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(src, proc.returncode, log) for src, proc, log in zip(srcs, procs, logs)
              if proc.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(("link", link.returncode, link.stdout + link.stderr))
    seconds = time.perf_counter() - start
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src} ({code}):\n{log}" for src, code, log in failed))
    os.replace(tmp, out)
    return out, seconds, "".join(logs)


def load(path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name, struct in STRUCT_SIZES:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} layout mismatch: C {fn()} "
                               f"bytes, ctypes {ctypes.sizeof(struct)}")
    for entry, names, source in (("rt_stats_constants", STATS_CONSTANTS, "stats_tiles.cuh"),
                                 ("rt_lagmom_constants", LAGMOM_CONSTANTS, "window_stats.cu"),
                                 ("rt_band_constants", BAND_CONSTANTS, "banded_matvec.cu"),
                                 ("rt_swa_constants", SWA_CONSTANTS, "swa_attention.cu")):
        consts = (ctypes.c_int * len(names))()
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = None
        fn(consts)
        want = [globals()[name] for name in names]
        if list(consts) != want:
            raise RuntimeError(f"{source} constants {dict(zip(names, consts))} "
                               f"differ from _build.py's {dict(zip(names, want))}")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    path, _, _ = build()
    return load(path)


# cudaError_t codes after which the CUDA context is unusable: illegal
# address, device assert, hardware stack error, illegal instruction,
# misaligned address, invalid address space, invalid pc, launch failure.
STICKY_ERRORS = frozenset({700, 710, 714, 715, 716, 717, 718, 719})


class DeviceFault(RuntimeError):
    """A sticky CUDA error: every later call in the process fails too."""


def check(code: int, name: str) -> None:
    if code in STICKY_ERRORS:
        raise DeviceFault(f"{name}: CUDA error {code} (sticky: the CUDA context is lost)")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
