"""Build the port's CUDA kernels and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled into one shared library with a
plain C interface, under ``build/repro_torch/`` at the root of the
checkout, on first use: one ``nvcc -c`` per source, all started together,
then one ``nvcc -shared`` link.  A header-only C interface keeps the build
to seconds (no PyTorch headers are compiled).  The library's file name
carries a hash of the sources and flags, so an edited source never loads a
stale build.

The C entry points take a pointer to a parameter struct (mirrored below:
:class:`PlanParams` from ``csrc/stats_tiles.cuh``, :class:`MomentParams`
from ``window_stats/csrc/window_stats.cu``, :class:`BandParams` from
``banded_matvec/csrc/banded_matvec.cu``, :class:`SwaParams` from
``swa_attention/csrc/swa_attention.cu``) and the CUDA stream; each returns
``cudaGetLastError()`` after its launches, and :func:`check` raises on a
non-zero code.
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

__all__ = ["PlanParams", "WelchMember", "MomentParams", "BandParams", "SwaParams", "library",
           "build",
           "check", "MAX_WINDOWS", "MAX_WELCH", "TILE", "FREQ_TILE", "KC", "BAND_COLS",
           "BAND_PASS", "BAND_VCOLS", "SWA_MAX_D", "THREADS"]

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
THREADS = 256
# Compile-time constants of banded_matvec/csrc/banded_matvec.cu.
BAND_COLS = 256
BAND_PASS = 8
BAND_VCOLS = 1024
# Compile-time constants of swa_attention/csrc/swa_attention.cu.
SWA_MAX_D = 128


class WelchMember(ctypes.Structure):
    _fields_ = [
        ("cos", ctypes.c_void_p),
        ("sin", ctypes.c_void_p),
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


class BandParams(ctypes.Structure):
    _fields_ = [
        ("coef", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("d", ctypes.c_int),
        ("b", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("rows_per_cta", ctypes.c_int),
        ("rows_per_pass", ctypes.c_int),
        ("col_tiles", ctypes.c_int),
        ("row_slabs", ctypes.c_int),
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
        ("G", ctypes.c_int),
        ("window", ctypes.c_int),
        ("dtype", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


ENTRY_POINTS = ("rt_cross_lag_sums", "rt_fused_lag_moments", "rt_segment_power",
                "rt_fused_plan", "rt_window_moments", "rt_segment_csd", "rt_banded_matvec",
                "rt_swa_attention")
STRUCT_SIZES = (("rt_plan_params_size", PlanParams), ("rt_welch_member_size", WelchMember),
                ("rt_moment_params_size", MomentParams), ("rt_band_params_size", BandParams),
                ("rt_swa_params_size", SwaParams))


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
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    path, _, _ = build()
    return load(path)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
