"""Build the port's CUDA kernels and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled by ONE ``nvcc`` call into a shared
library with a plain C interface, under ``build/repro_torch/`` at the root
of the checkout, on first use.  A header-only C interface keeps the build to
seconds (no PyTorch headers are compiled).  The library's file name carries
a hash of the sources and flags, so an edited source never loads a stale
build.

The C entry points take a pointer to a :class:`PlanParams` (mirrored below
from ``csrc/stats_tiles.cuh``) and the CUDA stream; each returns
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

__all__ = ["PlanParams", "WelchMember", "library", "build", "check",
           "MAX_WINDOWS", "MAX_WELCH", "TILE", "FREQ_TILE", "KC"]

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Compile-time constants of csrc/stats_tiles.cuh.
MAX_WINDOWS = 8
MAX_WELCH = 4
TILE = 64
FREQ_TILE = 32
KC = 32


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


ENTRY_POINTS = ("rt_cross_lag_sums", "rt_fused_lag_moments", "rt_segment_power",
                "rt_fused_plan")


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
    compiler output).  Reuses an existing build of the same sources.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel in the compiler output)."""
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
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    cmd = [_nvcc(), *flags, "-I", str(KERNELS_DIR / "csrc"), "-o", str(tmp),
           *map(str, srcs)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def load(path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name, struct in (("rt_plan_params_size", PlanParams),
                         ("rt_welch_member_size", WelchMember)):
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
