#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's seven CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each against its plain PyTorch version on the card, drives the fused
statistics plan end to end at full width through ``SeriesFrame``, runs the
single-family plans, then the three further paths -- the §6 banded spatial
AR fit, rolling moments and cross-spectra -- times every kernel, and prints
one JSON line per phase.  The second-to-last line lists the kernels; the
last line names the device and is printed only when every phase passed.

    python3 chip_smoke.py [--seed 0] [--chunks 64]

Full width: d = 64 channels, 64 chunks of 65,536 rows (2^22 samples per
channel, 1 GiB of float32 on the card), plan = autocovariance(16),
yule_walker(8), arma(2, 1), moments(64), moments(1024), welch(256, 128).
Rolling moments (w = 64, 1024) run over the same series, cross-spectra over
its first 131,072 rows (nperseg 256, overlap 128), and the spatial fit over
a banded AR(1) of d = 131,072, b = 4, simulated for 2,048 steps.
Exits non-zero, printing no result, without a GPU or when a phase fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

D, CHUNK, H, P_YW = 64, 65536, 16, 8
WINDOWS, NPERSEG, OVERLAP = (64, 1024), 256, 128
STEP = NPERSEG - OVERLAP
CARRY = max(WINDOWS) - 1  # the fused plan's halo: W_fused - 1

# Tolerances, each held per leaf: max|kernel - plain| <= TOL * scale, the
# scale being the leaf's own max|plain| unless noted.  Both sides accumulate
# in fp32 in different orders; the PSD adds a detrend and the twiddle
# contraction, and the solves of the fits amplify input differences by the
# condition number of their block-Toeplitz systems.  A first-moment sum
# (sum of y) is a cancellation of O(|y|) terms, so it is held per channel
# against the same sum taken over |y|; a mean likewise against sqrt(var).
# Counts must match exactly.
TOL = {"lag": 1e-4, "moments": 1e-4, "psd": 1e-3, "fit": 1e-2}
# Kernels 5-7, each entry against its own scale (see scaled_error): a window
# sum against the same window's sum of |x| (or its sum of x^2, itself), held
# to the float64 plain version; a banded product against sum_o |a_o| |x_o|;
# a cross-spectral entry (s, f, i, j) against sqrt(P_i(f) P_j(f)), P the
# power averaged over segments (a single segment's coefficient can come
# arbitrarily close to 0, so its own modulus is no scale for the rounding of
# a 256-term contraction).
TOL_NEW = {"window": 1e-5, "band": 1e-5, "csd": 1e-4}

# The §6 spatial fit: a sensor-lattice-sized banded AR(1).  The true
# diagonals are uniform in +-TRUE_DIAG, so every row and column absolute sum
# is below (2b+1) TRUE_DIAG = 0.45 >= ||A||_2; the stationary covariance lies
# between I and I / (1 - 0.45^2), and the step 2 / (lambda_min + lambda_max)
# of that range contracts the error by about 0.11 per step.
SPATIAL_D, SPATIAL_B, SPATIAL_T, SPATIAL_PARTS = 131072, 4, 2048, 16
SPATIAL_STEPS, PLAIN_STEPS, TRUE_DIAG = 20, 3, 0.05
A_NORM = (2 * SPATIAL_B + 1) * TRUE_DIAG
STEP_SIZE = 2.0 / (1.0 + 1.0 / (1.0 - A_NORM**2))
CSD_ROWS = 131072
# The fit's NLL is a float32 mean of (T-1) d = 2.7e8 squared residuals.  It
# must fall at every step until its excess over the minimum reaches that
# mean's rounding (the error contracts by about 0.11 per step, the excess by
# about 0.013, so within a handful of steps); from there it may only move
# within NLL_NOISE of itself (a few float32 ulps; a float32 sum of n terms
# may round by up to about log2(n) ulps).
NLL_NOISE = 1e-6
NLL_MIN_DESCENT = 3  # steps that must fall strictly before the noise floor

KERNEL_INFO = {
    "fused_plan_megakernel": ("src/repro_torch/kernels/fused_plan/csrc/fused_plan.cu",
                              "src/repro/kernels/fused_plan/kernel.py:145"),
    "cross_window_stats": ("src/repro_torch/kernels/window_stats/csrc/window_stats.cu",
                           "src/repro/kernels/window_stats/kernel.py:67"),
    "fused_lag_moments": ("src/repro_torch/kernels/window_stats/csrc/window_stats.cu",
                          "src/repro/kernels/window_stats/kernel.py:182"),
    "segment_dft_power": ("src/repro_torch/kernels/segment_dft/csrc/segment_dft.cu",
                          "src/repro/kernels/segment_dft/kernel.py:130"),
    "window_moments": ("src/repro_torch/kernels/window_stats/csrc/window_stats.cu",
                       "src/repro/kernels/window_stats/kernel.py:272"),
    "segment_csd": ("src/repro_torch/kernels/segment_dft/csrc/segment_dft.cu",
                    "src/repro/kernels/segment_dft/kernel.py:82"),
    "banded_matvec": ("src/repro_torch/kernels/banded_matvec/csrc/banded_matvec.cu",
                      "src/repro/kernels/banded_matvec/kernel.py:41"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, **info) -> None:
    emit({"phase": "failed", "error": msg, **info})
    sys.exit(1)


def leaves(x, path: str = "") -> list:
    """(path, tensor) of every tensor in a nest of dicts, tuples and lists."""
    if isinstance(x, dict):
        return [e for k in sorted(x) for e in leaves(x[k], f"{path}/{k}")]
    if isinstance(x, (tuple, list)):
        return [e for i, item in enumerate(x) for e in leaves(item, f"{path}/{i}")]
    return [] if x is None else [(path, x)]


def leaf_error(a, b, scale=None) -> tuple:
    """(max abs error, relative error, finite) of tensor ``a`` against
    ``b``; ``scale`` (a tensor broadcasting against ``b``) makes the check
    componentwise, else it is normwise against max|b|."""
    if tuple(a.shape) != tuple(b.shape):
        fail("shape mismatch", got=list(a.shape), want=list(b.shape))
    finite = bool(torch.isfinite(a).all())
    if not a.numel():
        return 0.0, 0.0, finite
    diff = (a.double() - b.double()).abs()
    err = diff.max().item()
    if scale is None:
        ref = b.double().abs().max().item()
        return err, (err / ref if ref > 0 else err), finite
    ratio = diff / scale.double().expand_as(diff)
    ratio = torch.where(diff == 0, torch.zeros_like(ratio), ratio)
    return err, ratio.max().item(), finite


def compare(got, want, tol: float, scales: dict = None) -> dict:
    """Every leaf of ``got`` against the same leaf of ``want``, each against
    its own scale.  ``scales`` maps a leaf path to a componentwise scale.  A
    moments result {"mean", "var", "count"} holds its count exactly and its
    mean per channel against sqrt(var).  Reports the worst leaf."""
    g, w = leaves(got), leaves(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        fail("structure mismatch", got=[p for p, _ in g], want=[p for p, _ in w])
    scales = dict(scales or {})
    for path, b in w:
        if path.endswith("/mean"):
            var = dict(w)[path[: -len("mean")] + "var"]
            scales.setdefault(path, var.double().sqrt().clamp_min(1e-30))
    res = {"max_abs_err": 0.0, "max_rel_err": 0.0, "worst": None, "tol": tol, "bad": []}
    for (path, a), (_, b) in zip(g, w):
        err, rel, finite = leaf_error(a, b, scales.get(path))
        exact = path.endswith("/count") or not b.is_floating_point()
        if (not finite) or (err != 0 if exact else rel > tol):
            res["bad"].append(path)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if res["worst"] is None or rel > res["max_rel_err"]:
            res["max_rel_err"], res["worst"] = rel, path
    res["ok"] = not res["bad"]
    return res


def moment_sums_split(mom, abs_mom) -> tuple:
    """Moment sums (K, 2, d) or (2, d) as one leaf per window and moment,
    and the componentwise scale of each first-moment leaf: the same sums
    taken over |y| (``abs_mom``)."""
    mom, abs_mom = mom.reshape(-1, 2, mom.shape[-1]), abs_mom.reshape(-1, 2, mom.shape[-1])
    nest = {f"w{k}": {"sum_y": mom[k, 0], "sum_y2": mom[k, 1]} for k in range(mom.shape[0])}
    scales = {f"/w{k}/sum_y": abs_mom[k, 0].clamp_min(1e-30) for k in range(mom.shape[0])}
    return nest, scales


def compare_moment_sums(got, want, abs_mom, tol: float) -> dict:
    """Moment sums per window and per moment (see :func:`moment_sums_split`)."""
    g, scales = moment_sums_split(got, abs_mom)
    w, _ = moment_sums_split(want, abs_mom)
    return compare(g, w, tol, scales)


def bitwise_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a), leaves(b)))


def planted_errors(moments: dict, tol: float) -> dict:
    """Whether :func:`compare` rejects each of a few small errors planted in
    a copy of a moments result: each must be caught."""
    var, mean = moments["var"].clone(), moments["mean"].clone()
    var[0] *= 1.01
    mean[0] += 1e-3 * moments["var"][0].sqrt()
    plants = {"var[0]*1.01": {"var": var}, "mean[0]+1e-3*std": {"mean": mean},
              "count+1": {"count": moments["count"] + 1}}
    return {name: not compare({**moments, **change}, moments, tol)["ok"]
            for name, change in plants.items()}


def make_series(n: int, d: int, seed: int, device) -> "torch.Tensor":
    """Per channel: a stable AR(1) (phi from 0.3 to 0.9), a period-50
    sinusoid with a random phase, and white noise; made on the device from
    ``seed``.  The AR(1) recursion runs as a log-step scan."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    a = torch.linspace(0.3, 0.9, d, device=device)
    shift = 1
    while shift < n:  # x_t += a^shift x_{t-shift}: doubles the horizon each step
        x = torch.cat([x[:shift], x[shift:] + a * x[:-shift]])
        a = a * a
        shift *= 2
    phase = torch.rand((d,), generator=g, device=device) * (2 * math.pi)
    t = torch.remainder(torch.arange(n, device=device), 50).float()
    x = x + torch.sin(t[:, None] * (2 * math.pi / 50) + phase)
    x = x + 0.5 * torch.randn((n, d), generator=g, device=device)
    return x.contiguous()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(launches: list, replays: int = 10, repeats: int = 5) -> list:
    """Device ms per launch of ``launches`` (callables that each launch one
    kernel and allocate nothing), captured once into a CUDA graph and
    replayed ``replays`` times per sample; ``repeats`` samples, sorted."""
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for launch in launches:
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(repeats):
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / (replays * len(launches)))
    return sorted(samples)


def device_split(fn, calls: int = 5) -> tuple:
    """(device ms per call by kernel name, top 8; total device ms per call;
    wall ms per call) of what ``fn`` launches, from torch.profiler.  The
    split is empty when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            split[ev.key[:60]] = us / calls / 1e3
    top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:8])
    return top, sum(split.values()), wall


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def scaled_error(got, want, scale, max_elems: int = 1 << 26) -> tuple:
    """(max |got - want|, max |got - want| / scale, all finite) of two
    tensors of one shape, real or complex (complex entries by the modulus of
    the difference), in float64, over chunks of the leading axis.  ``scale``
    has ``got``'s shape or broadcasts against it with a leading 1.  An entry
    that matches exactly counts 0 whatever its scale."""
    if tuple(got.shape) != tuple(want.shape):
        fail("shape mismatch", got=list(got.shape), want=list(want.shape))
    wide = torch.complex128 if got.is_complex() else torch.float64
    rows = max(1, max_elems // max(1, got[:1].numel()))
    err, rel, finite = 0.0, 0.0, True
    for i in range(0, got.shape[0], rows):
        g, w = got[i: i + rows], want[i: i + rows]
        sc = scale if scale.shape[0] == 1 else scale[i: i + rows]
        diff = (g.to(wide) - w.to(wide)).abs()
        ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / sc.double())
        err = max(err, diff.max().item())
        rel = max(rel, ratio.max().item())
        finite = finite and bool(torch.isfinite(torch.view_as_real(g) if g.is_complex()
                                                else g).all())
    return err, rel, finite


def planted_error_caught(got, want, scale, tol: float) -> bool:
    """Whether :func:`scaled_error` rejects ``got`` with one middle entry
    moved by 2 tol of its own scale (checked on that entry's leading slice)."""
    idx = tuple(n // 2 for n in got.shape)
    sidx = tuple(i if scale.shape[k] > 1 else 0 for k, i in enumerate(idx))
    row = slice(idx[0], idx[0] + 1)
    planted = got[row].clone()
    planted[(0,) + idx[1:]] += 2 * tol * scale[sidx].item()
    srow = scale if scale.shape[0] == 1 else scale[row]
    return scaled_error(planted, want[row], srow)[1] > tol


def new_kernel_case(fn, plain, scale_fn, args: tuple, tol: float) -> dict:
    """One parity case of kernels 5-7: two launches (bitwise equal), the plain
    version, each entry against its own scale, and a planted error."""
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    want, scale = plain(*args), scale_fn(*args)
    err, rel, finite = scaled_error(got, want, scale)
    res = {"max_abs_err": err, "max_rel_err": rel, "tol": tol, "finite": finite,
           "bitwise_repeat": bool(torch.equal(got, again)),
           "planted_error_caught": planted_error_caught(got, want, scale, tol),
           "shape": list(got.shape)}
    res["ok"] = finite and rel <= tol and res["bitwise_repeat"] and res["planted_error_caught"]
    return res


def window_scale(x, window: int):
    """Per window sum: the window's sum of |x| (first moment) and its sum of
    x^2 (second), float64 plain version, (n - w + 1, 2, d)."""
    from repro_torch.kernels.window_stats.ref import window_moments_ref

    return torch.stack([window_moments_ref(x.abs(), window)[:, 0],
                        window_moments_ref(x, window)[:, 1]], 1)


def csd_scale(segments, taper, detrend: bool = True):
    """sqrt(P_i(f) P_j(f)), P the plain power averaged over segments:
    (1, F, d, d)."""
    from repro_torch.kernels.segment_dft.ref import segment_dft_power_ref

    p = segment_dft_power_ref(segments, taper, detrend).mean(0)
    return (p[:, :, None] * p[:, None, :]).sqrt()[None]


def band_scale(diags, x):
    """sum_o |a_o| |x_o| per output of the banded product."""
    from repro_torch.kernels.banded_matvec.ref import banded_matvec_ref

    return banded_matvec_ref(diags.float().abs(), x.float().abs())


def band_valid(d: int, b: int, device):
    """(d, 2b+1) mask of the diagonal slots that lie on the matrix."""
    cols = torch.arange(d, device=device)[:, None] + torch.arange(-b, b + 1, device=device)
    return (cols >= 0) & (cols < d)


def band_csr(diags):
    """The banded matrix of (d, 2b+1) diagonals as a sparse CSR tensor."""
    d, w = diags.shape
    b = (w - 1) // 2
    cols = torch.arange(d, device=diags.device)[:, None] + torch.arange(-b, b + 1,
                                                                        device=diags.device)
    valid = (cols >= 0) & (cols < d)
    crow = torch.nn.functional.pad(torch.cumsum(valid.sum(1), 0), (1, 0))
    return torch.sparse_csr_tensor(crow, cols[valid], diags[valid], (d, d))


def new_kernel_work(name: str, shape: dict) -> tuple:
    """(bytes, operations of the function, operations of the kernel's design)
    of kernel 5, 6 or 7 on the inputs of ``shape``: each input read once,
    each output written once; a segment's spectrum counts a real FFT
    (2.5 L log2 L) plus detrend and taper, where the kernel contracts
    against twiddles (4 L F); a complex outer product 6 operations per
    entry; a rolling window sum 2 operations per start and moment (add the
    entering row, subtract the leaving one) plus one square per row."""
    f4 = 4
    if name == "window_moments":
        n, d, w = shape["n"], shape["d"], shape["w"]
        n_out = n - w + 1
        ops = n * d + 4 * n_out * d
        return n * d * f4 + n_out * 2 * d * f4, ops, ops
    if name == "segment_csd":
        S, L, d = shape["S"], shape["L"], shape["d"]
        F = L // 2 + 1
        outer = 6 * S * F * d * d
        return (S * L * d * f4 + L * f4 + S * F * d * d * 8,
                S * d * (2.5 * L * math.log2(L) + 3 * L) + outer,
                S * d * (4 * L * F + 3 * L) + outer)
    if name == "banded_matvec":
        m, d, b, valid = shape["m"], shape["d"], shape["b"], shape["valid_slots"]
        return d * (2 * b + 1) * f4 + 2 * m * d * f4, 2 * valid * m, 2 * valid * m
    raise KeyError(name)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=64, help="chunks of 65,536 rows")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    from repro_torch import SeriesFrame
    from repro_torch.core.estimators.spectral import hann_window
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import _build
    from repro_torch.kernels.banded_matvec import ops as bm, ref as bmr
    from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
    from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
    from repro_torch.kernels.window_stats import ops as ws, ref as wsr

    dev = torch.device("cuda", 0)

    # ---------------------------------------------------- 1. device, build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          "nvidia-smi: no output", flush=True)
    path, nvcc_s, log = _build.build(verbose=True)
    _build.library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "nvcc_seconds": nvcc_s, "library": os.path.relpath(path, ROOT),
          "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "ptxas": ptxas})

    # ------------------------------------------------ 2. kernel parity
    n_total = args.chunks * CHUNK
    series = make_series(n_total, D, args.seed, dev)
    taper = hann_window(NPERSEG, dev)
    starts = torch.arange(CHUNK, device=dev)
    z0 = torch.zeros((), dtype=torch.int32, device=dev)
    tail = series[CHUNK - CARRY: CHUNK].contiguous()
    tail_rows = torch.arange(CARRY, device=dev)

    def mega_args(y, mask, z):
        return (y, mask, z, H, WINDOWS, (NPERSEG,), (STEP,), (taper,))

    mega_chunk = mega_args(series[: CHUNK + CARRY], starts <= CHUNK - CARRY - 1, z0)
    boundary = mega_args(series[CHUNK - CARRY: CHUNK + CARRY],
                         torch.ones(CARRY, dtype=torch.bool, device=dev),
                         torch.full((), CHUNK - CARRY, dtype=torch.int32, device=dev))
    lag_chunk = (series[: CHUNK + H], starts <= CHUNK - H - 1, H)
    lag_tail = (tail, torch.ones(CARRY, dtype=torch.bool, device=dev), H)
    mom_chunk = (series[: CHUNK + CARRY], starts <= CHUNK - CARRY - 1, 0, WINDOWS)
    mom_tail = (tail, tail_rows <= CARRY - WINDOWS[0], 0, WINDOWS[0])
    seg_chunk, _ = fpr.welch_candidates(series[: CHUNK + NPERSEG - 1],
                                        starts <= CHUNK - NPERSEG, z0, NPERSEG, STEP)
    seg_tail, _ = fpr.welch_candidates(tail, tail_rows <= CARRY - NPERSEG, z0, NPERSEG, STEP)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    edge_grid = {  # tests/test_megakernel.py EDGE_GRID, on the card
        "short_chunk": dict(n=40, block_t=512),
        "d_one": dict(n=80, d=1, windows=(4, 12)),
        "odd_seg_len": dict(n=90, seg_lens=(13,), seg_steps=(5,)),
        "lag_exceeds_chunk": dict(n=24, max_lag=40, seg_lens=(), seg_steps=(), windows=(6,)),
        "multi_window": dict(n=100, windows=(3, 8, 17), mask_holes=True),
        "multi_welch": dict(n=128, seg_lens=(16, 24), seg_steps=(8, 12), z0=7,
                            mask_holes=True),
        "tiled_offset": dict(n=96, block_t=32, z0=11, mask_holes=True),
        "no_moments": dict(n=64, windows=()),
    }

    def edge_args(n=96, d=2, max_lag=6, windows=(8,), seg_lens=(16,), seg_steps=(8,), z0=0,
                  mask_holes=False, block_t=64):
        reach = max([max_lag] + [w - 1 for w in windows] + [s - 1 for s in seg_lens])
        y = torch.randn((n + reach, d), generator=gen, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        if mask_holes:
            mask[n // 3:: 5] = False
        tapers = tuple(torch.hann_window(L, periodic=False, device=dev) for L in seg_lens)
        return (y, mask, z0, max_lag, windows, seg_lens, seg_steps, tapers), block_t

    def abs_moment_sums(y, mask, windows):
        """The moment sums over |y|: the scale of each first-moment sum."""
        return wsr.fused_lag_moments_ref(y.abs(), mask, 0, windows)[1]

    def check_kernel(fn, plain, case_args, tol):
        got = fn(*case_args)
        again = fn(*case_args)
        torch.cuda.synchronize()
        res = compare(got, plain(*case_args), tol)
        res["bitwise_repeat"] = bitwise_equal(got, again)
        res["ok"] = res["ok"] and res["bitwise_repeat"]
        return res

    def parts_check(got, again, want, tols, abs_mom):
        """Each part of a (lag, mom, ...) result with its own tolerance; the
        moment sums per window and per moment; integer-valued counts exactly."""
        parts = {}
        for part, g, w in zip(("lag", "mom", "psd", "n_seg"), got, want):
            if part == "mom":
                parts[part] = (compare_moment_sums(g, w, abs_mom, tols[part])
                               if w is not None else compare(g, w, tols[part]))
            else:
                parts[part] = compare(g, w, tols[part])
        repeat = bitwise_equal(got, again)
        return {"max_abs_err": max(r["max_abs_err"] for r in parts.values()),
                "parts": parts, "bitwise_repeat": repeat,
                "ok": repeat and all(r["ok"] for r in parts.values())}

    mega_tols = {"lag": TOL["lag"], "mom": TOL["moments"], "psd": TOL["psd"], "n_seg": 0.0}

    def mega_check(case_args, **kw):
        """(lag, mom, psds, n_segs) against the plain version."""
        got = fp.fused_plan_update(*case_args, **kw)
        again = fp.fused_plan_update(*case_args, **kw)
        want = fpr.fused_plan_update_ref(*case_args)
        y, mask, windows = case_args[0], case_args[1], case_args[4]
        abs_mom = abs_moment_sums(y, mask, windows) if windows else None
        torch.cuda.synchronize()
        return parts_check(got, again, want, mega_tols, abs_mom)

    def lag_moments_check(case_args):
        """Kernel 3: (lag, mom) against the plain version."""
        got = ws.fused_lagged_moments(*case_args)
        again = ws.fused_lagged_moments(*case_args)
        want = wsr.fused_lag_moments_ref(*case_args)
        y, mask, _, window = case_args
        abs_mom = abs_moment_sums(y, mask, window)
        torch.cuda.synchronize()
        return parts_check(got, again, want, mega_tols, abs_mom)

    parity = {"fused_plan_megakernel": {"chunk": mega_check(mega_chunk),
                                        "merge_boundary": mega_check(boundary)}}
    for name, kw in edge_grid.items():
        case, bt = edge_args(**kw)
        parity["fused_plan_megakernel"][name] = mega_check(case, block_t=bt)
    parity["cross_window_stats"] = {
        "chunk": check_kernel(ws.masked_lagged_sums, wsr.masked_lagged_sums_ref, lag_chunk,
                              TOL["lag"]),
        "tail": check_kernel(ws.masked_lagged_sums, wsr.masked_lagged_sums_ref, lag_tail,
                             TOL["lag"]),
        "lagged_sums": check_kernel(ws.lagged_sums, wsr.lagged_sums_ref,
                                    (series[:CHUNK], H), TOL["lag"]),
    }
    parity["fused_lag_moments"] = {"chunk": lag_moments_check(mom_chunk),
                                   "tail": lag_moments_check(mom_tail)}
    parity["segment_dft_power"] = {
        "chunk": check_kernel(sd.segment_fft_power, sdr.segment_dft_power_ref,
                              (seg_chunk, taper), TOL["psd"]),
        "tail": check_kernel(sd.segment_fft_power, sdr.segment_dft_power_ref,
                             (seg_tail, taper), TOL["psd"]),
    }
    # kernels 5-7: the main-path shapes, then an edge grid; every entry held
    # to its own scale (TOL_NEW), two launches bitwise equal, one planted
    # error caught per case
    centred = series - series.mean(0)
    csd_segs = series[:CSD_ROWS].unfold(0, NPERSEG, STEP).transpose(1, 2)
    fit_diags = (torch.rand((SPATIAL_D, 2 * SPATIAL_B + 1), generator=gen, device=dev) * 2
                 - 1) * TRUE_DIAG  # off-matrix slots left non-zero on purpose
    fit_x = torch.randn((SPATIAL_T - 1, SPATIAL_D), generator=gen, device=dev)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def band_plain(diags, x):
        return bmr.banded_matvec_ref(diags.float(), x.float())

    def window_case(x, w):
        return new_kernel_case(ws.windowed_moments, wsr.window_moments_ref, window_scale,
                               (x, w), TOL_NEW["window"])

    def csd_case(segs, taper_, detrend=True):
        return new_kernel_case(sd.segment_csd, sdr.segment_csd_ref, csd_scale,
                               (segs, taper_, detrend), TOL_NEW["csd"])

    def band_case(diags, x):
        return new_kernel_case(bm.banded_matvec_rows, band_plain, band_scale, (diags, x),
                               TOL_NEW["band"])

    def hann(L):
        return torch.hann_window(L, periodic=False, device=dev)

    parity["window_moments"] = {
        "main_w64": window_case(centred, WINDOWS[0]),
        "main_w1024": window_case(centred, WINDOWS[1]),
        "w_one": window_case(rand(1000, 3) + 2.0, 1),
        "w_is_n": window_case(rand(500, 5), 500),
        "n_below_chain": window_case(rand(40, 2), 7),
        "d_one": window_case(rand(3000, 1) * 10.0, 100),
    }
    parity["segment_csd"] = {
        "main": csd_case(csd_segs, taper),
        "odd_L": csd_case(rand(5, 33, 3), hann(33)),
        "d_one": csd_case(rand(4, 64, 1), hann(64)),
        "two_channel_tiles": csd_case(rand(6, 64, 70), hann(64)),
        "no_detrend": csd_case(rand(6, 64, 70) + 1.0, hann(64), False),
    }
    parity["banded_matvec"] = {
        "fit": band_case(fit_diags, fit_x),
        "simulate_nrhs_1": band_case(fit_diags, fit_x[:1]),
        "transposed_band": band_case(bmr.band_transpose(fit_diags), fit_x),
        "d_not_tile_multiple": band_case(rand(1000, 7), rand(5, 1000)),
        "b_zero": band_case(rand(300, 1), rand(3, 300)),
        "b_over_tile": band_case(rand(700, 601) * 0.05, rand(4, 700)),
        "nrhs_1": band_case(rand(1000, 7), rand(1, 1000)),
        "halo_two_float4": band_case(rand(4096, 13), rand(7, 4096)),
        "unaligned_rows": band_case(rand(1000, 7), rand(5 * 1000 + 1)[1:].view(5, 1000)),
        "bf16": band_case(rand(513, 5, dtype=torch.bfloat16),
                          rand(6, 513, dtype=torch.bfloat16)),
    }
    del fit_x
    emit({"phase": "parity", "tolerance": "per leaf: max|kernel - plain| <= tol * scale "
          "(max|plain|; sum of y: per channel, the sum over |y|); kernels 5-7 per entry: "
          "a window sum against that window's sum of |x| (or of x^2), float64 plain; a "
          "banded product against sum |a||x|; a cross-spectral entry against "
          "sqrt(P_i(f) P_j(f)), P averaged over segments",
          "kernels": parity})
    bad = [f"{k}/{c}" for k, cases in parity.items() for c, r in cases.items() if not r["ok"]]
    if bad:
        fail("kernel parity", cases=bad)

    # ------------------------------------------------ 3. main path
    chunks = list(series.split(CHUNK))

    def run_plan(backend, chunk_list):
        frame = SeriesFrame.from_chunks(chunk_list[:-1], backend=backend, device=dev)
        frame.autocovariance(H)
        frame.yule_walker(P_YW)
        frame.arma(2, 1)
        frame.moments(WINDOWS[0])
        frame.moments(WINDOWS[1])
        frame.welch(nperseg=NPERSEG, overlap=OVERLAP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = frame.collect()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame.append(chunk_list[-1])
        second = frame.collect()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return first, second, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    run_plan("cuda", chunks[:3])  # warm-up: library, cuBLAS and cuSOLVER handles
    reset_launch_counts()
    first, second, collect_ms, append_ms = run_plan("cuda", chunks)
    counts = launch_counts()
    updates = len(chunks)
    plain_first, plain_second, plain_collect_ms, plain_append_ms = run_plan("torch", chunks)
    # where the time goes: device time by kernel over one whole run, against
    # its wall time (the run includes frame set-up, collect, append, collect)
    busy_by_kernel, busy_ms, wall_ms = device_split(lambda: run_plan("cuda", chunks), calls=1)

    member_tol = {"autocovariance": TOL["lag"], "yule_walker": TOL["fit"],
                  "arma": TOL["fit"], "moments": TOL["moments"],
                  "moments_2": TOL["moments"], "welch": TOL["psd"]}
    members = {}
    for tag, got, want in (("collect", first, plain_first), ("append", second, plain_second)):
        for name, tol in member_tol.items():
            members[f"{tag}/{name}"] = compare(got[name], want[name], tol)
    planted = planted_errors(plain_second["moments"], TOL["moments"])
    shapes_ok = (tuple(second["autocovariance"].shape) == (H + 1, D, D)
                 and tuple(second["yule_walker"][0].shape) == (P_YW, D, D)
                 and tuple(second["arma"][1].shape) == (1, D, D)
                 and tuple(second["welch"][1].shape) == (NPERSEG // 2 + 1, D)
                 and int(second["moments"]["count"].item()) == n_total - WINDOWS[0] + 1)
    counts_ok = (counts["fused_plan_megakernel"] == 2 * updates
                 and all(counts[k] >= 1 for k in ("cross_window_stats", "fused_lag_moments",
                                                  "segment_dft_power")))
    emit({"phase": "main_path", "samples_per_channel": n_total, "channels": D,
          "chunks": updates, "updates": updates, "launches": counts,
          "collect_ms": collect_ms, "append_collect_ms": append_ms,
          "samples_per_s": (n_total - CHUNK) * D / (collect_ms / 1e3),
          "plain_collect_ms": plain_collect_ms, "plain_append_collect_ms": plain_append_ms,
          "profiled_run": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                           "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
                           "device_ms_by_kernel": busy_by_kernel},
          "members": members, "shapes_ok": shapes_ok, "launch_counts_ok": counts_ok,
          "planted_errors_caught": planted})
    if not counts_ok:
        fail("main-path launch counts", launches=counts, updates=updates)
    if not all(planted.values()):
        fail("the member check misses a planted error", planted=planted)
    if not shapes_ok or not all(r["ok"] for r in members.values()):
        fail("main-path results", bad=[k for k, r in members.items() if not r["ok"]])

    # ------------------------------------------------ 4. single-family plans
    single = {}
    plans = {
        "lag_only": (lambda f: f.autocovariance(H), "cross_window_stats"),
        "moments_only": (lambda f: (f.moments(WINDOWS[0]), f.moments(WINDOWS[1])),
                         "fused_lag_moments"),
        "welch_only": (lambda f: f.welch(nperseg=NPERSEG, overlap=OVERLAP),
                       "segment_dft_power"),
    }
    few = chunks[:8]
    for name, (declare, kernel) in plans.items():
        results = {}
        for backend in ("cuda", "torch"):
            frame = SeriesFrame.from_chunks(few, backend=backend, device=dev)
            declare(frame)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[backend] = frame.collect()
            torch.cuda.synchronize()
            results[backend + "_ms"] = (time.perf_counter() - t0) * 1e3
            results[backend + "_counts"] = launch_counts()
        cmp = compare(results["cuda"], results["torch"],
                      TOL["psd"] if name == "welch_only" else TOL["lag"])
        launched = results["cuda_counts"][kernel]
        single[name] = {"kernel": kernel, "launches": launched, "chunks": len(few),
                        "collect_ms": results["cuda_ms"], "plain_collect_ms": results["torch_ms"],
                        "samples_per_s": len(few) * CHUNK * D / (results["cuda_ms"] / 1e3),
                        **cmp}
        single[name]["ok"] = cmp["ok"] and launched >= 2 * len(few)
    emit({"phase": "single_family", "plans": single})
    if not all(r["ok"] for r in single.values()):
        fail("single-family plans", bad=[k for k, r in single.items() if not r["ok"]])

    # ------------------------------------------------ 5. spatial fit (§6)
    from repro_torch import banded_predict, fit_banded_ar, welch_csd, windowed_moments
    from repro_torch.core.estimators.spatial import banded_nll
    from repro_torch.core.estimators.spectral import welch_psd
    from repro_torch.core.estimators.stats import mean as series_mean

    g_fit = torch.Generator(device=dev)
    g_fit.manual_seed(args.seed + 2)
    valid = band_valid(SPATIAL_D, SPATIAL_B, dev)
    true_diags = (torch.rand((SPATIAL_D, 2 * SPATIAL_B + 1), generator=g_fit, device=dev) * 2
                  - 1) * TRUE_DIAG * valid
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xs = torch.empty((SPATIAL_T, SPATIAL_D), device=dev)
    xs[0] = torch.randn(SPATIAL_D, generator=g_fit, device=dev)
    for t in range(SPATIAL_T - 1):  # x_{t+1} = A x_t + eps_t, kernel 7 at nrhs = 1
        xs[t + 1] = banded_predict(true_diags, xs[t]) + torch.randn(
            SPATIAL_D, generator=g_fit, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim_launches = launch_counts()["banded_matvec"]
    fit = fit_banded_ar(xs, SPATIAL_B, n_steps=SPATIAL_STEPS, step_size=STEP_SIZE,
                        num_parts=SPATIAL_PARTS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    band_launches = launch_counts()["banded_matvec"]
    fit_launches = band_launches - sim_launches
    trace = fit.nll_trace.tolist()
    rises = [b - a for a, b in zip(trace, trace[1:])]
    descent = next((k for k, r in enumerate(rises) if r >= 0), len(rises))
    coef_err = (fit.diags - true_diags)[valid]
    rms_err = coef_err.square().mean().sqrt().item()

    # the first PLAIN_STEPS steps again, on each backend
    short = {be: fit_banded_ar(xs, SPATIAL_B, n_steps=PLAIN_STEPS, step_size=STEP_SIZE,
                               num_parts=SPATIAL_PARTS, backend=be)
             for be in ("cuda", "torch")}
    plain_diags_err = (short["cuda"].diags - short["torch"].diags).abs().max().item()
    plain_nll_rel = ((short["cuda"].nll_trace - short["torch"].nll_trace).abs()
                     / short["torch"].nll_trace.abs()).max().item()
    del short

    # one step's device time, split: the kernel (its prepared launch), the
    # d/d diags shifted products (on this step's cotangent), the rest
    x_prev = xs[:-1]

    def fit_step():
        dg = fit.diags.clone().requires_grad_(True)
        v = banded_nll(dg, xs)
        torch.autograd.grad(v, dg)

    step_event_ms = cuda_ms(fit_step, 5, warmup=1)
    step_split, step_busy_ms, step_wall_ms = device_split(fit_step, calls=3)
    step_ms = step_busy_ms if step_busy_ms > 0 else step_event_ms
    prep_fit = bm.prepare_banded_matvec(fit.diags.t().contiguous(), x_prev)
    fit_kernel_ms = graph_ms([prep_fit.launch])
    kernel_ms = fit_kernel_ms[len(fit_kernel_ms) // 2]
    cot = (xs[1:] - prep_fit.launch()) * (-1.0 / (SPATIAL_T - 1))
    ddiags_ms = cuda_ms(lambda: bmr.band_gradient(cot, x_prev, SPATIAL_B), 5, warmup=1)

    # a loss differentiated with respect to x: the forward and A^T g
    grads, dx_launches = {}, None
    for be in ("cuda", "torch"):
        xx = x_prev.clone().requires_grad_(True)
        reset_launch_counts()
        loss = torch.sin(banded_predict(true_diags, xx, backend=be)).square().sum()
        (grads[be],) = torch.autograd.grad(loss, xx)
        torch.cuda.synchronize()
        if be == "cuda":
            dx_launches = launch_counts()["banded_matvec"]
        del xx, loss
    # |d loss / d pred| = |sin(2 pred)| <= 1
    dx_scale = band_scale(bmr.band_transpose(true_diags), torch.ones((1, SPATIAL_D), device=dev))
    dx_err, dx_rel, dx_finite = scaled_error(grads["cuda"], grads["torch"], dx_scale)
    del grads, cot, prep_fit

    spatial = {
        "phase": "spatial_fit", "d": SPATIAL_D, "bandwidth": SPATIAL_B, "T": SPATIAL_T,
        "num_parts": SPATIAL_PARTS, "steps": SPATIAL_STEPS, "step_size": STEP_SIZE,
        "simulate_ms": (t1 - t0) * 1e3, "simulate_launches": sim_launches,
        "fit_ms": (t2 - t1) * 1e3, "fit_ms_per_step": (t2 - t1) * 1e3 / SPATIAL_STEPS,
        "launches_per_step": fit_launches / SPATIAL_STEPS, "nll_trace": trace,
        "nll_monotone": (descent >= NLL_MIN_DESCENT
                         and all(r <= NLL_NOISE * abs(a) for r, a in zip(rises, trace))),
        "nll_strict_descent_steps": descent, "nll_max_rise": max(rises),
        "nll_noise_rel": NLL_NOISE,
        "rms_coef_err": rms_err, "max_coef_err": coef_err.abs().max().item(),
        "expected_rms_coef_err": 1 / math.sqrt(SPATIAL_T),
        "plain_steps": PLAIN_STEPS, "plain_diags_max_abs_err": plain_diags_err,
        "plain_nll_max_rel_err": plain_nll_rel,
        "step_device_ms": {"step": step_ms, "step_events_ms": step_event_ms,
                           "step_wall_ms": step_wall_ms, "kernel": kernel_ms,
                           "d_diags": ddiags_ms, "rest": step_ms - kernel_ms - ddiags_ms,
                           "by_kernel_name": step_split,
                           "note": "step: profiler device-busy ms per step (CUDA-event ms "
                                   "if the profiler saw no device work); kernel: CUDA graph of "
                                   "the prepared launch; d_diags: CUDA events around the "
                                   "shifted products on this step's cotangent"},
        "dx_loss": {"launches": dx_launches, "max_abs_err": dx_err, "max_rel_err": dx_rel,
                    "tol": TOL_NEW["band"], "finite": dx_finite},
    }
    spatial["ok"] = (spatial["nll_monotone"] and rms_err < 0.05 and math.isfinite(rms_err)
                     and fit_launches == SPATIAL_STEPS and plain_diags_err <= 1e-5
                     and plain_nll_rel <= 1e-5 and dx_launches == 2 and dx_finite
                     and dx_rel <= TOL_NEW["band"])
    emit(spatial)
    if not spatial["ok"]:
        fail("spatial fit")
    del xs, x_prev, fit

    # ------------------------------------------------ 6. rolling moments
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rolling = {w: windowed_moments(series, w) for w in WINDOWS}
    torch.cuda.synchronize()
    rolling_ms = (time.perf_counter() - t0) * 1e3
    rolling_launches = launch_counts()["window_moments"]
    mu = series_mean(series)
    members, plain32 = {}, {}
    for w, got in rolling.items():
        s64 = wsr.window_moments_ref(series - mu, w)  # float64 plain sums
        m_c = s64[:, 0] / w
        want = {"mean": m_c + mu, "var": torch.clamp(s64[:, 1] / w - m_c * m_c, min=0.0)}
        members[f"w{w}"] = compare(got, want, TOL["moments"])
        members[f"w{w}"]["shape_ok"] = tuple(got["var"].shape) == (n_total - w + 1, D)
        members[f"w{w}"]["var_nonnegative"] = bool((got["var"] >= 0).all())
        # the reference's float32 cumulative-sum formula, against float64
        s32 = wsr.window_moments_ref(series - mu, w, torch.float32)
        plain32[f"w{w}"] = scaled_error(s32, s64, window_scale(series - mu, w))[1]
        del s64, s32, want
    rolling_ok = (rolling_launches == len(WINDOWS)
                  and all(r["ok"] and r["shape_ok"] and r["var_nonnegative"]
                          for r in members.values()))
    emit({"phase": "rolling_moments", "samples_per_channel": n_total, "channels": D,
          "windows": list(WINDOWS), "ms": rolling_ms, "launches": rolling_launches,
          "output_gbytes": sum((n_total - w + 1) * 2 * D * 4 for w in WINDOWS) / 1e9,
          "against_float64": members,
          "window_sums_parity": {k: parity["window_moments"][f"main_w{w}"]["max_rel_err"]
                                 for k, w in (("w64", 64), ("w1024", 1024))},
          "float32_cumsum_formula_rel_err": plain32, "ok": rolling_ok})
    if not rolling_ok:
        fail("rolling moments")
    del rolling

    # ------------------------------------------------ 7. cross-spectra
    x_csd = series[:CSD_ROWS]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    freqs, csd = welch_csd(x_csd, nperseg=NPERSEG, overlap=OVERLAP)
    torch.cuda.synchronize()
    csd_ms = (time.perf_counter() - t0) * 1e3
    csd_launches = launch_counts()["segment_csd"]
    _, psd = welch_psd(x_csd, nperseg=NPERSEG, overlap=OVERLAP)  # kernel 4
    psd_launches = launch_counts()["segment_dft_power"]
    mult = torch.full((NPERSEG // 2 + 1,), 2.0, device=dev)
    mult[0] = mult[-1] = 1.0
    psd2 = psd / mult[:, None]  # two-sided, as the CSD diagonal
    pair = (psd2[:, :, None] * psd2[:, None, :]).sqrt()[None]
    herm = scaled_error(csd[None], csd.transpose(1, 2).conj()[None], pair)
    diag = torch.diagonal(csd, dim1=1, dim2=2)
    diag_err = scaled_error(diag.real[None], psd2[None], psd2[None])
    imag_diag = diag.imag.abs().max().item()
    _, csd_plain = welch_csd(x_csd, nperseg=NPERSEG, overlap=OVERLAP, backend="torch")
    plain_err = scaled_error(csd[None], csd_plain[None], pair)
    cross = {"phase": "cross_spectra", "rows": CSD_ROWS, "channels": D, "nperseg": NPERSEG,
             "overlap": OVERLAP, "segments": (CSD_ROWS - OVERLAP) // STEP,
             "primitive_gbytes": (CSD_ROWS - OVERLAP) // STEP * (NPERSEG // 2 + 1) * D * D * 8
             / 1e9, "ms": csd_ms, "launches": csd_launches, "psd_launches": psd_launches,
             "shape": list(csd.shape), "dtype": str(csd.dtype),
             "hermitian_rel_err": herm[1], "diag_vs_welch_psd_rel_err": diag_err[1],
             "diag_max_abs_imag": imag_diag, "vs_plain_rel_err": plain_err[1],
             "tol": TOL_NEW["csd"], "freqs_ok": bool(torch.equal(
                 freqs, torch.fft.rfftfreq(NPERSEG, device=dev)))}
    cross["ok"] = (csd_launches == 1 and psd_launches == 1 and herm[2] and plain_err[2]
                   and tuple(csd.shape) == (NPERSEG // 2 + 1, D, D)
                   and csd.dtype == torch.complex64 and cross["freqs_ok"]
                   and max(herm[1], diag_err[1], plain_err[1]) <= TOL_NEW["csd"])
    emit(cross)
    if not cross["ok"]:
        fail("cross spectra")
    del csd, csd_plain
    torch.cuda.empty_cache()

    # ------------------------------------------------ 8. timing
    # Rotate over 8 distinct chunks (134 MB > the 50 MB L2) so every call
    # reads its series from device memory, as the main path does.
    rot = max(1, min(8, args.chunks - 1))
    ys_mega = [mega_args(series[i * CHUNK: i * CHUNK + CHUNK + CARRY], mega_chunk[1], z0)
               for i in range(rot)]
    ys_lag = [(series[i * CHUNK: i * CHUNK + CHUNK + H], lag_chunk[1], H) for i in range(rot)]
    ys_mom = [(series[i * CHUNK: i * CHUNK + CHUNK + CARRY], mom_chunk[1], 0, WINDOWS)
              for i in range(rot)]
    segs = [fpr.welch_candidates(series[i * CHUNK: i * CHUNK + CHUNK + NPERSEG - 1],
                                 starts <= CHUNK - NPERSEG, z0, NPERSEG, STEP)[0].contiguous()
            for i in range(rot)]

    def rotating(fn, arg_list):
        it = [0]

        def call():
            fn(*arg_list[it[0] % rot])
            it[0] += 1
        return call

    def rfft_power(s, w):
        return torch.fft.rfft((s - s.mean(1, keepdim=True)) * w[:, None], dim=1).abs() ** 2

    def lag_library(a, b):
        """S(h)^T for h = 0..H as one batched fp32 GEMM (TF32 is off)."""
        return torch.matmul(b.unfold(0, a.shape[0], 1), a)

    # The kernel alone: its launches (with the fixed-order reduction) on
    # operands prepared once per chunk, captured into one CUDA graph and
    # replayed, so neither host work nor launch gaps enter the device time.
    lag_operands = [(torch.where(m[:, None], y[:CHUNK], 0.0).contiguous(), y.contiguous())
                    for y, m, _ in ys_lag]
    prepared = {
        "fused_plan_megakernel": [fp.prepare_fused_plan(*a) for a in ys_mega],
        "cross_window_stats": [ws.prepare_cross_lagged_sums(a, b, H) for a, b in lag_operands],
        "fused_lag_moments": [ws.prepare_fused_lag_moments(y.contiguous(), m, h, w)
                              for y, m, h, w in ys_mom],
        "segment_dft_power": [sd.prepare_segment_power(
            s, *(t.contiguous() for t in sdr.dft_power_matrices(NPERSEG, taper)), True)
            for s in segs],
    }
    wrappers = {
        "fused_plan_megakernel": (fp.fused_plan_update, fpr.fused_plan_update_ref, ys_mega),
        "cross_window_stats": (ws.masked_lagged_sums, wsr.masked_lagged_sums_ref, ys_lag),
        "fused_lag_moments": (ws.fused_lagged_moments, wsr.fused_lag_moments_ref, ys_mom),
        "segment_dft_power": (sd.segment_fft_power, sdr.segment_dft_power_ref,
                              [(s, taper) for s in segs]),
    }
    libraries = {"cross_window_stats": (lag_library, lag_operands),
                 "segment_dft_power": (rfft_power, [(s, taper) for s in segs])}
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the library GEMM would not be full fp32")
    library_check = {
        "cross_window_stats": compare(lag_library(*lag_operands[0]).transpose(1, 2),
                                      wsr.cross_lagged_sums_ref(*lag_operands[0], H),
                                      TOL["lag"]),
        "segment_dft_power": compare(rfft_power(segs[0], taper),
                                     sdr.segment_dft_power_ref(segs[0], taper), TOL["psd"]),
    }
    if not all(r["ok"] for r in library_check.values()):
        fail("a library yardstick disagrees with the plain version", check=library_check)

    split = {name: device_split(rotating(fn, a))[0] for name, (fn, _, a) in wrappers.items()}
    timing = {}
    for name, (fn, plain, a) in wrappers.items():
        launches = [p.launch for p in prepared[name]]
        samples = graph_ms(launches)
        lib = libraries.get(name)
        timing[name] = {
            "ms": samples[len(samples) // 2], "ms_samples": samples,
            "profiler_ms": device_split(rotating(lambda f: f(), [(f,) for f in launches]),
                                        calls=rot)[1],
            "wrapper_ms": cuda_ms(rotating(fn, a), 40),
            "plain_ms": cuda_ms(rotating(plain, a), 8),
            "library_ms": cuda_ms(rotating(*lib), 40) if lib else None,
        }

    # Bounds from this run's inputs: the bytes the function must move (each
    # input read once, each output written once) and the fp32 operations it
    # needs (valid starts and segments only).  The power of a segment counts
    # a real FFT, 2.5 L log2 L, plus detrend, taper and |.|^2; the kernels'
    # twiddle contraction (4 L F per segment and channel) is the cost of
    # this design and is reported beside the bound, not in it.
    f4 = 4
    F = NPERSEG // 2 + 1
    fft_flops = 2.5 * NPERSEG * math.log2(NPERSEG) + 3 * NPERSEG + 3 * F
    twiddle_flops = 4 * NPERSEG * F + 3 * NPERSEG + 3 * F
    n_mega = int(mega_chunk[1].sum().item())
    n_seg = int(fp.fused_plan_update(*mega_chunk)[3][0].item())
    rows_mom = CHUNK + CARRY
    mom_flops_rows = rows_mom * D * (1 + 4 * len(WINDOWS))
    mega_bytes = (rows_mom * D * f4 + CHUNK + NPERSEG * f4
                  + ((H + 1) * D * D + len(WINDOWS) * 2 * D + F * D) * f4)
    mega_lag_flops = n_mega * (H + 1) * D * D * 2
    n_lag = int(lag_chunk[1].sum().item())
    lag_bytes = (CHUNK + H) * D * f4 + CHUNK + (H + 1) * D * D * f4
    n_mom = int(mom_chunk[1].sum().item())
    mom_bytes = rows_mom * D * f4 + CHUNK + (D * D + len(WINDOWS) * 2 * D) * f4
    S = segs[0].shape[0]
    seg_bytes = S * NPERSEG * D * f4 + NPERSEG * f4 + S * F * D * f4
    work = {  # (bytes, function flops, flops of this design)
        "fused_plan_megakernel": (mega_bytes,
                                  mega_lag_flops + mom_flops_rows + n_seg * D * fft_flops,
                                  mega_lag_flops + mom_flops_rows + n_seg * D * twiddle_flops),
        "cross_window_stats": (lag_bytes, n_lag * (H + 1) * D * D * 2,
                               n_lag * (H + 1) * D * D * 2),
        "fused_lag_moments": (mom_bytes, n_mom * D * D * 2 + mom_flops_rows,
                              n_mom * D * D * 2 + mom_flops_rows),
        "segment_dft_power": (seg_bytes, S * D * fft_flops, S * D * twiddle_flops),
    }
    bounds = {k: bound_ms(b, f) for k, (b, f, _) in work.items()}
    shapes = {
        "fused_plan_megakernel": f"y ({CHUNK + CARRY}, {D}), H={H}, windows={WINDOWS}, "
                                 f"welch {NPERSEG}/{OVERLAP}",
        "cross_window_stats": f"y ({CHUNK + H}, {D}), H={H}",
        "fused_lag_moments": f"y ({CHUNK + CARRY}, {D}), H=0, windows={WINDOWS}",
        "segment_dft_power": f"segments ({S}, {NPERSEG}, {D})",
    }
    # kernels 5-7 at their paths' shapes: each operand exceeds the 50 MB L2
    # (1.07 GB series, 67 MB of segments, a 1.07 GB fit operand), so one
    # prepared launch replayed reads from device memory every time
    fit_x = torch.randn((SPATIAL_T - 1, SPATIAL_D), generator=gen, device=dev)
    C256, S256 = (t.contiguous() for t in sdr.dft_power_matrices(NPERSEG, taper))
    segs_c = csd_segs.contiguous()
    xt = centred.t().contiguous()[None]  # (1, d, n) for avg_pool1d
    csr, fit_xt = band_csr(fit_diags * band_valid(SPATIAL_D, SPATIAL_B, dev)), fit_x.t().contiguous()
    F = torch.nn.functional

    def pool_sums(w):
        return torch.stack([F.avg_pool1d(xt, w, 1) * w, F.avg_pool1d(xt * xt, w, 1) * w])

    def fft_csd(segs):
        f = torch.fft.rfft((segs - segs.mean(1, keepdim=True)) * taper[:, None], dim=1)
        return torch.einsum("sfi,sfj->sfij", f, f.conj())

    new_cases = {  # name: (prepared launch, wrapper call, plain call, library call, shape)
        "window_moments_w64": (ws.prepare_window_moments(centred, 64),
                               lambda: ws.windowed_moments(centred, 64),
                               lambda: wsr.window_moments_ref(centred, 64),
                               lambda: pool_sums(64), dict(n=n_total, d=D, w=64)),
        "window_moments": (ws.prepare_window_moments(centred, 1024),
                           lambda: ws.windowed_moments(centred, 1024),
                           lambda: wsr.window_moments_ref(centred, 1024),
                           lambda: pool_sums(1024), dict(n=n_total, d=D, w=1024)),
        "segment_csd": (sd.prepare_segment_csd(segs_c, C256, S256, True),
                        lambda: sd.segment_csd(segs_c, taper),
                        lambda: sdr.segment_csd_ref(segs_c, taper),
                        lambda: fft_csd(segs_c),
                        dict(S=segs_c.shape[0], L=NPERSEG, d=D)),
        "banded_matvec": (bm.prepare_banded_matvec(fit_diags.t().contiguous(), fit_x),
                          lambda: bm.banded_matvec_rows(fit_diags, fit_x),
                          lambda: bmr.banded_matvec_ref(fit_diags, fit_x),
                          lambda: torch.sparse.mm(csr, fit_xt),
                          dict(m=SPATIAL_T - 1, d=SPATIAL_D, b=SPATIAL_B,
                               valid_slots=int(band_valid(SPATIAL_D, SPATIAL_B, dev).sum()))),
    }
    # each yardstick computes the same function: check it against the plain version
    library_check.update({
        "window_moments": {"max_rel_err": scaled_error(
            pool_sums(1024)[:, 0].permute(2, 0, 1), wsr.window_moments_ref(centred, 1024),
            window_scale(centred, 1024))[1]},
        "segment_csd": {"max_rel_err": scaled_error(fft_csd(segs_c), sdr.segment_csd_ref(
            segs_c, taper), csd_scale(segs_c, taper))[1]},
        "banded_matvec": {"max_rel_err": scaled_error(
            torch.sparse.mm(csr, fit_xt).t(), bmr.banded_matvec_ref(fit_diags * band_valid(
                SPATIAL_D, SPATIAL_B, dev), fit_x), band_scale(fit_diags, fit_x))[1]},
    })
    for name in ("window_moments", "segment_csd", "banded_matvec"):
        library_check[name]["ok"] = library_check[name]["max_rel_err"] <= 1e-4
        if not library_check[name]["ok"]:
            fail("a library yardstick disagrees with the plain version", check=library_check)
    for name, (prep, wrapper, plain, lib, shape) in new_cases.items():
        samples = graph_ms([prep.launch])
        kernel = name if name in KERNEL_INFO else "window_moments"
        nbytes, flops, design = new_kernel_work(kernel, shape)
        b_ms, b_by = bound_ms(nbytes, flops)
        timing[name] = {
            "ms": samples[len(samples) // 2], "ms_samples": samples,
            # CUDA events around launches made from the host (the profiler
            # recorded none or a third of these launches in one run)
            "host_launch_ms": cuda_ms(prep.launch, 5, warmup=1),
            "wrapper_ms": cuda_ms(wrapper, 5, warmup=1),
            "plain_ms": cuda_ms(plain, 3, warmup=1),
            "library_ms": cuda_ms(lib, 3, warmup=1),
        }
        bounds[name] = (b_ms, b_by)
        work[name] = (nbytes, flops, design)
        shapes[name] = ", ".join(f"{k}={v}" for k, v in shape.items())
        split[name] = None
    del new_cases, fit_x, fit_xt, csr, segs_c, xt
    emit({"phase": "timing", "note": "main-path chunk shapes, cold series (8 rotating "
          "chunks); ms: median over repeats of a CUDA graph of the prepared launches "
          "(kernel and its reduction), ms_samples sorted; profiler_ms: profiler device "
          "time of the same launches made from the host; wrapper_ms, plain_ms, library_ms: "
          "CUDA events around back-to-back calls, host work included",
          "kernels": {k: {**t, "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                          "share_of_bound": bounds[k][0] / t["ms"],
                          "gbytes": work[k][0] / 1e9, "function_gflop": work[k][1] / 1e9,
                          "design_gflop": work[k][2] / 1e9,
                          "design_ms_at_fp32_peak": work[k][2] / PEAK_FP32 * 1e3,
                          "shape": shapes[k], "device_ms_by_kernel": split[k]}
                      for k, t in timing.items()},
          "library_check": library_check,
          "library_calls": {"window_moments": "F.avg_pool1d(x^T, w, 1) * w on x and on x^2 "
                                              "(two calls: no single call gives both sums)",
                            "segment_csd": "torch.fft.rfft of the detrended, tapered segments, "
                                           "then einsum('sfi,sfj->sfij', f, f.conj())",
                            "banded_matvec": "torch.sparse.mm(band as CSR, x^T) (x^T "
                                             "prepared once)"}})

    # ------------------------------------------------ 9. the kernels line
    # launches: each kernel's count from the run of its own path (the fused
    # plan for kernels 1-4, the spatial fit with its simulation for 7,
    # rolling moments for 5, cross-spectra for 6); ms and bound of kernel 5
    # at w = 1024
    path_launches = {**counts, "banded_matvec": band_launches,
                     "window_moments": rolling_launches, "segment_csd": csd_launches}
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in parity[name].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": t["library_ms"],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
