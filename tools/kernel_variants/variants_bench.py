"""Time design variants of the port's kernels on one NVIDIA GPU, each held
against the port's plain version.

    python3 tools/kernel_variants/variants_bench.py [moments|all]
    python3 tools/kernel_variants/variants_bench.py banded [BASELINE_KERNELS_DIR]
    python3 tools/kernel_variants/variants_bench.py stats BASELINE_KERNELS_DIR
    python3 tools/kernel_variants/variants_bench.py turns BASELINE_KERNELS_DIR
    python3 tools/kernel_variants/variants_bench.py lagmom [BASELINE_KERNELS_DIR]
    python3 tools/kernel_variants/variants_bench.py split [BASELINE_KERNELS_DIR]
    python3 tools/kernel_variants/variants_bench.py session [BASELINE_KERNELS_DIR]
    python3 tools/kernel_variants/variants_bench.py session_k3 [BASELINE_KERNELS_DIR]
    python3 tools/kernel_variants/variants_bench.py swa

moments: builds the variant file with nvcc into build/kernel_variants/ and,
at chip_smoke.py's shape (2^22 x 64, w = 64 and 1,024), prints one line per
variant: the median of 5 samples of 10 back-to-back launches (CUDA events),
the extremes, and the largest error against the plain version relative to
its largest value.

banded: kernel 7 (the banded product) and 7b (the gradient of its
diagonals) at the spatial fit's shapes, x and g (2,047, 131,072), b = 4, and
at one right-hand side cold: every design point of BAND_POINTS (rows in
flight a thread, patched into copies of banded_matvec.cu; threads per CTA,
row slabs and waves of the wrappers' launch shapes), held to the plain
version, then every point of each kernel with the shipped one in turns; with BASELINE_KERNELS_DIR (an earlier ``src/repro_torch/kernels``),
old against new in turns (baseline, this, this, baseline) for the product at
both shapes, A^T through the flag against the transposed copy, the wrapper
at one right-hand side, and d diags against the baseline's plain products.
Samples go to build/kernel_variants/variants_banded.json.

stats: times the kernels of this checkout (1-8, 7b, kernel 3 also at the
moments finalize's tail shape, kernel 8 also at lm_moe's prefill layer, q
(4, 8,000, 40, 128), k/v (4, 8,000, 8, 128), W = S) against those of another version of
``src/repro_torch/kernels`` (a copy of the package directory, for example a
parent commit's, unpacked with ``git archive`` into a directory that
.gitignore lists), both built here and loaded side by side, at
chip_smoke.py's shapes, in turns (baseline, this, this, baseline, STATS_ROUNDS
times: 2 STATS_ROUNDS paired turns, and in how many of them this checkout
was faster); then kernel 3's design points (``lagmom``); then sweeps the
launch shapes of this checkout's kernels 1-2 (lag and moment slabs, Welch
candidates per CTA) and kernel 4's segments per CTA on the FFT
path at 511 and 1,023 segments (the main path's and the cross-spectra's
welch_psd), and kernel 8's design points and ablations (``swa`` alone
runs only those): a copy of swa_attention.cu patched to each point of
SWA_POINTS (key tile, ring stages, consumer warpgroups, overlap, pingpong)
and to the ablations of SWA_ABLATIONS (the TMA stream, the products or the
softmax compiled out), at q (4, 8,000, 32, 80), k/v (4, 8,000, 8, 80),
W = 4,096, and the points of SWA_TURNS timed again in turns.  Each time is
the median of 5 samples of a CUDA graph of 8 prepared launches (kernels
1-4, on 8 distinct chunks: a cold 134 MB) or of one launch (kernels 5-8),
replayed 10 times.  Writes every sample to
build/kernel_variants/variants_stats.json (``swa``: variants_swa.json).

turns: the first part of ``stats`` alone (every kernel against the
baseline's in turns, with their bitwise equality), about a minute of
command time; samples go to build/kernel_variants/variants_turns.json.

lagmom: kernel 3's symmetric path (H = 0) at the main path's chunk (y (66,559,
64), 65,536 starts, windows (64, 1,024)), the moments finalize's tail (y
(1,086, 64), 960 of 1,023 starts, w = 64) and a moments-only plan's merge
boundary (y (2,046, 64), 1,023 starts): every design point of LAGMOM_POINTS
(ring rows and stages, launch bounds, patched into copies of
window_stats.cu; CTAs per SM, cluster size and least slab of ops.py), held
to the plain version, then every point with the shipped one in turns,
LAGMOM_ROUNDS times; with BASELINE_KERNELS_DIR, the shipped point against
the baseline's kernel 3 in turns at the chunk and the tail.  Samples go to
build/kernel_variants/variants_lagmom.json.

session: batched kernel 3 (H = 0) at the session's shapes first -- a
query's moments(32) tail (4,096 tenants), a moments-only plan's chunk and
merge boundary (65,536 tenants) -- each held to the plain version, with its
bound, the plain version's and the library call's times, a clock64() probe
of its phases, the design points of SESSION_K3_POINTS (tenants per CTA,
row lanes, launch bounds) in turns, and with BASELINE_KERNELS_DIR old
against new in turns beside the library call (samples in
build/kernel_variants/variants_session_k3.json; ``session_k3`` runs only
this part); then kernels 1 and 2 at the multi-tenant session's shapes
(65,536 tenants of d = 16; a query's lag tail at 4,096 tenants): the role
split of batched kernel 1 at the chunk and the merge boundary (copies of
fused_plan.cu with roles compiled out, SESSION_ABLATIONS), Welch candidates
per CTA swept at the chunk, and with BASELINE_KERNELS_DIR old against new in
turns (baseline, this, this, baseline, SESSION_ROUNDS times: 2 SESSION_ROUNDS
paired turns) at the chunk and the merge boundary (with the plain version),
the lag tail (with the torch.matmul yardstick), the main path's chunk and
the store's autocovariance_blocked (d = 64), and the chunk and the lag tail
at d = 32 (the 32-channel tile), each pair's outputs checked for bitwise
equality.  ``stats`` runs it too.  Samples go to
build/kernel_variants/variants_session.json.

split: kernel 3's device kernels per call, by name, with their device ms
per call (torch.profiler over 8 rotating prepared launches, after one warm
pass), at the chunk, the tail and the merge boundary: of the baseline's
package when BASELINE_KERNELS_DIR is given, else of this checkout's
(``stats`` reports both).
"""
import ctypes
import importlib
import importlib.util
import inspect
import json
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "kernel_variants")


def build(name: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, f"{name}.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                    os.path.join(HERE, f"{name}.cu")], check=True)
    return ctypes.CDLL(lib)


def median_ms(run) -> tuple:
    run()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(5):
        start.record()
        for _ in range(10):
            run()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / 10)
    samples.sort()
    return samples[2], samples[0], samples[-1]


# Design points of kernel 7 and its gradient (7b), swept at the spatial
# fit's shapes: (kernel, patched #defines, launch-shape constants of ops.py).
# The defines are the rows a thread loads before it computes (BM_ROWS,
# BG_ROWS); "SOURCE" names another source in this directory to build in
# place of banded_matvec.cu (band_gradient_ring.cu: 7b's rows staged
# through a ring of bulk copies, RING_STAGES stages of RING_ROWS rows).  The
# first point of each kernel is the checkout's own design.
_RING = "band_gradient_ring.cu"
BAND_POINTS = [
    ("band_gradient", {}, {}),
    ("band_gradient", {}, {"GRAD_THREADS": 256}), ("band_gradient", {"BG_ROWS": 1}, {}),
    ("band_gradient", {"BG_ROWS": 4}, {}), ("band_gradient", {}, {"GRAD_SLABS": 2}),
    ("band_gradient", {}, {"GRAD_SLABS": 4}), ("band_gradient", {"SOURCE": _RING}, {}),
    ("band_gradient", {"SOURCE": _RING, "RING_ROWS": 4, "RING_STAGES": 3}, {}),
    ("banded_matvec", {}, {}), ("banded_matvec", {"BM_ROWS": 1}, {}),
    ("banded_matvec", {"BM_ROWS": 4}, {}), ("banded_matvec", {}, {"WAVES": 2}),
    ("banded_matvec", {}, {"WAVES": 4}), ("banded_matvec", {}, {"ROWS_THREADS": 128}),
    ("banded_matvec_nrhs_1", {}, {}), ("banded_matvec_nrhs_1", {}, {"ONE_ROW_THREADS": 128}),
    ("banded_matvec_nrhs_1", {}, {"ONE_ROW_THREADS": 256}),
]
BAND_ROUNDS = 5
STATS_ROUNDS = 5

# Design points of kernel 3's symmetric path: (patched #defines of
# window_stats.cu, launch-shape constants or functions of
# window_stats/ops.py).  The first point is the checkout's own design;
# free_grid in place of ops.resident_clusters lets a pair ask for more
# clusters than the device holds at once (a second wave).  A point whose
# result is off the plain version by more than LAGMOM_TOL, or is not
# bitwise repeatable or symmetric, is reported invalid and not timed in
# turns.
def free_grid(device, windows, pairs):
    return None


LAGMOM_TOL = 1e-4  # chip_smoke.py's TOL["lag"] and TOL["moments"]
LAGMOM_POINTS = [
    ({}, {}),
    ({"LM_ROWS": 28}, {}), ({"LM_ROWS": 112}, {}),
    ({"LM_STAGES": 3}, {}), ({"LM_STAGES": 4}, {}),
    ({"LM_MIN_CTAS": 1}, {"LAGMOM_CTAS_PER_SM": 1}), ({}, {"LAGMOM_CTAS_PER_SM": 1}),
    ({}, {"resident_clusters": free_grid}),
    ({}, {"LAGMOM_MIN_SLAB": 16}), ({}, {"LAGMOM_MIN_SLAB": 64}),
    ({}, {"LAGMOM_CLUSTER": 8}), ({"VARIANT": "generic_staging"}, {}),
]
# Alternatives to parts of the shipped design, as patches of a copy of
# window_stats.cu (timed as design points): generic_staging copies the rows
# with stats_tiles.cuh's stage_rows (as they lie, the tile's shape a
# run-time value), so its reads take the identity slot (no swizzle).
LAGMOM_VARIANTS = {
    "generic_staging": [
        ("int lm_slot(int f) { return f ^ ((f >> 3) & 1); }", "int lm_slot(int f) { return f; }"),
        ("    lm_stage_rows(As, p.y, p.d, t.i0, p.vec != 0, row_of);\n"
         "    if (!t.diag) lm_stage_rows(As + LM_ROWS * RT_TILE, p.y, p.d, t.j0, p.vec != 0, row_of);",
         "    stage_rows(As, p.y, p.d, t.i0, RT_TILE, LM_ROWS, p.vec != 0, row_of);\n"
         "    if (!t.diag) stage_rows(As + LM_ROWS * RT_TILE, p.y, p.d, t.j0, RT_TILE, LM_ROWS,\n"
         "                            p.vec != 0, row_of);")],
}
LAGMOM_ROUNDS = 5
# Ablations of kernel 3's symmetric path: parts compiled out of a copy of
# window_stats.cu (an #ifdef at each anchor of _LAGMOM_ABLATION_PATCHES), to
# see which part sets its time.  LOOP_ONLY: the CTA leaves after its steps
# (no reduction); NO_LAG, NO_MOM: the products or the moment sums skipped;
# NO_COPY: no rows copied; NO_PROLOGUE: no prefix counts copied (every start
# valid); NO_CROSS: the clusters of a pair are not summed.  Results are garbage;
# only the times count.
LAGMOM_ABLATIONS = {"loop_only": ("LOOP_ONLY",), "no_lag": ("NO_LAG",), "no_mom": ("NO_MOM",),
                    "no_copy": ("NO_COPY",), "no_prologue": ("NO_PROLOGUE",),
                    "no_cross": ("NO_CROSS",), "copy_only": ("LOOP_ONLY", "NO_LAG", "NO_MOM"),
                    "sums_only": ("NO_COPY", "NO_LAG", "NO_MOM"),
                    "reduce_only": ("NO_COPY", "NO_LAG", "NO_MOM", "NO_PROLOGUE"),
                    "probe": ("PROBE",)}
# PROBE: the shipped kernel, and thread 0 of every CTA records clock64() at
# eight points (start; loop start; loop end; row lanes summed; cluster
# barrier passed; cluster sums stored; arrival known; end) into the unused
# tail of its cluster's stored sums (groups > 1), read back as cycles after
# the start.
LAGMOM_PROBES = ("start", "prologue", "loop", "lanes", "cluster_sync", "cluster_sums",
                 "arrival", "end")
_LAGMOM_ABLATION_PATCHES = [
    ("  const LmTile t(p, pair);\n",
     "#ifdef ABL_PROBE\n  long long probe[8] = {clock64(), 0, 0, 0, 0, 0, 0, 0};\n#endif\n"
     "  const LmTile t(p, pair);\n"),
    ("  float acc[LM_BLK][LM_BLK];\n",
     "#ifdef ABL_PROBE\n  __syncthreads();\n  probe[1] = clock64();\n#endif\n"
     "  float acc[LM_BLK][LM_BLK];\n"),
    ("  // the row lanes in order: entry q = 8 r + c of block b is e = q nblk + b\n",
     "#ifdef ABL_PROBE\n  probe[2] = clock64();\n#endif\n"
     "  // the row lanes in order: entry q = 8 r + c of block b is e = q nblk + b\n"),
    ("  // the cluster's slabs in rank order, through distributed shared memory:\n",
     "#ifdef ABL_PROBE\n  __syncthreads();\n  probe[3] = clock64();\n#endif\n"
     "  // the cluster's slabs in rank order, through distributed shared memory:\n"),
    ("  const int share = (total + C - 1) / C;\n",
     "#ifdef ABL_PROBE\n  probe[4] = clock64();\n#endif\n"
     "  const int share = (total + C - 1) / C;\n"),
    ("  cluster_arrive();  // this CTA is done",
     "#ifdef ABL_PROBE\n  __syncthreads();\n  probe[5] = clock64();\n#endif\n"
     "  cluster_arrive();  // this CTA is done"),
    ("    if (*flag) lm_share_sum(p, t, pair, e0, e1);\n",
     "#ifdef ABL_PROBE\n    probe[6] = clock64();\n#endif\n"
     "    if (*flag) lm_share_sum(p, t, pair, e0, e1);\n"),
    ("  cluster_wait();  // no CTA leaves while another may still read its shared memory\n",
     "  cluster_wait();  // no CTA leaves while another may still read its shared memory\n"
     "#ifdef ABL_PROBE\n  probe[7] = clock64();\n"
     "  if (threadIdx.x == 0 && p.groups > 1)\n    for (int i = 0; i < 8; ++i)\n"
     "      reinterpret_cast<int*>(p.part)[(size_t)cl * LM_PART_FLOATS + 4096 + rank * 8 + i] =\n"
     "          i == 6 && probe[6] == 0 ? -1 : (int)(probe[i] - probe[0]);\n#endif\n"),
    ("#define LM_ROWS ",
     "#ifdef ABL_NO_LAG\n#define LAG_ON false\n#else\n#define LAG_ON true\n#endif\n"
     "#ifdef ABL_NO_MOM\n#define MOM_ON false\n#else\n#define MOM_ON true\n#endif\n"
     "#define LM_ROWS "),
    ("    if (lanes == LM_FAST_LANES && r_end == LM_ROWS",
     "    if (LAG_ON && lanes == LM_FAST_LANES && r_end == LM_ROWS"),
    ("    } else if (lane < lanes) {\n      for (int r = lane; r < r_end; r += lanes) {\n",
     "    } else if (LAG_ON && lane < lanes) {\n      for (int r = lane; r < r_end; r += lanes) {\n"),
    ("    if (t.diag) {\n      // window k's counts",
     "    if (MOM_ON && t.diag) {\n      // window k's counts"),
    ("    lm_stage_rows(As, p.y, p.d, t.i0, p.vec != 0, row_of);\n",
     "#ifndef ABL_NO_COPY\n    lm_stage_rows(As, p.y, p.d, t.i0, p.vec != 0, row_of);\n#endif\n"),
    ("    cp_async4(pre + (k + 1) * (p.slab + 1) + i, p.prefix + idx, true);\n",
     "#ifdef ABL_NO_PROLOGUE\n    pre[(k + 1) * (p.slab + 1) + i] = k < 0 ? i : 0;\n#else\n"
     "    cp_async4(pre + (k + 1) * (p.slab + 1) + i, p.prefix + idx, true);\n#endif\n"),
    ("  __syncthreads();  // the ring is read out: it now holds the row lanes' tiles\n",
     "  __syncthreads();  // the ring is read out: it now holds the row lanes' tiles\n"
     "#ifdef ABL_LOOP_ONLY\n  {\n    float sum = 0.f;\n#pragma unroll\n"
     "    for (int i = 0; i < LM_BLK; ++i)\n#pragma unroll\n"
     "      for (int j = 0; j < LM_BLK; ++j) sum += acc[i][j];\n#pragma unroll\n"
     "    for (int k = 0; k < KW; ++k) sum += m1[k] + m2[k];\n"
     "    if (sum == 1.2345e30f) p.lag_out[threadIdx.x] = sum;\n    return;\n  }\n#endif\n"),
    ("  if (p.groups > 1) {\n    // share `rank`",
     "#ifdef ABL_NO_CROSS\n  if (false) {\n#else\n  if (p.groups > 1) {\n#endif\n"
     "    // share `rank`"),
]
NRHS1_COPIES = 20  # chip_smoke.py's cold one-right-hand-side graph


def _band_point_name(point) -> str:
    kernel, defines, knobs = point
    parts = [f"{k}={getattr(v, '__name__', v)}" for k, v in {**defines, **knobs}.items()]
    return kernel + ("/" + ",".join(parts) if parts else "/shipped")


def _define_source(text: str, defines: dict) -> str:
    for name, value in defines.items():
        line = re.findall(rf"^#define {name} \d+", text, re.M)
        if len(line) != 1:
            raise RuntimeError(f"#define {name} not found once")
        text = text.replace(line[0], f"#define {name} {value}")
    return text


def _turns(launchers: dict, rounds: int) -> dict:
    """Graph samples of each launcher, in turns A B .. B A, ``rounds`` times:
    {key: [sorted samples of one turn, ...]}."""
    keys = list(launchers)
    out = {k: [] for k in keys}
    for _ in range(rounds):
        for k in keys + keys[::-1]:
            out[k].append(launchers[k]())
            torch.cuda.empty_cache()
    return out


def _report_turns(label: str, turns: dict) -> dict:
    """Median over every sample of each key, each turn's median, and in how
    many of the paired turns (the same round and pass) the first key was
    faster than each other one."""
    keys = list(turns)
    rec = {}
    for k in keys:
        every = sorted(x for sample in turns[k] for x in sample)
        meds = [sample[len(sample) // 2] for sample in turns[k]]
        rec[k] = {"median_ms": every[len(every) // 2], "turn_medians": meds,
                  "min_ms": every[0], "max_ms": every[-1]}
        wins = ""
        if k != keys[0]:
            first = [sample[len(sample) // 2] for sample in turns[keys[0]]]
            won = sum(a < b for a, b in zip(first, meds))
            rec[k]["first_wins"] = won
            wins = f"; {keys[0]} faster in {won} of {len(meds)} paired turns"
        print(f"turns {label} {k}: ms {every[len(every) // 2]:.5f} over {len(every)} samples "
              f"(min {every[0]:.5f} max {every[-1]:.5f}); turn medians "
              f"{' '.join(f'{x:.5f}' for x in meds)}{wins}", flush=True)
    return rec


def _events_samples(fn, calls: int = 10, repeats: int = 5) -> list:
    """ms per call, sorted: ``repeats`` samples of ``calls`` back-to-back
    calls between CUDA events (host work included)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(repeats):
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / calls)
    return sorted(samples)


def _band_prepare(m, diags, x, transposed=False):
    """A product launch of package ``m``: this checkout's wrapper reads the
    diagonals (d, 2b+1) where they lie; an earlier one took them band-major."""
    prepare = m["banded_matvec.ops"].prepare_banded_matvec
    if "coef" in inspect.signature(prepare).parameters:
        if transposed:
            diags = m["banded_matvec.ref"].band_transpose(diags)
        return prepare(diags.t().contiguous(), x)
    return prepare(diags, x, transposed)


def banded(baseline_dir, gen, dev) -> None:
    """Kernel 7 and its gradient at the spatial fit's shapes (x and g
    (2,047, 131,072), b = 4; one right-hand side cold): the design points of
    BAND_POINTS (patched copies of banded_matvec.cu built side by side, and
    the wrappers' launch shapes), each held to the plain version, then all
    the points of each kernel in turns; then, with
    ``baseline_dir`` (an earlier ``src/repro_torch/kernels``), the product at
    both shapes, A^T, the wrapper at one right-hand side and d diags (the
    baseline's plain products where it has no kernel) in turns baseline,
    this, this, baseline, BAND_ROUNDS times.  Samples go to
    build/kernel_variants/variants_banded.json."""
    new = load_kernels("this_kernels", os.path.join(ROOT, "src", "repro_torch", "kernels"))
    old = load_kernels("baseline_kernels", os.path.abspath(baseline_dir)) if baseline_dir else None
    ops, ref = new["banded_matvec.ops"], new["banded_matvec.ref"]
    m, d, b = 2047, 131072, 4
    diags = torch.randn((d, 2 * b + 1), generator=gen, device=dev) * 0.05
    x = torch.randn((m, d), generator=gen, device=dev)
    g = torch.randn((m, d), generator=gen, device=dev)
    copies = [diags.clone() for _ in range(NRHS1_COPIES)]
    rows = [x[i: i + 1].contiguous() for i in range(NRHS1_COPIES)]
    want = {"banded_matvec": ref.banded_matvec_ref(diags, x),
            "banded_matvec_nrhs_1": ref.banded_matvec_ref(diags, x[:1]),
            "band_gradient": ref.band_gradient(g, x, b)}

    def preps(pkg_ops, kernel):
        if kernel == "band_gradient":
            return [pkg_ops.prepare_band_gradient(g, x, b)]
        if kernel == "banded_matvec":
            return [pkg_ops.prepare_banded_matvec(diags, x)]
        return [pkg_ops.prepare_banded_matvec(a, r) for a, r in zip(copies, rows)]

    src = os.path.join(os.path.dirname(new["_build"].__file__), "banded_matvec", "csrc",
                       "banded_matvec.cu")
    text = open(src).read()
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for point in BAND_POINTS:
        key = tuple(sorted(point[1].items()))
        if key and key not in builds:
            defines = dict(point[1])
            base = (open(os.path.join(HERE, defines.pop("SOURCE"))).read()
                    if "SOURCE" in defines else text)
            path = os.path.join(OUT, f"band_point_{len(builds)}.cu")
            with open(path, "w") as f:
                f.write(_define_source(base, defines))
            builds[key] = path
    procs = {key: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", path[:-3] + ".so", path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for key, path in builds.items()}
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"band point {key}: build failed\n{log[-2000:]}")
        lib = libs[key] = ctypes.CDLL(builds[key][:-3] + ".so")
        size = lib.rt_band_grad_params_size
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(new["_build"].BandGradParams):
            raise RuntimeError(f"band point {key}: BandGradParams differs from _build.py's")
    record = {"device": torch.cuda.get_device_name(0), "points": {}, "turns": {}}
    defaults = {k: getattr(ops, k) for k in ("GRAD_SLABS", "GRAD_THREADS", "ROWS_THREADS",
                                             "WAVES", "ONE_ROW_THREADS")}
    launchers = {}
    for point in BAND_POINTS:
        kernel, defines, knobs = point
        for k, v in {**defaults, **knobs}.items():
            setattr(ops, k, v)
        ps = preps(ops, kernel)
        for k, v in defaults.items():
            setattr(ops, k, v)
        key = tuple(sorted(defines.items()))
        if key:
            entry = getattr(libs[key], "rt_band_gradient" if kernel == "band_gradient"
                            else "rt_banded_matvec")
            entry.argtypes, entry.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int

            def launch_of(prep, entry=entry):
                def launch():  # on the current stream: the capture's, inside graph_samples
                    if entry(ctypes.byref(prep.params),
                             torch.cuda.current_stream(dev).cuda_stream) != 0:
                        raise RuntimeError("launch failed")
                    return prep.out
                return launch
            calls = [launch_of(prep) for prep in ps]
        else:
            calls = [prep.launch for prep in ps]
        got = calls[0]().clone()
        err = ((got - want[kernel]).abs().max() / want[kernel].abs().max()).item()
        again = calls[0]()
        samples = graph_samples(calls)
        name = _band_point_name(point)
        record["points"][name] = {"samples": samples, "max_rel_err": err,
                                  "bitwise_repeat": bool(torch.equal(got, again)),
                                  "shape": {k: getattr(ps[0].params, k) for k, t in
                                            ps[0].params._fields_ if t is ctypes.c_int}}
        launchers[name] = (lambda calls=calls: graph_samples(calls))
        print(f"point {name}: ms {samples[2]:.5f} (min {samples[0]:.5f} max {samples[-1]:.5f}) "
              f"max rel err {err:.2e}", flush=True)
    # every point of each kernel in turns with its shipped one
    for kernel in ("band_gradient", "banded_matvec", "banded_matvec_nrhs_1"):
        names = [n for n in record["points"] if n.split("/")[0] == kernel]
        record["turns"][f"{kernel}/points"] = _report_turns(
            kernel, _turns({n: launchers[n] for n in names}, BAND_ROUNDS))
    if old is not None:
        oops = old["banded_matvec.ops"]
        pairs = {
            "banded_matvec": ([p.launch for p in [_band_prepare(old, diags, x)]],
                              [p.launch for p in preps(ops, "banded_matvec")]),
            "banded_matvec_nrhs_1": ([_band_prepare(old, a, r).launch
                                      for a, r in zip(copies, rows)],
                                     [p.launch for p in preps(ops, "banded_matvec_nrhs_1")]),
            "banded_matvec_transposed": ([_band_prepare(old, diags, x, True).launch],
                                         [_band_prepare(new, diags, x, True).launch]),
        }
        for name, (base, this) in pairs.items():
            same = bool(torch.equal(base[0](), this[0]()))
            turns = _turns({"baseline": lambda base=base: graph_samples(base),
                            "this": lambda this=this: graph_samples(this)}, BAND_ROUNDS)
            record["turns"][name] = _report_turns(f"{name} (bitwise equal: {same})", turns)
        # host work included: the wrappers at one right-hand side, and d diags
        # (the baseline computes it as plain products, the checkout launches 7b)
        base_grad = (oops.band_gradient if hasattr(oops, "prepare_band_gradient")
                     else old["banded_matvec.ref"].band_gradient)
        wrappers = {
            "wrapper_nrhs_1": (lambda: oops.banded_matvec_rows(diags, x[:1]),
                               lambda: ops.banded_matvec_rows(diags, x[:1])),
            "d_diags": (lambda: base_grad(g, x, b), lambda: ops.band_gradient(g, x, b)),
        }
        for name, (base, this) in wrappers.items():
            turns = _turns({"baseline": lambda base=base: _events_samples(base),
                            "this": lambda this=this: _events_samples(this)}, BAND_ROUNDS)
            record["turns"][name] = _report_turns(name, turns)
    with open(os.path.join(OUT, "variants_banded.json"), "w") as f:
        json.dump(record, f, indent=1)


def moments(gen, dev) -> None:
    from repro_torch.kernels.window_stats.ref import window_moments_ref

    class MP(ctypes.Structure):
        _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p)] + [
            (k, ctypes.c_int) for k in ("n", "d", "w", "n_out", "chain", "ctas")]

    lib = build("window_moments_variants")
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    n, d = 2**22, 64
    x = torch.randn((n, d), generator=gen, device=dev)
    for w in (64, 1024):
        want = window_moments_ref(x, w)
        n_out = n - w + 1
        for variant, chain in [(0, 1024), (0, 2048), (0, 512), (1, 1024), (1, 2048), (1, 512),
                               (1, 256), (2, 1024), (2, 2048)]:
            out = torch.empty((n_out, 2, d), device=dev)
            per = d if variant == 0 else d // 4
            chains = -(-n_out // chain)
            p = MP(x.data_ptr(), out.data_ptr(), n, d, w, n_out, chain, -(-chains * per // 256))

            def run():
                if lib.launch(variant, ctypes.byref(p)) != 0:
                    raise RuntimeError(f"variant {variant}: launch failed")
            ms, lo, hi = median_ms(run)
            err = ((out - want).abs().max() / want.abs().max()).item()
            print(f"moments w {w} variant {variant} chain {chain}: ms {ms:.4f} (min {lo:.4f} "
                  f"max {hi:.4f}) err {err:.2e} ctas {p.ctas}", flush=True)


def load_kernels(name: str, directory: str):
    """The kernels package in ``directory`` imported as ``repro_torch.<name>``
    (its modules import each other relatively, and ``tiling`` reaches
    ``..core``: this checkout's), built with its own sources."""
    import repro_torch  # noqa: F401  (the parent of the loaded package)

    name = f"repro_torch.{name}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(directory, "__init__.py"), submodule_search_locations=[directory])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    mods = {sub: importlib.import_module(f"{name}.{sub}") for sub in (
        "_build", "_launch", "fused_plan.ops", "segment_dft.ops", "segment_dft.ref",
        "window_stats.ops", "window_stats.ref", "banded_matvec.ops", "banded_matvec.ref",
        "swa_attention.ops")}
    path, seconds, log = mods["_build"].build(verbose=True)
    mods["_build"].library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"{name}: built {os.path.basename(path)} in {seconds:.1f} s", flush=True)
    for ln in ptxas:
        print(f"  {ln}", flush=True)
    return mods


def graph_samples(launches: list, replays: int = 10, repeats: int = 5) -> list:
    """ms per launch, sorted: ``repeats`` samples of a CUDA graph of the
    launches replayed ``replays`` times."""
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for launch in launches:
            launch()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(repeats):
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / (replays * len(launches)))
    del graph
    return sorted(samples)


def lagmom_shapes(series, dev) -> dict:
    """Kernel 3's shapes on the main paths, each on 8 distinct operand sets
    of ``series`` (rows of 64 channels): (y, start mask, windows) lists."""
    from repro_torch.kernels.window_stats.ref import extend_rows

    chunk, carry, rot = 65536, 1023, 8
    starts = torch.arange(chunk, device=dev)
    tail_mask = torch.arange(carry, device=dev) <= carry - 64
    ones = torch.ones(carry, dtype=torch.bool, device=dev)
    return {
        "chunk": [(series[i * chunk: i * chunk + chunk + carry], starts <= chunk - carry - 1,
                   (64, 1024)) for i in range(rot)],
        "tail": [(extend_rows(series[(i + 1) * chunk - carry: (i + 1) * chunk],
                              carry + 63).contiguous(), tail_mask, (64,)) for i in range(rot)],
        "boundary": [(series[(i + 1) * chunk - carry: (i + 1) * chunk + carry], ones, (64, 1024))
                     for i in range(rot)],
    }


def _lagmom_turns(label, launchers: dict, rounds: int) -> dict:
    """_turns and _report_turns, plus in how many paired turns each key
    beat the first."""
    turns = _turns(launchers, rounds)
    rec = _report_turns(label, turns)
    keys = list(turns)
    first = [x[len(x) // 2] for x in turns[keys[0]]]
    for k in keys[1:]:
        mine = [x[len(x) // 2] for x in turns[k]]
        rec[k]["wins_over_first"] = sum(a < b for a, b in zip(mine, first))
        print(f"turns {label} {k}: faster than {keys[0]} in {rec[k]['wins_over_first']} of "
              f"{len(mine)} paired turns; median ratio {keys[0]} / {k} "
              f"{rec[keys[0]]['median_ms'] / rec[k]['median_ms']:.3f}", flush=True)
    return {"samples": turns, "report": rec}


def lagmom(new, old, series, gen, dev) -> dict:
    """Kernel 3's symmetric path: the design points of LAGMOM_POINTS at the
    shapes of :func:`lagmom_shapes`, each held to the plain version, then in
    turns with the shipped point; with ``old`` (a baseline package), the
    shipped point against the baseline's kernel 3 in turns at the chunk and
    the tail."""
    ops, ref = new["window_stats.ops"], new["window_stats.ref"]
    kdir = os.path.dirname(new["_build"].__file__)
    text = open(os.path.join(kdir, "window_stats", "csrc", "window_stats.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for defines, _ in LAGMOM_POINTS:
        key = tuple(sorted(defines.items()))
        if key and key not in builds:  # the design points
            path = os.path.join(OUT, f"lagmom_point_{len(builds)}.cu")
            with open(path, "w") as f:
                f.write(_patch(text, LAGMOM_VARIANTS[defines["VARIANT"]], defines["VARIANT"])
                        if "VARIANT" in defines else _define_source(text, defines))
            builds[key] = path
    ablated = os.path.join(OUT, "lagmom_ablated.cu")
    with open(ablated, "w") as f:
        f.write(_patch(text, _LAGMOM_ABLATION_PATCHES, "lagmom ablation"))
    flags = {}
    for name, abl in LAGMOM_ABLATIONS.items():
        key = (("ABLATION", name),)
        builds[key] = os.path.join(OUT, f"lagmom_ablation_{name}.cu")
        with open(builds[key], "w") as f:
            f.write(open(ablated).read())
        flags[key] = [f"-DABL_{a}" for a in abl]
    procs = {key: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", os.path.join(kdir, "csrc"),
         "-o", path[:-3] + ".so", path] + flags.get(key, []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for key, path in builds.items()}
    entries, occupancies = {}, {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"lagmom point {key}: build failed\n{log[-2000:]}")
        lib = ctypes.CDLL(builds[key][:-3] + ".so")
        size = lib.rt_lagmom_params_size
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(new["_build"].LagMomParams):
            raise RuntimeError(f"lagmom point {key}: LagMomParams differs from _build.py's")
        entry = lib.rt_lag_moments_sym
        entry.argtypes, entry.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        entries[key] = entry
        occupancy = lib.rt_lag_moments_occupancy
        occupancy.argtypes, occupancy.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        occupancies[key] = occupancy
        print(f"lagmom point {dict(key)}: ptxas {_ptxas_of(log, 'lag_moments_sym_kernel')}",
              flush=True)
    knobs0 = {k: getattr(ops, k) for k in ("LAGMOM_CTAS_PER_SM", "LAGMOM_MIN_SLAB",
                                            "LAGMOM_CLUSTER", "resident_clusters")}
    occupancies[()] = new["_build"].library().rt_lag_moments_occupancy
    record = {"device": torch.cuda.get_device_name(0), "points": {}, "turns": {},
              "ablations": {}}
    shapes = lagmom_shapes(series, dev)
    for shape in ("chunk", "tail"):
        preps = [ops.prepare_fused_lag_moments(y.contiguous(), m, 0, w) for y, m, w in shapes[shape]]
        for name in LAGMOM_ABLATIONS:
            entry = entries[(("ABLATION", name),)]

            def launch_of(prep, entry=entry):
                def launch():
                    if entry(ctypes.byref(prep.params),
                             torch.cuda.current_stream(dev).cuda_stream) != 0:
                        raise RuntimeError("launch failed")
                return launch
            samples = graph_samples([launch_of(prep) for prep in preps])
            record["ablations"][f"{shape}/{name}"] = samples
            print(f"lagmom ablation {shape} {name}: ms {samples[2]:.5f} (min {samples[0]:.5f} "
                  f"max {samples[-1]:.5f})", flush=True)
            if name == "probe" and preps[0].params.groups > 1:
                launch_of(preps[0])()
                torch.cuda.synchronize()
                cyc = preps[0].keep[2].view(torch.int32).view(-1, 5120)[:, 4096:4096 + 64]
                cyc = cyc.reshape(-1, 8).double()
                stats = {k: [cyc[:, i].mean().item(), cyc[:, i].max().item()]
                         for i, k in enumerate(LAGMOM_PROBES)}
                record["ablations"][f"{shape}/probe_cycles"] = stats
                print(f"lagmom probe {shape} cycles after start (mean, max over CTAs): " +
                      "; ".join(f"{k} {m:.0f} {x:.0f}" for k, (m, x) in stats.items()), flush=True)
        samples = graph_samples([prep.launch for prep in preps])
        print(f"lagmom ablation {shape} shipped: ms {samples[2]:.5f}", flush=True)
    for shape, cases in shapes.items():
        y0, m0, w0 = cases[0]
        want = ref.fused_lag_moments_ref(y0, m0, 0, w0)
        launchers = {}
        for defines, knobs in LAGMOM_POINTS:
            for k, v in {**knobs0, **knobs}.items():
                setattr(ops, k, v)
            preps = [ops.prepare_fused_lag_moments(y.contiguous(), m, 0, w) for y, m, w in cases]
            for k, v in knobs0.items():
                setattr(ops, k, v)
            key = tuple(sorted(defines.items()))
            if key:
                def launch_of(prep, entry=entries[key]):
                    def launch():  # on the current stream: the capture's, inside graph_samples
                        if entry(ctypes.byref(prep.params),
                                 torch.cuda.current_stream(dev).cuda_stream) != 0:
                            raise RuntimeError("launch failed")
                        return prep.out
                    return launch
                calls = [launch_of(prep) for prep in preps]
            else:
                calls = [prep.launch for prep in preps]
            lag, mom = (t.clone() for t in calls[0]())
            again = calls[0]()
            err = {"lag": ((lag - want[0]).abs().max() / want[0].abs().max()).item(),
                   "mom": ((mom - want[1]).abs().max() / want[1].abs().max()).item()}
            same = bool(torch.equal(lag, again[0]) and torch.equal(mom, again[1]))
            symmetric = bool(torch.equal(lag[0], lag[0].t()))
            samples = graph_samples(calls)
            name = _band_point_name(("lagmom", defines, knobs)).split("/", 1)[1]
            params = preps[0].params
            occ = (ctypes.c_int * 2)()
            with torch.cuda.device(dev):
                if occupancies[key](ctypes.byref(params), occ) != 0:
                    raise RuntimeError(f"lagmom point {name}: occupancy query failed")
            occ = tuple(occ)
            valid = max(err.values()) <= LAGMOM_TOL and same and symmetric
            record["points"][f"{shape}/{name}"] = {
                "samples": samples, "max_rel_err": err, "bitwise_repeat": same,
                "symmetric": symmetric, "valid": valid, "occupancy": occ,
                "grid": {k: getattr(params, k) for k in ("slab", "cluster", "groups", "pairs")}}
            if valid:
                launchers[name] = (lambda calls=calls: graph_samples(calls))
            print(f"lagmom {shape} {name}: {'' if valid else 'INVALID (not timed in turns) '}"
                  f"ms {samples[2]:.5f} (min {samples[0]:.5f} max "
                  f"{samples[-1]:.5f}) rel err lag {err['lag']:.2e} mom {err['mom']:.2e} "
                  f"repeat {same} symmetric {symmetric} slab {params.slab} cluster "
                  f"{params.cluster} groups {params.groups}; CTAs per SM, resident clusters "
                  f"{occ}", flush=True)
        record["turns"][f"{shape}/points"] = _lagmom_turns(f"lagmom {shape}", launchers,
                                                           LAGMOM_ROUNDS)
        if old is not None and shape in ("chunk", "tail"):
            oops = old["window_stats.ops"]
            base = [oops.prepare_fused_lag_moments(y.contiguous(), m, 0, w) for y, m, w in cases]
            this = [ops.prepare_fused_lag_moments(y.contiguous(), m, 0, w) for y, m, w in cases]
            record["turns"][f"{shape}/baseline"] = _lagmom_turns(
                f"lagmom {shape} against the baseline",
                {"baseline": lambda: graph_samples([p.launch for p in base]),
                 "this": lambda: graph_samples([p.launch for p in this])}, STATS_ROUNDS)
    with open(os.path.join(OUT, "variants_lagmom.json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def profile_split(launches: list, rounds: int = 5) -> dict:
    """{device kernel name: [launches per call, device ms per call]} of
    ``launches`` (one call each), profiled over ``rounds`` passes."""
    from torch.profiler import ProfilerActivity, profile

    for launch in launches:
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for launch in launches:
                launch()
        torch.cuda.synchronize()
    calls = rounds * len(launches)
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            out[ev.key[:60]] = [ev.count / calls, us / calls / 1e3]
    return out


def split(new, old, series, dev) -> dict:
    """Kernel 3's device kernels per call at the chunk and the tail, for
    this checkout and (``old``) the baseline."""
    record = {}
    for label, m in (("this", new), ("baseline", old)):
        if m is None:
            continue
        ops = m["window_stats.ops"]
        for shape, cases in lagmom_shapes(series, dev).items():
            preps = [ops.prepare_fused_lag_moments(y.contiguous(), mk, 0, w) for y, mk, w in cases]
            rec = record[f"{label}/{shape}"] = profile_split([p.launch for p in preps])
            print(f"split {label} {shape}: " + "; ".join(
                f"{k}: {c:.2f} a call, {ms:.5f} ms" for k, (c, ms) in rec.items()), flush=True)
    return record


# Kernels 1 and 2 at the multi-tenant session's shapes (chip_smoke.py's
# session phase: 65,536 tenants of d = 16, 256-row chunks, a 127-row carry,
# H = 16, windows (32, 128), Welch 64/32; a query's lag tail at 4,096
# tenants), at the d = 64 shapes the same code serves (the main path's
# chunk, the store's autocovariance_blocked), and at d = 32 (the small lag
# role's 32-channel tile).
SESSION_USERS, SESSION_D, SESSION_ROWS, SESSION_CARRY = 65536, 16, 256, 127
SESSION_H, SESSION_WINDOWS, SESSION_WELCH, SESSION_QUERY = 16, (32, 128), (64, 32), 4096
SESSION_ROUNDS = 5  # 2 SESSION_ROUNDS paired turns
# Ablations of batched kernel 1: roles compiled out of a copy of
# fused_plan.cu (the role's call in fused_plan_kernel under an #ifndef), so
# that each launch's time splits by role.  Results are garbage; only the
# times count.
SESSION_ABLATIONS = {"no_lag": ("NO_LAG",), "no_mom": ("NO_MOM",), "no_welch": ("NO_WELCH",),
                     "lag_only": ("NO_MOM", "NO_WELCH"), "mom_only": ("NO_LAG", "NO_WELCH"),
                     "welch_only": ("NO_LAG", "NO_MOM"),
                     "reduce_only": ("NO_LAG", "NO_MOM", "NO_WELCH")}
# (flag, the role's call in fused_plan_kernel): the one line that matches
# is wrapped in #ifndef ABL_<flag>.
_SESSION_ROLE_CALLS = [("NO_LAG", r"^ *lag\w*<[^;]*>\(p, b, tn, smem\);\n"),
                       ("NO_MOM", r"^ *moment_role<[^;]*>\(p, b, tn, smem\);\n"),
                       ("NO_WELCH", r"^ *welch_member_role<[^;]*>\(p, p\.welch\[j\], b, tn, "
                                    r"smem\);\n")]


def session_ablation_source(text: str) -> str:
    """fused_plan.cu's text with each role's call in fused_plan_kernel under
    an #ifndef ABL_NO_<role>."""
    for flag, pattern in _SESSION_ROLE_CALLS:
        found = re.findall(pattern, text, re.M)
        if len(found) != 1:
            raise RuntimeError(f"session ablation {flag}: role call not found once")
        text = text.replace(found[0], f"#ifndef ABL_{flag}\n{found[0]}#endif\n")
    return text


def session_operands(gen, dev) -> dict:
    """Operand sets at the session's shapes, made on the card: kernel 1's
    chunk (y (65,536, 383, 16), 129 valid starts a tenant) and merge boundary
    (y (65,536, 254, 16), 127 starts), kernel 2's lag tail ((4,096, 127, 16)
    against the tail extended by H zero rows), and the d = 64 shapes: the
    main path's chunk (y (66,559, 64), 65,536 starts) and the store's
    autocovariance_blocked (512 blocks of (8,208, 64), 8,192 starts); and
    the 32-channel tile's: the chunk at d = 32 for 16,384 tenants and the
    lag tail at d = 32."""
    from repro_torch.core.estimators.spectral import hann_window

    users, d, rows, carry, H = SESSION_USERS, SESSION_D, SESSION_ROWS, SESSION_CARRY, SESSION_H
    y = torch.randn((users, rows + carry, d), generator=gen, device=dev)
    y[:, rows:] = 0.0  # the chunk's zero extension
    z0 = torch.full((users,), 7 * rows, dtype=torch.int32, device=dev)
    starts = torch.arange(rows, device=dev)
    chunk_mask = (starts <= rows - carry - 1).expand(users, rows).contiguous()
    boundary = y[:, rows - carry: rows + carry].contiguous()
    boundary_mask = torch.ones((users, carry), dtype=torch.bool, device=dev)
    tail = torch.randn((SESSION_QUERY, carry, d), generator=gen, device=dev)
    ext = torch.nn.functional.pad(tail, (0, 0, 0, H)).contiguous()
    main = torch.randn((65536 + 1023, 64), generator=gen, device=dev)
    blocks = torch.randn((512, 8192 + H, 64), generator=gen, device=dev)
    wide = torch.randn((SESSION_USERS // 4, rows + carry, 32), generator=gen, device=dev)
    wide_tail = torch.randn((SESSION_QUERY, carry, 32), generator=gen, device=dev)
    L, step = SESSION_WELCH[0], SESSION_WELCH[0] - SESSION_WELCH[1]
    members = (H, SESSION_WINDOWS, (L,), (step,), (hann_window(L, dev),))
    main_members = (H, (64, 1024), (256,), (128,), (hann_window(256, dev),))
    return {"chunk": (y, chunk_mask, z0, members),
            "boundary": (boundary, boundary_mask, z0 + rows - carry, members),
            "lag_tail": (tail.contiguous(), ext),
            "main_chunk": (main, torch.arange(65536, device=dev) <= 65536 - 1023 - 1,
                           torch.zeros((), dtype=torch.int32, device=dev), main_members),
            "blocked": (blocks[:, :8192].contiguous(), blocks),
            "chunk_d32": (wide, chunk_mask[: wide.shape[0]], z0[: wide.shape[0]], members),
            "lag_tail_d32": (wide_tail, torch.nn.functional.pad(wide_tail, (0, 0, 0, H))
                             .contiguous())}


def _smoke():
    """chip_smoke.py as a module: kernel 3's library yardstick and bound."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# Batched kernel 3 (H = 0) at the session's shapes: a query's moments(32)
# tail (4,096 tenants of (158, 16), 96 of 127 starts valid: the finalize's
# mask), a moments-only plan's chunk (65,536 tenants of (383, 16), 129 of
# 256 starts, windows (32, 128)) and its merge boundary ((254, 16), 127
# starts).  SESSION_K3_POINTS: (#defines patched into a copy of
# window_stats.cu: launch bounds; launch-shape knobs of
# this checkout's window_stats/ops.py: tenants per CTA, row lanes of S(0)),
# each held to the plain version and timed in turns with the shipped point
# (the first).
SESSION_K3 = ("k3_tail", "k3_chunk", "k3_boundary")
SESSION_K3_POINTS = [({}, {}), ({}, {"LAGMOM_TENANTS": 1}), ({}, {"LAGMOM_TENANTS": 2}),
                     ({}, {"LAGMOM_TENANTS": 8}), ({}, {"LAGMOM_LANES": 12}),
                     ({"LM_BATCH_MIN_CTAS": 3}, {})]


# PROBE: the shipped batched kernel, thread 0 of every CTA summing clock64()
# over the CTA's tenants per phase (the first three end at a CTA barrier, so
# they read as the slowest warp's), written over its first tenant's S(0)
# after the launch's last store: the session's garbage, only the cycles count.
SESSION_K3_PHASES = ("wait_rows", "loops", "lane_sums_and_prefix", "counts")
_SESSION_K3_PROBE_PATCHES = [
    ("  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;\n",
     "  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;\n"
     "  long long ph[4] = {0, 0, 0, 0};\n  long long t_prev = clock64();\n"
     "#define LB_PROBE(k) { const long long t_now = clock64(); ph[k] += t_now - t_prev; "
     "t_prev = t_now; }\n"),
    ("    __syncthreads();     // ... for every thread; its mask and window counts are in\n",
     "    __syncthreads();     // ... for every thread; its mask and window counts are in\n"
     "    LB_PROBE(0)\n"),
    ("    __syncthreads();  // the row lanes are in; the slot is read out\n",
     "    __syncthreads();  // the row lanes are in; the slot is read out\n    LB_PROBE(1)\n"),
    ("      build_prefix();\n      __syncthreads();\n      build_counts();\n    }\n  }\n",
     "      build_prefix();\n      __syncthreads();\n      LB_PROBE(2)\n      build_counts();\n"
     "    }\n    LB_PROBE(3)\n  }\n  __syncthreads();\n  if (threadIdx.x == 0)\n"
     "    for (int k = 0; k < 4; ++k)\n"
     "      reinterpret_cast<int*>(p.lag_out + (size_t)tn0 * d * d)[k] = (int)ph[k];\n"),
]


def session_k3_operands(ops: dict, gen, dev) -> dict:
    """(y, start mask, windows) of batched kernel 3 at SESSION_K3's shapes;
    the chunk and the merge boundary are kernel 1's (session_operands)."""
    carry, w = SESSION_CARRY, SESSION_WINDOWS[0]
    tail = torch.randn((SESSION_QUERY, carry + w - 1, SESSION_D), generator=gen, device=dev)
    tail[:, carry:] = 0.0  # the tail's zero extension
    tail_mask = (torch.arange(carry, device=dev) <= carry - w).expand(
        SESSION_QUERY, carry).contiguous()
    return {"k3_tail": (tail, tail_mask, (w,)),
            "k3_chunk": (ops["chunk"][0], ops["chunk"][1], SESSION_WINDOWS),
            "k3_boundary": (ops["boundary"][0], ops["boundary"][1], SESSION_WINDOWS)}


def k3_errors(ref, got, y, mask, windows) -> tuple:
    """(S(0)'s worst error over its tenant's max|S(0)|, each moment sum's
    worst error over the same sum of |y|): chip_smoke.py's kernel 3 check,
    tenant by tenant."""
    lag, mom = ref.fused_lag_moments_ref(y, mask, 0, windows)
    scale = ref.fused_lag_moments_ref(y.abs(), mask, 0, windows)[1]
    e_lag = ((got[0] - lag).abs().flatten(1).amax(1)
             / lag.abs().flatten(1).amax(1).clamp_min(1e-30)).max().item()
    err = (got[1] - mom).abs()
    e_mom = torch.where(err == 0, torch.zeros_like(err), err / scale).max().item()
    return e_lag, e_mom


def _set_knobs(mod, knobs: dict) -> dict:
    """Sets ``knobs`` on module ``mod``; returns the values they replaced."""
    old = {k: getattr(mod, k) for k in knobs}
    for k, v in knobs.items():
        setattr(mod, k, v)
    return old


def session_k3(new, old, ops: dict, dev) -> dict:
    """Batched kernel 3 at SESSION_K3's shapes: each launch held to the plain
    version (S(0) exactly symmetric, two launches bitwise), its time (a CUDA
    graph of the prepared launch), the plain version's, the library call's
    (chip_smoke.lag_moments_library) and the bound (chip_smoke's
    lag_moments_work and bound_ms on this run's inputs); the design points of
    SESSION_K3_POINTS in turns with the shipped point; with ``old``, old
    against new in turns with the library call, each side held to the plain
    version (the summation order differs, so not bitwise)."""
    smoke = _smoke()
    nops, ref = new["window_stats.ops"], new["window_stats.ref"]
    record = {"device": torch.cuda.get_device_name(0), "shapes": {}, "points": {}, "turns": {}}
    points = [pt for pt in SESSION_K3_POINTS if all(hasattr(nops, k) for k in pt[1])]
    kdir = os.path.dirname(new["_build"].__file__)
    text = open(os.path.join(kdir, "window_stats", "csrc", "window_stats.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for defines, _ in points + [({"PROBE": 1}, {})]:
        key = tuple(sorted(defines.items()))
        if key and key not in procs:
            path = os.path.join(OUT, f"k3_point_{len(procs)}.cu")
            with open(path, "w") as f:
                f.write(_patch(text, _SESSION_K3_PROBE_PATCHES, "session k3 probe")
                        if "PROBE" in defines else _define_source(text, defines))
            procs[key] = (path, subprocess.Popen(
                ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
                 os.path.join(kdir, "csrc"), "-o", path[:-3] + ".so", path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for key, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"session k3 point {key}: build failed\n{log[-2000:]}")
        lib = ctypes.CDLL(path[:-3] + ".so")
        lib.rt_lagmom_batch_params_size.restype = ctypes.c_int
        if lib.rt_lagmom_batch_params_size() != ctypes.sizeof(new["_build"].LagMomBatchParams):
            raise RuntimeError(f"session k3 point {key}: LagMomBatchParams differs")
        entries[key] = lib.rt_lag_moments_batched
        entries[key].argtypes, entries[key].restype = [ctypes.c_void_p] * 2, ctypes.c_int
        for tw in (16, 32):
            print(f"session k3 point {dict(key)} lag_moments_batched_kernel<{tw}>: ptxas "
                  f"{_ptxas_of(log, f'lag_moments_batched_kernelILi{tw}E')}", flush=True)
    for shape in SESSION_K3:
        y, mask, windows = ops[shape]
        B, L = mask.shape
        rows, d, K = L + max(windows) - 1, y.shape[-1], len(windows)
        prep = nops.prepare_fused_lag_moments(y, mask, 0, windows)
        got = tuple(t.clone() for t in prep.launch())
        again = prep.launch()
        e_lag, e_mom = k3_errors(ref, got, y, mask, windows)
        ok = (e_lag <= LAGMOM_TOL and e_mom <= LAGMOM_TOL and torch.equal(got[0], again[0])
              and torch.equal(got[1], again[1])
              and torch.equal(got[0], got[0].transpose(-1, -2)))
        lib_ops = smoke.lag_moments_library_operands(y, mask, windows)
        lib_err = k3_errors(ref, smoke.lag_moments_library(*lib_ops), y, mask, windows)
        del got, again
        valid = int(mask.sum().item())
        nbytes, flops, _ = smoke.lag_moments_work(rows, L, 0, d, K)
        b_ms, b_by = smoke.bound_ms(B * nbytes, B * flops + valid * d * (d + 1))
        replays = 3 if B > SESSION_QUERY else 10
        ms = graph_samples([prep.launch], replays=replays)
        plain = _events_samples(lambda: ref.fused_lag_moments_ref(y, mask, 0, windows), calls=1)
        lib = _events_samples(lambda: smoke.lag_moments_library(*lib_ops))
        rec = {"shape": f"y {tuple(y.shape)}, {valid // B} valid starts a tenant of {L}, "
                        f"windows {windows}", "ms": ms[len(ms) // 2], "ms_samples": ms,
               "plain_ms": plain[len(plain) // 2], "library_ms": lib[len(lib) // 2],
               "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms[len(ms) // 2],
               "lag_err": e_lag, "mom_err": e_mom, "library_err": list(lib_err), "ok": ok,
               "entry": prep.entry}
        record["shapes"][shape] = rec
        print(f"session k3 {shape}: ms {rec['ms']:.5f} (min {ms[0]:.5f} max {ms[-1]:.5f}) "
              f"bound {b_ms:.5f} ({b_by}, share {rec['share']:.3f}) plain {rec['plain_ms']:.4f} "
              f"library {rec['library_ms']:.5f} err {e_lag:.2e} / {e_mom:.2e} (library "
              f"{lib_err[0]:.2e} / {lib_err[1]:.2e}) entry {prep.entry} ok {ok}", flush=True)
        if not ok:
            print(f"session k3 {shape}: INVALID against the plain version", flush=True)
        # the phases of each CTA (the probe build's launch on the same params)
        probe = entries[(("PROBE", 1),)]
        if probe(ctypes.byref(prep.params), torch.cuda.current_stream(dev).cuda_stream):
            raise RuntimeError("session k3 probe: launch failed")
        torch.cuda.synchronize()
        tenants = prep.params.tenants
        cyc = prep.out[0][::tenants].reshape(-1, d * d)[:, :4].contiguous().view(torch.int32)
        cyc = cyc.double() / tenants
        rec["phase_cycles_per_tenant"] = {k: [cyc[:, i].mean().item(), cyc[:, i].max().item()]
                                          for i, k in enumerate(SESSION_K3_PHASES)}
        print(f"session k3 {shape} probe, cycles a tenant (mean, max over CTAs): " + "; ".join(
            f"{k} {m:.0f} {x:.0f}" for k, (m, x) in rec["phase_cycles_per_tenant"].items()),
            flush=True)
        del prep, lib_ops
        torch.cuda.empty_cache()
    for shape in SESSION_K3 if len(points) > 1 else ():
        y, mask, windows = ops[shape]
        launchers = {}
        for defines, knobs in points:
            saved = _set_knobs(nops, knobs)
            prep = nops.prepare_fused_lag_moments(y, mask, 0, windows)
            _set_knobs(nops, saved)
            key = tuple(sorted(defines.items()))
            if key:
                def launch(prep=prep, entry=entries[key]):
                    if entry(ctypes.byref(prep.params), torch.cuda.current_stream(dev).cuda_stream):
                        raise RuntimeError("launch failed")
                    return prep.out
            else:
                launch = prep.launch
            got = tuple(t.clone() for t in launch())
            again = launch()
            e_lag, e_mom = k3_errors(ref, got, y, mask, windows)
            name = ",".join(f"{k}={v}" for k, v in {**defines, **knobs}.items()) or "shipped"
            if (max(e_lag, e_mom) > LAGMOM_TOL or not torch.equal(got[0], again[0])
                    or not torch.equal(got[1], again[1])):
                print(f"session k3 point {shape} {name}: INVALID ({e_lag:.2e} / {e_mom:.2e})",
                      flush=True)
                continue
            replays = 3 if mask.shape[0] > SESSION_QUERY else 10
            launchers[name] = lambda launch=launch, r=replays: graph_samples([launch], replays=r)
        record["points"][shape] = _lagmom_turns(f"session k3 points {shape}", launchers,
                                                SESSION_ROUNDS)
        del launchers
        torch.cuda.empty_cache()
    if old is None:
        return record
    oops = old["window_stats.ops"]
    for shape in SESSION_K3:
        y, mask, windows = ops[shape]
        base = oops.prepare_fused_lag_moments(y, mask, 0, windows)
        this = nops.prepare_fused_lag_moments(y, mask, 0, windows)
        errs = {"baseline": k3_errors(ref, base.launch(), y, mask, windows),
                "this": k3_errors(ref, this.launch(), y, mask, windows)}
        print(f"session k3 {shape} errors against the plain version: {errs}", flush=True)
        lib_ops = smoke.lag_moments_library_operands(y, mask, windows)
        replays = 3 if mask.shape[0] > SESSION_QUERY else 10
        launchers = {"baseline": lambda: graph_samples([base.launch], replays=replays),
                     "this": lambda: graph_samples([this.launch], replays=replays),
                     "library": lambda: _events_samples(
                         lambda: smoke.lag_moments_library(*lib_ops))}
        rec = _lagmom_turns(f"session {shape}", launchers, SESSION_ROUNDS)
        rec["errors"] = errs
        record["turns"][shape] = rec
        del base, this, lib_ops, launchers
        torch.cuda.empty_cache()
    return record


def session_prepare(m, which: str, ops: dict):
    """Package ``m``'s prepared launch of ``which`` on the operands of
    :func:`session_operands`."""
    if which in ("lag_tail", "blocked", "lag_tail_d32"):
        a, b = ops[which]
        return m["window_stats.ops"].prepare_cross_lagged_sums(a, b, SESSION_H)
    y, mask, z0, members = ops[which]
    return m["fused_plan.ops"].prepare_fused_plan(y, mask, z0, *members)


def session(new, old, gen, dev, k3_only: bool = False) -> dict:
    """Batched kernel 3 at the session's shapes first (:func:`session_k3`;
    ``k3_only``: nothing else), then kernels 1 and 2: the role split of batched
    kernel 1 (chunk and merge boundary; SESSION_ABLATIONS built from this
    checkout's fused_plan.cu), a sweep of Welch candidates per CTA at the
    chunk, and with ``old`` (a baseline package) old against new in turns
    (baseline, this, this, baseline, SESSION_ROUNDS times) at the chunk, the
    merge boundary and the lag tail (with the torch.matmul yardstick in the
    same turns), at the d = 64 shapes (the main path's chunk, the store's
    autocovariance_blocked) and at d = 32 (the chunk at 16,384 tenants, the
    lag tail), each pair checked for bitwise equal outputs.
    Samples go to build/kernel_variants/variants_session.json."""
    kdir = os.path.dirname(new["_build"].__file__)
    os.makedirs(OUT, exist_ok=True)
    ops = session_operands(gen, dev)
    k3 = session_k3(new, old, {**ops, **session_k3_operands(ops, gen, dev)}, dev)
    with open(os.path.join(OUT, "variants_session_k3.json"), "w") as f:
        json.dump(k3, f, indent=1)
    if k3_only:
        return {"k3": k3}
    ablated = os.path.join(OUT, "session_ablated.cu")
    with open(ablated, "w") as f:
        f.write(session_ablation_source(
            open(os.path.join(kdir, "fused_plan", "csrc", "fused_plan.cu")).read()))
    procs = {name: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", os.path.join(kdir, "csrc"),
         "-o", os.path.join(OUT, f"session_{name}.so"), ablated] + [f"-DABL_{f}" for f in flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in SESSION_ABLATIONS.items()}
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"session ablation {name}: build failed\n{log[-2000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"session_{name}.so"))
        size = lib.rt_plan_params_size
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(new["_build"].PlanParams):
            raise RuntimeError(f"session ablation {name}: PlanParams differs from _build.py's")
        entry = lib.rt_fused_plan
        entry.argtypes, entry.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        entries[name] = entry
        for kernel in ("ILb0ELi16E", "ILb1ELi16E", "ILb0ELi32E", "ILb1ELi32E", "ILb0ELi64E",
                       "ILb1ELi64E"):
            print(f"session ablation {name} fused_plan_kernel<{kernel[3]}, {kernel[7:9]}>: "
                  f"ptxas {_ptxas_of(log, 'fused_plan_kernel' + kernel)}", flush=True)
    record = {"device": torch.cuda.get_device_name(0), "split": {}, "sweeps": {}, "turns": {},
              "k3": k3}
    for shape in ("chunk", "boundary"):
        prep = session_prepare(new, shape, ops)
        launchers = {"shipped": prep.launch}
        for name, entry in entries.items():
            def launch(entry=entry, prep=prep):
                if entry(ctypes.byref(prep.params), torch.cuda.current_stream(dev).cuda_stream):
                    raise RuntimeError("launch failed")
            launchers[name] = launch
        for name, launch in launchers.items():
            samples = graph_samples([launch], replays=3, repeats=5)
            record["split"][f"{shape}/{name}"] = samples
            print(f"session split {shape} {name}: ms {samples[2]:.4f} (min {samples[0]:.4f} "
                  f"max {samples[-1]:.4f})", flush=True)
        p = prep.params
        record["split"][f"{shape}/grid"] = {
            "tenant_ctas": p.lag_ctas + p.mom_ctas + sum(p.welch[j].ctas
                                                         for j in range(p.n_welch)),
            "lag_ctas": p.lag_ctas, "mom_ctas": p.mom_ctas,
            "welch_ctas": [p.welch[j].ctas for j in range(p.n_welch)]}
        print(f"session grid {shape}: {record['split'][f'{shape}/grid']}", flush=True)
        del prep, launchers
        torch.cuda.empty_cache()
    fpm = new["fused_plan.ops"]
    shipped = fpm.WELCH_GROUP
    for group in (1, 2, 4, 8, 16):
        fpm.WELCH_GROUP = group
        samples = graph_samples([session_prepare(new, "chunk", ops).launch], replays=3)
        record["sweeps"][f"chunk/welch_group={group}"] = samples
        print(f"session sweep chunk welch_group={group}: ms {samples[2]:.4f} (min "
              f"{samples[0]:.4f} max {samples[-1]:.4f})", flush=True)
    fpm.WELCH_GROUP = shipped
    if old is None:
        with open(os.path.join(OUT, "variants_session.json"), "w") as f:
            json.dump(record, f, indent=1)
        return record
    tail, ext = ops["lag_tail"]
    for shape in ("chunk", "boundary", "lag_tail", "main_chunk", "blocked", "chunk_d32",
                  "lag_tail_d32"):
        base, this = session_prepare(old, shape, ops), session_prepare(new, shape, ops)
        got, want = this.launch(), base.launch()
        got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
        flat = lambda r: [x for t in r if t is not None
                          for x in (t if isinstance(t, tuple) else (t,))]
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
        del got, want
        replays = 3 if shape in ("chunk", "boundary", "chunk_d32") else 10
        launchers = {"baseline": lambda: graph_samples([base.launch], replays=replays),
                     "this": lambda: graph_samples([this.launch], replays=replays)}
        if shape == "lag_tail":
            lib = torch.matmul(ext.unfold(1, tail.shape[1], 1), tail[:, None]).transpose(-1, -2)
            err = ((lib - this.launch()).abs().max() / lib.abs().max()).item()
            print(f"session lag_tail library against this: max rel diff {err:.2e}", flush=True)
            del lib
            launchers["library"] = lambda: _events_samples(
                lambda: torch.matmul(ext.unfold(1, tail.shape[1], 1), tail[:, None]))
        if shape in ("chunk", "boundary"):  # the plain version, in the same turns
            from repro_torch.kernels.fused_plan.ref import fused_plan_update_ref

            args = ops[shape][:3] + ops[shape][3]
            launchers["plain"] = lambda: _events_samples(
                lambda: fused_plan_update_ref(*args), calls=1)
        rec = _lagmom_turns(f"session {shape} (bitwise equal: {same})", launchers,
                            SESSION_ROUNDS)
        rec["bitwise_equal"] = same
        record["turns"][shape] = rec
        del base, this, launchers
        torch.cuda.empty_cache()
    with open(os.path.join(OUT, "variants_session.json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def stats(baseline_dir: str, gen, dev, turns_only: bool = False) -> None:
    from repro_torch.core.estimators.spectral import hann_window
    from repro_torch.kernels.fused_plan.ref import welch_candidates
    from repro_torch.kernels.segment_dft.ref import dft_power_matrices

    old = load_kernels("baseline_kernels", os.path.abspath(baseline_dir))
    new = load_kernels("this_kernels", os.path.join(ROOT, "src", "repro_torch", "kernels"))
    D, CHUNK, H, WINDOWS, L, STEP = 64, 65536, 16, (64, 1024), 256, 128
    CARRY, ROT = max(WINDOWS) - 1, 8
    series = torch.randn((ROT * CHUNK + CARRY, D), generator=gen, device=dev)
    taper = hann_window(L, dev)
    starts = torch.arange(CHUNK, device=dev)
    z0 = torch.zeros((), dtype=torch.int32, device=dev)
    mask_mega = starts <= CHUNK - CARRY - 1
    mask_lag = starts <= CHUNK - H - 1
    ys = [series[i * CHUNK: i * CHUNK + CHUNK + CARRY] for i in range(ROT)]
    segs = [welch_candidates(y[: CHUNK + L - 1], starts <= CHUNK - L, z0, L, STEP)[0]
            .contiguous() for y in ys]
    lag_ops = [(torch.where(mask_lag[:, None], y[:CHUNK], 0.0).contiguous(),
                y[: CHUNK + H].contiguous()) for y in ys]
    C, S = (t.contiguous() for t in dft_power_matrices(L, taper))
    tails = lagmom_shapes(series, dev)["tail"]

    def spectral_operands(prepare):
        """The operands after the segments: (cos, sin) for a package whose
        segment kernels took the twiddle matrices, else (taper,)."""
        return (C, S) if "cos" in inspect.signature(prepare).parameters else (taper,)

    def preps(m, which):
        """Prepared launches of kernels 1-4 of package ``m``."""
        fp, sd, ws = m["fused_plan.ops"], m["segment_dft.ops"], m["window_stats.ops"]
        if which == "fused_plan_megakernel":
            return [fp.prepare_fused_plan(y, mask_mega, z0, H, WINDOWS, (L,), (STEP,),
                                          (taper,)) for y in ys]
        if which == "cross_window_stats":
            return [ws.prepare_cross_lagged_sums(a, b, H) for a, b in lag_ops]
        if which == "fused_lag_moments":
            return [ws.prepare_fused_lag_moments(y.contiguous(), mask_mega, 0, WINDOWS)
                    for y in ys]
        if which == "fused_lag_moments_tail":
            return [ws.prepare_fused_lag_moments(y.contiguous(), m, 0, w) for y, m, w in tails]
        ops = spectral_operands(sd.prepare_segment_power)
        return [sd.prepare_segment_power(s, *ops, True) for s in segs]

    # kernels 5-8 at chip_smoke.py's shapes
    x5 = torch.randn((2**22, D), generator=gen, device=dev)
    csd_segs = x5[:131072].unfold(0, L, STEP).transpose(1, 2).contiguous()
    diags = torch.randn((131072, 9), generator=gen, device=dev) * 0.05
    x7 = torch.randn((2047, 131072), generator=gen, device=dev)
    g7 = torch.randn((2047, 131072), generator=gen, device=dev)
    q = torch.randn((4, 8000, 32, 80), generator=gen, device=dev).bfloat16()
    kv = [torch.randn((4, 8000, 8, 80), generator=gen, device=dev).bfloat16()
          for _ in range(2)]
    # kernel 8 at lm_moe's prefill layer (llama4-maverick: G = 5, D = 128, W = S)
    qkv_llama4 = [torch.randn((4, 8000, n, 128), generator=gen, device=dev).bfloat16()
                  for n in (40, 8, 8)]

    def single(m, which):
        ws, sd = m["window_stats.ops"], m["segment_dft.ops"]
        if which == "window_moments":
            return [ws.prepare_window_moments(x5, 1024)]
        if which == "segment_csd":
            ops = spectral_operands(sd.prepare_segment_csd)
            return [sd.prepare_segment_csd(csd_segs, *ops, True)]
        if which == "banded_matvec":
            return [_band_prepare(m, diags, x7)]
        if which == "band_gradient":
            return [m["banded_matvec.ops"].prepare_band_gradient(g7, x7, 4)]
        if which == "swa_attention_llama4":
            return [m["swa_attention.ops"].prepare_swa_attention(*qkv_llama4, 8000,
                                                                  1 / math.sqrt(128))]
        return [m["swa_attention.ops"].prepare_swa_attention(q, kv[0], kv[1], 4096,
                                                              1 / math.sqrt(80))]

    record = {"device": torch.cuda.get_device_name(0), "turns": {}, "sweeps": {}}

    def flat(r):
        """Every tensor of a launch's (nested) outputs, real, float32."""
        items = [t for t in (r if isinstance(r, tuple) else (r,)) for t in (
            t if isinstance(t, tuple) else (t,)) if t is not None]
        return [torch.view_as_real(t) if t.is_complex() else t.float() for t in items]
    multi = ["fused_plan_megakernel", "cross_window_stats", "fused_lag_moments",
             "fused_lag_moments_tail", "segment_dft_power"]
    names = multi + ["window_moments", "segment_csd", "banded_matvec", "band_gradient",
                     "swa_attention", "swa_attention_llama4"]
    for name in names:
        make = preps if name in multi else single
        # parity of this package's first launch against the baseline's
        got, want = make(new, name)[0].launch(), make(old, name)[0].launch()
        err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(flat(got), flat(want)))
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
        del got, want
        base, this = make(old, name), make(new, name)
        rec = _lagmom_turns(f"{name} (bitwise equal: {same}, max rel diff {err:.2e})",
                            {"baseline": lambda: graph_samples([p.launch for p in base]),
                             "this": lambda: graph_samples([p.launch for p in this])},
                            STATS_ROUNDS)
        del base, this
        torch.cuda.empty_cache()
        rep = rec["report"]
        record["turns"][name] = {**rec, "rel_diff_vs_baseline": err, "bitwise_equal": same,
                                 "speed_up": rep["baseline"]["median_ms"] / rep["this"]["median_ms"]}
        print(f"{name}: baseline {rep['baseline']['median_ms']:.5f} ms, this "
              f"{rep['this']['median_ms']:.5f} ms, speed-up "
              f"{record['turns'][name]['speed_up']:.3f}x, this faster in "
              f"{rep['this']['wins_over_first']} of {2 * STATS_ROUNDS} paired turns, "
              f"max rel diff {err:.2e}, bitwise equal {same}", flush=True)
    del g7
    if turns_only:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "variants_turns.json"), "w") as f:
            json.dump(record, f, indent=1)
        return
    record["lagmom"] = lagmom(new, old, series, gen, dev)
    record["split"] = split(new, old, series, dev)
    del series
    record["session"] = session(new, old, gen, dev)

    # launch-shape sweeps of this package
    lch, fpm = new["_launch"], new["fused_plan.ops"]
    defaults = (lch.LAG_CTAS_PER_SM, fpm.WELCH_GROUP)
    sweeps = [("lag_ctas_per_sm", k, "fused_plan_megakernel") for k in (1, 2, 3, 4)]
    sweeps += [("lag_ctas_per_sm", k, "cross_window_stats") for k in (1, 2, 3, 4)]
    sweeps += [("welch_group", g, "fused_plan_megakernel") for g in (1, 2, 4, 8)]
    for knob, value, name in sweeps:
        lch.LAG_CTAS_PER_SM, fpm.WELCH_GROUP = defaults
        setattr(*{"lag_ctas_per_sm": (lch, "LAG_CTAS_PER_SM"),
                  "welch_group": (fpm, "WELCH_GROUP")}[knob], value)
        samples = graph_samples([p.launch for p in preps(new, name)])
        record["sweeps"][f"{name}/{knob}={value}"] = samples
        print(f"sweep {name} {knob}={value}: ms {samples[2]:.4f} (min {samples[0]:.4f} "
              f"max {samples[-1]:.4f})", flush=True)
    lch.LAG_CTAS_PER_SM, fpm.WELCH_GROUP = defaults
    for mom in (2, 4, 8):
        lch.MOM_CTAS_PER_SM = mom
        for name in ("fused_plan_megakernel",):
            samples = graph_samples([p.launch for p in preps(new, name)])
            record["sweeps"][f"{name}/mom_ctas_per_sm={mom}"] = samples
            print(f"sweep {name} mom_ctas_per_sm={mom}: ms {samples[2]:.4f} (min "
                  f"{samples[0]:.4f} max {samples[-1]:.4f})", flush=True)
    lch.MOM_CTAS_PER_SM = 2

    # kernel 4 on the FFT path, segments per CTA: the wrapper takes one; a
    # group keeps the next segment's copy in flight during this one's
    # transform.  At 511 segments (the main path's chunk) and at 1,023 (the
    # cross-spectra phase's welch_psd), each on 8 distinct sets of segments.
    sdm = new["segment_dft.ops"]
    for n_seg in (511, 1023):
        sets = [x5[i * 131072: i * 131072 + (n_seg + 1) * STEP].unfold(0, L, STEP)
                .transpose(1, 2).contiguous() for i in range(ROT)]
        want = sdm.prepare_segment_power(sets[0], taper, True).launch().clone()
        for group in (1, 2, 3, 4):
            def prep(segs):
                out = torch.empty((n_seg, L // 2 + 1, D), device=dev)
                p = lch.new_params(segs.view(n_seg * L, D), 0)
                p.detrend = 1
                _, _, ops = lch.add_welch(p, taper, None, n_seg, 1, L, group, dev, out=out)
                return lch.Prepared(sdm.SEGMENT_DFT_POWER, p, dev, out, (segs,) + ops)
            preps_g = [prep(segs) for segs in sets]
            same = torch.equal(preps_g[0].launch(), want)
            samples = graph_samples([p.launch for p in preps_g])
            record["sweeps"][f"segment_dft_power_{n_seg}/group={group}"] = samples
            print(f"sweep segment_dft_power {n_seg} segments, group={group}: ms "
                  f"{samples[2]:.4f} (min {samples[0]:.4f} max {samples[-1]:.4f}) "
                  f"equal to group 1: {same}", flush=True)
            del preps_g
        del sets
    record["sweeps"].update(swa_sweep(new, q, kv, dev))
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "variants_stats.json"), "w") as f:
        json.dump(record, f, indent=1)


# Design points of kernel 8's bf16 path, swept at the layer shape: (key
# tile, ring stages, consumer warpgroups, overlap, pingpong); the first is
# the checkout's own design, swa_attention.cu as it stands, and every other
# one a patched copy of it (_point_source).  Overlap: the next tile's Q K^T
# issued with this tile's P V (off: each tile's products and softmax one
# after the other); pingpong: the consumer warpgroups take turns to issue
# (off: each issues when its stage is full).
SWA_POINTS = [(64, 4, 3, 1, 1), (64, 4, 3, 0, 0), (64, 4, 3, 1, 0), (64, 4, 3, 0, 1),
              (64, 3, 3, 1, 1), (64, 5, 3, 1, 1), (128, 3, 3, 1, 1), (128, 3, 2, 1, 1),
              (128, 3, 2, 0, 0), (128, 2, 2, 1, 1), (128, 4, 2, 1, 1), (64, 4, 2, 1, 1)]
# Points timed in turns (A B C D D C B A, SWA_ROUNDS times), so that their
# medians stand apart from the spread between turns: the checkout's design
# with and without overlap and pingpong, and two consumers at 128 keys and
# 3 stages (the first design of this kernel on wgmma) likewise.
SWA_TURNS = [(64, 4, 3, 1, 1), (64, 4, 3, 0, 0), (128, 3, 2, 1, 1), (128, 3, 2, 0, 0)]
SWA_ROUNDS = 10
_SWA_PRODUCER_REGS = 24

# (anchor, replacement) in the consumer's tile loop and turns
_NO_OVERLAP = [
    ("      issue_s(stage);  // the next S and the last P V in flight together\n"
     "      issue_pv(prev);\n      turn_pass();\n      wgmma_wait<1>();\n"
     "      consume(it, true, prev);\n",
     "      issue_pv(prev);\n      wgmma_wait<0>();\n      fence_regs(o);\n"
     "      release(prev);\n      issue_s(stage);\n      turn_pass();\n"
     "      wgmma_wait<0>();\n      consume(it, false, 0);\n")]
_NO_PINGPONG = [
    ("  auto turn_wait = [&]() { bar_sync(1 + wg, 256); };\n", "  auto turn_wait = [&]() {};\n"),
    ("  auto turn_pass = [&]() { bar_arrive(1 + (wg + 1) % SWA_CONSUMERS, 256); };\n",
     "  auto turn_pass = [&]() {};\n"),
    ("  if (wg == SWA_CONSUMERS - 1) bar_arrive(1, 256);\n", ""),
    ("  if (wg == 0) bar_sync(1, 256);\n", "")]


def _patch(text: str, patches, what: str) -> str:
    for anchor, patched in patches:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{what}: anchor not found once: {anchor!r}")
        text = text.replace(anchor, patched)
    return text


def _wgmma_ss(n: int) -> str:
    """swa_attention.cu's wgmma_ss overload for a key tile of n: S (64 x n)
    = / += Q K^T, m64n{n}k16, both operands from shared memory."""
    r = n // 2
    outs = [f'"+f"(d[{i}])' for i in range(r)]
    return ("__device__ __forceinline__ void wgmma_ss(float (&d)[%d], uint64_t a, uint64_t b, "
            "int acc) {\n  asm volatile(\n"
            '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %%%d, 0;\\n"\n'
            '      "wgmma.mma_async.sync.aligned.m64n%dk16.f32.bf16.bf16 "\n'
            '      "{%s}, "\n'
            '      "%%%d, %%%d, p, 1, 1, 0, 0;\\n}\\n"\n'
            "      : %s\n"
            '      : "l"(a), "l"(b), "r"(acc));\n}\n'
            % (r, r + 2, n, ", ".join(f"%{i}" for i in range(r)), r, r + 1,
               ",\n        ".join(", ".join(outs[i:i + 8]) for i in range(0, r, 8))))


def swa_consumer_regs(consumers: int) -> int:
    """Registers a consumer thread may take with setmaxnreg.inc: the CTA's
    launch allocation (65,536 / threads, in steps of 8) less the producer
    warpgroup's, shared by the consumers, at most 240."""
    threads = 128 * (consumers + 1)
    launch = min(255, 65536 // threads) // 8 * 8
    return min(240, (launch * (consumers + 1) - _SWA_PRODUCER_REGS) // consumers // 8 * 8)


def _point_source(text: str, point) -> str:
    """swa_attention.cu's text patched to the design point (key tile, ring
    stages, consumer warpgroups, overlap, pingpong)."""
    keys, stages, consumers, overlap, pingpong = point
    for name, value in (("SWA_KEYS", keys), ("SWA_STAGES", stages),
                        ("SWA_CONSUMERS", consumers),
                        ("SWA_CONSUMER_REGS", swa_consumer_regs(consumers))):
        line = re.findall(rf"^#define {name} \d+", text, re.M)
        if len(line) != 1:
            raise RuntimeError(f"#define {name} not found once")
        text = text.replace(line[0], f"#define {name} {value}")
    if f"void wgmma_ss(float (&d)[{keys // 2}]" not in text:
        anchor = "// O (64 x N, f32) += P"
        text = _patch(text, [(anchor, _wgmma_ss(keys) + anchor)], f"keys={keys}")
    if not overlap:
        text = _patch(text, _NO_OVERLAP, "overlap=0")
    if not pingpong:
        text = _patch(text, _NO_PINGPONG, "pingpong=0")
    return text


def _point_name(point) -> str:
    return ",".join(f"{n}={v}" for n, v in
                    zip(("keys", "stages", "consumers", "overlap", "pingpong"), point))


# Ablations of the checkout's design: parts of the bf16 path compiled out of a
# copy of swa_attention.cu (the text at each anchor gains an #ifdef), to see
# which part sets the kernel's time.  ABL_NO_TMA: the producer signals each
# stage without loading it (K and V stay the zeros written at the start);
# ABL_NO_S, ABL_NO_PV: the products are not issued; ABL_NO_SOFTMAX: P is S
# packed as it is.  Results are garbage; only the times count.
SWA_ABLATIONS = {"tma_only": ("NO_S", "NO_PV", "NO_SOFTMAX"), "no_tma": ("NO_TMA",),
                 "products_only": ("NO_TMA", "NO_SOFTMAX"),
                 "qk_only": ("NO_TMA", "NO_SOFTMAX", "NO_PV"),
                 "pv_only": ("NO_TMA", "NO_SOFTMAX", "NO_S"),
                 "softmax_only": ("NO_TMA", "NO_S", "NO_PV")}
_ABLATION_PATCHES = [
    ("  auto issue_s = [&](int stage) {\n",
     "  auto issue_s = [&](int stage) {\n"
     "#ifdef ABL_NO_S\n    wgmma_commit();\n    return;\n#endif\n"),
    ("  auto issue_pv = [&](int stage) {\n",
     "  auto issue_pv = [&](int stage) {\n"
     "#ifdef ABL_NO_PV\n    wgmma_commit();\n    return;\n#endif\n"),
    ("    if (kt + SWA_KEYS - 1 <= w_lo && kt > w_hi - W)  // inside every row's window\n",
     "#ifdef ABL_NO_SOFTMAX\n    alpha_a = alpha_b = 1.f;\n    if (false)\n#else\n"
     "    if (kt + SWA_KEYS - 1 <= w_lo && kt > w_hi - W)\n#endif\n"),
    ("      softmax(Masked<true>(), kt, alpha_a, alpha_b);\n",
     "#ifndef ABL_NO_SOFTMAX\n      softmax(Masked<true>(), kt, alpha_a, alpha_b);\n"
     "#else\n      ;\n#endif\n"),
    ("        mbar_expect_tx(&full[stage], Sm::K_BYTES + Sm::V_BYTES);\n",
     "#ifdef ABL_NO_TMA\n        mbar_arrive(&full[stage]);\n        continue;\n#endif\n"
     "        mbar_expect_tx(&full[stage], Sm::K_BYTES + Sm::V_BYTES);\n"),
    ("  if (threadIdx.x == 0) {\n    for (int i = 0; i < Sm::STAGES; ++i) {\n",
     "#ifdef ABL_NO_TMA\n"
     "  for (int i = threadIdx.x; i < Sm::STAGES * (Sm::K_BYTES + Sm::V_BYTES) / 16;\n"
     "       i += blockDim.x)\n"
     "    reinterpret_cast<uint4*>(ks)[i] = make_uint4(0, 0, 0, 0);\n#endif\n"
     "  if (threadIdx.x == 0) {\n    for (int i = 0; i < Sm::STAGES; ++i) {\n"),
]


def swa_sweep(m, q, kv, dev) -> dict:
    """Kernel 8 built from package ``m``'s swa_attention.cu once per design
    point of SWA_POINTS (a patched copy in build/ for all but the first) and
    once per ablation of SWA_ABLATIONS, all compiled together, each launched
    at the layer shape through the same SwaParams as the package's wrapper,
    held to the package's own launch (largest difference over the largest
    entry) and timed as a CUDA graph; then the points of SWA_TURNS in turns."""
    src = os.path.join(os.path.dirname(m["_build"].__file__), "swa_attention", "csrc",
                       "swa_attention.cu")
    os.makedirs(OUT, exist_ok=True)
    text = open(src).read()
    builds = []
    for i, point in enumerate(SWA_POINTS):
        path = os.path.join(OUT, f"swa_point_{i}.cu")
        with open(path, "w") as f:
            f.write(_point_source(text, point) if i else text)
        builds.append(("swa_attention/" + _point_name(point), path, []))
    ablated = os.path.join(OUT, "swa_attention_ablated.cu")
    with open(ablated, "w") as f:
        f.write(_patch(text, _ABLATION_PATCHES, "ablation"))
    builds += [(f"swa_attention/ablation={name}", ablated, [f"-DABL_{f}" for f in flags])
               for name, flags in SWA_ABLATIONS.items()]
    libs, procs = [], []
    for i, (_, path, defines) in enumerate(builds):
        lib = os.path.join(OUT, f"swa_{i}.so")
        libs.append(lib)
        procs.append(subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib, path] + defines,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    prep = m["swa_attention.ops"].prepare_swa_attention(q, kv[0], kv[1], 4096, 1 / math.sqrt(80))
    want = prep.launch().clone()
    out, launchers = {}, {}
    for (key, _, _), lib, proc, log in zip(builds, libs, procs, logs):
        if proc.returncode != 0:
            print(f"sweep {key}: build failed\n{log[-2000:]}", flush=True)
            continue
        fn = ctypes.CDLL(lib).rt_swa_attention
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int

        def launch(fn=fn, key=key):  # on the current stream: the capture's, inside graph_samples
            if fn(ctypes.byref(prep.params), torch.cuda.current_stream(dev).cuda_stream) != 0:
                raise RuntimeError(f"{key}: launch failed")
        prep.out.zero_()
        launch()
        torch.cuda.synchronize()
        diff = ((prep.out.float() - want.float()).abs().max() / want.float().abs().max()).item()
        samples = graph_samples([launch])
        out[key] = samples
        launchers[key] = launch
        print(f"sweep {key}: ms {samples[2]:.4f} (min {samples[0]:.4f} max {samples[-1]:.4f}) "
              f"max rel diff to the package's launch {diff:.2e}; D=80 build: "
              f"{_ptxas_d80(log)}", flush=True)
    keys = ["swa_attention/" + _point_name(point) for point in SWA_TURNS]
    if all(k in launchers for k in keys):
        turns = {k: [] for k in keys}
        for _ in range(SWA_ROUNDS):
            for k in keys + keys[::-1]:
                turns[k].append(graph_samples([launchers[k]]))
        for k in keys:
            every = sorted(x for sample in turns[k] for x in sample)
            medians = [sample[2] for sample in turns[k]]
            out[k.replace("swa_attention/", "swa_turns/")] = turns[k]
            print(f"turns {k}: ms {every[len(every) // 2]:.4f} over {len(every)} samples (min "
                  f"{every[0]:.4f} max {every[-1]:.4f}); turn medians "
                  f"{' '.join(f'{x:.4f}' for x in medians)}", flush=True)
    return out


def _ptxas_of(log: str, kernel: str) -> str:
    """The -Xptxas -v lines (registers, spills) of the kernel whose mangled
    name holds ``kernel``."""
    lines, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = kernel in ln
        elif keep and ("spill" in ln or "registers" in ln):
            lines.append(ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip())
    return "; ".join(lines)


def _ptxas_d80(log: str) -> str:
    """The -Xptxas -v lines of the D = 80 bf16 kernel: registers, spills and
    any performance note."""
    lines, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "swa_bf16_kernelILi80E" in ln
        elif keep and ("spill" in ln or "registers" in ln):
            lines.append(ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip())
        elif "ILi80E" in ln and "C75" in ln:
            lines.append(ln.split("(C75", 1)[1][:80])
    return "; ".join(lines)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    if which in ("stats", "turns"):
        if len(sys.argv) < 3:
            sys.exit(f"{which} needs the baseline kernels directory")
        stats(sys.argv[2], gen, dev, turns_only=which == "turns")
        return
    if which in ("session", "session_k3"):
        new = load_kernels("this_kernels", os.path.join(ROOT, "src", "repro_torch", "kernels"))
        old = (load_kernels("baseline_kernels", os.path.abspath(sys.argv[2]))
               if len(sys.argv) > 2 else None)
        session(new, old, gen, dev, k3_only=which == "session_k3")
        return
    if which in ("lagmom", "split"):
        new = load_kernels("this_kernels", os.path.join(ROOT, "src", "repro_torch", "kernels"))
        old = (load_kernels("baseline_kernels", os.path.abspath(sys.argv[2]))
               if len(sys.argv) > 2 else None)
        series = torch.randn((8 * 65536 + 1023, 64), generator=gen, device=dev)
        if which == "split":  # the baseline's alone when it is given
            record = split(None if old is not None else new, old, series, dev)
            os.makedirs(OUT, exist_ok=True)
            with open(os.path.join(OUT, "variants_split.json"), "w") as f:
                json.dump(record, f, indent=1)
        else:
            lagmom(new, old, series, gen, dev)
        return
    if which == "swa":
        m = load_kernels("this_kernels", os.path.join(ROOT, "src", "repro_torch", "kernels"))
        q = torch.randn((4, 8000, 32, 80), generator=gen, device=dev).bfloat16()
        kv = [torch.randn((4, 8000, 8, 80), generator=gen, device=dev).bfloat16()
              for _ in range(2)]
        record = swa_sweep(m, q, kv, dev)
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "variants_swa.json"), "w") as f:
            json.dump(record, f, indent=1)
        return
    if which in ("banded", "all"):
        banded(sys.argv[2] if which == "banded" and len(sys.argv) > 2 else None, gen, dev)
    if which in ("moments", "all"):
        moments(gen, dev)


if __name__ == "__main__":
    main()
