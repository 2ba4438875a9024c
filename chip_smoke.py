#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's nine CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each against its plain PyTorch version on the card, drives the fused
statistics plan end to end at full width through ``SeriesFrame``, runs the
single-family plans, then the three further statistics paths -- the §6
banded spatial AR fit, rolling moments and cross-spectra -- times kernels
1-7 and 7b (the gradient of kernel 7's diagonals; kernel 3 also at the
moments finalize's tail), drives the overlapping block store
(``SeriesFrame.from_sharded`` over ``TimeSeriesStore``: kernel 1 launched
once per collect for every block, kernel 2 once per
``autocovariance_blocked``), the same store's path on a one-rank NCCL
mesh (``from_sharded(mesh=)``, mesh stores in both halo modes,
``autocovariance_sharded``, ``halo_exchange``, an elastic restore: the
distribution layer, one ``psum_tree`` collective a collect), the
multi-tenant session (FrameSession over
RollingStatsService: kernels 1-4 launched once per arrival batch and per
batched query for every tenant), the serving gateway (StatsGateway over a
session with forecasts and anomaly scores: per-tick coalescing, crc32
checkpoints, kill and restart past a torn generation, a chaos-poisoned
tenant quarantined and rebuilt), then checks and times kernel 8
(sliding-window attention) and serves h2o-danube-1.8b at full width and
depth through ``ServeEngine.generate``, then with int8 weights
(``ServeEngine(quantize=True)``), then the mixture-of-experts family:
llama4-maverick-400b-a17b at full width with its depth cut to 2 layers
(its MoE layer held against a float32 loop over the experts),
deepseek-v2-236b at full width with its depth cut to 7 layers (multi-head
latent attention: the prefill through kernel 8 at q/k 192, v 128, the
decode absorbed against the latent cache), qwen3-0.6b at full width
and depth, served and then trained (``lm_train``: AdamW steps at train_4k's
sequence of 4,096 on the synthetic token pipeline, float32 moments, remat,
the fused cross-entropy, plain attention: no kernel has a backward; checked
against the served loss, finite differences, float32 accumulation and a
bitwise restart from a checkpoint) and served over two model ranks on the
one card (``lm_tp``: tensor parallelism, two processes of
tools/tp_phase.py over gloo, kernel 8 on each rank's heads, each rank's
vocab shard of the logits held against the whole model on one rank) and
trained over a (2, 2) mesh of ranks on the one card (``lm_tp_train``: four
processes, the backward through the model-axis collectives, the norm
across shards, ZeRO-1 moments; each rank's float32 step held against the
one-rank step on the whole batch), and zamba2-7b at full width and full
depth (the Mamba2 / shared-attention hybrid: the prefill through kernel 8 at head dim 112, G =
1, once per application of the shared block; the chunked SSD held against
its recurrence), and xlstm-125m at full width and full depth (the xLSTM
family: mLSTM and sLSTM mixers in plain PyTorch, no kernel on the path;
held in float32 against the CPU, its chunked mLSTM against its recurrence,
its sLSTM across segments), whisper-base at full width and full depth (the
encoder-decoder: the decoder's causal self-attention prefill through kernel
8 at head dim 64, G = 1, the encoder and cross-attention bidirectional in
plain PyTorch; held in float32 against the CPU) and llava-next-34b at full
width (the VLM: 2,880 stub patch embeddings before the text, every layer's
prefill through kernel 8 at 128, G = 7); then the dry run of each of those
phases on the host (``dryrun``: `launch.costing`'s count of the phase's
own prefill, decode or train step on the meta device held against the
phase's hand count, its measured times against the bound and its peak
memory against the prediction); then the paper's last estimators at its
own VAR workload sizes (``configs/paper_var.py``: the §5 conditional MLE by
gradient descent and SGD, ARMA and MA fits from kernel 2's
autocovariances, the §6 banded fit with kernels 7 and 7b, differencing)
and the §9-11 graph map-reduce with the traffic DBN; last, the backend
policy layer:
the calibration measured on the card (``repro_torch.core.calibrate``),
the ``"auto"`` backend with that table over the main path's plan and a
session tick (every call held against ``"cuda"``), and the counted
circuit breaker through the gateway under a chaos schedule; printing one
JSON line per phase.  Every phase before the calibration runs on the
built-in tile blocks, whatever table a machine has cached.
The second-to-last line lists the kernels; the last line names the device
and is printed only when every phase passed.

    python3 chip_smoke.py [--seed 0] [--chunks 64]

Full width: d = 64 channels, 64 chunks of 65,536 rows (2^22 samples per
channel, 1 GiB of float32 on the card), plan = autocovariance(16),
yule_walker(8), arma(2, 1), moments(64), moments(1024), welch(256, 128).
Rolling moments (w = 64, 1024) run over the same series, cross-spectra over
its first 131,072 rows (nperseg 256, overlap 128), and the spatial fit over
a banded AR(1) of d = 131,072, b = 4, simulated for 2,048 steps.  The
store holds the same series in 512 blocks of 8,192 rows plus the plan's
1,023-row halo; one 65,536-row append doubles it.  The mesh phase runs
that store's series and plan at world 1 (cut: one card; NCCL in-process,
a ``file://`` rendezvous in a temporary directory).  The session: 65,536
tenants of d = 16, 8 ticks of 256 rows each, plan autocovariance(16),
yule_walker(8), moments(32), moments(128), welch(64, 32), then an eviction
session of 16,384 tenants over a 2,048-sample ring of 8 buckets.  The
gateway: the session's width and plan plus forecast(16, "ar", p=8),
forecast(16, "auto", p=4, max_period=16) and anomaly_scores("arma", p=2,
q=1); each tick all 65,536 tenants submit a (256, 16) host chunk and 4,096
a query; snapshots every 4 ticks; tenant i's sinusoid at bin k_i in [4, 12]
of the 64-point segment plants the period round(64 / k_i); the chaos
check at 4,096 tenants (cut: it needs a fault-free twin run).  The store's
replan adds forecast(32, "ar", p=8) and anomaly_scores("arma", p=2, q=1).
Serving: h2o-danube-1.8b (24 layers, d_model 2560, 32 query / 8 KV heads of 80,
window 4096) in bf16 with random weights from ``--seed``, 4 prompts of
8,000 tokens, 32 greedy new tokens each.  The calibration: the reference's
default grid (512 to 32,768 rows, d = 8), its table written to
``build/repro_torch/calibration_cuda.json``.  "auto": the main path's plan
over 8 chunks (cut from 64, for time) and one tick of the session's
65,536 tenants.  The breaker: tests/test_chaos.py:602's schedule at 4,096
tenants (cut from 65,536: it needs a fault-free twin run) of the gateway's
width and plan.
lm_quant: lm_serve's model and prompts, the engine holding int8 codes and
float32 scales and dequantizing them to bf16 on every call.  lm_moe:
llama4-maverick-400b-a17b (d_model 5,120, 40 / 8 heads of 128, 128 experts
of 8,192, top-1, one shared expert, vocab 202,048) in bf16 with depth
**cut** from 48 to 2 layers (69.3 GB of weights), 4 prompts of 8,000
tokens, 16 new each; kernel 8 is also checked and timed alone at its
prefill's layer shape (W = S = 8,000, G = 5).  lm_mla: deepseek-v2-236b
(d_model 5,120, 128 heads, MLA ranks q 1,536 / kv 512, rope 64, nope 128,
v 128, 160 experts of 1,536, top-6, two shared, vocab 102,400) in bf16
with depth **cut** from 60 to 7 layers (57.72 GB of weights), 4 prompts of
8,000 tokens, 16 new each; kernel 8 is also checked and timed alone at its
prefill's layer shape (q/k 192, v 128, G = 1, W = S = 8,000), and at q/k
and v widths that differ over an edge grid.  lm_qwen3: qwen3-0.6b, 2
prompts of 4,096 tokens, 8 new.  lm_train: qwen3-0.6b in bf16 at full
width and depth, sequence 4,096, microbatches of 8, the global batch
**cut** from 256 to TRAIN_MICRO x TRAIN_ACCUM sequences (the phase's time),
the pipeline's bigram vocabulary **cut** to 4,096 (its dense tables), 3
steps and a restart of 2.  lm_tp: qwen3-0.6b at full width and depth over
2 model ranks (**cut**: one card, the ranks sharing it over host-staged
gloo), lm_qwen3's 2 prompts of 4,096 tokens, 32 greedy decode steps.
lm_tp_train: qwen3-0.6b at full width and depth over a (data, model) mesh
of (2, 2) (**cut**: one card, the four ranks sharing it over host-staged
gloo), train_4k's sequence of 4,096, 2 sequences a data rank (the global
batch **cut** from 256 to 4, the phase's time), one float32 step and 2
bf16 steps.
lm_zamba: zamba2-7b (81 Mamba2 layers of
d_model 3,584, 112 SSD heads of 64, state 64, chunk 256; one shared block of
32 heads of 112 and d_ff 14,336 applied 14 times; vocab 32,000) in bf16 with
no cut (13.50 GB of weights), 4 prompts of 8,000 tokens, 16 new each;
kernel 8 is also checked and timed alone at its prefill's layer shape (W =
S = 8,000, G = 1, D = 112).  lm_xlstm: xlstm-125m (6 pairs of mLSTM ->
sLSTM, d_model 768, 4 heads, the mLSTM's d_in 1,536, vocab 50,304) in bf16
with no cut (0.35 GB of weights), 4 prompts of 2,000 tokens (the serial
sLSTM runs 12,000 eager steps a prefill), 32 new each; its profiled
prefill **cut** to 500 tokens.  lm_whisper: whisper-base (6 encoder and 6
decoder layers, d_model 512, 8 heads of 64, d_ff 2,048, vocab 51,865) in
bf16 with no cut (0.22 GB of weights), 32 clips of 1,500 stub frames, a
192-token decoder prompt and 64 new tokens each, max_len 256.  lm_llava:
llava-next-34b (60 layers, d_model 7,168, 56 / 8 heads of 128, d_ff
20,480, vocab 64,000, 2,880 patches) in bf16 at depth LLAVA_LAYERS (60:
no cut, 68.9 GB of weights), 4 requests of 2,880 stub patch embeddings
and 512 text tokens, 32 new each.  paper_var:
var-dense-small (n = 100,000, d = 8, p = 3) and var-dense-wide (n =
1,000,000, d = 64, p = 2), each fit_ar_mle for 200 steps at block size
4,096 (a second fit of 100 steps updates the precision every 50, and a
third of 20 steps takes fit_ar_mle's default step, reported only), and
fit_ar_sgd for 2,000 steps of 256 windows; varma (n = 500,000, d = 8, p =
2, q = 1): gamma(0..30) held against its plain version, fit_arma(m = 25),
fit_ma(m = 20) on a VMA(1) series; var-banded-highd (d = 16,384, b = 4, p = 1) with n **cut** from
200,000 to 32,768 (the simulation is one eager kernel-7 step a sample) and
the fit **cut** from 300 to 20 steps; differencing on the var-dense-wide
series integrated once.  graphs: the traffic DBN on a 65,536-link corridor
for 2,048 steps (inflow 0.08, then 0 in float32 and float64), a 256 x 256
sensor lattice in 16 parts with 1-hop halos, and the graph map-reduce of a
(65,536, 2,048) float32 series.
Exits non-zero, printing no result, without a GPU or when a phase fails.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
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
# a 256-term contraction).  The power of kernels 1 and 4 is held both ways:
# normwise (TOL["psd"], against max|plain|) and per bin (TOL_NEW["psd"]),
# each entry (segment, f, channel) against the plain power at (f, channel)
# averaged over segments, or a power summed over segments against itself.
# Normwise alone lets the faint bins go: at the main path's shape max|plain|
# is set by the low bins of the phi = 0.9 channels, about 180 times the
# faintest high-frequency bin.  Both sides round in fp32, by about eps
# sqrt(L) of a segment's typical coefficient, and a mean over few segments
# can fall far below its expectation: on the H100 the per-bin readings were
# 2.1e-5 at the main path's shape and up to 4.1e-4 over 5 segments of L =
# 4,096 (tests/test_torch_cuda.py).
TOL_NEW = {"window": 1e-5, "band": 1e-5, "csd": 1e-4, "psd": 1e-3}
# Kernel 3's edge grid (TOL["lag"], TOL["moments"]): lags, widths and
# windows (one, the main path's two, eight), masks with holes.
LAGMOM_N = 3000
LAGMOM_LAGS = (0, 1, 16, 40)
LAGMOM_DIMS = (1, 63, 64, 65, 130)
LAGMOM_WINDOWS = {"w1": (1,), "w64_1024": (64, 1024),
                  "w8": (3, 8, 17, 64, 100, 257, 512, 1024)}

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
NRHS1_COPIES = 20  # distinct operand sets of the one-right-hand-side timing
# The fit's NLL is a float32 mean of (T-1) d = 2.7e8 squared residuals.  It
# must fall at every step until its excess over the minimum reaches that
# mean's rounding (the error contracts by about 0.11 per step, the excess by
# about 0.013, so within a handful of steps); from there it may only move
# within NLL_NOISE of itself (a few float32 ulps; a float32 sum of n terms
# may round by up to about log2(n) ulps).
NLL_NOISE = 1e-6
NLL_MIN_DESCENT = 3  # steps that must fall strictly before the noise floor

# Kernel 8 and the serving path: h2o-danube-1.8b at full width and depth in
# bf16, 4 requests of 8,000 prompt tokens (above the 4,096 window, not a
# multiple of 64; the prefill ring shifts 3,904) and 32 greedy new tokens
# each (decode wraps the ring).  Kernel 8's layer shape is that prefill's.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "danube", 4, 8000, 32
SWA_B, SWA_S, SWA_H, SWA_KVH, SWA_D, SWA_W = 4, 8000, 32, 8, 80, 4096
# lm_moe: llama4-maverick-400b-a17b at full width (d_model 5,120, 40 / 8
# heads of 128, 128 experts of 8,192, top-1, one shared expert, vocab
# 202,048, capacity factor 1.25, "gather" dispatch) in bf16 with its depth
# **cut** to MOE_LAYERS of 48: a layer holds 32.59 GB (its experts 32.21),
# the embedding and lm_head 2.069 GB each, so two layers take 69.3 GB of the
# card's 80 GiB.  lm_serve's prompts (4 x 8,000 tokens: T = 32,000, each
# expert's bucket 312) and MOE_NEW greedy new tokens.  No window, so its
# prefill runs kernel 8 at W = S: MOE_SWA is that layer shape (B, S, H,
# KVH, D), G = 5.  Check 2 holds moe_apply against a float32 loop over the
# experts on the first layer's prefill input: max |kernel path - plain| of
# each token's row within MOE_TOL of the row's max|plain| (bf16 rounds g, u,
# the activation, each expert's and the shared expert's outputs and their
# sum: about 4 ulps of 2^-8 at the row's largest entries).
MOE_ARCH, MOE_LAYERS, MOE_NEW = "llama4", 2, 16
# the plain path's query chunk: at W = S = 8,000 one chunk of 512 queries
# holds (4, 8, 5, 512, 8,000) float32 logits, 2.6 GB, three times over,
# beside 69.3 GB of weights; 128 queries hold a quarter of that
MOE_PLAIN_CHUNK = 128
MOE_SWA = (4, 8000, 40, 8, 128)
MOE_TOL = 2e-2
# the profiled prefill and decode step run each MoE layer inside MOE_RANGE,
# and split its device time by the aten operators called in it: MOE_OPS
MOE_RANGE = "lm_moe.moe_apply"
MOE_OPS = {"experts_bmm": ("aten::bmm",),
           "gathers_scatters": ("aten::index", "aten::index_put_"),
           "shared_and_router_mm": ("aten::matmul", "aten::mm")}
KERNEL8_NAME = "swa_bf16_kernel"  # kernel 8's bf16 entry, as the profiler names it
# lm_mla: deepseek-v2-236b at full width (d_model 5,120, 128 heads, MLA ranks
# q 1,536 and kv 512, rope 64, nope 128, v 128; 160 experts of 1,536, top-6,
# two shared; vocab 102,400; capacity factor 1.25, "gather" dispatch) in
# bf16 with its depth **cut** to MLA_LAYERS of 60: a layer holds 7.946 GB
# (experts 7.550, MLA 0.298, shared 0.094), the embedding and lm_head 1.049
# GB each, so 7 layers take 57.72 GB; with 8 (65.67 GB) the plain path's
# attention ran out of the card's 79.18 GiB (its einsum copies K, 1.46 GiB,
# beside 5.8 GiB of the allocator's unused blocks).  lm_serve's prompts (4 x
# 8,000 tokens) and MLA_NEW greedy new tokens.  The prefill runs kernel 8
# at the non-absorbed form's layer shape MLA_SWA (B, S, H, D, DV): q/k of
# nope + rope = 192, v of 128, G = 1 (KVH = H), W = S; decode is absorbed
# (plain PyTorch against the (B, C, 576) latent cache).  MLA_RANGE: each
# layer's attention in its profiler range, split by MLA_OPS: the products
# called directly in it (a prefill's seven projections; a decode step's
# five, the fold through w_uk and the two attention products).
MLA_ARCH, MLA_LAYERS, MLA_NEW = "deepseek-v2", 7, 16
MLA_SWA = (4, 8000, 128, 192, 128)
# the plain path's query chunk: at W = S one chunk of 64 queries holds (4,
# 128, 1, 64, 8,000) float32 logits, 1.05 GB, a few times over
MLA_PLAIN_CHUNK = 64
MLA_RANGE = "lm_mla.mla_apply"
MLA_OPS = {"mla_projections": ("aten::matmul", "aten::mm", "aten::einsum")}
# the function each profiler range wraps: a name in `models/transformer.py`,
# or (module, attribute path)
RANGE_TARGETS = {MOE_RANGE: "moe_apply", MLA_RANGE: "attention_apply"}
# qwen3-0.6b at full width and depth (28 layers, d_model 1,024, 16 / 8
# heads of 128, qk_norm, no window) in bf16: 2 prompts of 4,096 tokens, 8
# new, lm_serve's checks 1-2 (kernel 8 at W = S = 4,096, G = 2).
QWEN_ARCH, QWEN_BATCH, QWEN_PROMPT, QWEN_NEW = "qwen3", 2, 4096, 8
# lm_tp: qwen3-0.6b at full width and depth over TP_MODEL model ranks on
# the one card (the gloo transport: NCCL refuses two ranks on one device;
# each rank a process, tools/tp_phase.py), lm_qwen3's prompts, then
# TP_STEPS greedy decode steps through build_cell's tensor-parallel
# prefill and decode.  Kernel 8 runs on each rank's 8 query / 4 KV heads
# (TP_SWA).  Checks 1 and 2 hold the ranks against the whole model on one
# rank at TP_FLOOR_FACTOR x the floor measured in the same run (rank 0's
# kernel prefill against its plain-attention prefill: random bf16 layers
# amplify one attention's rounding, and a tensor-parallel rank rounds
# each row-parallel partial to bf16 once more).
TP_ARCH, TP_MODEL, TP_BATCH, TP_PROMPT, TP_STEPS = "qwen3", 2, 2, 4096, 32
TP_FLOOR_FACTOR = 4.0
TP_SWA = (2, 4096, 8, 4, 128)  # B, S, query heads, KV heads, head dim of a rank
TP_LIMIT_S = 120.0  # the phase's time, the ranks' start included
TP_TIMEOUT_S = 300  # the ranks' processes are killed after this
TP_REHEARSAL = (40, 4)  # prompt, decode steps of the CPU rehearsal (the reduced config)
# lm_tp_train: qwen3-0.6b trained at full width and depth over a (data,
# model) mesh of TP_TRAIN_MESH on the one card (four processes of
# tools/tp_phase.py --train over gloo), train_4k's sequence of TP_TRAIN_SEQ,
# TP_TRAIN_ROWS sequences a data rank (a global batch of 4: **cut** from
# 256, the phase's time), full remat, the fused cross-entropy, the plain
# chunked attention, ZeRO-1 moments.  Check 1 holds one float32 step,
# clipped (TP_TRAIN_CLIP below the whole model's norm) at the constant lr
# TP_TRAIN_LR, against the one-rank step on the whole batch (each rank runs
# it in turn: the same function, and cheaper than carrying the whole
# reference to every process through the host), normwise per leaf within
# max(TP_TRAIN_MIN_LIMIT, TP_TRAIN_FLOOR_FACTOR x floor), the floor the
# one-rank step's gradients at accumulation 1 against 2 (this run); check 5
# runs TP_TRAIN_BF16_STEPS bf16 steps.
TP_TRAIN_MESH, TP_TRAIN_SEQ, TP_TRAIN_ROWS = (2, 2), 4096, 2
TP_TRAIN_LR, TP_TRAIN_CLIP, TP_TRAIN_BF16_STEPS = 1e-4, 0.1, 2
TP_TRAIN_FLOOR_FACTOR, TP_TRAIN_MIN_LIMIT = 4.0, 1e-4
TP_TRAIN_LIMIT_S = 180.0  # the phase's time, the ranks' start included
TP_TRAIN_TIMEOUT_S = 420  # the ranks' processes are killed after this
TP_TRAIN_REHEARSAL = 32  # the CPU rehearsal's sequence (the reduced config)
# lm_train: qwen3-0.6b trained at full width and depth (28 layers, d_model
# 1,024, 16 / 8 heads of 128, d_ff 3,072, vocab 151,936, qk_norm; 596 M
# matmul weights with lm_head, 752 M parameters with the embedding) in bf16
# from ``--seed``: float32 AdamW moments, every block under full remat, the
# fused chunked cross-entropy, plain chunked attention (kernel 8 has no
# backward).  train_4k's sequence of TRAIN_SEQ tokens, microbatches of
# TRAIN_MICRO sequences, TRAIN_ACCUM of them a step: a global batch of
# TRAIN_MICRO x TRAIN_ACCUM sequences, **cut** from train_4k's 256 to fit
# the phase's time.  Tokens from the pipeline with its bigram vocabulary
# **cut** to TRAIN_DATA_VOCAB (the reference's dense (V, V) tables would be
# 92 GB each at 151,936); the model keeps its full embedding and head.
# TRAIN_STEPS steps from the seed (warmup 1: step 0's lr is 0), the state
# after step 0 checkpointed, restored into a model of another seed, and
# steps 1-2 run again (the restart check, under deterministic algorithms).
# On an H100 80GB HBM3 at 700 W a microbatch took about 6 s and a step of 8
# of them 48.5 s: 6 steps and the checks overran the phase's 300 s; at 4 (a
# global batch of 32) the whole run, with the dryrun phase, took 1,127.7 s
# of its 1,200 s limit on a slower host, so a step takes TRAIN_ACCUM = 2 (a
# global batch of 16: accumulation still runs in float32 buffers).
TRAIN_ARCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_ACCUM = "qwen3", 4096, 8, 2
TRAIN_GLOBAL_BATCH = 256  # train_4k's
TRAIN_DATA_VOCAB, TRAIN_STEPS, TRAIN_LR = 4096, 3, 3e-4
# check 2: finite differences of the float32 loss on one sequence along
# TRAIN_FD_DIRS random directions in the span of the leaves' own scalings
# (each leaf scaled by 1 + e c_l, c_l standard normal), at e = TRAIN_FD_EPS
# and half of it (their difference is the floor)
TRAIN_FD_DIRS, TRAIN_FD_EPS, TRAIN_FD_FACTOR = 4, 1e-2, 4.0
# check 3: TRAIN_ACC_ROWS sequences in float32, accum = TRAIN_ACC_ROWS
# against 1; the floor is accum 1 over one row repeated against that row
TRAIN_ACC_ROWS, TRAIN_ACC_FACTOR = 2, 8.0
# check 1: the training loss and logits against the served forward's
# (kernel 8) on one microbatch (the logits on its first row), within
# TRAIN_SERVE_FACTOR x the floors that float32 attention in the served path
# reads; and against the served path with the same plain bf16 attention
# (the loss to TRAIN_SAME_TOL relative: float32 sums in another order)
TRAIN_SERVE_FACTOR, TRAIN_SAME_TOL = 4.0, 1e-5
TRAIN_OPT_RANGE = "lm_train.adamw_update"
# lm_train runs in a process of its own under torch.use_deterministic_
# algorithms, which needs cuBLAS's fixed workspace (TRAIN_CUBLAS, read when
# a process makes its first cuBLAS handle); in this process it would hold
# for every phase (a decode step of lm_moe's model took 25.6-27.0 ms with
# it against 24.9 without on an H100 80GB HBM3 at 700 W,
# `tools/moe_decode_timing.py` in turns)
TRAIN_CUBLAS, TRAIN_TIMEOUT_S = ":4096:8", 600
TRAIN_GROUPS = ("projection_and_mlp_gemms", "attention_products", "attention_elementwise",
                "cross_entropy", "optimizer", "other")
# lm_zamba: zamba2-7b at full width and full depth (81 Mamba2 layers of
# d_model 3,584, d_inner 7,168, 112 SSD heads of 64, state 64, conv 4,
# chunk 256; one shared attention + MLP block, 32 heads of 112, d_ff
# 14,336, applied before layers 0, 6, ..., 78: 14 applications, each with
# its own KV cache; vocab 32,000) in bf16: 6.75e9 parameters, 13.50 GB.
# lm_serve's prompts (4 x 8,000 tokens: 8,000 is not a multiple of the
# chunk, so the SSD's pad runs) and ZAMBA_NEW greedy new tokens.  Its
# prefill runs kernel 8 at ZAMBA_SWA (B, S, H = KVH, D), W = S, G = 1, once
# an application.  Check 3 holds layer 0's chunked SSD over the first
# ZAMBA_SSD_STEPS tokens (4 chunks, the last padded) against as many steps
# of its s == 1 recurrence, on a float32 copy of the layer's weights and
# input (the two forms sum in other orders: ~1e-6 of max|y|), normwise
# within ZAMBA_SSD_TOL; the reference's unmasked decay planted in its place
# must give NaN and fail it.
ZAMBA_ARCH, ZAMBA_NEW, ZAMBA_SSD_STEPS, ZAMBA_SSD_TOL = "zamba2", 16, 1000, 1e-4
# Checks 1 and 4 at the logits: 81 random bf16 layers amplify a rounding
# difference in one layer's attention far above SERVE_TOL (on the H100 the
# kernel and plain paths' logits read 0.148 apart, where their attention
# agrees to 1.6e-2 a row at the layer).  So each application's attention is held
# in situ, on the kernel path's own q, k, v, at the layer limits
# (SWA_ROW_TOL, SWA_ROW_MEAN_TOL), and the logits against the floor of the
# model's amplification: the distance between the plain path and the same
# path with its attention computed in float32 (Q K^T, P and P V left
# unrounded), measured in the same run; the logits must be within
# ZAMBA_FLOOR_FACTOR times that floor, and never need less than SERVE_TOL.
ZAMBA_FLOOR_FACTOR = 2.0
ZAMBA_SWA = (4, 8000, 32, 112)
# the plain path's query chunk: at W = S one chunk of 256 queries holds (4,
# 32, 1, 256, 8,000) float32 logits, 1.05 GB, a few times over
ZAMBA_PLAIN_CHUNK = 256
# each Mamba2 mixer, its SSD, the shared block's attention and its MLP in
# profiler ranges, split by the products called directly in each
ZAMBA_MIXER_RANGE, ZAMBA_SSD_RANGE = "lm_zamba.mamba2_apply", "lm_zamba.ssd_apply"
ZAMBA_ATTN_RANGE, ZAMBA_MLP_RANGE = "lm_zamba.attention_apply", "lm_zamba.mlp_apply"
_MM = ("aten::matmul", "aten::mm")
ZAMBA_OPS = {ZAMBA_MIXER_RANGE: {"mamba_projections": _MM},
             ZAMBA_SSD_RANGE: {"ssd_products": ("aten::einsum", "aten::matmul", "aten::bmm")},
             ZAMBA_ATTN_RANGE: {"attention_projections": _MM},
             ZAMBA_MLP_RANGE: {"shared_mlp_products": _MM}}
RANGE_TARGETS.update({ZAMBA_MIXER_RANGE: ("repro_torch.models.zamba", "mamba2_apply"),
                      ZAMBA_SSD_RANGE: ("repro_torch.models.ssm", "_ssd"),
                      ZAMBA_ATTN_RANGE: "attention_apply",
                      ZAMBA_MLP_RANGE: ("repro_torch.models.layers", "MLP.forward")})
# lm_xlstm: xlstm-125m at full width and full depth (12 layers in 6 pairs of
# mLSTM -> sLSTM, d_model 768, 4 heads: the mLSTM's d_in 1,536 in heads of
# 384, the sLSTM's heads of 192; vocab 50,304) in bf16: 1.729e8 parameters,
# 0.35 GB.  XLSTM_BATCH prompts of XLSTM_PROMPT tokens (2,000 = 31 x 64 +
# 16: the mLSTM's pad of 48 runs; the xLSTM paper's 125M models were
# trained at a context of 2,048, which 2,000 + XLSTM_NEW fit) and
# XLSTM_NEW greedy new tokens.  4 x 8,000, the other LM phases' prompts,
# would be 48,000 serial sLSTM steps a prefill, about a million eager
# launches.  No kernel runs on this path: both mixers are plain PyTorch (the
# reference's are jnp and lax.scan).  Checks, all in float32 on a copy of
# the bf16 weights: (1) the card against the CPU over a 1 x XLSTM_CHECK_PROMPT
# prompt and XLSTM_CHECK_STEPS decode steps, logits within XLSTM_LOGITS_TOL
# of each row's max|logit| (IEEE float32 on both: the port turns TF32 off);
# (2) layer 0's mLSTM chunked against its s == 1 recurrence over the
# prompts, the output and the final C e^m and n e^m within XLSTM_MLSTM_TOL
# normwise (tests/test_mixers.py:60), the causal mask on the log weights
# dropped (a planted fault) must fail it; (3) layer 1's sLSTM, 1,000 tokens
# then 1,000 more from their state, against all 2,000 at once within
# XLSTM_SLSTM_TOL (tests/test_mixers.py:98), the second segment restarted
# from the fresh state (a planted fault) must fail it; (4) the greedy tokens
# of 1 x XLSTM_CHECK_PROMPT + XLSTM_GREEDY_NEW against greedy by full
# forward where the top-2 margin decides at XLSTM_LOGITS_TOL, and the first
# decode step against the full forward at that limit.
XLSTM_ARCH, XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = "xlstm", 4, 2000, 32
XLSTM_CHECK_PROMPT, XLSTM_CHECK_STEPS, XLSTM_GREEDY_NEW = 256, 4, 8
XLSTM_LOGITS_TOL, XLSTM_MLSTM_TOL, XLSTM_SLSTM_TOL = 1e-4, 2e-4, 1e-5
XLSTM_SPLIT = 1000  # check 3's first segment
# the profiled prefill's prompt, **cut** from 2,000: a prefill launches
# about 20 device kernels a step of each sLSTM layer, and on an NVIDIA H100
# 80GB HBM3 at 700 W the profile of the whole 4 x 2,000 prefill (about
# 250,000 kernels) took about 100 s to record and split
XLSTM_PROFILE_PROMPT = 500
# each mixer, its scan, the sLSTM's FFN and the head in profiler ranges,
# split by the products called directly in each
XLSTM_MLSTM_RANGE, XLSTM_SLSTM_RANGE = "lm_xlstm.mlstm_apply", "lm_xlstm.slstm_apply"
XLSTM_SCAN_RANGE, XLSTM_STEP_RANGE = "lm_xlstm.mlstm_scan_apply", "lm_xlstm.mlstm_step_apply"
XLSTM_REC_RANGE, XLSTM_FFN_RANGE = "lm_xlstm.slstm_scan_apply", "lm_xlstm.slstm_ffn_apply"
XLSTM_HEAD_RANGE = "lm_xlstm.head_apply"
XLSTM_OPS = {XLSTM_MLSTM_RANGE: {"mlstm_projections": _MM},
             XLSTM_SCAN_RANGE: {"scan_products": ("aten::matmul",)},
             XLSTM_STEP_RANGE: {"step_products": ("aten::matmul",)},
             XLSTM_SLSTM_RANGE: {"slstm_gate_projection": _MM},
             XLSTM_REC_RANGE: {"recurrent_products": ("aten::baddbmm",)},
             XLSTM_FFN_RANGE: {"ffn_products": _MM},
             XLSTM_HEAD_RANGE: {"head_products": _MM}}
RANGE_TARGETS.update({XLSTM_MLSTM_RANGE: ("repro_torch.models.xlstm_lm", "mlstm_apply"),
                      XLSTM_SLSTM_RANGE: ("repro_torch.models.xlstm_lm", "slstm_apply"),
                      XLSTM_SCAN_RANGE: ("repro_torch.models.xlstm", "_mlstm_chunk_scan"),
                      XLSTM_STEP_RANGE: ("repro_torch.models.xlstm", "_mlstm_step"),
                      XLSTM_REC_RANGE: ("repro_torch.models.xlstm", "_slstm_scan"),
                      XLSTM_FFN_RANGE: ("repro_torch.models.xlstm", "_slstm_ffn"),
                      XLSTM_HEAD_RANGE: ("repro_torch.models.xlstm_lm", "_logits")})
# lm_whisper: whisper-base at full width and full depth (6 encoder and 6
# decoder layers, d_model 512, 8 heads of 64, d_ff 2,048, vocab 51,865; the
# reference's backbone: rope, RMSNorm, SwiGLU, a separate lm_head; the audio
# frontend a stub, `models.vlm_stub.fake_frame_embeds`) in bf16: 32 clips of
# WHISPER_FRAMES encoder frames (Whisper's 30-second window after its two
# stride-2 convolutions), each with a WHISPER_PROMPT-token decoder prompt
# (the previous segment's text and the start-of-transcript tokens, as in
# long-form transcription) and WHISPER_NEW greedy new tokens, capacity
# WHISPER_MAX_LEN.  The prefill runs kernel 8 at WHISPER_SWA (B, S, H, KVH,
# D), W = S, G = 1, once a decoder layer; the encoder's self-attention and
# every cross-attention are bidirectional plain PyTorch
# (`encdec.full_attention`).  Checks: (1) the card against the CPU in
# float32 over WHISPER_CHECK_BATCH clips and WHISPER_CHECK_STEPS decode
# steps, logits within WHISPER_LOGITS_TOL of each row's max|logit|; (2)
# kernel 8 against the plain path, each decoder layer in situ and the
# logits against the floor (lm_zamba's rule), the window cut by SWA_FAULT
# keys must fail; (3) the encoder run causal (a planted fault) must fail
# check 1's limit; (4) the cross K/V padded by WHISPER_CROSS_PAD zero
# positions (a planted fault) must fail check 1's limit; (5) greedy tokens
# against a teacher-forced full forward where the top-2 margin decides;
# (6) kernel 8 once a decoder layer a prefill, never in the encoder,
# cross-attention or decode; the other kernels never.
WHISPER_ARCH, WHISPER_BATCH, WHISPER_FRAMES = "whisper", 32, 1500
WHISPER_PROMPT, WHISPER_NEW, WHISPER_MAX_LEN = 192, 64, 256
WHISPER_CHECK_BATCH, WHISPER_CHECK_STEPS, WHISPER_LOGITS_TOL = 2, 4, 1e-4
WHISPER_CROSS_PAD = 64
WHISPER_SWA = (32, 192, 8, 8, 64)
# each decoder layer's self-attention, its cross-attention, the cross K/V
# projections and each MLP in profiler ranges; `encdec.full_attention` in
# one of two, by its caller: the encoder's self-attention or a
# cross-attention (`whisper_ranged`)
WHISPER_SELF_RANGE, WHISPER_CROSS_RANGE = "lm_whisper.self_attn_apply", "lm_whisper.cross_attn_apply"
WHISPER_XKV_RANGE, WHISPER_MLP_RANGE = "lm_whisper.cross_kv_apply", "lm_whisper.mlp_apply"
WHISPER_ENC_ATTN_RANGE = "lm_whisper.encoder_attention_apply"
WHISPER_XATTN_RANGE = "lm_whisper.cross_attention_apply"
WHISPER_OPS = {WHISPER_SELF_RANGE: {"self_projections": _MM},
               WHISPER_CROSS_RANGE: {"cross_projections": _MM},
               WHISPER_XKV_RANGE: {"cross_kv_projections": _MM},
               WHISPER_MLP_RANGE: {"mlp_products": _MM},
               WHISPER_ENC_ATTN_RANGE: {"encoder_attention_products": ("aten::einsum",)},
               WHISPER_XATTN_RANGE: {"cross_attention_products": ("aten::einsum",)}}
RANGE_TARGETS.update({WHISPER_SELF_RANGE: ("repro_torch.models.encdec", "_self_attn"),
                      WHISPER_XKV_RANGE: ("repro_torch.models.encdec", "_cross_kv"),
                      WHISPER_MLP_RANGE: ("repro_torch.models.layers", "MLP.forward")})
# lm_llava: llava-next-34b at full width (60 layers, d_model 7,168, 56 query
# and 8 KV heads of 128 (G = 7), d_ff 20,480, vocab 64,000, rope theta 5e6;
# the vision tower a stub, `models.vlm_stub.fake_patch_embeds`, through
# patch_proj (7,168 x 7,168)) in bf16: 34.44e9 parameters, 68.9 GB, depth
# LLAVA_LAYERS.  LLAVA_BATCH requests, each one image at the anyres budget
# of 2,880 patch embeddings and LLAVA_PROMPT text tokens, LLAVA_NEW greedy
# new tokens.  Its prefill runs kernel 8 at LLAVA_SWA (B, S = 2,880 + 512,
# H, KVH, D), W = S, G = 7, once a layer.  Checks: (1) kernel 8 against the
# plain path as lm_whisper's check 2 (the plain version in query chunks of
# LLAVA_PLAIN_CHUNK: (4, 8, 7, 256, 3,392) float32 logits, 0.78 GB, a few
# times over beside 68.9 GB of weights); (2) decode from pos0 = S_text (the
# patches forgotten) must fail against decode from S_text + n_patches; (3)
# greedy tokens against a teacher-forced full forward; (4) kernel 8 once a
# layer a prefill, never in decode.
LLAVA_ARCH, LLAVA_BATCH, LLAVA_PROMPT, LLAVA_NEW = "llava", 4, 512, 32
LLAVA_LAYERS = 60
LLAVA_SWA = (4, 3392, 56, 8, 128)
LLAVA_PLAIN_CHUNK = 256
LLAVA_ATTN_RANGE, LLAVA_MLP_RANGE = "lm_llava.attention_apply", "lm_llava.mlp_apply"
LLAVA_OPS = {LLAVA_ATTN_RANGE: {"attention_projections": _MM},
             LLAVA_MLP_RANGE: {"mlp_products": _MM}}
RANGE_TARGETS.update({LLAVA_ATTN_RANGE: "attention_apply",
                      LLAVA_MLP_RANGE: ("repro_torch.models.layers", "MLP.forward")})
# Kernel 8 per entry against its row's max|v| (an output row is a convex
# combination of its window's rows of v): f32 1e-5 (both sides accumulate in
# f32 in another order); bf16 1e-2 (P is rounded to bf16 before P V on both
# sides, at other points: the kernel before normalising, the plain version
# after).  That scale bounds the output but, over a full window of random
# v, is about 100 times a typical output entry; so each output row (one
# position and head, D entries) is also held by its norm, ||kernel - plain||
# / ||plain||: at most SWA_ROW_TOL in every row, and at most SWA_ROW_MEAN_TOL
# on average over the rows whose window is full.  On the H100, bf16 (each
# side rounds P and the output to bf16) read 1.47e-2 at most over the 1.02M
# rows of the layer shape and 4.1-4.8e-3 on average; f32 (accumulation
# order) 1.2e-6 and 8.4e-7: the limits are about twice the bf16 readings.
# The kernel run at W - 64 against the plain version at W must fail them.
# The served model's logits against the plain path's: 3e-2 of the row's
# max|logit| (24 bf16 layers, each rounding its activations).
SWA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SWA_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
SWA_ROW_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SWA_FAULT = 64  # keys dropped from the window in the fault readings
SERVE_TOL = 3e-2
SWA_EDGE = {  # name: (S, W, G, D[, B, KVH]); B = 1 and 2 KV heads unless given
    "s1000_w70_g4_d80": (1000, 70, 4, 80),
    "s1000_w1_g4_d80": (1000, 1, 4, 80),
    "s1000_w_is_s_g1_d64": (1000, 1000, 1, 64),
    "s1000_w4096_g4_d128": (1000, 4096, 4, 128),
    "s1000_w70_g1_d128": (1000, 70, 1, 128),
    "s1000_w70_g4_d64": (1000, 70, 4, 64),
    # D a multiple of 8 but not of 16; the registry's G = 7 and 16 at D =
    # 128; S below one key tile and S = 1; two batch rows of 8 KV heads
    "s1000_w70_g4_d72": (1000, 70, 4, 72),
    "s1000_w300_g7_d128": (1000, 300, 7, 128),
    "s500_w100_g16_d128": (500, 100, 16, 128),
    "s40_w16_g4_d80": (40, 16, 4, 80),
    "s1_w4_g4_d80": (1, 4, 4, 80),
    "s700_w200_g4_d80_b2_kvh8": (700, 200, 4, 80, 2, 8),
}
SWA_EDGE_DV = {  # name: (S, W, G, D, DV), q/k of D and v of DV; B = 1, 2 KV heads
    # multi-head latent attention's widths, W = S and banded; a pair the
    # (192, 128) instantiation serves with zero columns; pairs square
    # instantiations serve; S not a multiple of 64, below one tile, 1
    "s1000_w_is_s_g1_d192_dv128": (1000, 1000, 1, 192, 128),
    "s300_w70_g2_d192_dv128": (300, 70, 2, 192, 128),
    "s130_w_is_s_g1_d184_dv120": (130, 130, 1, 184, 120),
    "s1000_w300_g4_d24_dv16": (1000, 300, 4, 24, 16),
    "s200_w50_g2_d64_dv128": (200, 50, 2, 64, 128),
    "s40_w16_g1_d192_dv128": (40, 16, 1, 192, 128),
    "s1_w4_g1_d192_dv128": (1, 4, 1, 192, 128),
}
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)

# The multi-tenant session (FrameSession over RollingStatsService): 65,536
# tenants of d = 16 channels, 8 ticks of a (65,536, 256, 16) arrival batch
# (1.07 GB a tick, 2,048 samples a tenant); the plan autocovariance(16),
# yule_walker(8), moments(32), moments(128), welch(64, 32): moments(128)
# sets the carry at 127 rows, so a finalize corrects the lag members' tails
# with kernel 2, moments(32)'s with kernel 3 and Welch's with kernel 4.  The
# eviction session: 16,384 tenants, a ring of 8 buckets over 2,048 samples,
# 12 ticks (the ring wraps).  Parity is held with the reference tests'
# tolerances (tests/test_frame.py: allclose rtol, atol per member).
SESSION_D, SESSION_USERS, SESSION_ROWS, SESSION_TICKS = 16, 65536, 256, 8
SESSION_QUERY, SESSION_SAMPLED = 4096, 16
EVICT_USERS, EVICT_WINDOW, EVICT_BUCKETS, EVICT_TICKS, EVICT_SAMPLED = 16384, 2048, 8, 12, 8
SESSION_LAGS, SESSION_YW, SESSION_WINDOWS, SESSION_WELCH = 16, 8, (32, 128), (64, 32)
SESSION_TOL = {"autocovariance": (1e-4, 1e-4), "yule_walker": (1e-3, 1e-4),
               "moments": (1e-5, 1e-5), "welch": (1e-4, 1e-4)}

# The gateway (StatsGateway over FrameSession): the session phase's width
# (65,536 tenants of d = 16, 8 ticks of 256 rows) and plan, plus
# forecast(16, "ar", p=8), forecast(16, "auto", p=4, max_period=16) and
# anomaly_scores("arma", p=2, q=1): H stays 16 and the carry 127 rows.  Every
# tick each tenant submits a host chunk and GATEWAY_QUERY tenants a query; a
# query runs kernel 2 for each of the 5 lag-family members, kernel 3 for
# moments(32)'s tail and kernel 4 twice (the Welch tail and the auto
# member's read).  Tenant i's sinusoid sits at bin k_i in [4, 12] of the
# 64-point Welch segment, so its planted period is round(64 / k_i); its
# amplitude is 2, twice the session phase's: at 1 the AR(1) channels' power
# near DC outweighed it in 190 of 4,096 tenants on the H100, and the
# detector (the reference's) takes the largest non-DC bin.  The
# chaos check runs at CHAOS_USERS tenants (cut from 65,536: it needs a
# fault-free twin run beside the faulty one).
GATEWAY_NPERSEG, GATEWAY_BINS, GATEWAY_AMPLITUDE = SESSION_WELCH[0], (4, 12), 2.0
GATEWAY_HORIZON, GATEWAY_MAX_PERIOD = 16, 16
GATEWAY_QUERY, GATEWAY_SAMPLED, GATEWAY_SNAPSHOT_EVERY, GATEWAY_PROFILED_TICK = 4096, 64, 4, 5
CHAOS_USERS, CHAOS_TICKS, CHAOS_REBUILD_AT, CHAOS_QUERY = 4096, 6, 4, 256

# The overlapping block store (TimeSeriesStore, SeriesFrame.from_sharded) on
# the fused plan phase's series and plan: blocks of STORE_BLOCK rows (the
# reference's default), the plan's halo h_right = CARRY = 1,023 (width
# 9,215), so 2^22 samples are 512 blocks (1.21 GB; replication overhead
# 0.1248).  A collect launches kernel 1 once for every block, then the
# finalize tails (kernel 2 three times, 3 and 4 once).  The planted fault:
# the first halo row of the middle block (255 of 512) zeroed in a copy of the
# store.
STORE_BLOCK = 8192
# The replan over the grown store adds moments(16) and, at d = 64, a forecast
# of STORE_HORIZON steps (AR(8)) and ARMA(2, 1) anomaly scores over the
# plan's 1,023-row tail, held against the chunk path's collect of the same
# members at TOL["fit"] (normwise; non-finite entries exactly).
STORE_HORIZON = 32


def declare_replan(frame):
    frame.moments(16)
    frame.forecast(STORE_HORIZON, "ar", p=P_YW)
    frame.anomaly_scores("arma", p=2, q=1)
    return frame


STORE_COLLECT_LAUNCHES = {"fused_plan_megakernel": 1, "cross_window_stats": 3,
                          "fused_lag_moments": 1, "segment_dft_power": 1}

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
    # the d diags half of kernel 7's VJP, which the reference computes in jnp
    "band_gradient": ("src/repro_torch/kernels/banded_matvec/csrc/banded_matvec.cu",
                      "src/repro/kernels/banded_matvec/ops.py:69"),
    "swa_attention": ("src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu",
                      "src/repro/kernels/swa_attention/kernel.py:90"),
}


# The backend policy layer (phases 11-13).  The calibration runs at the
# reference's default grid (512-32,768 rows, d = 8) and writes its table
# under build/, never to the user's cache.  The "auto" phase drives the main
# path's plan over AUTO_CHUNKS chunks (cut from 64 for time) and one session
# tick of the session phase's 65,536 tenants with the measured table
# installed; every call is also run on the "cuda" backend on the same
# inputs: bitwise, with the same launches, where "auto" took "cuda", within
# PRIMITIVE_TOL where it took "torch".  The breaker phase is the scenario of
# tests/test_chaos.py:602 at CHAOS_USERS tenants (cut from 65,536: it needs a
# fault-free twin run) of the gateway phase's width and plan.
CALIB_PATH = os.path.join(ROOT, "build", "repro_torch", "calibration_cuda.json")
AUTO_CHUNKS = 8
KPC_PAIRS = 3  # back-to-back (auto, cuda) profiles of the auto phase's plan, at most
PRIMITIVE_KERNEL = {"lagged_sums": "cross_window_stats",
                    "masked_lagged_sums": "cross_window_stats",
                    "windowed_moments": "window_moments", "segment_fft_power": "segment_dft_power",
                    "segment_csd": "segment_csd", "banded_matvec": "banded_matvec",
                    "fused_lagged_moments": "fused_lag_moments",
                    "fused_plan_update": "fused_plan_megakernel"}
# per output part: fused_plan_update's (lag, mom, psds, n_segs), the others' one
PRIMITIVE_TOL = {"fused_plan_update": (TOL["lag"], TOL["moments"], TOL["psd"], 0.0),
                 "fused_lagged_moments": (TOL["lag"], TOL["moments"]),
                 "segment_fft_power": (TOL["psd"],), "segment_csd": (TOL_NEW["csd"],),
                 "windowed_moments": (TOL_NEW["window"],), "banded_matvec": (TOL_NEW["band"],),
                 "lagged_sums": (TOL["lag"],), "masked_lagged_sums": (TOL["lag"],)}
BREAKER_STALL_TICK = 2  # tests/test_chaos.py:602: gateway.tick stalls at tick 2


# The fused plan of the main path and the store, and each member's tolerance.
MEMBER_TOL = {"autocovariance": TOL["lag"], "yule_walker": TOL["fit"], "arma": TOL["fit"],
              "moments": TOL["moments"], "moments_2": TOL["moments"], "welch": TOL["psd"]}


def declare_plan(frame):
    """The main path's six requests on ``frame``."""
    frame.autocovariance(H)
    frame.yule_walker(P_YW)
    frame.arma(2, 1)
    frame.moments(WINDOWS[0])
    frame.moments(WINDOWS[1])
    frame.welch(nperseg=NPERSEG, overlap=OVERLAP)
    return frame


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


def compare(got, want, tol: float, scales: dict = None, same_nonfinite: bool = False) -> dict:
    """Every leaf of ``got`` against the same leaf of ``want``, each against
    its own scale.  ``scales`` maps a leaf path to a componentwise scale.  A
    moments result {"mean", "var", "count"} holds its count exactly and its
    mean per channel against sqrt(var).  ``same_nonfinite`` (forecasts and
    anomaly scores, whose innovations filter overflows under a
    non-invertible fitted MA part on both paths) holds every non-finite
    entry of ``want`` exactly (the same inf, or NaN) and the finite entries
    against their own max.  Reports the worst leaf."""
    g, w = leaves(got), leaves(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        fail("structure mismatch", got=[p for p, _ in g], want=[p for p, _ in w])
    scales = dict(scales or {})
    for path, b in w:
        if path.endswith("/mean"):
            var = dict(w)[path[: -len("mean")] + "var"]
            scales.setdefault(path, var.double().sqrt().clamp_min(1e-30))
    res = {"max_abs_err": 0.0, "max_rel_err": 0.0, "worst": None, "tol": tol, "bad": []}
    res["nonfinite"] = 0
    for (path, a), (_, b) in zip(g, w):
        if same_nonfinite and b.is_floating_point():
            a, b, same = split_nonfinite(a, b)
            res["nonfinite"] += same[1]
            err, rel, finite = leaf_error(a, b, scales.get(path))
            finite = finite and same[0]
        else:
            err, rel, finite = leaf_error(a, b, scales.get(path))
        exact = path.endswith("/count") or not b.is_floating_point()
        if (not finite) or (err != 0 if exact else rel > tol):
            res["bad"].append(path)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if res["worst"] is None or rel > res["max_rel_err"]:
            res["max_rel_err"], res["worst"] = rel, path
    res["ok"] = not res["bad"]
    return res


def ma_radius(frame, name: str) -> float:
    """Spectral radius of the MA part that member ``name`` of a collected
    ``frame`` fits (0 without one).  Below 1 the innovations filter that
    seeds an arma forecast and scores an anomaly member is stable; above 1
    it diverges geometrically on every path (the reference's too), the
    rounding difference of two paths growing with it, so no tolerance holds
    its residuals."""
    from repro_torch.core import forecast as tf

    req = next(r for r in frame._recorded if r.name == name)
    model, p, q, m, max_period = req.params[-5:]
    spec = tf.resolve_model_spec(model, p, q, m, max_period)
    _, theta, _, _ = tf._fitted_model(frame._plan.groups[0], frame._states[0], spec)
    q, d = theta.shape[-3], theta.shape[-1]
    if q == 0:
        return 0.0
    comp = torch.zeros((q * d, q * d), dtype=torch.float64, device=theta.device)
    comp[:d] = torch.cat(list(theta.double()), -1)
    comp[d:, : (q - 1) * d] = torch.eye((q - 1) * d, dtype=torch.float64, device=theta.device)
    return torch.linalg.eigvals(comp).abs().max().item()


def split_nonfinite(a, b) -> tuple:
    """(a, b) with the entries where ``b`` is not finite set to 0 on both
    sides, and (whether ``a`` holds exactly ``b``'s non-finite entries --
    the same infs, NaN where ``b`` has NaN -- , how many there are)."""
    fin = torch.isfinite(b)
    off = ~fin
    same = (torch.equal(torch.isfinite(a), fin) and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[torch.isinf(b)], b[torch.isinf(b)]))
    return (torch.where(fin, a, torch.zeros_like(a)), torch.where(fin, b, torch.zeros_like(b)),
            (same, int(off.sum().item())))


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


def kernels_per_call(fn, calls: int) -> dict:
    """{device kernel name: launches per call of ``fn``} from torch.profiler
    (empty when the profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            out[ev.key[:60]] = ev.count / calls
    return out


def ops_per_call(fn) -> dict:
    """{aten operator: calls} that one call of ``fn`` dispatches, counted
    on the host by a dispatch mode after a warm-up call: the PyTorch work
    beside the port's own launches, exact where the profiler's record of
    device kernels is not (a profile's kernel counts can move by one or two
    between runs of the same code)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls[str(func)] += 1
            return func(*args, **(kwargs or {}))

    fn()
    torch.cuda.synchronize()
    with Count() as mode:
        fn()
        torch.cuda.synchronize()
    return dict(sorted(mode.calls.items()))


def lag_moments_work(rows: int, n: int, valid: int, d: int, windows: int) -> tuple:
    """(bytes, operations of the function, operations of the design) of
    kernel 3 at H = 0 over ``rows`` rows of d channels, ``n`` starts of
    which ``valid`` count, and ``windows`` windows: the series and the start
    mask read once, S(0) and the moment sums written once; S(0) is
    symmetric, so the function needs its d (d + 1) / 2 distinct entries, a
    multiply-add each per valid start (the design's cost counts all d^2),
    plus per row and channel a square and a multiply-add per window and
    moment."""
    nbytes = rows * d * 4 + n + (d * d + windows * 2 * d) * 4
    per_row = rows * d * (1 + 4 * windows)
    return nbytes, valid * d * (d + 1) + per_row, valid * d * d * 2 + per_row


def lag_moments_library(a, y, weights):
    """Kernel 3 at H = 0 as two fp32 cuBLAS products (TF32 is off): S(0) =
    a^T y[:n] with a the masked head rows, and the moment sums C [y, y^2]
    with C (K, rows) the exact window counts c_w(t) as floats.  A leading
    tenant axis on every operand makes both batched products."""
    s0 = torch.matmul(a.transpose(-1, -2), y[..., : a.shape[-2], :])
    mom = torch.matmul(weights, torch.cat([y, y * y], -1))
    return s0.unsqueeze(-3), mom.view(weights.shape[:-1] + (2, y.shape[-1]))


def lag_moments_library_operands(y, mask, windows):
    """(a, y, C) of :func:`lag_moments_library`: the masked head rows and
    the window counts c_w(t) = #valid starts in [t - w + 1, t], over the rows
    [0, n + max(windows) - 1) of ``y`` (a leading tenant axis on ``y`` and
    ``mask`` carries through)."""
    n = mask.shape[-1]
    rows = n + max(windows) - 1
    prefix = torch.nn.functional.pad(torch.cumsum(mask, -1), (1, 0))
    t = torch.arange(rows, device=y.device)
    hi = prefix[..., torch.clamp(t + 1, max=n)]
    weights = torch.stack([(hi - prefix[..., torch.clamp(t + 1 - w, 0, n)]).float()
                           for w in windows], -2)
    a = torch.where(mask[..., None], y[..., :n, :], 0.0).contiguous()
    return a, y[..., :rows, :].contiguous(), weights.contiguous()


def lag_library(a, b):
    """Kernel 2's S(h)^T for h = 0..H as one fp32 GEMM over an unfolded
    view (TF32 is off); batched over a leading tenant axis."""
    if a.ndim == 3:
        return torch.matmul(b.unfold(1, a.shape[1], 1), a[:, None])
    return torch.matmul(b.unfold(0, a.shape[0], 1), a)


def rfft_power(s, w):
    """Kernel 4's per-segment power of (S, L, d) segments: one rfft."""
    return torch.fft.rfft((s - s.mean(1, keepdim=True)) * w[:, None], dim=1).abs() ** 2


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
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


def power_bin_error(got, want, per_segment: bool) -> dict:
    """Each entry of a power against the plain power at its (frequency,
    channel): averaged over segments for a per-segment power (S, F, d),
    itself for a power summed over segments (F, d).  A power is a sum of
    non-negative terms, so no cancellation sits below this scale."""
    g, w = (got, want) if per_segment else (got[None], want[None])
    err, rel, finite = scaled_error(g, w, w.double().mean(0, keepdim=True))
    tol = TOL_NEW["psd"]
    return {"max_abs_err": err, "max_rel_err": rel, "tol": tol, "finite": finite,
            "ok": finite and rel <= tol}


def planted_bin_error(got, want, per_segment: bool) -> dict:
    """Moves one entry of ``got`` -- the middle segment, at the bin of the
    upper half of the frequencies and the channel where the plain power is
    least -- by 2 TOL_NEW["psd"] of its per-bin scale.  Reports where,
    whether :func:`power_bin_error` catches it, and what the normwise check
    (against max|plain|) reads for the planted tensor."""
    g, w = (got, want) if per_segment else (got[None], want[None])
    scale = w.double().mean(0)
    half = scale.shape[0] // 2
    upper = scale[half:]
    k = int(torch.argmin(upper.masked_fill(upper <= 0, math.inf)))
    f, c = half + k // upper.shape[1], k % upper.shape[1]
    s = g.shape[0] // 2
    planted = g.clone()
    planted[s, f, c] += 2 * TOL_NEW["psd"] * scale[f, c].item()
    res = power_bin_error(planted if per_segment else planted[0], want, per_segment)
    return {"segment": s, "bin": f, "channel": c, "bin_share_of_max": scale[f, c].item()
            / max(scale.max().item(), 1e-300), "per_bin_rel": res["max_rel_err"],
            "caught": not res["ok"], "normwise_rel": leaf_error(planted, w)[1]}


def empty_launch(prep) -> None:
    """An empty kernel on the grid, block and shared memory of a prepared
    banded product (the launch alone, for comparison with short launches)."""
    from repro_torch.kernels import _build

    stream = torch.cuda.current_stream(prep.device).cuda_stream
    _build.check(_build.library().rt_band_empty(ctypes.byref(prep.params), stream),
                 "band_empty")


# Kernel 3's planted fault: the sum of a cluster's slabs leaves out the
# pair's middle slab.  The shipped source has no switch for it; a copy of
# window_stats.cu with this line patched is built beside the library.
LAGMOM_FAULT = ("if (q < C) v += x[h][q];",
                "if (q < C && g * C + q != ((p.rows + p.slab - 1) / p.slab - 1) / 2) "
                "v += x[h][q];")


def lagmom_fault_source() -> str:
    """window_stats.cu's text with LAGMOM_FAULT patched in."""
    from repro_torch.kernels import _build

    text = (_build.KERNELS_DIR / "window_stats" / "csrc" / "window_stats.cu").read_text()
    if text.count(LAGMOM_FAULT[0]) != 1:
        raise RuntimeError(f"planted fault: {LAGMOM_FAULT[0]!r} not found once in window_stats.cu")
    return text.replace(*LAGMOM_FAULT)


def start_lagmom_fault_build():
    """Starts nvcc on the faulty copy (lagmom_fault_source) under build/;
    returns a function that waits for it and returns the copy's
    rt_lag_moments_sym, which takes the shipped wrapper's prepared params."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "planted"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"window_stats_dropped_slab.{os.getpid()}.cu"
    cu.write_text(lagmom_fault_source())
    so = cu.with_suffix(".so")
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                             str(_build.KERNELS_DIR / "csrc"), "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    @functools.lru_cache(maxsize=None)
    def finish():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the planted fault's copy:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.rt_lagmom_params_size.restype = ctypes.c_int
        if lib.rt_lagmom_params_size() != ctypes.sizeof(_build.LagMomParams):
            raise RuntimeError("planted fault's copy: LagMomParams differs from _build.py's")
        entry = lib.rt_lag_moments_sym
        entry.argtypes, entry.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        return entry
    return finish


def lag_moments_empty(prep) -> None:
    """An empty kernel on the grid, cluster and shared memory of a prepared
    launch of kernel 3's symmetric path (the launch alone)."""
    from repro_torch.kernels import _build

    stream = torch.cuda.current_stream(prep.device).cuda_stream
    _build.check(_build.library().rt_lag_moments_empty(ctypes.byref(prep.params), stream),
                 "lag_moments_empty")


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


def grad_scale(g, x, b: int):
    """sum_n |g||x| per entry of d diags (0 in the off-matrix slots)."""
    from repro_torch.kernels.banded_matvec.ref import band_gradient

    return band_gradient(g.abs(), x.abs(), b)


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
    of kernel 5, 6, 7 or 7b on the inputs of ``shape``: each input read once,
    each output written once; a segment's spectrum counts a real FFT
    (2.5 L log2 L) plus detrend and taper, where the kernel contracts
    against twiddles (4 L F); a complex outer product 6 operations per
    entry; a rolling window sum 2 operations per start and moment (add the
    entering row, subtract the leaving one) plus one square per row; the
    banded product and its gradient one multiply-add per valid diagonal slot
    and row (y from the diagonals and x, or d diags from g and x)."""
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
    if name in ("banded_matvec", "band_gradient"):  # y from x, or d diags from g and x
        m, d, b, valid = shape["m"], shape["d"], shape["b"], shape["valid_slots"]
        return d * (2 * b + 1) * f4 + 2 * m * d * f4, 2 * valid * m, 2 * valid * m
    raise KeyError(name)


def swa_work(b: int, s: int, h: int, kvh: int, d: int, window: int, itemsize: int,
             dv: int = None) -> tuple:
    """(bytes, operations) of sliding-window attention with q/k of D and v of
    DV (default D): q, k, v read once, out written once; 2 (D + DV)
    operations (a multiply-add a column of Q K^T and of P V) per unmasked
    (query, key) pair of every head."""
    from repro_torch.kernels.swa_attention.ref import valid_pairs

    dv = d if dv is None else dv
    nbytes = (b * s * h * (d + dv) + b * s * kvh * (d + dv)) * itemsize
    return nbytes, 2 * (d + dv) * valid_pairs(s, window) * b * h


def row_norm_errors(got, want):
    """||got - want|| / ||want|| over the last axis, in float64, per row of
    a (B, ...) tensor (a row that matches exactly counts 0)."""
    out = []
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).norm(dim=-1)
        ref = w.double().norm(dim=-1)
        out.append(torch.where(diff == 0, torch.zeros_like(diff), diff / ref))
    return torch.stack(out)


def planted_row_error_caught(got, want, tol: float) -> bool:
    """Whether :func:`row_norm_errors` rejects ``got`` with one middle entry
    moved by 2 tol of its row's norm (checked on that entry's leading slice)."""
    idx = tuple(n // 2 for n in got.shape)
    row = slice(idx[0], idx[0] + 1)
    planted = got[row].clone()
    planted[(0,) + idx[1:]] += 2 * tol * want[idx[:-1]].double().norm().item()
    return row_norm_errors(planted, want[row]).max().item() > tol


def row_rel_errors(got, want):
    """max |got - want| / max |want| over the last axis (one logits row)."""
    got, want = got.float(), want.float()
    return (got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)


def greedy_disagreements(plain, tokens, tol: float) -> tuple:
    """(decided, disagreeing) steps: a step is decided where the plain
    logits' top-2 margin exceeds ``tol`` of the row's max|logit|; there
    the served token must be the plain argmax.  plain (B, T, V), tokens
    (B, T)."""
    top2 = plain.float().topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol * plain.float().abs().amax(-1)
    wrong = decided & (plain.argmax(-1) != tokens.to(plain.device).long())
    return int(decided.sum()), int(wrong.sum())


def serve_launches_ok(launches: dict, layers: int) -> bool:
    """Kernel 8 pinned on the serving path: one launch per layer in each
    prefill (the generate's, the split prefill's, the extended one's),
    none in decode."""
    return (launches["generate"] == layers and launches["prefill"] == layers
            and launches["extended_prefill"] == layers and launches["decode"] == 0)


def moe_plain(layer, xt, k: int, capacity: int) -> tuple:
    """A MoE layer's output by a loop over its experts, in float32, written
    apart from `models/moe.py`: the float32 router's top-k, then for each
    expert the tokens routed to it in token order, the first ``capacity`` of
    them kept, SwiGLU by ``torch.mm`` on the float32 weights, weighted by the
    renormalised gate; plus the shared expert.  xt (T, d) -> (out (T, d)
    float32, expert_idx (T, k), pairs dropped)."""
    xf = xt.float()
    probs = torch.softmax(xf @ layer.router.float(), dim=-1)
    gates, expert_idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(xf)
    dropped = 0
    for e in range(layer.e_gate.shape[0]):
        tok, choice = torch.nonzero(expert_idx == e, as_tuple=True)  # in token order
        dropped += max(0, tok.numel() - capacity)
        tok, choice = tok[:capacity], choice[:capacity]
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        act = torch.nn.functional.silu(torch.mm(xe, layer.e_gate[e].float()))
        y = torch.mm(act * torch.mm(xe, layer.e_up[e].float()), layer.e_down[e].float())
        out.index_add_(0, tok, y * gates[tok, choice, None])
    if layer.shared is not None:
        s = layer.shared
        act = torch.nn.functional.silu(torch.mm(xf, s.w_gate.float()))
        out += torch.mm(act * torch.mm(xf, s.w_up.float()), s.w_down.float())
    return out, expert_idx, dropped


def host_drops(expert_idx: np.ndarray, capacity: int, experts: int) -> int:
    """Pairs the stable-rank rule drops, counted on the host: an expert keeps
    its first ``capacity`` pairs."""
    counts = np.bincount(expert_idx.reshape(-1), minlength=experts)
    return int(np.maximum(counts - capacity, 0).sum())


def planted_capacity(cfg, t: int, capacity: int):
    """``cfg`` with the capacity factor that gives each expert ``capacity``
    slots for ``t`` tokens under the static rule (a planted fault)."""
    from repro_torch.models.moe import moe_capacity

    m = cfg.moe
    factor = (capacity + 0.5) * m.num_experts / (t * m.top_k)
    out = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=factor))
    if moe_capacity(t, out) != capacity:
        raise ValueError(f"no capacity factor gives {capacity} slots for {t} tokens")
    return out


def moe_routes(model, cfg, store: list) -> list:
    """Forward hooks on every layer's mlp_norm that append that layer's
    routing of the tokens it sees, (expert_idx, kept), to ``store``; returns
    the handles (remove them after the call)."""
    from repro_torch.models.moe import moe_capacity, moe_route

    def hook(layer):
        def record(_mod, _inp, h):
            xt = h.reshape(-1, h.shape[-1])
            idx, pos = moe_route(layer.mlp, xt, cfg)[3:]
            store.append((idx, pos < moe_capacity(xt.shape[0], cfg)))
        return record

    return [layer.mlp_norm.register_forward_hook(hook(layer)) for layer in model.layers]


@contextlib.contextmanager
def forced_routes(recorded: list):
    """Within the block, the i-th MoE layer call routes its tokens to the
    experts of ``recorded``'s i-th entry (a :func:`moe_routes` store of
    another run of the same calls), with gates from this call's own router
    probabilities at those experts, renormalised, and bucket places by the
    same stable rank: two paths compared through the same routes, so that
    a near-tie expert moved by rounding does not move one path's output by
    a whole expert's.  Raises if the calls outnumber the store."""
    from unittest import mock

    from repro_torch.models import moe

    entries = iter(recorded)
    route = moe.moe_route

    def forced(p, xt, cfg):
        logits, probs = route(p, xt, cfg)[:2]
        idx = next(entries)[0]
        gates = probs.gather(1, idx)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return logits, probs, gates, idx, moe.bucket_positions(idx, cfg.moe.num_experts)

    with mock.patch.object(moe, "moe_route", forced):
        yield


def route_differences(a: list, b: list) -> dict:
    """(token, layer) routes that differ between two paths' routings, and
    tokens kept in one path and dropped in the other."""
    return {"routes_differ": sum(int((x[0] != y[0]).any(-1).sum()) for x, y in zip(a, b)),
            "kept_vs_dropped": sum(int((x[1] != y[1]).any(-1).sum()) for x, y in zip(a, b))}


def range_other(name: str) -> str:
    """The key of a range's device time outside its operator groups:
    "moe_other" for MOE_RANGE, "mla_other" for MLA_RANGE."""
    return name.rsplit(".", 1)[-1].replace("apply", "other")


def range_target(name: str) -> tuple:
    """(owner, attribute) of the function RANGE_TARGETS names for a range."""
    import importlib

    target = RANGE_TARGETS[name]
    module, path = (("repro_torch.models.transformer", target) if isinstance(target, str)
                    else target)
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def split_events(events, kernels=(KERNEL8_NAME,), ranges=None) -> dict:
    """Device ms of a profile split by stage: each range's of ``ranges``
    (name -> operator groups; default MOE_RANGE's MOE_OPS) and, within it,
    its groups' (the operators called directly in the range) and the rest
    of the range (:func:`range_other`); each kernel-name fragment's; the
    total over device kernels (annotations left out) and the rest.  Each
    device kernel is counted once, where the ``aten::`` operator that
    launched it sits: in the innermost range above it (a range's time
    leaves the ranges nested in it out, as lm_zamba's SSD in its mixer) and
    in the group of its ancestor called directly in that range.  A range's
    own annotation is never counted, nor the kernels the profiler also
    hangs on the runtime's events under an operator ("Command Buffer Full"
    where the host runs ahead of a saturated card: summing a range's
    ``device_time_total`` counted those kernels twice).  A kernel launched
    through ctypes (kernel 8) is no operator's: its time is its own,
    outside every range, even where the range's function launched it (as
    the H100's profiles show).  ``calls``: the operators seen in each group;
    ``top_kernels``: the ten kernel names (cut to 80 characters) with the
    most device ms."""
    ranges = {MOE_RANGE: MOE_OPS} if ranges is None else ranges
    groups = {group: ops for r in ranges.values() for group, ops in r.items()}
    out = {name: 0.0 for name in (*ranges, *groups, *kernels)}
    calls = {group: 0 for group in groups}
    by_name = collections.Counter()
    total = 0.0
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if not ev.name.startswith("aten::"):
                continue
            parent = ev.cpu_parent
            if parent is not None and parent.name in ranges:
                for group, ops in ranges[parent.name].items():
                    calls[group] += ev.name in ops
            own = sum(k.duration for k in ev.kernels) / 1e3
            child = ev
            while parent is not None and parent.name not in ranges:
                child, parent = parent, parent.cpu_parent
            if parent is None or not own:
                continue
            out[parent.name] += own
            for group, ops in ranges[parent.name].items():
                if child.name in ops:
                    out[group] += own
        elif not getattr(ev, "is_user_annotation", False) and ev.name not in ranges:
            total += ev.device_time_total / 1e3
            by_name[ev.name[:80]] += ev.device_time_total / 1e3
            for frag in kernels:
                if frag in ev.name:
                    out[frag] += ev.device_time_total / 1e3
    for name, ops in ranges.items():
        out[range_other(name)] = out[name] - sum(out[group] for group in ops)
    out["total"] = total
    out["rest"] = total - sum(out[name] for name in ranges) - sum(out[frag] for frag in kernels)
    out["calls"] = calls
    out["top_kernels"] = by_name.most_common(10)
    return out


@contextlib.contextmanager
def moe_ranged(names=(MOE_RANGE,)):
    """Within the block, each call of the function RANGE_TARGETS names for
    each range of ``names`` (each MoE layer, each layer's attention, each
    Mamba2 mixer and its SSD, the shared MLP) runs inside a profiler range
    of that name (for :func:`split_events`); the library itself enters
    none."""
    from unittest import mock

    from torch.profiler import record_function

    def ranged(apply, name):
        def call(*a, **kw):
            with record_function(name):
                return apply(*a, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for name in names:
            owner, attr = range_target(name)
            stack.enter_context(mock.patch.object(
                owner, attr, ranged(getattr(owner, attr), name)))
        yield


def moe_device_split(fn, calls: int = 1, ranges=None, warm: bool = True,
                     ranged=None) -> dict:
    """:func:`split_events` of ``calls`` calls of ``fn`` (after one warm-up
    unless not ``warm``) with each range's function in its range (default:
    each MoE layer; ``ranged``: another context of :func:`moe_ranged`'s
    signature), per call, with the wall ms per call."""
    from torch.profiler import ProfilerActivity, profile

    ranges = {MOE_RANGE: MOE_OPS} if ranges is None else ranges
    if warm:
        fn()
    torch.cuda.synchronize()
    with (ranged or moe_ranged)(tuple(ranges)), profile(activities=[ProfilerActivity.CPU,
                                                        ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    split = split_events(prof.events(), ranges=ranges)
    seen = split.pop("calls")
    top = [(name, ms / calls) for name, ms in split.pop("top_kernels")]
    split = {k: v / calls for k, v in split.items()}
    split["top_kernels"] = top
    return {"wall_ms": wall, "device_busy_share": split["total"] / wall if wall else None,
            "device_ms": split, "ops_seen": {k: v // calls for k, v in seen.items()}}


def mla_work(cfg, b: int, q_len: int, kv_len: int) -> tuple:
    """((bytes, operations) of the projections, of the attention) of one
    prefill (q_len = kv_len: the non-absorbed form) or decode step (q_len =
    1: absorbed) of b sequences through an MLA model's layers in bf16.
    Every projection weight is read once and multiplies every token in both
    forms (the absorbed fold q_nope W_uk and the context's W_uv cost what the
    non-absorbed k_nope and v expansions do a token); the prefill's
    attention takes 2 (nope + rope + v) operations a causal (query, key)
    pair of each head and writes the latent cache, the decode step's 2 (2
    kv_lora + rope) a cached key of each head and reads the cache."""
    m, L, d, h = cfg.mla, cfg.n_layers, cfg.d_model, cfg.n_heads
    r, rp, n, hv = m.kv_lora_rank, m.rope_head_dim, m.nope_head_dim, m.v_head_dim
    t = b * q_len
    q_proj = (d * m.q_lora_rank + m.q_lora_rank * h * (n + rp) if m.q_lora_rank
              else d * h * (n + rp))
    weights = q_proj + d * (r + rp) + r * h * n + r * h * hv + h * hv * d
    lat_bytes = L * b * kv_len * (r + rp) * 2
    if q_len == kv_len:
        attn_ops = 2 * (n + rp + hv) * b * h * q_len * (q_len + 1) // 2
    else:
        attn_ops = 2 * (2 * r + rp) * b * h * q_len * kv_len
    return (L * weights * 2, L * 2 * t * weights), (lat_bytes, L * attn_ops)


def moe_serve_work(cfg, b: int, q_len: int, kv_len: int, capacity: int,
                   experts_read: int = None, expert_pairs: int = None) -> dict:
    """{op: (bytes, operations)} of one prefill (q_len = kv_len = S) or one
    decode step (q_len = 1 against kv_len cached keys) of b sequences of a
    MoE model in bf16: each weight read once, the token embeddings gathered,
    the K/V written (prefill) or read (decode), the last position's logits
    written; every matrix product's multiply-adds (2 operations each), the
    experts over all E x capacity slots (the static-capacity formulation).
    An MLA model's projections and attention are :func:`mla_work`'s.
    ``experts_read``: experts whose weights a decode step needs (default
    all); ``expert_pairs``: the (token, choice) pairs the experts must
    compute over all layers (default every slot, L E capacity), such as
    the pairs a run's routing kept."""
    m, L = cfg.moe, cfg.n_layers
    d, hd, h, kvh, v = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.vocab
    e, f, t = m.num_experts, m.d_ff_expert, b * q_len
    fs = m.num_shared * f
    if cfg.attn == "mla":
        projections, attention = mla_work(cfg, b, q_len, kv_len)
    else:
        pairs = b * h * (q_len * (q_len + 1) // 2 if q_len == kv_len else q_len * kv_len)
        proj = d * (h * hd + 2 * kvh * hd) + h * hd * d
        projections = (L * proj * 2, L * 2 * t * proj)
        attention = (2 * L * b * kv_len * kvh * hd * 2, L * 4 * hd * pairs)
    read = e if experts_read is None else experts_read
    pairs_e = L * e * capacity if expert_pairs is None else expert_pairs
    return {
        "embed": (t * d * 2 * 2, 0),
        "projections": projections,
        "attention": attention,
        "router": (L * d * e * 4, L * 2 * t * d * e),
        "experts": (L * read * 3 * d * f * 2, 2 * 3 * pairs_e * d * f),
        "shared": (L * 3 * d * fs * 2, L * 2 * 3 * t * d * fs),
        "lm_head": (d * v * 2 + b * v * 4, 2 * b * d * v),
    }


def work_bounds(work: dict) -> dict:
    """The bound of the whole call, max(bytes / rate, operations / bf16
    peak), and the sum of each operation's own bound."""
    nbytes = sum(w[0] for w in work.values())
    flops = sum(w[1] for w in work.values())
    ms, by = bound_ms(nbytes, flops, PEAK_BF16)
    per_op = {op: bound_ms(*w, PEAK_BF16) for op, w in work.items()}
    return {"bound_ms": ms, "bound_by": by, "gbytes": nbytes / 1e9, "tflop": flops / 1e12,
            "sum_of_op_bounds_ms": sum(b[0] for b in per_op.values()),
            "op_bounds_ms": {op: b[0] for op, b in per_op.items()}}


def zamba_work(cfg, b: int, q_len: int, kv_len: int = None) -> dict:
    """{op: (bytes, operations, peak rate)} of one prefill (q_len = kv_len =
    S) or one decode step (q_len = 1 against kv_len cached keys) of b
    sequences through the hybrid in bf16, its SSD in float32.  Each weight
    read once (A_log, D, dt_bias in float32), the token embeddings
    gathered, the last position's logits written; the prefill writes the
    KV caches and the Mamba2 states, a decode step reads the KV caches and
    reads and writes the states.  Operations: 2 a multiply-add of every
    matrix product, the shared block's at each of its applications, the
    attention's 4 hd a causal (query, key) pair of each head (a cached key
    in decode); the SSD's products as its chunked form computes them, over
    the sequence padded to the chunk: C B^T (l, s), the whole (l, s) square
    of scores times x per head, the chunk states and their readout (2 N hd
    a step and head each); a decode step's state update and readout."""
    kv_len = q_len if kv_len is None else kv_len
    m, L, d, v = cfg.ssm, cfg.n_layers, cfg.d_model, cfg.vocab
    d_in = m.expand * d
    nh, n, p, chunk = d_in // m.head_dim, m.state_dim, m.head_dim, m.chunk
    conv_ch = d_in + 2 * n
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    apps = -(-L // cfg.shared_attn_every)
    t = b * q_len
    mixer_mm = d * (2 * d_in + 2 * n + nh) + d_in * d
    mixer_bytes = (mixer_mm + m.conv_width * conv_ch + conv_ch + d_in + d) * 2 + 3 * nh * 4
    shared_mm = d * (h + 2 * kvh) * hd + h * hd * d + 3 * d * cfg.d_ff
    state_bytes = L * b * (nh * p * n * 4 + (m.conv_width - 1) * conv_ch * 2)
    kv_bytes = apps * 2 * b * kv_len * kvh * hd * 2
    if q_len == kv_len:
        pairs = b * h * q_len * (q_len + 1) // 2
        padded = -(-q_len // chunk) * chunk
        ssd_ops = 2 * b * padded * chunk * (n + nh * p) + 2 * 2 * b * padded * nh * p * n
        states = state_bytes
    else:
        pairs = b * h * q_len * kv_len
        ssd_ops = 2 * 2 * b * nh * p * n
        states = 2 * state_bytes
    return {
        "embed": (t * d * 2 * 2, 0, PEAK_BF16),
        "mamba_projections": (L * mixer_bytes, L * 2 * t * mixer_mm, PEAK_BF16),
        "shared_block": ((shared_mm + 2 * d) * 2, apps * 2 * t * shared_mm, PEAK_BF16),
        "attention": (kv_bytes, apps * 4 * hd * pairs, PEAK_BF16),
        "ssd_products": (states, L * ssd_ops, PEAK_FP32),
        "lm_head": ((d * v + d) * 2 + b * v * 2, 2 * b * d * v, PEAK_BF16),
    }


def zamba_bounds(work: dict) -> dict:
    """The bound of the whole call: max(bytes / rate, the sum over ops of
    operations / that op's peak: bf16 tensor cores, the SSD's float32),
    and each op's own bound."""
    nbytes = sum(w[0] for w in work.values())
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(w[1] / w[2] for w in work.values())
    per_op = {op: bound_ms(*w) for op, w in work.items()}
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gbytes": nbytes / 1e9, "tflop": sum(w[1] for w in work.values()) / 1e12,
            "tflop_by_op": {op: w[1] / 1e12 for op, w in work.items()},
            "op_bounds_ms": {op: b[0] for op, b in per_op.items()}}


def zamba_groups(split: dict) -> dict:
    """A profiled zamba call's device ms by operator group, from
    :func:`split_events` over ZAMBA_OPS' ranges: the Mamba2 and
    attention projections, the SSD's products and its elementwise passes,
    kernel 8, the shared MLP, the rest of the mixers (conv, gates, gate
    norm, softplus), and the rest (rope, decode attention, layer norms and
    residual adds, embedding, lm_head)."""
    groups = {"projections": split["mamba_projections"] + split["attention_projections"],
              "ssd_products": split["ssd_products"], "ssd_elementwise": split["ssd_other"],
              "kernel8": split[KERNEL8_NAME], "shared_mlp": split[ZAMBA_MLP_RANGE],
              "mixer_other": split["mamba2_other"]}
    groups["rest"] = split["total"] - sum(groups.values())
    return groups


def checked_attention(plain, report: list, cut: int = 0):
    """An ``attention=`` hook for a prefill: each call runs kernel 8 (at the
    window less ``cut`` keys: a planted fault) and ``plain`` on the same q,
    k, v, appends the (max, mean) of their row norm errors
    (:func:`row_norm_errors`) to ``report``, and returns kernel 8's
    output."""
    from repro_torch.kernels.swa_attention.ops import swa_attention

    def attention(q, k, v, window, scale=None):
        got = swa_attention(q, k, v, window - cut, scale=scale)
        rows = row_norm_errors(got, plain(q, k, v, window, scale=scale))
        report.append((rows.max().item(), rows.mean().item()))
        return got
    return attention


def in_situ_ok(report: list) -> bool:
    """Every call of :func:`checked_attention` within the layer limits."""
    tol, mean_tol = SWA_ROW_TOL[torch.bfloat16], SWA_ROW_MEAN_TOL[torch.bfloat16]
    return bool(report) and all(worst <= tol and mean <= mean_tol for worst, mean in report)


def zamba_launches_ok(launches: dict, cfg) -> bool:
    """Kernel 8 pinned on the hybrid's serving path: once per application
    of the shared block in each prefill, never in decode."""
    apps = -(-cfg.n_layers // cfg.shared_attn_every)
    return (launches["generate"] == launches["prefill"] == apps and launches["decode"] == 0)


def unmasked_diag_scores(cum, cb, dt):
    """The reference's within-chunk scores, `repro/models/ssm.py:138-147`
    copied in the port's (b, nc, h, l, s) layout: the exp over the whole
    (l, s) square, then the causal mask.  Above the diagonal the exponent is
    a sum of |dt A| that can pass float32's exp range, and inf x 0 = NaN."""
    chunk = cum.shape[-1]
    li, sj = cum[..., :, None], cum[..., None, :]
    decay = torch.exp(li - sj)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=cum.device))
    return cb[:, :, None] * decay * causal * dt[..., None, :]


@contextlib.contextmanager
def planted_unmasked_decay():
    """Within the block, the port's SSD takes the reference's unmasked
    decay (:func:`unmasked_diag_scores`): a planted fault."""
    from unittest import mock

    from repro_torch.models import ssm

    with mock.patch.object(ssm, "_diag_scores", unmasked_diag_scores):
        yield


def _rel64(a, b) -> float:
    """max|a - b| / max|b| in float64."""
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def ssd_recurrence_check(mixer, x, cfg, tol: float = ZAMBA_SSD_TOL, step=None) -> tuple:
    """Check 3 of lm_zamba: ``mamba2_apply``'s chunked form over x (B, S,
    d) against S steps of its s == 1 recurrence from a zero state, the
    output and the final SSD and conv states each within ``tol`` of the
    recurrence's max|.|; a NaN anywhere fails.  ``step``: the recurrence's
    (output, state) from an earlier call on the same input.  Returns
    (report, step)."""
    from repro_torch.models.ssm import mamba2_apply, mamba2_state_spec

    y, st = mamba2_apply(mixer, x, cfg, return_state=True)
    if step is None:
        state = {k: torch.zeros(s.shape, dtype=s.dtype, device=x.device)
                 for k, s in mamba2_state_spec(cfg, x.shape[0], x.dtype).items()}
        ys = []
        for i in range(x.shape[1]):
            out, state = mamba2_apply(mixer, x[:, i:i + 1], cfg, state=state)
            ys.append(out)
        step = (torch.cat(ys, 1), state)
    y_step, st_step = step
    errs = {"output": _rel64(y, y_step), "ssd": _rel64(st["ssd"], st_step["ssd"]),
            "conv": _rel64(st["conv"], st_step["conv"])}
    report = {"rel_err": errs, "tol": tol, "steps": x.shape[1],
              "nan_share": 1.0 - torch.isfinite(y).float().mean().item(),
              "recurrence_finite": bool(torch.isfinite(y_step).all())}
    report["ok"] = (report["nan_share"] == 0 and report["recurrence_finite"]
                    and all(e <= tol for e in errs.values()))
    return report, step


def xlstm_work(cfg, b: int, q_len: int) -> dict:
    """{op: (bytes, operations, peak rate)} of one prefill of b sequences of
    q_len > 1 tokens, or one decode step (q_len = 1), through the xLSTM in
    bf16, its recurrent states in float32.  Each weight read once, the token
    embeddings gathered, the last position's logits written; the prefill
    writes the states, a decode step reads and writes them.  Operations: 2
    a multiply-add of every bf16 product (the mLSTM's four projections, the
    sLSTM's gate projection and FFN, lm_head at the last position); in
    float32 the sLSTM's recurrent product (2 nh hd 4 hd a token) and the
    mLSTM's as its chunked form computes them over the sequence padded to
    the chunk (q k^T and the weighted scores times v, 4 L hd a token and
    head; the carry's readout and update, 4 hd^2; the normaliser's, 4 hd),
    or a decode step's update and readout (4 hd^2 a head)."""
    from repro_torch.models.xlstm_lm import _n_pairs

    d, v, nh, pairs = cfg.d_model, cfg.vocab, cfg.n_heads, _n_pairs(cfg)
    d_in, hs = 2 * d, d // nh
    hm = d_in // nh
    t = b * q_len
    m_mm = d * 2 * d_in + d_in * 3 * d_in + d_in * 2 * nh + d_in * d
    s_mm = d * 4 * d + d * 2 * d + 2 * d * d if cfg.slstm_every else 0
    r = nh * hs * 4 * hs if cfg.slstm_every else 0
    norms = pairs * (d + d_in + (2 * d if cfg.slstm_every else 0)) + d
    m_state = pairs * b * nh * (hm * hm + hm + 1) * 4
    s_state = pairs * b * 4 * nh * hs * 4 if cfg.slstm_every else 0
    if q_len > 1:
        chunk = min(64, q_len)
        padded = -(-q_len // chunk) * chunk
        scan_ops = pairs * b * nh * padded * (4 * chunk * hm + 4 * hm * hm + 4 * hm)
        moved = 1
    else:
        scan_ops = pairs * b * nh * 4 * hm * hm
        moved = 2
    return {
        "embed": (t * d * 2 * 2, 0, PEAK_BF16),
        "mlstm_projections": (pairs * m_mm * 2, pairs * 2 * t * m_mm, PEAK_BF16),
        "mlstm_scan": (moved * m_state, scan_ops, PEAK_FP32),
        "slstm_recurrence": (pairs * r * 2 + moved * s_state, pairs * 2 * t * r, PEAK_FP32),
        "slstm_projections": (pairs * s_mm * 2, pairs * 2 * t * s_mm, PEAK_BF16),
        "norms": (norms * 2, 0, PEAK_BF16),
        "lm_head": (d * v * 2 + b * v * 2, 2 * b * d * v, PEAK_BF16),
    }


def xlstm_groups(split: dict) -> dict:
    """A profiled xLSTM call's device ms by group, from :func:`split_events`
    over XLSTM_OPS' ranges: the mLSTM's four projections, its chunk scan
    (a decode step: its recurrence step), the sLSTM's recurrence, its gate
    projection, its FFN, the mixers' norms and gates (the rest of both
    mixers: the gate activations, the silu gate, the gate norms, casts,
    pads and layout copies), lm_head with the final norm, and the rest (the
    pairs' pre-norms, residual adds, the embedding)."""
    groups = {"mlstm_projections": split["mlstm_projections"],
              "mlstm_scan": split[XLSTM_SCAN_RANGE] + split[XLSTM_STEP_RANGE],
              "slstm_recurrence": split[XLSTM_REC_RANGE],
              "slstm_gate_projection": split["slstm_gate_projection"],
              "slstm_ffn": split[XLSTM_FFN_RANGE],
              "norms_and_gates": split["mlstm_other"] + split["slstm_other"],
              "lm_head": split[XLSTM_HEAD_RANGE]}
    groups["rest"] = split["total"] - sum(groups.values())
    return groups


def unmasked_log_weights(cf, li):
    """The mLSTM's within-chunk log weights cf[l] - cf[s] + li[s] without
    the causal mask: every source, later ones too, reaches every target."""
    return cf[..., :, None] - cf[..., None, :] + li[..., None, :]


@contextlib.contextmanager
def planted_unmasked_log_weights():
    """Within the block, the port's mLSTM drops the causal mask on its log
    weights (:func:`unmasked_log_weights`): a planted fault."""
    from unittest import mock

    from repro_torch.models import xlstm

    with mock.patch.object(xlstm, "_log_weights", unmasked_log_weights):
        yield


def mlstm_recurrence_check(mixer, x, cfg, tol: float = XLSTM_MLSTM_TOL, step=None) -> tuple:
    """Check 2 of lm_xlstm: ``mlstm_apply``'s chunked form over x (B, S, d)
    against S steps of its s == 1 recurrence from the fresh state: the
    output, and the final state's C e^m and n e^m (the stabiliser m splits
    the scale between them in each form's own way), each within ``tol`` of
    the recurrence's max|.|; a non-finite value fails.  ``step``: the
    recurrence's (output, state) from an earlier call on the same input.
    Returns (report, step)."""
    from repro_torch.models.xlstm import mlstm_apply, mlstm_state_spec

    y, st = mlstm_apply(mixer, x, cfg, return_state=True)
    if step is None:
        state = {k: torch.zeros(s.shape, dtype=s.dtype, device=x.device)
                 for k, s in mlstm_state_spec(cfg, x.shape[0]).items()}
        state["m"].fill_(-1e30)
        ys = []
        for i in range(x.shape[1]):
            out, state = mlstm_apply(mixer, x[:, i:i + 1], cfg, state=state)
            ys.append(out)
        step = (torch.cat(ys, 1), state)
    y_step, st_step = step

    def scaled(state, name):
        m = state["m"].double().exp()
        return state[name].double() * (m[..., None, None] if name == "C" else m[..., None])

    errs = {"output": _rel64(y, y_step),
            "C_exp_m": _rel64(scaled(st, "C"), scaled(st_step, "C")),
            "n_exp_m": _rel64(scaled(st, "n"), scaled(st_step, "n"))}
    finite = bool(torch.isfinite(y).all() and all(torch.isfinite(t).all() for t in st.values()))
    report = {"rel_err": errs, "tol": tol, "steps": x.shape[1], "finite": finite,
              "recurrence_finite": bool(torch.isfinite(y_step).all())}
    report["ok"] = (finite and report["recurrence_finite"]
                    and all(e <= tol for e in errs.values()))
    return report, step


def slstm_carry_check(mixer, x, cfg, split: int, tol: float = XLSTM_SLSTM_TOL,
                      restart: bool = False) -> dict:
    """Check 3 of lm_xlstm: ``slstm_apply`` over x[:, :split], then over the
    rest from that state (from the fresh state with ``restart``: a planted
    fault), against one pass over all of x: the outputs and the final state
    within |a - b| <= tol + tol |b| (tests/test_mixers.py:98's rule)."""
    from repro_torch.models.xlstm import slstm_apply

    t0 = time.perf_counter()
    y, st = slstm_apply(mixer, x, cfg, return_state=True)
    if x.is_cuda:
        torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    y1, st1 = slstm_apply(mixer, x[:, :split], cfg, return_state=True)
    y2, st2 = slstm_apply(mixer, x[:, split:], cfg, state=None if restart else st1,
                          return_state=True)

    def excess(a, b):  # max of |a - b| / (tol + tol |b|): at most 1 passes
        return ((a.double() - b.double()).abs() / (tol + tol * b.double().abs())).max().item()

    worst = {"output": excess(torch.cat([y1, y2], 1), y),
             **{f"state_{k}": excess(st2[k], st[k]) for k in st}}
    return {"excess_over_tol": worst, "tol": tol, "steps": x.shape[1], "split": split,
            "full_pass_ms": full_ms, "finite": bool(torch.isfinite(y).all()),
            "ok": bool(torch.isfinite(y).all()) and all(e <= 1.0 for e in worst.values())}


def teacher_forced(model, cfg, prompts, tokens, extra=None, grow=None, pos0=None,
                   attention=None) -> "torch.Tensor":
    """The logits (B, T, V) float32 of a prefill over ``prompts`` (and the
    ``extra`` inputs: frames, patch embeddings; through ``attention``, by
    default the kernel's wrapper) and T - 1 decode steps fed ``tokens``
    (B, T)[:, :-1] from ``pos0`` (default: where a generate starts, after
    the VLM's patches): the steps a generate of T tokens takes, on another
    model, device or attention.  ``grow`` fits the prefill's cache to a
    capacity (an engine's ``_grow_cache``) where decode needs one."""
    from repro_torch.models import decode_step, prefill

    logits, cache = prefill(model, {"tokens": prompts, **(extra or {})}, cfg,
                            attention=attention)
    if grow is not None:
        cache = grow(cache, prompts.shape[0])
    if pos0 is None:
        pos0 = prompts.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    steps = [logits.float()]
    for i in range(1, tokens.shape[1]):
        logits, cache = decode_step(model, cache, {"tokens": tokens[:, i - 1],
                                                   "pos": pos0 + i - 1}, cfg)
        steps.append(logits.float())
    return torch.stack(steps, 1)


def float_model(params, cfg, device):
    """A float32 copy of a model on ``device`` (its tree's leaves cast)."""
    from repro_torch.core.mapreduce import tree_map
    from repro_torch.models import params_from_tree, params_to_tree

    return params_from_tree(tree_map(lambda t: t.to(device, torch.float32),
                                     params_to_tree(params)), cfg)


def whisper_work(cfg, b: int, enc_len: int, q_len: int = 0, kv_len: int = None) -> dict:
    """{op: (bytes, operations, peak rate)} in bf16 of b clips of enc_len
    frames through the encoder alone (q_len = 0), a prefill (q_len = kv_len
    = S_dec: the encoder, each decoder layer's cross K/V and the decoder)
    or a decode step (q_len = 1 against kv_len cached self keys and the
    enc_len cross keys).  Each weight read once, the frames read (and the
    encoder's states written when it runs alone), the token embeddings
    gathered, the last position's logits written; the prefill writes the
    self and cross caches, a decode step reads them.  Operations: 2 a
    multiply-add of every matrix product; attention 4 hd a (query, key)
    pair of each head: every pair in the encoder and cross-attention, the
    causal pairs in the prefill's self-attention, the cached keys in
    decode."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    le, ld, v = cfg.enc_layers, cfg.n_layers, cfg.vocab
    attn_w = d * (h + 2 * kvh) * hd + h * hd * d  # one self-attention's projections
    cross_qo, cross_kv, mlp_w = 2 * d * h * hd, 2 * d * kvh * hd, 3 * d * cfg.d_ff
    kv_row = kvh * hd * 2 * 2  # one position's K and V
    te = b * enc_len
    work = {}
    if q_len != 1:  # the encoder runs
        work["frames"] = (te * d * 2 * (2 if q_len == 0 else 1), 0, PEAK_BF16)
        work["encoder_projections"] = ((attn_w + 2 * d) * le * 2 + d * 2,
                                       2 * te * attn_w * le, PEAK_BF16)
        work["encoder_mlp"] = (mlp_w * le * 2, 2 * te * mlp_w * le, PEAK_BF16)
        work["encoder_attention"] = (0, 4 * hd * b * h * enc_len * enc_len * le, PEAK_BF16)
    if q_len == 0:
        return work
    kv_len = q_len if kv_len is None else kv_len
    td = b * q_len
    prefill = q_len == kv_len
    pairs = b * h * q_len * (q_len + 1) // 2 if prefill else b * h * kv_len
    cross_cache = ld * te * kv_row
    work["embed"] = (td * d * 2 * 2, 0, PEAK_BF16)
    work["decoder_projections"] = ((attn_w + cross_qo + 3 * d) * ld * 2 + d * 2,
                                   2 * td * (attn_w + cross_qo) * ld, PEAK_BF16)
    if prefill:
        work["cross_kv"] = (cross_kv * ld * 2 + cross_cache, 2 * te * cross_kv * ld, PEAK_BF16)
    work["decoder_mlp"] = (mlp_w * ld * 2, 2 * td * mlp_w * ld, PEAK_BF16)
    work["self_attention"] = (ld * b * kv_len * kv_row, 4 * hd * pairs * ld, PEAK_BF16)
    work["cross_attention"] = (0 if prefill else cross_cache,
                               4 * hd * b * h * q_len * enc_len * ld, PEAK_BF16)
    work["lm_head"] = (d * v * 2 + b * v * 2, 2 * b * d * v, PEAK_BF16)
    return work


def llava_work(cfg, b: int, text_len: int, kv_len: int = None) -> dict:
    """{op: (bytes, operations, peak rate)} in bf16 of a prefill (kv_len
    None: n_patches + text_len positions, the patch embeddings through
    patch_proj) or a decode step (one token against kv_len cached keys) of
    b requests through the VLM.  Each weight read once, the inputs read,
    the KV cache written (prefill) or read (decode), the last position's
    logits written; 2 operations a multiply-add, attention 4 hd a causal
    (query, key) pair of each head (a cached key in decode)."""
    d, h, kvh, hd, n_l, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                             cfg.n_layers, cfg.vocab)
    attn_w = d * (h + 2 * kvh) * hd + h * hd * d
    mlp_w = 3 * d * cfg.d_ff
    kv_row = kvh * hd * 2 * 2
    if kv_len is None:
        q = s = cfg.n_patches + text_len
        pairs = b * h * q * (q + 1) // 2
        work = {"patch_proj": (d * d * 2 + b * cfg.n_patches * d * 2,
                               2 * b * cfg.n_patches * d * d, PEAK_BF16),
                "embed": (b * text_len * d * 2 * 2, 0, PEAK_BF16)}
    else:
        q, s = 1, kv_len
        pairs = b * h * kv_len
        work = {"embed": (b * d * 2 * 2, 0, PEAK_BF16)}
    t = b * q
    work.update({
        "projections": ((attn_w + 2 * d) * n_l * 2 + d * 2, 2 * t * attn_w * n_l, PEAK_BF16),
        "mlp": (mlp_w * n_l * 2, 2 * t * mlp_w * n_l, PEAK_BF16),
        "attention": (n_l * b * s * kv_row, 4 * hd * pairs * n_l, PEAK_BF16),
        "lm_head": (d * v * 2 + b * v * 2, 2 * b * d * v, PEAK_BF16),
    })
    return work


@contextlib.contextmanager
def whisper_ranged(names):
    """:func:`moe_ranged` over ``names``, with the two ranges that are no
    function's: `encdec.full_attention` runs in WHISPER_XATTN_RANGE when a
    cross-attention (itself in WHISPER_CROSS_RANGE) calls it, else (the
    encoder's self-attention) in WHISPER_ENC_ATTN_RANGE."""
    from unittest import mock

    from torch.profiler import record_function

    from repro_torch.models import encdec

    cross, full = encdec._cross_attn, encdec.full_attention
    inside = []

    def ranged_cross(*a, **kw):
        inside.append(True)
        try:
            with record_function(WHISPER_CROSS_RANGE):
                return cross(*a, **kw)
        finally:
            inside.pop()

    def ranged_full(*a, **kw):
        with record_function(WHISPER_XATTN_RANGE if inside else WHISPER_ENC_ATTN_RANGE):
            return full(*a, **kw)

    own = (WHISPER_CROSS_RANGE, WHISPER_XATTN_RANGE, WHISPER_ENC_ATTN_RANGE)
    with mock.patch.object(encdec, "_cross_attn", ranged_cross), \
            mock.patch.object(encdec, "full_attention", ranged_full), \
            moe_ranged(tuple(n for n in names if n not in own)):
        yield


def whisper_groups(split: dict) -> dict:
    """A profiled whisper call's device ms by group, from
    :func:`split_events` over WHISPER_OPS' ranges: the encoder's attention
    and the cross-attention (each `full_attention`: products, float32
    softmax, casts), kernel 8, the projections (self, cross q/o, cross
    K/V), the MLPs, the self-attention's rest (rope, the decode step's
    attention), and the rest (norms, residual adds, embedding, lm_head)."""
    groups = {"encoder_attention": split[WHISPER_ENC_ATTN_RANGE],
              "cross_attention": split[WHISPER_XATTN_RANGE], "kernel8": split[KERNEL8_NAME],
              "projections": split["self_projections"] + split["cross_projections"]
              + split["cross_kv_projections"], "mlp": split[WHISPER_MLP_RANGE],
              "self_attention_other": split["self_attn_other"]}
    groups["rest"] = split["total"] - sum(groups.values())
    return groups


def llava_groups(split: dict) -> dict:
    """A profiled llava call's device ms by group: the attention
    projections, kernel 8, the attention's rest (rope, the decode step's
    attention), the MLPs, and the rest (norms, residuals, patch_proj,
    embedding, lm_head)."""
    groups = {"projections": split["attention_projections"], "kernel8": split[KERNEL8_NAME],
              "attention_other": split["attention_other"], "mlp": split[LLAVA_MLP_RANGE]}
    groups["rest"] = split["total"] - sum(groups.values())
    return groups


@contextlib.contextmanager
def planted_causal_encoder():
    """The planted fault of lm_whisper's check 3: the encoder's
    self-attention made causal (the plain chunked version), the decoder's
    and every cross-attention left as they are."""
    from unittest import mock

    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import encdec

    self_attn = encdec._self_attn

    def causal_encoder(p, x, cfg, positions, causal, **kw):
        if not causal:
            return self_attn(p, x, cfg, positions, True, attention=swa_attention_chunked)
        return self_attn(p, x, cfg, positions, causal, **kw)

    with mock.patch.object(encdec, "_self_attn", causal_encoder):
        yield


def padded_cross(grow, pad: int):
    """The planted fault of lm_whisper's check 4: an engine's ``_grow_cache``
    whose cross K/V gains ``pad`` zero positions (what fitting the cross
    cache to a longer capacity would do)."""
    def padded(cache, batch):
        out = grow(cache, batch)
        out["cross"] = {name: torch.cat([t, t.new_zeros(t.shape[:2] + (pad,) + t.shape[3:])], 2)
                        for name, t in out["cross"].items()}
        return out
    return padded


def prefill_launches_ok(report: dict, layers: int) -> bool:
    """Kernel 8 pinned on a serving path: once a layer (the
    encoder-decoder's: a decoder layer) in each prefill, the generate's
    and the split one, and never in any other call counted (the encoder, a
    cross-attention, decode); no other kernel in the generate.  ``report``:
    {"swa_attention": {call: launches}, "other_kernels": {name: launches}}."""
    swa = report["swa_attention"]
    return (swa["generate"] == swa["prefill"] == layers
            and all(n == 0 for call, n in swa.items() if call not in ("generate", "prefill"))
            and all(n == 0 for n in report["other_kernels"].values()))


def stats_paths(args, dev, lagmom_fault) -> dict:
    """Phases 2-8: kernels 1-7 against their plain versions, the fused plan
    end to end, the single-family plans, the spatial fit, rolling moments,
    cross-spectra and the kernels' timing.  Returns each kernel's parity
    cases, timing, bound and launches on its own path.  ``lagmom_fault``:
    start_lagmom_fault_build's function."""
    from repro_torch import SeriesFrame
    from repro_torch.kernels import _build
    from repro_torch.core.estimators.spectral import hann_window
    from repro_torch.kernels import launch_counts, path_counts, reset_launch_counts
    from repro_torch.kernels.banded_matvec import ops as bm, ref as bmr
    from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
    from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
    from repro_torch.kernels.window_stats import ops as ws, ref as wsr

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
    # a moments-only plan's merge boundary: the two carried halves, every start valid
    mom_boundary = (series[CHUNK - CARRY: CHUNK + CARRY],
                    torch.ones(CARRY, dtype=torch.bool, device=dev), 0, WINDOWS)
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
        "mixed_paths": dict(n=700, d=64, max_lag=16, windows=(64,), seg_lens=(256, 17),
                            seg_steps=(128, 5), z0=3, mask_holes=True),
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

    def mega_check(case_args, plant=False, **kw):
        """(lag, mom, psds, n_segs) against the plain version; each Welch
        member's power also per bin.  ``plant``: and a planted bin error in
        the first member."""
        got = fp.fused_plan_update(*case_args, **kw)
        again = fp.fused_plan_update(*case_args, **kw)
        want = fpr.fused_plan_update_ref(*case_args)
        y, mask, windows = case_args[0], case_args[1], case_args[4]
        abs_mom = abs_moment_sums(y, mask, windows) if windows else None
        torch.cuda.synchronize()
        res = parts_check(got, again, want, mega_tols, abs_mom)
        bins = [power_bin_error(g, w, False) for g, w in zip(got[2], want[2])]
        res["psd_per_bin"] = {"max_rel_err": max([b["max_rel_err"] for b in bins], default=0.0),
                              "tol": TOL_NEW["psd"], "ok": all(b["ok"] for b in bins)}
        res["ok"] = res["ok"] and res["psd_per_bin"]["ok"]
        if plant:
            res["planted_bin_error"] = planted_bin_error(got[2][0], want[2][0], False)
            res["ok"] = res["ok"] and res["planted_bin_error"]["caught"]
        return res

    def power_check(case_args):
        """Kernel 4: normwise, then per bin (a third launch)."""
        res = check_kernel(sd.segment_fft_power, sdr.segment_dft_power_ref, case_args,
                           TOL["psd"])
        res["per_bin"] = power_bin_error(sd.segment_fft_power(*case_args),
                                         sdr.segment_dft_power_ref(*case_args), True)
        res["ok"] = res["ok"] and res["per_bin"]["ok"]
        return res

    def lag_moments_check(case_args):
        """Kernel 3: (lag, mom) against the plain version, two launches
        bitwise equal; at H = 0 S(0) bitwise equal to its transpose."""
        got = ws.fused_lagged_moments(*case_args)
        again = ws.fused_lagged_moments(*case_args)
        want = wsr.fused_lag_moments_ref(*case_args)
        y, mask, max_lag, window = case_args
        abs_mom = abs_moment_sums(y, mask, window)
        torch.cuda.synchronize()
        res = parts_check(got, again, want, mega_tols, abs_mom)
        if max_lag == 0:
            res["symmetric"] = bool(torch.equal(got[0][0], got[0][0].t()))
            res["ok"] = res["ok"] and res["symmetric"]
        return res

    def lag_moments_grid():
        """Kernel 3 over H in LAGMOM_LAGS, d in LAGMOM_DIMS and the windows of
        LAGMOM_WINDOWS, masks with holes (n = LAGMOM_N starts), each case
        as lag_moments_check; reported as one summary."""
        cases = {}
        for max_lag in LAGMOM_LAGS:
            for d in LAGMOM_DIMS:
                for wname, windows in LAGMOM_WINDOWS.items():
                    reach = max(max_lag, max(windows) - 1)
                    y = torch.randn((LAGMOM_N + reach, d), generator=gen, device=dev)
                    mask = torch.ones(LAGMOM_N, dtype=torch.bool, device=dev)
                    mask[LAGMOM_N // 3:: 5] = False
                    mask[-LAGMOM_N // 10:] = False
                    cases[f"h{max_lag}_d{d}_{wname}"] = lag_moments_check(
                        (y, mask, max_lag, windows))
        worst = max(cases, key=lambda k: max(r["max_rel_err"] for r in cases[k]["parts"].values()))
        return {"cases": len(cases), "n": LAGMOM_N, "lags": list(LAGMOM_LAGS),
                "dims": list(LAGMOM_DIMS), "windows": {k: list(w) for k, w in LAGMOM_WINDOWS.items()},
                "worst": worst, "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
                "max_rel_err": {part: max(r["parts"][part]["max_rel_err"] for r in cases.values())
                                for part in ("lag", "mom")},
                "all_bitwise_repeat": all(r["bitwise_repeat"] for r in cases.values()),
                "all_symmetric_h0": all(r["symmetric"] for r in cases.values() if "symmetric" in r),
                "bad": [k for k, r in cases.items() if not r["ok"]],
                "ok": all(r["ok"] for r in cases.values())}

    def dropped_slab(case_args):
        """The fault: the middle slab's partial left out of the in-launch sum
        (LAGMOM_FAULT's copy of the kernel, on the shipped wrapper's prepared
        launch), held to the plain version as in lag_moments_check."""
        y, mask, max_lag, windows = case_args
        prep = ws.prepare_fused_lag_moments(y.contiguous(), mask, max_lag, windows)
        _build.check(lagmom_fault()(ctypes.byref(prep.params),
                                    torch.cuda.current_stream(dev).cuda_stream),
                     "lag_moments_sym (planted fault)")
        lag, mom = prep.out
        want = wsr.fused_lag_moments_ref(*case_args)
        torch.cuda.synchronize()
        res = parts_check((lag, mom), (lag, mom), want, mega_tols,
                          abs_moment_sums(y, mask, windows))
        return {"slab": (-(-prep.params.rows // prep.params.slab) - 1) // 2,
                "max_rel_err": {k: r["max_rel_err"] for k, r in res["parts"].items()},
                "caught": not res["ok"]}

    parity = {"fused_plan_megakernel": {"chunk": mega_check(mega_chunk, plant=True),
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
                                   "tail": lag_moments_check(mom_tail),
                                   "merge_boundary": lag_moments_check(mom_boundary),
                                   "grid": lag_moments_grid()}
    odd_segs = series[: 40 * 255].reshape(40, 255, D)  # not a power of two: twiddles
    parity["segment_dft_power"] = {
        "chunk": power_check((seg_chunk, taper)),
        "tail": power_check((seg_tail, taper)),
        "odd_L_twiddle": power_check((odd_segs, hann_window(255, dev))),
        "no_detrend": power_check((seg_tail, taper, False)),
    }
    # planted errors on the FFT path's output: 2 tol of max|plain| in a middle
    # entry (normwise), 2 tol of the per-bin scale in the faintest
    # high-frequency bin (per bin)
    fft_out = sd.segment_fft_power(seg_chunk, taper)
    fft_plain = sdr.segment_dft_power_ref(seg_chunk, taper)
    chunk_case = parity["segment_dft_power"]["chunk"]
    chunk_case["planted_error_caught"] = planted_error_caught(
        fft_out, fft_plain, fft_plain.abs().amax().reshape(1, 1, 1), TOL["psd"])
    chunk_case["planted_bin_error"] = planted_bin_error(fft_out, fft_plain, True)
    chunk_case["ok"] &= (chunk_case["planted_error_caught"]
                         and chunk_case["planted_bin_error"]["caught"])
    del fft_out, fft_plain
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

    def transposed_case(diags, x):
        """A^T x through the kernel's flag (the diagonals where they lie),
        held to the plain version on band_transpose(diags), and bitwise equal
        to the kernel on that copy."""
        res = new_kernel_case(lambda a, v: bm.prepare_banded_matvec(a, v, True).launch(),
                              lambda a, v: band_plain(bmr.band_transpose(a), v),
                              lambda a, v: band_scale(bmr.band_transpose(a), v), (diags, x),
                              TOL_NEW["band"])
        res["bitwise_vs_band_transpose"] = bool(torch.equal(
            bm.prepare_banded_matvec(diags, x, True).launch(),
            bm.prepare_banded_matvec(bmr.band_transpose(diags), x).launch()))
        res["ok"] = res["ok"] and res["bitwise_vs_band_transpose"]
        return res

    def grad_case(g, x, b, fn=bm.band_gradient):
        return new_kernel_case(fn, bmr.band_gradient, grad_scale, (g, x, b), TOL_NEW["band"])

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
        "transposed_flag_fit": transposed_case(fit_diags, fit_x),
        "transposed_flag_nrhs_1": transposed_case(fit_diags, fit_x[:1]),
        "transposed_flag_generic": transposed_case(rand(1000, 7), rand(5, 1000)),
    }
    # kernel 7b, d diags: each entry against sum_n |g||x|, off-matrix slots exactly 0
    fit_g = rand(SPATIAL_T - 1, SPATIAL_D)
    parity["band_gradient"] = {
        "fit": grad_case(fit_g, fit_x, SPATIAL_B),
        "d_not_tile_multiple": grad_case(rand(5, 1000), rand(5, 1000), 3),
        "b_zero": grad_case(rand(3, 300), rand(3, 300), 0),
        "b_over_tile": grad_case(rand(4, 700), rand(4, 700), 300),
        "nrhs_1": grad_case(rand(1, 1000), rand(1, 1000), 3),
        "halo_two_float4": grad_case(rand(7, 4096), rand(7, 4096), 6),
        "d_below_band": grad_case(rand(9, 8), rand(9, 8), 6),
        "unaligned_rows": grad_case(rand(5 * 1000 + 1)[1:].view(5, 1000),
                                    rand(5 * 1000 + 1)[1:].view(5, 1000), 3),
    }

    def dropped_offset(g, x, b):  # the fault: one offset's products never summed
        out = bm.band_gradient(g, x, b)
        out[:, b + 1] = 0.0
        return out

    fault = grad_case(fit_g, fit_x, SPATIAL_B, dropped_offset)
    faults = {"band_gradient_dropped_offset": {"max_rel_err": fault["max_rel_err"],
                                               "caught": not fault["ok"]},
              "fused_lag_moments_dropped_slab": dropped_slab(mom_chunk)}
    del fit_x, fit_g
    emit({"phase": "parity", "tolerance": "per leaf: max|kernel - plain| <= tol * scale "
          "(max|plain|; sum of y: per channel, the sum over |y|); the power of kernels 1 "
          "and 4 also per bin (TOL_NEW psd): each entry against the plain power at its "
          "(f, channel), averaged over segments; kernels 5-7 per entry: "
          "a window sum against that window's sum of |x| (or of x^2), float64 plain; a "
          "banded product against sum |a||x|; a cross-spectral entry against "
          "sqrt(P_i(f) P_j(f)), P averaged over segments; d diags against sum_n |g||x|",
          "kernels": parity, "planted_faults": faults})
    bad = [f"{k}/{c}" for k, cases in parity.items() for c, r in cases.items() if not r["ok"]]
    bad += [f"fault {k} not caught" for k, r in faults.items() if not r["caught"]]
    if bad:
        fail("kernel parity", cases=bad)

    # ------------------------------------------------ 3. main path
    chunks = list(series.split(CHUNK))

    def run_plan(backend, chunk_list):
        frame = declare_plan(SeriesFrame.from_chunks(chunk_list[:-1], backend=backend,
                                                     device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = frame.collect()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = launch_counts()
        frame.append(chunk_list[-1])
        appended = launch_counts()
        second = frame.collect()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # the launches of the append's one update and of the collect after
        # it, each counted on its own (the totals run on)
        steps = {"append": {k: v - before[k] for k, v in appended.items()},
                 "collect": {k: v - appended[k] for k, v in launch_counts().items()}}
        return first, second, (t1 - t0) * 1e3, (t2 - t1) * 1e3, steps

    run_plan("cuda", chunks[:3])  # warm-up: library, cuBLAS and cuSOLVER handles
    reset_launch_counts()
    first, second, collect_ms, append_ms, steps = run_plan("cuda", chunks)
    counts, paths = launch_counts(), path_counts()
    updates = len(chunks)
    plain_first, plain_second, plain_collect_ms, plain_append_ms, _ = run_plan("torch", chunks)
    # where the time goes: device time by kernel over one whole run, against
    # its wall time (the run includes frame set-up, collect, append, collect)
    busy_by_kernel, busy_ms, wall_ms = device_split(lambda: run_plan("cuda", chunks), calls=1)

    members = {}
    for tag, got, want in (("collect", first, plain_first), ("append", second, plain_second)):
        for name, tol in MEMBER_TOL.items():
            members[f"{tag}/{name}"] = compare(got[name], want[name], tol)
        members[f"{tag}/welch_per_bin"] = power_bin_error(got["welch"][1], want["welch"][1],
                                                          False)
    planted = planted_errors(plain_second["moments"], TOL["moments"])
    shapes_ok = (tuple(second["autocovariance"].shape) == (H + 1, D, D)
                 and tuple(second["yule_walker"][0].shape) == (P_YW, D, D)
                 and tuple(second["arma"][1].shape) == (1, D, D)
                 and tuple(second["welch"][1].shape) == (NPERSEG // 2 + 1, D)
                 and int(second["moments"]["count"].item()) == n_total - WINDOWS[0] + 1)
    # every Welch member of the main path (L = 256) takes the FFT path
    counts_ok = (counts["fused_plan_megakernel"] == 2 * updates
                 and paths["fused_plan_megakernel"] == {"fft": 2 * updates, "twiddle": 0}
                 and paths["segment_dft_power"]["fft"] == counts["segment_dft_power"]
                 and all(counts[k] >= 1 for k in ("cross_window_stats", "fused_lag_moments",
                                                  "segment_dft_power")))
    emit({"phase": "main_path", "samples_per_channel": n_total, "channels": D,
          "chunks": updates, "updates": updates, "launches": counts,
          "launches_by_step": steps,
          # the moments finalize's tail (w = 64): the collect after the append
          "fused_lag_moments_per_collect": steps["collect"]["fused_lag_moments"],
          "welch_path_launches": paths,
          "collect_ms": collect_ms, "append_collect_ms": append_ms,
          "samples_per_s": (n_total - CHUNK) * D / (collect_ms / 1e3),
          "plain_collect_ms": plain_collect_ms, "plain_append_collect_ms": plain_append_ms,
          "profiled_run": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                           "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
                           "device_ms_by_kernel": busy_by_kernel},
          "members": members, "shapes_ok": shapes_ok, "launch_counts_ok": counts_ok,
          "planted_errors_caught": planted})
    if not counts_ok:
        fail("main-path launch counts", launches=counts, paths=paths, updates=updates)
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
        results, frames = {}, {}
        for backend in ("cuda", "torch"):
            frame = frames[backend] = SeriesFrame.from_chunks(few, backend=backend, device=dev)
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
        if name == "welch_only":
            single[name]["per_bin"] = power_bin_error(results["cuda"]["welch"][1],
                                                      results["torch"]["welch"][1], False)
            cmp["ok"] = cmp["ok"] and single[name]["per_bin"]["ok"]
        if name == "moments_only":
            # one more chunk's update, then the collect after it, each
            # counted on its own (expected: the chunk and its merge boundary;
            # the finalize's tail)
            reset_launch_counts()
            frames["cuda"].append(chunks[len(few)])
            torch.cuda.synchronize()
            single[name]["launches_per_chunk"] = launch_counts()[kernel]
            reset_launch_counts()
            frames["cuda"].collect()
            torch.cuda.synchronize()
            single[name]["launches_per_collect"] = launch_counts()[kernel]
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
    grad_launches = launch_counts()["band_gradient"]
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

    # one step's device time, split: the product and the d diags kernel
    # (each its prepared launch, on this step's operands), the rest
    x_prev = xs[:-1]

    def fit_step():
        dg = fit.diags.clone().requires_grad_(True)
        v = banded_nll(dg, xs)
        torch.autograd.grad(v, dg)

    step_event_ms = cuda_ms(fit_step, 5, warmup=1)
    step_split, step_busy_ms, step_wall_ms = device_split(fit_step, calls=3)
    step_ms = step_busy_ms if step_busy_ms > 0 else step_event_ms
    prep_fit = bm.prepare_banded_matvec(fit.diags, x_prev)
    fit_kernel_ms = graph_ms([prep_fit.launch])
    kernel_ms = fit_kernel_ms[len(fit_kernel_ms) // 2]
    cot = (xs[1:] - prep_fit.launch()) * (-1.0 / (SPATIAL_T - 1))
    prep_grad = bm.prepare_band_gradient(cot, x_prev, SPATIAL_B)
    ddiags_samples = graph_ms([prep_grad.launch])
    ddiags_ms = ddiags_samples[len(ddiags_samples) // 2]
    ddiags_plain_ms = cuda_ms(lambda: bmr.band_gradient(cot, x_prev, SPATIAL_B), 5, warmup=1)

    # a loss differentiated with respect to x: the forward and A^T g, which
    # reads the diagonals where they lie (band_transpose is never called)
    grads, dx_launches, transposes = {}, None, []
    real_transpose = {mod: mod.band_transpose for mod in (bm, bmr)}
    for mod, real in real_transpose.items():
        mod.band_transpose = lambda dg, real=real: transposes.append(1) or real(dg)
    for be in ("cuda", "torch"):
        xx = x_prev.clone().requires_grad_(True)
        reset_launch_counts()
        loss = torch.sin(banded_predict(true_diags, xx, backend=be)).square().sum()
        (grads[be],) = torch.autograd.grad(loss, xx)
        torch.cuda.synchronize()
        if be == "cuda":
            dx_launches = launch_counts()
        del xx, loss
    for mod, real in real_transpose.items():
        mod.band_transpose = real
    # |d loss / d pred| = |sin(2 pred)| <= 1
    dx_scale = band_scale(bmr.band_transpose(true_diags), torch.ones((1, SPATIAL_D), device=dev))
    dx_err, dx_rel, dx_finite = scaled_error(grads["cuda"], grads["torch"], dx_scale)
    del grads, cot, prep_fit, prep_grad

    spatial = {
        "phase": "spatial_fit", "d": SPATIAL_D, "bandwidth": SPATIAL_B, "T": SPATIAL_T,
        "num_parts": SPATIAL_PARTS, "steps": SPATIAL_STEPS, "step_size": STEP_SIZE,
        "simulate_ms": (t1 - t0) * 1e3, "simulate_launches": sim_launches,
        "fit_ms": (t2 - t1) * 1e3, "fit_ms_per_step": (t2 - t1) * 1e3 / SPATIAL_STEPS,
        "launches_per_step": {"banded_matvec": fit_launches / SPATIAL_STEPS,
                              "band_gradient": grad_launches / SPATIAL_STEPS},
        "nll_trace": trace,
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
                           "d_diags": ddiags_ms, "d_diags_samples": ddiags_samples,
                           "d_diags_plain": ddiags_plain_ms,
                           "rest": step_ms - kernel_ms - ddiags_ms,
                           "by_kernel_name": step_split,
                           "note": "step: profiler device-busy ms per step (CUDA-event ms "
                                   "if the profiler saw no device work); kernel, d_diags: CUDA "
                                   "graph of the prepared launch of the product and of the d "
                                   "diags kernel on this step's operands; d_diags_plain: CUDA "
                                   "events around the plain version's shifted products"},
        "dx_loss": {"launches": dx_launches, "band_transpose_calls": len(transposes),
                    "max_abs_err": dx_err, "max_rel_err": dx_rel,
                    "tol": TOL_NEW["band"], "finite": dx_finite},
    }
    spatial["ok"] = (spatial["nll_monotone"] and rms_err < 0.05 and math.isfinite(rms_err)
                     and fit_launches == SPATIAL_STEPS and grad_launches == SPATIAL_STEPS
                     and plain_diags_err <= 1e-5 and plain_nll_rel <= 1e-5
                     and dx_launches["banded_matvec"] == 2
                     and dx_launches["band_gradient"] == 0 and not transposes and dx_finite
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
    # kernel 3 at the tail of the moments finalize: the carried 1,023 rows
    # zero-extended by w - 1 = 63 (1,086 rows), 960 valid starts, w = 64
    ys_tail = [(wsr.extend_rows(series[(i + 1) * CHUNK - CARRY: (i + 1) * CHUNK],
                                CARRY + WINDOWS[0] - 1).contiguous(), mom_tail[1], 0, (WINDOWS[0],))
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
        "fused_lag_moments_tail": [ws.prepare_fused_lag_moments(y, m, h, w)
                                   for y, m, h, w in ys_tail],
        "segment_dft_power": [sd.prepare_segment_power(s, taper, True) for s in segs],
    }
    wrappers = {
        "fused_plan_megakernel": (fp.fused_plan_update, fpr.fused_plan_update_ref, ys_mega),
        "cross_window_stats": (ws.masked_lagged_sums, wsr.masked_lagged_sums_ref, ys_lag),
        "fused_lag_moments": (ws.fused_lagged_moments, wsr.fused_lag_moments_ref, ys_mom),
        "fused_lag_moments_tail": (ws.fused_lagged_moments, wsr.fused_lag_moments_ref, ys_tail),
        "segment_dft_power": (sd.segment_fft_power, sdr.segment_dft_power_ref,
                              [(s, taper) for s in segs]),
    }
    lagmom_operands = {name: [lag_moments_library_operands(y, m, w) for y, m, _, w in ys]
                       for name, ys in (("fused_lag_moments", ys_mom),
                                        ("fused_lag_moments_tail", ys_tail))}
    libraries = {"cross_window_stats": (lag_library, lag_operands),
                 "segment_dft_power": (rfft_power, [(s, taper) for s in segs]),
                 **{name: (lag_moments_library, ops) for name, ops in lagmom_operands.items()}}
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the library GEMM would not be full fp32")
    library_check = {
        "cross_window_stats": compare(lag_library(*lag_operands[0]).transpose(1, 2),
                                      wsr.cross_lagged_sums_ref(*lag_operands[0], H),
                                      TOL["lag"]),
        "segment_dft_power": compare(rfft_power(segs[0], taper),
                                     sdr.segment_dft_power_ref(segs[0], taper), TOL["psd"]),
    }
    for name, ys in (("fused_lag_moments", ys_mom), ("fused_lag_moments_tail", ys_tail)):
        y, m, _, w = ys[0]
        got = lag_moments_library(*lagmom_operands[name][0])
        want = wsr.fused_lag_moments_ref(y, m, 0, w)
        library_check[name] = parts_check(got, got, want, mega_tols, abs_moment_sums(y, m, w))
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
            "device_kernels_per_call": kernels_per_call(
                rotating(lambda f: f(), [(f,) for f in launches]), rot),
            "wrapper_ms": cuda_ms(rotating(fn, a), 40),
            "plain_ms": cuda_ms(rotating(plain, a), 8),
            "library_ms": cuda_ms(rotating(*lib), 40) if lib else None,
        }
    # the tail's launches are short: beside them, an empty kernel on the same
    # grid, cluster and shared memory, in a graph of as many launches
    empty = graph_ms([functools.partial(lag_moments_empty, p)
                      for p in prepared["fused_lag_moments_tail"]])
    timing["fused_lag_moments_tail"]["empty_launch_ms"] = empty[len(empty) // 2]
    timing["fused_lag_moments_tail"]["empty_launch_ms_samples"] = empty

    # Bounds from this run's inputs: the bytes the function must move (each
    # input read once, each output written once) and the fp32 operations it
    # needs (valid starts and segments only).  The power of a segment counts
    # a real FFT, 2.5 L log2 L, plus detrend, taper and |.|^2; the cost of
    # the kernels' own design is reported beside the bound, not in it.
    f4 = 4
    F = NPERSEG // 2 + 1
    fft_flops = 2.5 * NPERSEG * math.log2(NPERSEG) + 3 * NPERSEG + 3 * F
    # this design (the FFT path): a radix-4 butterfly costs 34 operations
    # (three complex twiddles, eight complex additions) for 4 complex points,
    # 8.5 L per stage and log4 L stages per pair of channels; then mean,
    # centring and taper (3 L) and the two-for-one split with |.|^2 (6 F)
    design_flops = 2.125 * NPERSEG * math.log2(NPERSEG) + 3 * NPERSEG + 6 * F
    n_mega = int(mega_chunk[1].sum().item())
    n_seg = int(fp.fused_plan_update(*mega_chunk)[3][0].item())
    rows_mom = CHUNK + CARRY
    mom_flops_rows = rows_mom * D * (1 + 4 * len(WINDOWS))
    mega_bytes = (rows_mom * D * f4 + CHUNK + NPERSEG * f4
                  + ((H + 1) * D * D + len(WINDOWS) * 2 * D + F * D) * f4)
    mega_lag_flops = n_mega * (H + 1) * D * D * 2
    n_lag = int(lag_chunk[1].sum().item())
    lag_bytes = (CHUNK + H) * D * f4 + CHUNK + (H + 1) * D * D * f4
    n_tail = int(mom_tail[1].sum().item())
    rows_tail = CARRY + WINDOWS[0] - 1
    S = segs[0].shape[0]
    seg_bytes = S * NPERSEG * D * f4 + NPERSEG * f4 + S * F * D * f4
    work = {  # (bytes, function flops, flops of this design)
        "fused_plan_megakernel": (mega_bytes,
                                  mega_lag_flops + mom_flops_rows + n_seg * D * fft_flops,
                                  mega_lag_flops + mom_flops_rows + n_seg * D * design_flops),
        "cross_window_stats": (lag_bytes, n_lag * (H + 1) * D * D * 2,
                               n_lag * (H + 1) * D * D * 2),
        "fused_lag_moments": lag_moments_work(rows_mom, CHUNK, int(mom_chunk[1].sum().item()),
                                              D, len(WINDOWS)),
        "fused_lag_moments_tail": lag_moments_work(rows_tail, CARRY, n_tail, D, 1),
        "segment_dft_power": (seg_bytes, S * D * fft_flops, S * D * design_flops),
    }
    bounds = {k: bound_ms(b, f) for k, (b, f, _) in work.items()}
    shapes = {
        "fused_plan_megakernel": f"y ({CHUNK + CARRY}, {D}), H={H}, windows={WINDOWS}, "
                                 f"welch {NPERSEG}/{OVERLAP}",
        "cross_window_stats": f"y ({CHUNK + H}, {D}), H={H}",
        "fused_lag_moments": f"y ({CHUNK + CARRY}, {D}), H=0, windows={WINDOWS}",
        "fused_lag_moments_tail": f"y ({rows_tail}, {D}), {n_tail} of {CARRY} starts, H=0, "
                                  f"window {WINDOWS[0]}",
        "segment_dft_power": f"segments ({S}, {NPERSEG}, {D})",
    }
    # kernels 5-7b at their paths' shapes: each operand exceeds the 50 MB L2
    # (1.07 GB series, 67 MB of segments, a 1.07 GB fit operand), so one
    # prepared launch replayed reads from device memory every time
    fit_x = torch.randn((SPATIAL_T - 1, SPATIAL_D), generator=gen, device=dev)
    fit_g = torch.randn((SPATIAL_T - 1, SPATIAL_D), generator=gen, device=dev)
    segs_c = csd_segs.contiguous()
    xt = centred.t().contiguous()[None]  # (1, d, n) for avg_pool1d
    csr, fit_xt = band_csr(fit_diags * band_valid(SPATIAL_D, SPATIAL_B, dev)), fit_x.t().contiguous()
    F = torch.nn.functional

    def pool_sums(w):
        return torch.stack([F.avg_pool1d(xt, w, 1) * w, F.avg_pool1d(xt * xt, w, 1) * w])

    def fft_csd(segs):
        f = torch.fft.rfft((segs - segs.mean(1, keepdim=True)) * taper[:, None], dim=1)
        return torch.einsum("sfi,sfj->sfij", f, f.conj())

    def unfold_gradient(g, x, b):
        """d diags as one contraction over the neighbourhoods of x."""
        return torch.einsum("nr,nrw->rw", g, F.pad(x, (b, b)).unfold(1, 2 * b + 1, 1))

    # the simulation's shape, 2,047 of the spatial path's 2,067 launches: one
    # right-hand side.  Timed cold, as the bytes bound assumes: a graph of
    # NRHS1_COPIES launches, each on its own copy of the diagonals and its
    # own row of x (115 MB in all, over the 50 MB L2), so every launch reads
    # device memory.  The simulation keeps its diagonals warm in L2 from step
    # to step: warm_ms replays one launch NRHS1_COPIES times, for comparison
    # only (no bound is stated for it); empty_launch_ms is an empty kernel on
    # the same grid in a graph of as many launches, the launch alone.
    nrhs1 = [bm.prepare_banded_matvec(fit_diags.clone(), fit_x[i: i + 1].contiguous())
             for i in range(NRHS1_COPIES)]
    valid_slots = int(band_valid(SPATIAL_D, SPATIAL_B, dev).sum())
    new_cases = {  # name: (prepared launches, wrapper call, plain call, library call, shape)
        "window_moments_w64": ([ws.prepare_window_moments(centred, 64)],
                               lambda: ws.windowed_moments(centred, 64),
                               lambda: wsr.window_moments_ref(centred, 64),
                               lambda: pool_sums(64), dict(n=n_total, d=D, w=64)),
        "window_moments": ([ws.prepare_window_moments(centred, 1024)],
                           lambda: ws.windowed_moments(centred, 1024),
                           lambda: wsr.window_moments_ref(centred, 1024),
                           lambda: pool_sums(1024), dict(n=n_total, d=D, w=1024)),
        "segment_csd": ([sd.prepare_segment_csd(segs_c, taper, True)],
                        lambda: sd.segment_csd(segs_c, taper),
                        lambda: sdr.segment_csd_ref(segs_c, taper),
                        lambda: fft_csd(segs_c),
                        dict(S=segs_c.shape[0], L=NPERSEG, d=D)),
        "banded_matvec": ([bm.prepare_banded_matvec(fit_diags, fit_x)],
                          lambda: bm.banded_matvec_rows(fit_diags, fit_x),
                          lambda: bmr.banded_matvec_ref(fit_diags, fit_x),
                          lambda: torch.sparse.mm(csr, fit_xt),
                          dict(m=SPATIAL_T - 1, d=SPATIAL_D, b=SPATIAL_B,
                               valid_slots=valid_slots)),
        "banded_matvec_nrhs_1": (nrhs1,
                                 lambda: bm.banded_matvec_rows(fit_diags, fit_x[:1]),
                                 lambda: bmr.banded_matvec_ref(fit_diags, fit_x[:1]),
                                 lambda: torch.sparse.mm(csr, fit_xt[:, :1]),
                                 dict(m=1, d=SPATIAL_D, b=SPATIAL_B, valid_slots=valid_slots)),
        "band_gradient": ([bm.prepare_band_gradient(fit_g, fit_x, SPATIAL_B)],
                          lambda: bm.band_gradient(fit_g, fit_x, SPATIAL_B),
                          lambda: bmr.band_gradient(fit_g, fit_x, SPATIAL_B),
                          lambda: unfold_gradient(fit_g, fit_x, SPATIAL_B),
                          dict(m=SPATIAL_T - 1, d=SPATIAL_D, b=SPATIAL_B,
                               valid_slots=valid_slots)),
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
        "band_gradient": {"max_rel_err": scaled_error(
            unfold_gradient(fit_g, fit_x, SPATIAL_B), bmr.band_gradient(fit_g, fit_x, SPATIAL_B),
            grad_scale(fit_g, fit_x, SPATIAL_B))[1]},
    })
    for name in ("window_moments", "segment_csd", "banded_matvec", "band_gradient"):
        library_check[name]["ok"] = library_check[name]["max_rel_err"] <= 1e-4
        if not library_check[name]["ok"]:
            fail("a library yardstick disagrees with the plain version", check=library_check)
    for name, (preps, wrapper, plain, lib, shape) in new_cases.items():
        samples = graph_ms([p.launch for p in preps])
        kernel = next(k for k in KERNEL_INFO if name.startswith(k))
        nbytes, flops, design = new_kernel_work(kernel, shape)
        b_ms, b_by = bound_ms(nbytes, flops)
        timing[name] = {
            "ms": samples[len(samples) // 2], "ms_samples": samples,
            # CUDA events around launches made from the host (the profiler
            # recorded none or a third of these launches in one run)
            "host_launch_ms": cuda_ms(preps[0].launch, 5, warmup=1),
            "wrapper_ms": cuda_ms(wrapper, 5, warmup=1),
            "plain_ms": cuda_ms(plain, 3, warmup=1),
            "library_ms": cuda_ms(lib, 3, warmup=1),
        }
        if len(preps) > 1:
            warm = graph_ms([preps[0].launch] * len(preps))
            timing[name]["warm_ms"], timing[name]["warm_ms_samples"] = warm[len(warm) // 2], warm
            empty = graph_ms([functools.partial(empty_launch, p) for p in preps])
            timing[name]["empty_launch_ms"] = empty[len(empty) // 2]
            timing[name]["empty_launch_ms_samples"] = empty
        bounds[name] = (b_ms, b_by)
        work[name] = (nbytes, flops, design)
        shapes[name] = ", ".join(f"{k}={v}" for k, v in shape.items())
        split[name] = None
    del new_cases, nrhs1, fit_x, fit_g, fit_xt, csr, segs_c, xt
    emit({"phase": "timing", "note": "main-path chunk shapes, cold series (8 rotating "
          "chunks); ms: median over repeats of a CUDA graph of the prepared launches "
          "(kernel and its reduction), ms_samples sorted; profiler_ms: profiler device "
          "time of the same launches made from the host; wrapper_ms, plain_ms, library_ms: "
          "CUDA events around back-to-back calls, host work included; "
          f"banded_matvec_nrhs_1: a graph of {NRHS1_COPIES} launches at one right-hand "
          "side, each on its own copy of the diagonals (cold, beyond the L2); "
          "fused_lag_moments_tail: kernel 3 at the moments finalize's tail, 8 rotating tails "
          "(278 KB each, within the L2 as after the collect that carries them); warm_ms: one "
          "launch replayed as often, the diagonals warm in L2 as in the simulation; "
          "empty_launch_ms: an empty kernel on the same grid, block and shared memory in a "
          "graph of as many launches (the launch alone; not a bound)",
          "kernels": {k: {**t, "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                          "share_of_bound": bounds[k][0] / t["ms"],
                          "gbytes": work[k][0] / 1e9, "function_gflop": work[k][1] / 1e9,
                          "design_gflop": work[k][2] / 1e9,
                          "design_ms_at_fp32_peak": work[k][2] / PEAK_FP32 * 1e3,
                          "shape": shapes[k], "device_ms_by_kernel": split[k]}
                      for k, t in timing.items()},
          "library_check": library_check,
          "library_calls": {"fused_lag_moments": "torch.mm(a^T, y[:n]) (a the masked head "
                                                 "rows) and torch.mm(C, torch.cat([y, y*y], 1)) "
                                                 "(C the window counts), fp32",
                            "window_moments": "F.avg_pool1d(x^T, w, 1) * w on x and on x^2 "
                                              "(two calls: no single call gives both sums)",
                            "segment_csd": "torch.fft.rfft of the detrended, tapered segments, "
                                           "then einsum('sfi,sfj->sfij', f, f.conj())",
                            "banded_matvec": "torch.sparse.mm(band as CSR, x^T) (x^T "
                                             "prepared once)",
                            "band_gradient": "torch.einsum('nr,nrw->rw', g, F.pad(x, (b, b))"
                                             ".unfold(1, 2b+1, 1))"}})

    # launches: each kernel's count from the run of its own path (the fused
    # plan for kernels 1-4, the spatial fit with its simulation for 7, the
    # fit for 7b,
    # rolling moments for 5, cross-spectra for 6); ms and bound of kernel 5
    # at w = 1024
    launches = {**counts, "banded_matvec": band_launches, "band_gradient": grad_launches,
                "window_moments": rolling_launches, "segment_csd": csd_launches}
    return {"parity": parity, "timing": timing, "bounds": bounds, "launches": launches}



# ------------------------------------------------------------- the store
def lag_library_stacked(a, b):
    """Kernel 2's S(h) for h = 0..H over a leading block axis as one fp32
    GEMM over an unfolded view, the lags stacked into the rows: (P, (H+1) d,
    n) @ (P, n, d) (PyTorch copies the overlapping view, H+1 times the
    blocks, before the GEMM); returns (P, H+1, d, d)."""
    P, n, d = a.shape
    rows = b.unfold(1, n, 1).reshape(P, -1, n)
    return torch.matmul(rows, a).view(P, -1, d, d).transpose(-1, -2)


def store_phase(args, dev) -> dict:
    """The overlapping block store at full width: the fused plan over
    ``SeriesFrame.from_sharded`` (one launch of kernel 1 for every block)
    against the chunk path's collect in the same call; a repeat bitwise;
    ``autocovariance_blocked`` (one launch of kernel 2) and
    ``StreamingEstimator.from_store``; an append (the store grows in place,
    bitwise a fresh placement; the collect after it walks the chunk only) and
    a replan over the grown store; a planted halo fault caught.  Times the
    collects (wall, device busy share), the batched launches of kernels 1
    and 2 over the blocks beside their plain and library versions and their
    bounds, and ``append_rows``.  Returns {"launches": the collect's launch
    counts, "kernels": the batched rows}."""
    from repro_torch import SeriesFrame, StreamingEstimator, TimeSeriesStore
    from repro_torch.core.estimators.spectral import hann_window
    from repro_torch.core.estimators.stats import (autocovariance_blocked, lag_sum_engine,
                                                   streaming_autocovariance)
    from repro_torch.core.overlap import OverlapSpec, make_overlapping_blocks
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
    from repro_torch.kernels.window_stats import ops as ws, ref as wsr

    started = time.perf_counter()
    n = args.chunks * CHUNK
    x = make_series(n, D, args.seed, dev)
    chunks = list(x.split(CHUNK))
    bad = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def collect_store(data):
        return declare_plan(SeriesFrame.from_sharded(data, block_size=STORE_BLOCK,
                                                     device=dev)).collect()

    def collect_chunks(chunk_list, extra=None):
        frame = declare_plan(SeriesFrame.from_chunks(chunk_list, device=dev))
        if extra is not None:
            extra(frame)
        return frame.collect()

    def members_vs(got, want, tols=MEMBER_TOL):
        out = {name: compare(got[name], want[name], tol,
                             same_nonfinite=name.startswith(("forecast", "anomaly")))
               for name, tol in tols.items()}
        out["welch_per_bin"] = power_bin_error(got["welch"][1], want["welch"][1], False)
        return out

    def others_zero(counts, allowed):
        return all(v == allowed.get(k, 0) for k, v in counts.items())

    # ---- the collect: the chunk path first (its yardstick), then the store
    collect_chunks(chunks[:2])  # warm-up of the chunk path's handles
    want, chunk_ms = timed(lambda: collect_chunks(chunks))
    frame = declare_plan(SeriesFrame.from_sharded(x, block_size=STORE_BLOCK, device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    got, store_ms = timed(frame.collect)
    counts = launch_counts()
    collect_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    counts_ok = others_zero(counts, STORE_COLLECT_LAUNCHES)
    members = members_vs(got, want)
    shapes_ok = (tuple(got["autocovariance"].shape) == (H + 1, D, D)
                 and int(got["moments"]["count"].item()) == n - WINDOWS[0] + 1
                 and int(got["moments_2"]["count"].item()) == n - WINDOWS[1] + 1)
    if not counts_ok:
        bad.append("collect launches")
    if not shapes_ok or not all(r["ok"] for r in members.values()):
        bad.append("collect members")

    # ---- a caller's store: geometry, repeats, busy share, device kernels
    store, placement_ms = timed(lambda: TimeSeriesStore.from_series(x, STORE_BLOCK, 0, CARRY,
                                                                    device=dev))
    spec = store.spec
    geometry = {"blocks": spec.num_blocks, "block_size": spec.block_size,
                "h_right": spec.h_right, "width": spec.padded_width,
                "replication_overhead": store.replication_overhead,
                "store_gbytes": store.blocks.numel() * 4 / 1e9,
                "lag_partials_gbytes": spec.num_blocks * (H + 1) * D * D * 4 / 1e9}
    again = collect_store(store)
    repeat, traverse_ms = timed(lambda: collect_store(store))
    repeat_ok = bitwise_equal(again, repeat) and bitwise_equal(again, got)
    if not repeat_ok:
        bad.append("repeat not bitwise")
    store_split, store_busy, store_wall = device_split(lambda: collect_store(store), calls=1)
    chunk_split, chunk_busy, chunk_wall = device_split(lambda: collect_chunks(chunks), calls=1)
    device_kernels = kernels_per_call(lambda: collect_store(store), 1)
    mega_device = {k: v for k, v in device_kernels.items() if "fused_plan_kernel" in k}
    if mega_device and list(mega_device.values()) != [1.0]:  # empty: no profiler activity
        bad.append("device launches of kernel 1 per collect")
    del again, repeat

    # ---- kernel 2 over the blocks: autocovariance_blocked, the streaming estimator
    reset_launch_counts()
    blocked = autocovariance_blocked(x, H, STORE_BLOCK)
    torch.cuda.synchronize()
    blocked_counts = launch_counts()
    streamed = StreamingEstimator.from_store(lag_sum_engine(H, D, device=dev), store,
                                             CHUNK).finalize(streaming_autocovariance)
    lag_checks = {"blocked_vs_collect": compare(blocked, got["autocovariance"], TOL["lag"]),
                  "streamed_vs_collect": compare(streamed, got["autocovariance"], TOL["lag"]),
                  "streamed_vs_blocked": compare(streamed, blocked, TOL["lag"])}
    blocked_ok = others_zero(blocked_counts, {"cross_window_stats": 1})
    if not blocked_ok:
        bad.append("autocovariance_blocked launches")
    if not all(r["ok"] for r in lag_checks.values()):
        bad.append("blocked / streamed autocovariance")
    del blocked, streamed

    # ---- batched kernel 1 over the blocks, with the planted halo fault
    P, B, K, F = spec.num_blocks, STORE_BLOCK, len(WINDOWS), NPERSEG // 2 + 1
    taper = hann_window(NPERSEG, dev)
    blocks = store.padded_blocks_single_host()
    bid = torch.arange(P, dtype=torch.int32, device=dev)
    mask = bid.long()[:, None] * B + torch.arange(B, device=dev) + CARRY + 1 <= n
    mega = (blocks, mask, bid * B, H, WINDOWS, (NPERSEG,), (STEP,), (taper,))
    prep = fp.prepare_fused_plan(*mega)
    got1 = prep.launch()
    want1 = fpr.fused_plan_update_ref(*mega)
    abs_mom = wsr.fused_lag_moments_ref(blocks.abs(), mask, 0, WINDOWS)[1]

    def mega_leaves(g1):
        return {"lag": (g1[0], want1[0], TOL["lag"], None),
                **moment_leaves("mom", g1[1], want1[1], abs_mom, TOL["moments"]),
                **power_leaves("psd", g1[2][0], want1[2][0], P),
                "n_seg": (g1[3][0], want1[3][0], None, None)}
    torch.cuda.synchronize()
    parity1 = tenant_parity(mega_leaves(got1))
    k = P // 2 - 1
    faulty = blocks.clone()
    faulty[k, B] = 0.0  # block k's first halo row: block k+1's first core row
    fault1 = tenant_parity(mega_leaves(fp.fused_plan_update(faulty, *mega[1:])))
    fault_store = TimeSeriesStore(blocks=faulty, spec=spec)
    faulted = collect_store(fault_store)
    clean = collect_store(store)
    fault = {"block": k, "row": B, "lag_per_block": fault1["lag"],
             "caught": not fault1["lag"]["ok"] and fault1["lag"]["tenant"] == k,
             "collect_vs_clean_max_abs": (faulted["autocovariance"]
                                          - clean["autocovariance"]).abs().max().item(),
             "collect_vs_chunk_path": compare(faulted["autocovariance"], want["autocovariance"],
                                              TOL["lag"])}
    del faulty, fault_store, faulted, clean
    if not all(r["ok"] for r in parity1.values()):
        bad.append("batched kernel 1 parity")
    if not fault["caught"]:
        bad.append("planted halo fault not caught")
    n_valid = int(mask.sum().item())
    n_seg = int(got1[3][0].sum().item())
    mrows = B + CARRY
    nbytes = (P * mrows * D * 4 + P * B + NPERSEG * 4
              + P * ((H + 1) * D * D + K * 2 * D + F * D) * 4)
    flops = (n_valid * (H + 1) * D * D * 2 + P * mrows * D * (1 + 4 * K)
             + n_seg * D * fft_flops(NPERSEG))
    del got1, abs_mom
    samples = graph_ms([prep.launch], replays=3, repeats=3)
    plain = event_ms(lambda: fpr.fused_plan_update_ref(*mega))
    del want1, prep
    rows = {}
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = samples[len(samples) // 2]
    rows["fused_plan_megakernel"] = {
        "ms": ms, "ms_samples": samples, "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
        "bytes": nbytes, "flops": flops, "plain_ms": plain[len(plain) // 2],
        "plain_ms_samples": plain, "library_ms": None, "parity": parity1,
        "shape": f"y ({P}, {mrows}, {D}), {n_valid} valid starts, H={H}, windows={WINDOWS}, "
                 f"welch {NPERSEG}/{OVERLAP}, {n_seg} segments"}

    # ---- batched kernel 2: the launch of autocovariance_blocked
    blocks16, _ = make_overlapping_blocks(x, OverlapSpec(n, B, 0, H))
    head = blocks16[:, :B].contiguous()  # the wrapper's masked head rows (all starts valid)
    prep2 = ws.prepare_cross_lagged_sums(head, blocks16, H)
    ones = torch.ones((P, B), dtype=torch.bool, device=dev)
    got2 = prep2.launch()
    want2 = wsr.masked_lagged_sums_ref(blocks16, ones, H)
    torch.cuda.synchronize()
    parity2 = tenant_parity({"lag": (got2, want2, TOL["lag"], None)})
    lib_parity2 = tenant_parity({"lag": (lag_library_stacked(head, blocks16), want2,
                                         TOL["lag"], None)})
    if not all(r["ok"] for r in parity2.values()):
        bad.append("batched kernel 2 parity")
    if not all(r["ok"] for r in lib_parity2.values()):
        bad.append("kernel 2 library yardstick")
    del got2, want2
    samples2 = graph_ms([prep2.launch], replays=5, repeats=3)
    plain2 = event_ms(lambda: wsr.masked_lagged_sums_ref(blocks16, ones, H))
    lib2 = event_ms(lambda: lag_library_stacked(head, blocks16))
    nbytes2 = P * (B + H) * D * 4 + P * (H + 1) * D * D * 4
    flops2 = P * B * (H + 1) * D * D * 2
    b2, by2 = bound_ms(nbytes2, flops2)
    ms2 = samples2[len(samples2) // 2]
    rows["cross_window_stats"] = {
        "ms": ms2, "ms_samples": samples2, "bound_ms": b2, "bound_by": by2, "share": b2 / ms2,
        "bytes": nbytes2, "flops": flops2, "plain_ms": plain2[len(plain2) // 2],
        "plain_ms_samples": plain2, "library_ms": lib2[len(lib2) // 2],
        "library_ms_samples": lib2, "parity": parity2, "library_parity": lib_parity2,
        "shape": f"blocks ({P}, {B + H}, {D}), H={H}, every start valid"}
    del blocks16, head, prep2, ones, blocks, mask, mega

    # ---- append: the store grows in place; the collect after it walks the chunk
    new = make_series(CHUNK, D, args.seed + 5, dev)
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    _, append_ms = timed(lambda: frame.append(new))
    append_counts = launch_counts()
    append_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    reset_launch_counts()
    after, after_ms = timed(frame.collect)
    after_counts = launch_counts()
    want_after = collect_chunks(chunks + [new])
    after_members = members_vs(after, want_after)
    _, rows_ms = timed(lambda: store.append_rows(new))  # a caller's store: grows
    capacity = store.blocks.shape[0]
    fresh = TimeSeriesStore.from_series(torch.cat([x, new]), B, 0, CARRY, device=dev)
    store_bitwise = (store.spec == fresh.spec
                     and torch.equal(store.padded_blocks_single_host(), fresh.blocks))
    del fresh
    _, steady_ms = timed(lambda: store.append_rows(new))  # in place, no growth
    reset_launch_counts()
    declare_replan(frame)
    replan, replan_ms = timed(frame.collect)
    replan_counts = launch_counts()
    tols = {**MEMBER_TOL, "moments_3": TOL["moments"], "forecast": TOL["fit"],
            "anomaly": TOL["fit"]}
    chunk_frame = declare_replan(declare_plan(SeriesFrame.from_chunks(chunks + [new],
                                                                      device=dev)))
    want_replan = chunk_frame.collect()
    radius = ma_radius(chunk_frame, "anomaly")
    del chunk_frame
    if radius >= 1.0:  # a diverging filter: its residuals are held by their fit only
        unheld = {k: replan["anomaly"].pop(k) for k in ("z", "score")}
        unheld_want = {k: want_replan["anomaly"].pop(k) for k in ("z", "score")}
    replan_members = members_vs(replan, want_replan, tols)
    replan_members["anomaly"]["ma_radius"] = radius
    if radius >= 1.0:
        replan_members["anomaly"]["residuals_unheld"] = compare(unheld, unheld_want, TOL["fit"],
                                                                same_nonfinite=True)
        replan["anomaly"].update(unheld)
    append_ok = (others_zero(append_counts, {"fused_plan_megakernel": 2})
                 and others_zero(after_counts, {k: v for k, v in STORE_COLLECT_LAUNCHES.items()
                                                if k != "fused_plan_megakernel"})
                 and all(r["ok"] for r in after_members.values()))
    replan_ok = (replan_counts["fused_plan_megakernel"] == 1
                 and all(r["ok"] for r in replan_members.values())
                 and tuple(replan["forecast"]["pred"].shape) == (STORE_HORIZON, D)
                 and tuple(replan["anomaly"]["z"].shape) == (CARRY, D))
    del want_replan
    if not append_ok:
        bad.append("append")
    if not store_bitwise or capacity < 2 * P:
        bad.append("append_rows")
    if not replan_ok:
        bad.append("replan")

    report = {
        "phase": "store", "samples_per_channel": n, "channels": D, "geometry": geometry,
        "launches": counts, "launches_ok": counts_ok,
        "device_kernels_per_collect": mega_device,
        "collect_ms": store_ms, "placement_ms": placement_ms, "traverse_ms": traverse_ms,
        "chunk_collect_ms": chunk_ms,
        "collect_peak_gbytes": collect_peak_gb,
        "samples_per_s": n * D / (store_ms / 1e3),
        "profiled_collect": {"wall_ms": store_wall, "device_busy_ms": store_busy,
                             "busy_share": store_busy / store_wall if store_wall else None,
                             "device_ms_by_kernel": store_split},
        "profiled_chunk_collect": {"wall_ms": chunk_wall, "device_busy_ms": chunk_busy,
                                   "busy_share": chunk_busy / chunk_wall if chunk_wall
                                   else None, "device_ms_by_kernel": chunk_split},
        "members": members, "shapes_ok": shapes_ok, "repeat_bitwise": repeat_ok,
        "autocovariance_blocked_launches": blocked_counts, "lag_checks": lag_checks,
        "planted_fault": fault,
        "append": {"ms": append_ms, "launches": append_counts, "collect_after_ms": after_ms,
                   "collect_after_launches": after_counts, "members": after_members,
                   "allocated_before_gbytes": before_gb, "peak_gbytes": append_peak_gb,
                   "append_rows_growth_ms": rows_ms, "append_rows_in_place_ms": steady_ms,
                   "capacity_blocks": capacity, "store_bitwise_fresh_placement": store_bitwise,
                   "ok": append_ok},
        "replan": {"ms": replan_ms, "launches": replan_counts, "members": replan_members,
                   "ok": replan_ok},
        "batched_kernels": rows,
        "tolerance": "members as main_path (vs the chunk path's collect); batched launches "
                     "block by block against the batched plain version (one-problem "
                     "tolerances); the planted fault must fail its block's lag check",
        "seconds": time.perf_counter() - started, "bad": bad}
    emit(report)
    if bad:
        fail("store phase", bad=bad)
    return {"launches": counts, "kernels": rows, "collect": got, "collect_ms": store_ms,
            "after": after, "replan": replan}


def results_bitwise(a, b) -> bool:
    """Two results (nests of tensors) bitwise alike, NaN included."""
    la, lb = leaves(a), leaves(b)
    return ([p for p, _ in la] == [p for p, _ in lb]
            and all(same_bits(x.cpu().numpy(), y.cpu().numpy())
                    for (_, x), (_, y) in zip(la, lb)))


def mesh_phase(args, dev, store) -> dict:
    """The distribution layer on a one-rank NCCL mesh (cut: the machine
    has one card), over the store phase's series and plan: (a)
    ``SeriesFrame.from_sharded(x, mesh=)`` collects bitwise the store
    phase's collect (kernel 1 once, ``psum_tree`` one collective), then an
    append and a replan; (b) ``TimeSeriesStore.from_series(..., mesh=)`` in
    both halo modes, ``map_reduce`` and ``sharded_window_map_reduce`` of a
    chunk kernel (kernel 2), exchange bitwise replicate and the one-device
    store; (c) ``autocovariance_sharded`` bitwise ``autocovariance_blocked``
    (kernel 2 once); (d) ``halo_exchange`` returning the zero-padded shard;
    (e) the store's DTensor blocks saved and restored with Shard(0)
    shardings, bitwise.  Times the mesh collect beside the store phase's,
    the exchange-mode stitch, ``psum_tree`` and the NCCL start.  Returns
    {"launches": the mesh collect's launch counts}."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch import SeriesFrame, TimeSeriesStore
    from repro_torch.checkpoint.manager import restore_pytree, save_pytree
    from repro_torch.core.backend import get_backend
    from repro_torch.core.estimators.stats import autocovariance_blocked, autocovariance_sharded
    from repro_torch.core.halo import halo_exchange
    from repro_torch.core.mapreduce import block_window_map_reduce, sharded_window_map_reduce
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import (collective_count, data_mesh, psum_tree,
                                      reset_collective_count)

    started = time.perf_counter()
    n = args.chunks * CHUNK
    x = make_series(n, D, args.seed, dev)  # the store phase's series
    bad = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def counted(fn):
        reset_launch_counts()
        reset_collective_count()
        out, ms = timed(fn)
        return out, ms, {k: v for k, v in launch_counts().items() if v}, collective_count()

    # no network on the card's machine: NCCL's bootstrap may find no
    # interface but the loopback, which one rank on one host needs
    ifname = os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh, mesh_ms = timed(lambda: data_mesh(1, 0, "file://" + os.path.join(tmp, "rdv")))
        # NCCL builds its communicator at the first collective
        _, first_ms = timed(lambda: psum_tree(torch.ones(1, device=dev), mesh))
        init = {"backend": dist.get_backend(), "mesh_ms": mesh_ms,
                "first_collective_ms": first_ms, "nccl_init_ms": mesh_ms + first_ms,
                "NCCL_SOCKET_IFNAME": ifname}
        if dist.get_backend() != "nccl":
            bad.append("backend")

        # ---- (a) the collect, an append, a replan
        frame = declare_plan(SeriesFrame.from_sharded(x, mesh=mesh, block_size=STORE_BLOCK,
                                                      device=dev))
        got, collect_ms, collect_counts, collect_coll = counted(frame.collect)
        collect_ok = (results_bitwise(got, store["collect"]) and collect_coll == 1
                      and collect_counts.get("fused_plan_megakernel") == 1)
        states = frame._states[0]
        stat_tree = (states.stat, states.sample_sum, torch.cat([states.head, states.tail]))
        psum_bytes = sum(t.numel() * t.element_size() for _, t in leaves(stat_tree))
        psum_samples = sorted(timed(lambda: psum_tree(stat_tree, mesh))[1] for _ in range(20))
        new = make_series(CHUNK, D, args.seed + 5, dev)  # the store phase's append
        after, after_ms, after_counts, after_coll = counted(lambda: frame.append(new).collect())
        # the append's two updates, then the collect's finalize tails
        after_ok = (results_bitwise(after, store["after"]) and after_coll == 0
                    and after_counts == {**STORE_COLLECT_LAUNCHES, "fused_plan_megakernel": 2})
        declare_replan(frame)
        replan, replan_ms, replan_counts, replan_coll = counted(frame.collect)
        radius = ma_radius(frame, "anomaly")
        want_replan = store["replan"]
        tols = {**MEMBER_TOL, "moments_3": TOL["moments"], "forecast": TOL["fit"],
                "anomaly": TOL["fit"]}
        held = {k: v for k, v in replan.items()}
        want_held = {k: v for k, v in want_replan.items()}
        if radius >= 1.0:  # a diverging filter: its residuals are held by their fit only
            held["anomaly"] = {k: v for k, v in replan["anomaly"].items()
                               if k not in ("z", "score")}
            want_held["anomaly"] = {k: v for k, v in want_replan["anomaly"].items()
                                    if k not in ("z", "score")}
        replan_members = {name: compare(held[name], want_held[name], tol,
                                        same_nonfinite=name.startswith(("forecast", "anomaly")))
                          for name, tol in tols.items()}
        # the blocks once more, then the append kept since the first collect
        replan_ok = (replan_coll == 1 and replan_counts.get("fused_plan_megakernel") == 3
                     and all(r["ok"] for r in replan_members.values()))
        for ok, name in ((collect_ok, "collect"), (after_ok, "append"), (replan_ok, "replan")):
            if not ok:
                bad.append(name)
        del frame, got, after, replan, held, want_held

        # ---- (b) mesh stores in both halo modes
        kern = lambda w: w[0] * w[-1]  # the products at lag CARRY, per channel
        be = get_backend(None, dev)
        chunk_kernel = lambda y, m: be.masked_lagged_sums(y, m, H)
        stores, sums = {}, {}
        for mode in ("replicate", "exchange"):
            stores[mode], place_ms = timed(lambda: TimeSeriesStore.from_series(
                x, STORE_BLOCK, 0, CARRY, mesh=mesh, halo_mode=mode, device=dev))
            sums[mode], ms, counts, coll = counted(lambda: stores[mode].map_reduce(kern))
            sums[mode + "_ms"], sums[mode + "_collectives"] = ms, coll
            sums[mode + "_placement_ms"] = place_ms
        local = stores["exchange"].blocks.to_local()
        stitched, stitch_ms = timed(lambda: stores["exchange"].padded_blocks_local(local))
        stitch = {"ms": stitch_ms, "gbytes": stitched.numel() * stitched.element_size() / 1e9,
                  "bitwise_replicate": torch.equal(stitched,
                                                   stores["replicate"].blocks.to_local())}
        del stitched, local
        one_device = TimeSeriesStore.from_series(x, STORE_BLOCK, 0, CARRY, device=dev)
        free_sum = one_device.map_reduce(kern)
        blocks = stores["replicate"].blocks
        swmr, swmr_ms, swmr_counts, swmr_coll = counted(lambda: sharded_window_map_reduce(
            None, blocks, stores["replicate"].spec, mesh, chunk_kernel=chunk_kernel))
        free_swmr = block_window_map_reduce(None, x, one_device.spec, chunk_kernel=chunk_kernel)
        del one_device
        store_ok = (torch.equal(sums["replicate"], sums["exchange"])
                    and torch.equal(sums["replicate"], free_sum)
                    and sums["replicate_collectives"] == sums["exchange_collectives"] == 1
                    and stitch["bitwise_replicate"] and torch.equal(swmr, free_swmr)
                    and swmr_coll == 1 and swmr_counts == {"cross_window_stats": 1}
                    and isinstance(blocks, DTensor)
                    and tuple(blocks.shape) == tuple(blocks.to_local().shape))
        if not store_ok:
            bad.append("mesh stores")

        # ---- (c) autocovariance_sharded: kernel 2 once
        st16 = TimeSeriesStore.from_series(x, STORE_BLOCK, 0, H, mesh=mesh, device=dev)
        acov, acov_ms, acov_counts, acov_coll = counted(lambda: autocovariance_sharded(
            st16.blocks, st16.spec, H, mesh))
        blocked = autocovariance_blocked(x, H, STORE_BLOCK)
        acov_ok = (torch.equal(acov, blocked) and acov_coll == 1
                   and acov_counts == {"cross_window_stats": 1})
        if not acov_ok:
            bad.append("autocovariance_sharded")
        del st16

        # ---- (d) halo_exchange at world 1: the zero-padded shard
        padded, halo_ms = timed(lambda: halo_exchange(x, 4, 5, mesh))
        halo_ok = (torch.equal(padded[4: 4 + n], x) and not padded[:4].any()
                   and not padded[4 + n:].any())
        if not halo_ok:
            bad.append("halo_exchange")
        del padded

        # ---- (e) elastic restore of the store's DTensor blocks
        ckdir = os.path.join(tmp, "ckpt")
        _, save_ms = timed(lambda: save_pytree({"blocks": blocks}, ckdir, 0))
        back, restore_ms = timed(lambda: restore_pytree(
            {"blocks": blocks}, ckdir, shardings={"blocks": (mesh, [Shard(0)])}))
        restore_ok = (isinstance(back["blocks"], DTensor)
                      and torch.equal(back["blocks"].to_local(), blocks.to_local()))
        if not restore_ok:
            bad.append("restore")
        del back, blocks, stores
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    report = {
        "phase": "mesh", "world": 1, "samples_per_channel": n, "channels": D, "init": init,
        "collect": {"ms": collect_ms, "store_phase_ms": store["collect_ms"],
                    "launches": collect_counts, "collectives": collect_coll,
                    "bitwise_store_phase": collect_ok},
        "psum_tree": {"bytes": psum_bytes, "ms_median": psum_samples[len(psum_samples) // 2],
                      "ms_samples": psum_samples},
        "append": {"ms": after_ms, "launches": after_counts, "collectives": after_coll,
                   "ok": after_ok},
        "replan": {"ms": replan_ms, "launches": replan_counts, "collectives": replan_coll,
                   "members": replan_members, "ma_radius": radius, "ok": replan_ok},
        "stores": {"map_reduce_ms": {m: sums[m + "_ms"] for m in ("replicate", "exchange")},
                   "placement_ms": {m: sums[m + "_placement_ms"]
                                    for m in ("replicate", "exchange")},
                   "exchange_stitch": stitch, "chunk_kernel_ms": swmr_ms,
                   "chunk_kernel_launches": swmr_counts, "ok": store_ok},
        "autocovariance_sharded": {"ms": acov_ms, "launches": acov_counts,
                                   "collectives": acov_coll, "bitwise_blocked": acov_ok},
        "halo_exchange": {"ms": halo_ms, "ok": halo_ok},
        "restore": {"save_ms": save_ms, "restore_ms": restore_ms, "bitwise": restore_ok},
        "tolerance": "bitwise against the store phase's collect and append, the one-device "
                     "store and autocovariance_blocked; the replan (the append replayed after "
                     "the walk, where the store phase scattered it) as the store phase's",
        "seconds": time.perf_counter() - started, "bad": bad}
    emit(report)
    if bad:
        fail("mesh phase", bad=bad)
    return {"launches": collect_counts}


# ---------------------------------------------------------- the session
class SessionSource:
    """Arrival batches of a session, tick by tick, made on the card from a
    seed: per tenant and channel a stable AR(1) (phi from 0.3 to 0.9), a
    period-50 sinusoid with a random phase and white noise; the AR state
    carries from one tick to the next.  With ``bins`` ((users,) ints) tenant
    i's sinusoid sits at bin bins[i] of a GATEWAY_NPERSEG-point segment
    instead.  Two sources of one seed give the same ticks."""

    def __init__(self, users: int, seed: int, dev, bins=None):
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(seed)
        self.users, self.dev, self.t = users, dev, 0
        self.bins = bins
        shape = (users, 1, SESSION_D)
        self.phi = 0.3 + 0.6 * torch.rand(shape, generator=self.g, device=dev)
        self.phase = torch.rand(shape, generator=self.g, device=dev) * (2 * math.pi)
        self.state = torch.zeros(shape, device=dev)

    def next(self) -> "torch.Tensor":
        rows = SESSION_ROWS
        x = torch.randn((self.users, rows, SESSION_D), generator=self.g, device=self.dev)
        a, shift = self.phi, 1
        while shift < rows:  # x_t += a^shift x_{t-shift}: the AR(1) as a log-step scan
            x = torch.cat([x[:, :shift], x[:, shift:] + a * x[:, :-shift]], 1)
            a, shift = a * a, shift * 2
        steps = torch.arange(1, rows + 1, device=self.dev, dtype=torch.float32)[None, :, None]
        x = x + self.phi ** steps * self.state
        self.state = x[:, -1:]
        if self.bins is None:
            t = torch.arange(self.t, self.t + rows, device=self.dev).remainder(50).float()
            x = x + torch.sin(t[None, :, None] * (2 * math.pi / 50) + self.phase)
        else:
            t = torch.arange(self.t, self.t + rows, device=self.dev).remainder(GATEWAY_NPERSEG)
            angle = (self.bins[:, None] * t[None, :]).remainder(GATEWAY_NPERSEG).float()
            wave = torch.sin(angle[:, :, None] * (2 * math.pi / GATEWAY_NPERSEG) + self.phase)
            x = x + GATEWAY_AMPLITUDE * wave
        x = x + 0.5 * torch.randn(x.shape, generator=self.g, device=self.dev)
        self.t += rows
        return x.contiguous()


def new_session(dev, users: int, **kw):
    from repro_torch import FrameSession

    sess = FrameSession(d=SESSION_D, num_users=users, device=dev, **kw)
    sess.autocovariance(SESSION_LAGS)
    sess.yule_walker(SESSION_YW)
    for w in SESSION_WINDOWS:
        sess.moments(w)
    sess.welch(nperseg=SESSION_WELCH[0], overlap=SESSION_WELCH[1])
    return sess


def session_compare(got, want, index=None) -> dict:
    """Every member of a session result against ``want`` (``index`` picks
    one tenant of a batched result), allclose-style: the worst
    |got - want| / (atol + rtol |want|) per member, at most 1, finite;
    counts exact."""
    out = {}
    for name, w in want.items():
        rtol, atol = SESSION_TOL[name.split("_2")[0]]
        g = got[name]
        worst, finite, exact = 0.0, True, True
        for (path, a), (_, b) in zip(leaves(g), leaves(w)):
            a = a if index is None else a[index]
            b = b.to(a.device)
            finite &= bool(torch.isfinite(a).all())
            if path.endswith("/count"):
                exact &= bool(torch.equal(a.float(), b.float()))
                continue
            ratio = (a.double() - b.double()).abs() / (atol + rtol * b.double().abs())
            worst = max(worst, ratio.max().item())
        out[name] = {"worst": worst, "ok": finite and exact and worst <= 1.0}
    return out


def session_ok(report: dict) -> bool:
    return all(v["ok"] for v in report.values())


def batched_results_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a), leaves(b)))


def profile_once(fn) -> tuple:
    """(device busy ms, wall ms, device ms by kernel, top 6) of one call of
    ``fn`` under torch.profiler; busy is 0 when the profiler records no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            split[ev.key[:60]] = us / 1e3
    top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:6])
    return sum(split.values()), wall, top


def fft_flops(L: int) -> float:
    """A segment's power per channel: a real FFT (2.5 L log2 L), detrend and
    taper (3 L), |.|^2 (3 F)."""
    return 2.5 * L * math.log2(L) + 3 * L + 3 * (L // 2 + 1)


def tenant_rel(got, want, scale=None, max_elems: int = 1 << 26) -> tuple:
    """(worst relative error, its tenant, all finite) of a batched leaf (B,
    ...) against ``want``, tenant by tenant: each tenant's max|got - want|
    over its own max|want| (normwise per tenant), or entry by entry over
    ``scale`` (broadcasting against ``got``, leading axis 1 or B).  An
    entry that matches exactly counts 0."""
    if tuple(got.shape) != tuple(want.shape):
        fail("shape mismatch", got=list(got.shape), want=list(want.shape))
    rows = max(1, max_elems // max(1, got[:1].numel()))
    worst, at, finite = 0.0, -1, True
    for i in range(0, got.shape[0], rows):
        g, w = got[i: i + rows].double(), want[i: i + rows].double()
        diff = (g - w).abs().flatten(1)
        if scale is None:
            ref = w.abs().flatten(1).amax(1, keepdim=True)
        else:
            sc = scale if scale.shape[0] == 1 else scale[i: i + rows]
            ref = sc.double().expand_as(g).flatten(1)
        ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / ref).amax(1)
        k = int(ratio.argmax())
        if ratio[k].item() > worst or at < 0:
            worst, at = ratio[k].item(), i + k
        finite = finite and bool(torch.isfinite(got[i: i + rows]).all())
    return worst, at, finite


def tenant_parity(leaves_: dict) -> dict:
    """{leaf: (got, want, tol, scale or None; tol None: exact)} held tenant
    by tenant (:func:`tenant_rel`); reports each leaf's worst tenant."""
    out = {}
    for name, (g, w, tol, scale) in leaves_.items():
        if tol is None:
            out[name] = {"exact": bool(torch.equal(g, w)), "ok": bool(torch.equal(g, w))}
            continue
        rel, at, finite = tenant_rel(g, w, scale)
        out[name] = {"max_rel_err": rel, "tenant": at, "tol": tol, "finite": finite,
                     "ok": finite and rel <= tol}
    return out


def moment_leaves(tag: str, got, want, abs_mom, tol: float) -> dict:
    """Batched moment sums (B, K, 2, d) per window and moment, as
    :func:`compare_moment_sums` holds one problem's: each first-moment sum
    per channel against the same sum over |y|, each second-moment sum
    normwise per tenant."""
    out = {}
    for k in range(got.shape[1]):
        out[f"{tag}/w{k}/sum_y"] = (got[:, k, 0], want[:, k, 0], tol,
                                    abs_mom[:, k, 0].clamp_min(1e-30))
        out[f"{tag}/w{k}/sum_y2"] = (got[:, k, 1], want[:, k, 1], tol, None)
    return out


def power_leaves(tag: str, got, want, tenants: int) -> dict:
    """A batched power -- (B, F, d) summed over segments, or (B S, F, d) per
    segment -- held per tenant normwise (TOL["psd"]) and per bin
    (TOL_NEW["psd"]): each entry against the tenant's plain power at its
    (frequency, channel), averaged over the tenant's segments."""
    g, w = (t.reshape((tenants, -1) + tuple(t.shape[-2:])) for t in (got, want))
    return {f"{tag}/normwise": (g, w, TOL["psd"], None),
            f"{tag}/per_bin": (g, w, TOL_NEW["psd"], w.double().mean(1, keepdim=True))}


def event_ms(fn, samples: int = 5) -> list:
    """Device ms of single calls of ``fn`` (CUDA events), ``samples``
    samples after one warm-up call, sorted."""
    fn()
    return sorted(cuda_ms(fn, 1, warmup=0) for _ in range(samples))


def batched_kernel_times(dev, sess, last_chunk, query_ids) -> dict:
    """Kernels 1-4 in their batched launch form: kernels 1 and 3 at the
    session's ingest shape (the chunk and the merge boundary, every tenant;
    kernel 3 as a moments-only plan's chunk kernel), kernels 2, 3 and 4 at a
    batched query's tail corrections.  Each launch is held tenant by tenant
    against the batched plain version on the same inputs (the one-problem
    rows' tolerances), and must reject two planted faults in a middle
    tenant: its largest lag partial left out of its sum (where the CTAs
    write a tenant's sums directly -- kernel 3's batched path, one lag slab
    a tenant -- its largest lag left out), and its result read from its
    neighbour's slot.  ms: median of a CUDA graph
    of the prepared launch (with its reduction) replayed; bound from this
    run's inputs (each input read once, each output written once; valid
    starts and segments only); plain_ms and library_ms (a one-call PyTorch
    version, checked against the plain version first): median of single
    calls after a warm-up."""
    from repro_torch.core.estimators.spectral import hann_window
    from repro_torch.kernels.fused_plan import ops as fp, ref as fpr
    from repro_torch.kernels.fused_plan.ref import welch_candidates
    from repro_torch.kernels.segment_dft import ops as sd, ref as sdr
    from repro_torch.kernels.window_stats import ops as ws, ref as wsr

    f4, d, H = 4, SESSION_D, SESSION_LAGS
    L, step = SESSION_WELCH[0], SESSION_WELCH[0] - SESSION_WELCH[1]
    taper = hann_window(L, dev)
    carry = max(SESSION_WINDOWS) - 1
    K = len(SESSION_WINDOWS)
    F = L // 2 + 1
    out = {}
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the library GEMM would not be full fp32")

    def faults(prep, got, first, tenants):
        """The two planted faults in a copy of ``first`` (the launch's
        first output), each held by ``got``'s own leaves check."""
        m = tenants // 2
        planted = {}
        p = prep.params
        if prep.path == "batched" or (p.lag_ctas and p.lag_part == p.lag_out):
            # the CTAs wrote each tenant's sums (kernel 3's batched path, or
            # one lag slab a tenant): the tenant's largest lag left out
            j = int(first[m].flatten(1).abs().amax(1).argmax())
            bad = first.clone()
            bad[m, j] = 0.0
            planted["lag_left_out"] = bad
        elif p.lag_ctas:  # the launch sums lag partials
            part = next(t for t in prep.keep if tuple(t.shape) == (
                tenants, p.lag_slabs, p.H + 1, p.d, p.d))
            j = int(part[m].flatten(1).abs().amax(1).argmax())
            bad = first.clone()
            bad[m] -= part[m, j]
            planted["partial_left_out"] = bad
        bad = first.clone()
        row = first.shape[0] // 2
        bad[row] = first[row + 1]
        planted["neighbour_slot"] = bad
        return {k: not all(r["ok"] for r in got(v).values()) for k, v in planted.items()}

    def record(name, prep, plain, leaves_of, tenants, nbytes, flops, shape, library=None,
               replays=5):
        """``leaves_of(result, want)`` -> the leaves for tenant_parity;
        the first output of the launch is the faults' target."""
        got = prep.launch()
        want = plain()
        torch.cuda.synchronize()
        parity = tenant_parity(leaves_of(got, want))
        first = got[0] if isinstance(got, tuple) else got

        def check(bad):
            return tenant_parity(leaves_of((bad,) + tuple(got[1:])
                                           if isinstance(got, tuple) else bad, want))
        caught = faults(prep, check, first, tenants)
        lib = None
        if library is not None:
            lib_parity = tenant_parity(leaves_of(library(), want))
            if not all(r["ok"] for r in lib_parity.values()):
                fail("a batched library yardstick disagrees with the plain version",
                     kernel=name, check=lib_parity)
            lib = event_ms(library)
        del got, want
        samples = graph_ms([prep.launch], replays=replays, repeats=3)
        b_ms, b_by = bound_ms(nbytes, flops)
        ms = samples[len(samples) // 2]
        plain_samples = event_ms(plain)
        out[name] = {"ms": ms, "ms_samples": samples, "bound_ms": b_ms, "bound_by": b_by,
                     "share": b_ms / ms, "bytes": nbytes, "flops": flops,
                     "plain_ms": plain_samples[len(plain_samples) // 2],
                     "plain_ms_samples": plain_samples,
                     "library_ms": lib[len(lib) // 2] if lib else None,
                     "library_ms_samples": lib, "shape": shape, "tenants": tenants,
                     "parity": parity, "faults_caught": caught,
                     "ok": all(r["ok"] for r in parity.values()) and all(caught.values())}

    # kernel 1: the chunk of an ingest tick and its merge boundary, every tenant
    users, rows = last_chunk.shape[:2]
    z0 = torch.full((users,), (SESSION_TICKS - 1) * rows, dtype=torch.int32, device=dev)
    y = torch.cat([last_chunk, last_chunk.new_zeros((users, carry, d))], 1)
    starts = torch.arange(rows, device=dev)
    cases = {"fused_plan_megakernel": (y, (starts <= rows - carry - 1).expand(users, rows)
                                       .contiguous(), z0),
             "fused_plan_megakernel_boundary": (
                 y[:, rows - carry: rows + carry].contiguous(),
                 (torch.arange(carry, device=dev) + carry + 1 <= 2 * carry).expand(
                     users, carry).contiguous(), z0 + rows - carry)}
    for name, (yy, mask, zz) in cases.items():
        args = (yy, mask, zz, H, SESSION_WINDOWS, (L,), (step,), (taper,))
        abs_mom = wsr.fused_lag_moments_ref(yy.abs(), mask, 0, SESSION_WINDOWS)[1]
        # kernel 3 at the same chunk (or merge boundary): a moments-only plan's
        # chunk kernel, whose one family is kernel 3 at H = 0
        mrows = mask.shape[1] + carry
        valid = int(mask.sum().item())
        lib = lag_moments_library_operands(yy, mask, SESSION_WINDOWS)
        nbytes, flops, _ = lag_moments_work(mrows, mask.shape[1], 0, d, K)
        record(name.replace("fused_plan_megakernel", "fused_lag_moments_chunk")
               .replace("chunk_boundary", "boundary"),
               ws.prepare_fused_lag_moments(yy, mask, 0, SESSION_WINDOWS),
               lambda yy=yy, mask=mask: wsr.fused_lag_moments_ref(yy, mask, 0, SESSION_WINDOWS),
               lambda got, want, abs_mom=abs_mom: {
                   "lag": (got[0], want[0], TOL["lag"], None),
                   **moment_leaves("mom", got[1], want[1], abs_mom, TOL["moments"])},
               users, users * nbytes, users * flops + valid * d * (d + 1),
               f"y ({users}, {mrows}, {d}), H=0, windows={SESSION_WINDOWS}, {valid} valid "
               f"starts (a moments-only plan)", library=lambda lib=lib: lag_moments_library(*lib),
               replays=3)
        del lib

        def mega_leaves(got, want, abs_mom=abs_mom):
            return {"lag": (got[0], want[0], TOL["lag"], None),
                    **moment_leaves("mom", got[1], want[1], abs_mom, TOL["moments"]),
                    **power_leaves("psd", got[2][0], want[2][0], users),
                    "n_seg": (got[3][0], want[3][0], None, None)}
        n_valid = int(mask.sum().item())
        n_seg = int(fp.fused_plan_update(*args)[3][0].sum().item())
        mrows = mask.shape[1] + carry
        nbytes = (users * mrows * d * f4 + mask.numel() + L * f4
                  + users * ((H + 1) * d * d + K * 2 * d + F * d) * f4)
        flops = (n_valid * (H + 1) * d * d * 2 + users * mrows * d * (1 + 4 * K)
                 + n_seg * d * fft_flops(L))
        record(name, fp.prepare_fused_plan(*args), lambda: fpr.fused_plan_update_ref(*args),
               mega_leaves, users, nbytes, flops,
               f"y ({users}, {mrows}, {d}), H={H}, windows={SESSION_WINDOWS}, "
               f"welch {L}/{SESSION_WELCH[1]}, {n_valid} valid starts", replays=3)
        del args, abs_mom
    del y, cases

    # kernels 2, 3, 4: the tail corrections of a batched query
    states = sess.partials_batch(query_ids)
    if len(states) != 1:
        fail("the session's requests compiled to more than one plan group", groups=len(states))
    state = states[0]
    tail, B = state.tail, len(query_ids)
    rows_t = torch.arange(carry, device=dev)
    ones = torch.ones((B, carry), dtype=torch.bool, device=dev)
    ext = torch.nn.functional.pad(tail, (0, 0, 0, H)).contiguous()
    record("cross_window_stats", ws.prepare_cross_lagged_sums(tail.contiguous(), ext, H),
           lambda: wsr.masked_lagged_sums_ref(tail, ones, H),
           lambda got, want: {"lag": (got, want, TOL["lag"], None)}, B,
           B * ((carry + H) * d + carry * d + (H + 1) * d * d) * f4,
           B * carry * (H + 1) * d * d * 2, f"tail ({B}, {carry}, {d}), H={H}",
           library=lambda: lag_library(tail, ext).transpose(-1, -2))
    w = SESSION_WINDOWS[0]
    mask = ((rows_t >= carry - state.length[:, None]) & (rows_t <= carry - w)).contiguous()
    y3 = torch.nn.functional.pad(tail, (0, 0, 0, w - 1)).contiguous()
    abs3 = wsr.fused_lag_moments_ref(y3.abs(), mask, 0, (w,))[1]
    lib3 = lag_moments_library_operands(y3, mask, (w,))
    valid = int(mask.sum().item())
    nbytes, flops, _ = lag_moments_work(carry + w - 1, carry, 0, d, 1)
    record("fused_lag_moments", ws.prepare_fused_lag_moments(y3, mask, 0, (w,)),
           lambda: wsr.fused_lag_moments_ref(y3, mask, 0, (w,)),
           lambda got, want: {"lag": (got[0], want[0], TOL["lag"], None),
                              **moment_leaves("mom", got[1], want[1], abs3, TOL["moments"])},
           B, B * nbytes, B * flops + valid * d * (d + 1),
           f"tail ({B}, {carry + w - 1}, {d}), H=0, window {w}, {valid} valid starts",
           library=lambda: lag_moments_library(*lib3))
    del abs3, lib3
    wmask = (rows_t >= carry - state.length[:, None]) & (rows_t <= carry - L)
    wins, ok = welch_candidates(tail, wmask, state.t0 + state.length - carry, L, step)
    segs = wins.reshape(-1, L, d).contiguous()
    n_seg = int(ok.sum().item())
    record("segment_dft_power", sd.prepare_segment_power(segs, taper, True),
           lambda: sdr.segment_dft_power_ref(segs, taper),
           lambda got, want: power_leaves("psd", got, want, B), B,
           n_seg * L * d * f4 + L * f4 + n_seg * F * d * f4, n_seg * d * fft_flops(L),
           f"segments ({segs.shape[0]}, {L}, {d}), {n_seg} valid",
           library=lambda: rfft_power(segs, taper))
    return out


def session_phase(args, dev) -> dict:
    """The multi-tenant session at 65,536 tenants (growing) and 16,384
    (eviction): launches per tick and per query, parity of sampled tenants
    with per-user frames and the plain session, the retained window,
    repeatability, kill-and-restart, a planted NaN; times a tick, a batched
    query and kernels 1-4 in their batched form."""
    import numpy as np

    from repro_torch import SeriesFrame
    from repro_torch.core.integrity import sentinel_scan
    from repro_torch.kernels import launch_counts, path_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 18)
    users, rows = SESSION_USERS, SESSION_ROWS
    ids = np.arange(users)
    sample = np.sort(rng.choice(users, SESSION_SAMPLED, replace=False))
    sample_t = torch.as_tensor(sample, device=dev)
    checks, metrics = {}, {}

    # ---- growing session: 8 ticks, every tenant each tick
    sess = new_session(dev, users)
    plain = new_session(dev, SESSION_SAMPLED, backend="torch")
    src = SessionSource(users, args.seed, dev)
    kept, tick_ms, chunk = [], [], None
    reset_launch_counts()
    for tick in range(SESSION_TICKS):
        del chunk
        chunk = src.next()
        torch.cuda.synchronize()
        if tick == SESSION_TICKS - 1:  # the profiled tick
            busy, wall, top = profile_once(lambda: sess.ingest(ids, chunk))
            metrics["profiled_tick"] = {"device_busy_ms": busy, "wall_ms": wall,
                                        "busy_share": busy / wall, "by_kernel": top}
        else:
            t0 = time.perf_counter()
            sess.ingest(ids, chunk)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        part = chunk[sample_t]
        kept.append(part)
        plain.ingest(np.arange(SESSION_SAMPLED), part)
    counts = launch_counts()
    steady = sorted(tick_ms[1:])
    ms_tick = steady[len(steady) // 2]
    metrics.update({"ingest_ms_per_tick": ms_tick, "tick_ms": tick_ms,
                    "samples_per_s": users * rows / (ms_tick / 1e3),
                    "channel_values_per_s": users * rows * SESSION_D / (ms_tick / 1e3),
                    "launches": counts})
    checks["launches_per_tick"] = {
        "megakernel": counts["fused_plan_megakernel"], "ticks": SESSION_TICKS,
        "ok": counts["fused_plan_megakernel"] == 2 * SESSION_TICKS
        and all(v == 0 for k, v in counts.items() if k != "fused_plan_megakernel")}

    # ---- parity: sampled tenants against per-user frames and the plain session
    got_b = sess.query_batch(sample)
    plain_b = plain.query_batch(np.arange(SESSION_SAMPLED))
    parity = {"query": {}, "query_batch": {}, "plain_session": {}}
    for i, u in enumerate(sample):
        frame = SeriesFrame.from_chunks([k[i] for k in kept], device=dev)
        frame.autocovariance(SESSION_LAGS)
        frame.yule_walker(SESSION_YW)
        for w in SESSION_WINDOWS:
            frame.moments(w)
        frame.welch(nperseg=SESSION_WELCH[0], overlap=SESSION_WELCH[1])
        want = frame.collect()
        for key, rep in (("query", session_compare(sess.query(int(u)), want)),
                         ("query_batch", session_compare(got_b, want, i)),
                         ("plain_session", session_compare(plain_b, want, i))):
            for name, r in rep.items():
                cur = parity[key].setdefault(name, {"worst": 0.0, "ok": True})
                cur["worst"] = max(cur["worst"], r["worst"])
                cur["ok"] &= r["ok"]
    checks["parity"] = {**parity, "tenants": sample.tolist(),
                        "ok": all(session_ok(v) for v in parity.values())}
    del plain, plain_b, kept, got_b

    # ---- a batched query of 4,096 tenants: launches as a one-tenant query's;
    # kernel 3 on its batched path for the batch, its symmetric one for one
    query_ids = np.sort(rng.choice(users, SESSION_QUERY, replace=False))
    per_query, k3_paths = {}, {}
    for label, q in (("batch", query_ids), ("one", query_ids[:1])):
        reset_launch_counts()
        sess.query_batch(q)
        torch.cuda.synchronize()
        per_query[label] = launch_counts()
        k3_paths[label] = path_counts()["fused_lag_moments"]
    metrics["query_batch_ms"] = cuda_ms(lambda: sess.query_batch(query_ids), 5, warmup=1)
    metrics["query_batch_tenants"] = SESSION_QUERY
    busy, wall, top = profile_once(lambda: sess.query_batch(query_ids))
    metrics["profiled_query"] = {"device_busy_ms": busy, "wall_ms": wall,
                                 "busy_share": busy / wall, "by_kernel": top}
    want_q = {"cross_window_stats": 2, "fused_lag_moments": 1, "segment_dft_power": 1,
              "fused_plan_megakernel": 0}
    checks["launches_per_query"] = {
        **per_query, "fused_lag_moments_paths": k3_paths,
        "ok": per_query["batch"] == per_query["one"]
        and all(per_query["batch"][k] == v for k, v in want_q.items())
        and k3_paths == {"batch": {"sym": 0, "batched": 1, "two_role": 0},
                         "one": {"sym": 1, "batched": 0, "two_role": 0}}}

    # ---- repeatability: the same ticks into a second session, bitwise
    again = new_session(dev, users)
    src2 = SessionSource(users, args.seed, dev)
    for _ in range(SESSION_TICKS):
        again.ingest(ids, src2.next())
    lanes_a = sess.state_template()["group_0"]["lanes"].flatten()
    lanes_b = again.state_template()["group_0"]["lanes"].flatten()
    checks["repeatable"] = {"ok": all(torch.equal(a, b) for a, b in zip(lanes_a, lanes_b))}
    del again, src2, lanes_a, lanes_b

    # ---- kill and restart: export, import into a fresh session, bitwise
    snap = sess.export_state()
    fresh = new_session(dev, users)
    fresh.import_state(snap)
    del snap
    checks["restart"] = {"ok": batched_results_equal(sess.query_batch(query_ids),
                                                     fresh.query_batch(query_ids))}
    del fresh
    gc.collect()

    # ---- kernels 1-4 in their batched form, at the session's shapes
    kernels = batched_kernel_times(dev, sess, chunk, query_ids)
    checks["batched_kernels"] = {"bad": [k for k, v in kernels.items() if not v["ok"]],
                                 "ok": all(v["ok"] for v in kernels.values())}
    del sess, chunk, src
    gc.collect()
    torch.cuda.empty_cache()

    # ---- eviction session: the ring wraps; one tenant poisoned at the end
    ev_users = EVICT_USERS
    ev_ids = np.arange(ev_users)
    ev_sample = np.sort(rng.choice(ev_users, EVICT_SAMPLED, replace=False))
    ev = new_session(dev, ev_users, window=EVICT_WINDOW, num_buckets=EVICT_BUCKETS)
    src = SessionSource(ev_users, args.seed + 1, dev)
    kept = []
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(EVICT_TICKS):
        chunk = src.next()
        ev.ingest(ev_ids, chunk)
        kept.append(chunk[torch.as_tensor(ev_sample, device=dev)])
    torch.cuda.synchronize()
    metrics["eviction_ms_per_tick"] = (time.perf_counter() - t0) * 1e3 / EVICT_TICKS
    ev_counts = launch_counts()
    retained = ev.retained_lengths()
    start = EVICT_TICKS * rows - EVICT_WINDOW
    plan = ev.plan
    ev_b = ev.query_batch(ev_sample)
    ev_par = {"query": {}, "query_batch": {}}
    for i, u in enumerate(ev_sample):
        x = torch.cat([k[i] for k in kept], 0)[start:]
        want = plan.finalize(plan.from_chunk(x, t0=start), cache=False)
        for key, rep in (("query", session_compare(ev.query(int(u)), want)),
                         ("query_batch", session_compare(ev_b, want, i))):
            for name, r in rep.items():
                cur = ev_par[key].setdefault(name, {"worst": 0.0, "ok": True})
                cur["worst"] = max(cur["worst"], r["worst"])
                cur["ok"] &= r["ok"]
    checks["eviction"] = {
        **ev_par, "retained": int(retained.min().item()),
        "megakernel": ev_counts["fused_plan_megakernel"],
        "ok": bool((retained == EVICT_WINDOW).all().item())
        and ev_counts["fused_plan_megakernel"] == 2 * EVICT_TICKS
        and all(session_ok(v) for v in ev_par.values())}
    del kept, ev_b

    victim = int(rng.integers(ev_users))
    chunk = src.next()
    chunk[victim, SESSION_ROWS // 2, 3] = float("nan")
    verdict, _ = sentinel_scan(chunk)
    ev.ingest(ev_ids, chunk)  # unsanitized: the victim's lane is poisoned
    healthy = ev.audit()
    lane_mask = ev.lane_health
    bucket = (EVICT_TICKS * rows // (EVICT_WINDOW // EVICT_BUCKETS)) % EVICT_BUCKETS
    checks["planted_nan"] = {
        "victim": victim, "scan_flags": np.flatnonzero(~verdict).tolist(),
        "audit_flags": np.flatnonzero(~healthy).tolist(),
        "lanes_flagged": [list(map(int, ij)) for ij in zip(*np.nonzero(~lane_mask))],
        "ok": np.flatnonzero(~verdict).tolist() == [victim]
        and np.flatnonzero(~healthy).tolist() == [victim]
        and [tuple(map(int, ij)) for ij in zip(*np.nonzero(~lane_mask))] == [(bucket, victim)]}
    del ev, src, chunk

    metrics["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    emit({"phase": "session", "device": torch.cuda.get_device_name(0),
          "growing": {"tenants": users, "d": SESSION_D, "rows_per_tick": rows,
                      "ticks": SESSION_TICKS},
          "eviction": {"tenants": ev_users, "window": EVICT_WINDOW, "buckets": EVICT_BUCKETS,
                       "ticks": EVICT_TICKS},
          "metrics": metrics, "checks": checks})
    emit({"phase": "session_kernels", "note": "kernels 1-4 in their batched launch form: "
          "kernel 1 at an ingest tick of every tenant (chunk and merge boundary), kernel 3 "
          "also there as a moments-only plan's chunk kernel (its batched path), kernels "
          "2-4 at a batched query's tail corrections; each held tenant by tenant against "
          "the batched plain version (one-problem tolerances), with two planted faults "
          "caught; ms: median of a CUDA graph of the prepared launch and its reduction; "
          "bound from this run's inputs; plain_ms, library_ms: median of single calls "
          "after a warm-up (CUDA events)",
          "kernels": kernels})
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        fail("session checks failed", failed=bad)
    return {"kernels": kernels, "metrics": metrics}


# ---------------------------------------------------------- the gateway
def new_gateway_session(dev, users: int, **kw):
    """The session phase's plan plus the gateway's forecast and anomaly
    members (GATEWAY_* below)."""
    sess = new_session(dev, users, **kw)
    sess.forecast(GATEWAY_HORIZON, "ar", p=P_YW)
    sess.forecast(GATEWAY_HORIZON, "auto", p=4, max_period=GATEWAY_MAX_PERIOD)
    sess.anomaly_scores("arma", p=2, q=1)
    return sess


def same_bits(a, b) -> bool:
    """Bitwise equality of two host arrays (NaN included)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                        b.view(np.uint8))


def stacked_answers(answers: list) -> dict:
    """{leaf path: the waiters' leaves stacked} of a list of per-tenant
    answers (host numpy trees)."""
    per = [dict(leaves(a)) for a in answers]
    return {p: np.stack([d[p] for d in per]) for p in per[0]}


def answers_equal(answers: list, want) -> bool:
    """The waiters' answers bitwise ``want``: a batched host result, its
    tenants in the waiters' order, or another list of answers."""
    got = stacked_answers(answers)
    ref = stacked_answers(want) if isinstance(want, list) else dict(leaves(want))
    return set(got) == set(ref) and all(same_bits(got[p], ref[p]) for p in ref)


def tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, fn) for v in tree)
    return fn(tree)


def forecast_leaf_error(got, want) -> tuple:
    """(normwise error over the entries where ``want`` is finite, whether
    the non-finite entries match exactly, how many there are) of two host
    arrays."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(w)
    same = (np.array_equal(np.isfinite(g), fin) and np.array_equal(np.isnan(g), np.isnan(w))
            and np.array_equal(g[np.isinf(w)], w[np.isinf(w)]))
    if not fin.any():
        return 0.0, same, int((~fin).sum())
    g, w = np.where(fin, g, 0.0), np.where(fin, w, 0.0)
    diff, ref = np.abs(g - w).max(), np.abs(w).max()
    return (diff / ref if ref > 0 else diff), same, int((~fin).sum())


def gateway_compare(got: dict, want: dict, diverging=()) -> dict:
    """One tenant's gateway answer (host numpy) against its per-tenant frame
    (tensors): statistics as ``session_compare`` (the reference tests'
    tolerances); forecast and anomaly leaves normwise at TOL["fit"] with
    their non-finite entries held exactly, ``period`` and ``valid``
    exactly.  The residuals (``z``, ``score``) of a member in ``diverging``
    (its fitted MA part not invertible: see ``ma_radius``) are reported,
    not held."""
    out = {}
    for name, w in want.items():
        if not name.startswith(("forecast", "anomaly")):
            g = tree_to(got[name], lambda v: torch.from_numpy(np.asarray(v)))
            rep = session_compare({name: g}, {name: tree_to(w, lambda v: v.cpu())})
            out[name] = rep[name]
            continue
        worst, ok, nonfinite, unheld = 0.0, True, 0, 0.0
        for key, wv in w.items():
            wv = wv.cpu().numpy()
            if key in ("period", "valid"):
                ok &= same_bits(np.asarray(got[name][key]), wv)
                continue
            err, same, off = forecast_leaf_error(got[name][key], wv)
            nonfinite += off
            if name in diverging and key in ("z", "score"):
                unheld = max(unheld, err)
                continue
            worst = max(worst, err)
            ok &= same and err <= TOL["fit"]
        out[name] = {"worst": worst, "nonfinite": nonfinite, "ok": bool(ok),
                     "diverging": int(name in diverging), "unheld_worst": unheld}
    return out


def gateway_phase(args, dev) -> dict:
    """StatsGateway over the session phase's 65,536 tenants with forecast and
    anomaly members: every tenant submits a host chunk and 4,096 a query
    each tick.  Checks: launches a tick and a query (independent of the
    query's size), answers bitwise a twin session fed the same batches,
    sampled tenants against per-tenant frames on the plain backend, every
    planted period detected, kill and restart past a torn generation, and
    (at 4,096 tenants) a chaos-poisoned tenant quarantined, the others
    bitwise a fault-free run, the tenant rebuilt.  Times the tick by stage,
    a profiled tick's device time, the query with and without the forecast
    members, snapshots and the restore."""
    import asyncio
    import shutil
    import tempfile

    from repro_torch import SeriesFrame
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import chaos
    from repro_torch.serving.gateway import GatewayConfig, StatsGateway, _to_host

    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    rng = np.random.default_rng(args.seed + 20)
    users, rows = SESSION_USERS, SESSION_ROWS
    ids = np.arange(users)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 20)
    bins = torch.randint(GATEWAY_BINS[0], GATEWAY_BINS[1] + 1, (users,), generator=g,
                         device=dev)
    planted = np.round(GATEWAY_NPERSEG / bins.cpu().numpy()).astype(np.int32)
    query_ids = np.sort(rng.choice(users, GATEWAY_QUERY, replace=False))
    sample_pos = np.sort(rng.choice(GATEWAY_QUERY, GATEWAY_SAMPLED, replace=False))
    sample = query_ids[sample_pos]
    sample_t = torch.as_tensor(sample, device=dev)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    run = loop.run_until_complete
    ckdir = tempfile.mkdtemp(prefix="gateway_ckpt_")
    checks, metrics, bad = {}, {}, []
    try:
        cfg = GatewayConfig(max_pending_ingest=users, sentinel=True,
                            snapshot_every=GATEWAY_SNAPSHOT_EVERY, checkpoint_dir=ckdir)
        gw = StatsGateway(new_gateway_session(dev, users), cfg)
        twin = new_gateway_session(dev, users)
        base = new_session(dev, users)  # the same statistics without forecast members
        src = SessionSource(users, args.seed + 20, dev, bins=bins)
        per_query = {"cross_window_stats": 5, "fused_lag_moments": 1, "segment_dft_power": 2}
        per_tick = {**per_query, "fused_plan_megakernel": 2}
        kept, ticks, twin_equal, launches_ok = [], [], [], []
        snapshot_answers = last_answers = None
        torn = chaos.FaultInjector(seed=args.seed).corrupt("checkpoint.payload", calls={0})
        for tick in range(SESSION_TICKS):
            x = src.next()
            host = x.cpu().numpy()  # the clients' payloads
            kept.append(x[sample_t])
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            futs = [gw.submit_ingest(u, host[u]) for u in range(users)]
            qfuts = [gw.submit_query(int(u)) for u in query_ids]
            t1 = time.perf_counter()
            if tick == SESSION_TICKS - 1:
                chaos.install(torn)  # the tick's snapshot is torn on disk
            if tick == GATEWAY_PROFILED_TICK:
                held = []
                busy, wall, top = profile_once(lambda: held.append(run(gw.tick())))
                stats = held[0]
                metrics["profiled_tick"] = {"device_busy_ms": busy, "wall_ms": wall,
                                            "busy_share": busy / wall, "by_kernel": top}
            else:
                stats = run(gw.tick())
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            counts = launch_counts()
            write_ms = None
            if (tick + 1) % GATEWAY_SNAPSHOT_EVERY == 0:
                gw._loop_rt.manager.flush()  # the writer thread: crc32 and the write
                write_ms = (time.perf_counter() - t2) * 1e3
                chaos.clear()
            ok_fut = all(f.done() and f.exception() is None for f in futs)
            answers = [f.result() for f in qfuts]
            t3 = time.perf_counter()
            twin.ingest(ids, x)
            want = _to_host(twin.query_batch(query_ids))
            base.ingest(ids, x)
            twin_equal.append(ok_fut and answers_equal(answers, want))
            launches_ok.append(all(v == per_tick.get(k, 0) for k, v in counts.items()))
            if tick == GATEWAY_SNAPSHOT_EVERY - 1:
                snapshot_answers = want
            last_answers = answers
            ticks.append({"admission_ms": (t1 - t0) * 1e3, "tick_ms": (t2 - t1) * 1e3,
                          "split_ms": {k: v * 1e3 for k, v in stats["split"].items()},
                          "snapshot_write_ms": write_ms, "launches": counts,
                          "twin_check_ms": (time.perf_counter() - t3) * 1e3})
            del host, futs, qfuts, answers, want
        metrics["ticks"] = ticks
        steady = sorted(t["tick_ms"] + t["admission_ms"] for t in ticks[1:])
        metrics["tick_ms_median"] = steady[len(steady) // 2]
        metrics["gateway_metrics"] = {k: gw.metrics()[k] for k in ("ingest", "query",
                                                                   "batch_occupancy")}
        checks["launches_per_tick"] = {"want": per_tick, "ok": all(launches_ok)}
        checks["twin_bitwise"] = {"ticks": twin_equal, "ok": all(twin_equal)}
        # the default path wraps no circuit breaker: health() reports none
        checks["no_breaker"] = {"ok": "breaker" not in gw.health()}

        # ---- query-only ticks of 1 and 4,096 tenants: the same launches
        per_size = {}
        for label, q in (("one", query_ids[:1]), ("batch", query_ids)):
            reset_launch_counts()
            futs = [gw.submit_query(int(u)) for u in q]
            run(gw.tick())
            torch.cuda.synchronize()
            per_size[label] = launch_counts()
        checks["launches_per_query"] = {
            **per_size, "ok": per_size["one"] == per_size["batch"]
            and all(v == per_query.get(k, 0) for k, v in per_size["batch"].items())}

        # ---- sampled tenants against per-tenant frames on the plain backend
        final = stacked_answers(last_answers)
        parity = {}
        for i, u in enumerate(sample):
            series = torch.cat([k[i] for k in kept], 0)
            frame = SeriesFrame.from_array(series, backend="torch", device=dev)
            frame.autocovariance(SESSION_LAGS)
            frame.yule_walker(SESSION_YW)
            for w in SESSION_WINDOWS:
                frame.moments(w)
            frame.welch(nperseg=SESSION_WELCH[0], overlap=SESSION_WELCH[1])
            frame.forecast(GATEWAY_HORIZON, "ar", p=P_YW)
            frame.forecast(GATEWAY_HORIZON, "auto", p=4, max_period=GATEWAY_MAX_PERIOD)
            frame.anomaly_scores("arma", p=2, q=1)
            want = frame.collect()
            diverging = {"anomaly"} if ma_radius(frame, "anomaly") >= 1.0 else set()
            for name, r in gateway_compare(last_answers[sample_pos[i]], want, diverging).items():
                cur = parity.setdefault(name, {"worst": 0.0, "nonfinite": 0, "diverging": 0,
                                               "unheld_worst": 0.0, "ok": True})
                cur["worst"] = max(cur["worst"], r["worst"])
                cur["unheld_worst"] = max(cur["unheld_worst"], r.get("unheld_worst", 0.0))
                cur["nonfinite"] += r.get("nonfinite", 0)
                cur["diverging"] += r.get("diverging", 0)
                cur["ok"] &= r["ok"]
        checks["plain_parity"] = {"members": parity, "tenants": len(sample),
                                  "ok": all(v["ok"] for v in parity.values())}
        periods = final[("/forecast_2/period")]
        checks["periods"] = {"detected_right": int((periods == planted[query_ids]).sum()),
                             "tenants": GATEWAY_QUERY,
                             "ok": bool((periods == planted[query_ids]).all())}
        anomaly_finite = np.isfinite(final["/anomaly/score"]).all(1)
        metrics["anomaly_finite_tenants"] = int(anomaly_finite.sum())
        del kept, final, last_answers

        # ---- query cost with and without the forecast members
        metrics["query_batch_ms"] = cuda_ms(lambda: twin.query_batch(query_ids), 3, warmup=1)
        metrics["query_batch_ms_without_forecasts"] = cuda_ms(
            lambda: base.query_batch(query_ids), 3, warmup=1)
        merged = twin.partials_batch(query_ids)[0]
        group = twin.plan.groups[0]
        metrics["finalize_ms_by_member"] = {
            m.name: cuda_ms(lambda m=m: m.finalize(merged), 2, warmup=1) for m in group.members}
        del merged, base
        gc.collect()

        # ---- snapshot costs, then kill and restart past the torn generation
        export_t0 = time.perf_counter()
        snap = twin.export_state()
        export_ms = (time.perf_counter() - export_t0) * 1e3
        flat = ckpt._flatten(snap)
        crc_t0 = time.perf_counter()
        for leaf in flat.values():
            ckpt._checksum(leaf)
        crc_ms = (time.perf_counter() - crc_t0) * 1e3
        snap_bytes = sum(v.nbytes for v in flat.values())
        del snap, flat
        gw._loop_rt.manager.flush()
        run(gw.stop(final_snapshot=False))
        del gw
        gc.collect()
        steps = ckpt.list_steps(ckdir)
        restore_t0 = time.perf_counter()
        gw2 = StatsGateway(new_gateway_session(dev, users), cfg)
        restore_ms = (time.perf_counter() - restore_t0) * 1e3
        futs = [gw2.submit_query(int(u)) for u in query_ids]
        run(gw2.tick())
        restarted = [f.result() for f in futs]
        disk = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ckdir)
                   for f in fs)
        checks["restart"] = {
            "generations": steps, "restored_tick": gw2._tick - 2,
            "skipped": gw2._loop_rt.last_restore_skipped,
            "ok": gw2.counters["restored_from_snapshot"] == 1
            and gw2._loop_rt.last_restore_skipped == [SESSION_TICKS - 1]
            and gw2._tick == GATEWAY_SNAPSHOT_EVERY + 1
            and gw2.counters["programs_ingest"] == 0
            and answers_equal(restarted, snapshot_answers)}
        metrics["snapshot"] = {"export_ms": export_ms, "crc32_ms": crc_ms, "bytes": snap_bytes,
                               "tick_export_ms": ticks[GATEWAY_SNAPSHOT_EVERY - 1]["split_ms"]
                               ["snapshot"],
                               "write_ms": ticks[GATEWAY_SNAPSHOT_EVERY - 1]["snapshot_write_ms"],
                               "disk_bytes": disk, "restore_ms": restore_ms}
        run(gw2.stop(final_snapshot=False))
        del gw2, restarted, snapshot_answers, twin
        gc.collect()
        torch.cuda.empty_cache()

        # ---- chaos at CHAOS_USERS tenants: one tenant poisoned and rebuilt
        checks["chaos"] = gateway_chaos(args, dev, bins[:CHAOS_USERS], run, ckdir)
    finally:
        chaos.clear()
        loop.close()
        asyncio.set_event_loop(None)
        shutil.rmtree(ckdir, ignore_errors=True)

    metrics["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    metrics["phase_seconds"] = time.perf_counter() - started
    bad = [k for k, v in checks.items() if not v["ok"]]
    emit({"phase": "gateway", "device": torch.cuda.get_device_name(0),
          "tenants": users, "d": SESSION_D, "rows_per_tick": rows, "ticks": SESSION_TICKS,
          "queried": GATEWAY_QUERY, "sampled": GATEWAY_SAMPLED,
          "chaos_tenants": CHAOS_USERS, "metrics": metrics, "checks": checks})
    if bad:
        fail("gateway checks failed", failed=bad)
    return {"launches_per_tick": per_tick, "launches_per_query": per_query}


def gateway_chaos(args, dev, bins, run, ckdir) -> dict:
    """Check 6 at CHAOS_USERS tenants (a fault-free twin run is needed):
    ``ingest.payload`` NaN-poisons the victim's chunk at tick 2 under the
    ``quarantine`` policy; every other tenant's answers (CHAOS_QUERY each
    tick, then all of them) bitwise a fault-free run's; ``rebuild_tenant``
    restores the victim from the newest intact generation, bitwise a
    gateway that ingested only what that generation held (ticks 0 and 1)."""
    from repro_torch.runtime import chaos
    from repro_torch.serving.gateway import GatewayConfig, PoisonedChunk, StatsGateway

    users = CHAOS_USERS
    rng = np.random.default_rng(args.seed + 21)
    victim = int(rng.integers(users))
    others = np.setdiff1d(np.arange(users), [victim])
    qset = np.sort(rng.choice(others, CHAOS_QUERY, replace=False))

    def drive(faulty: bool, ticks: int):
        kw = dict(max_pending_ingest=users, sentinel=True, sentinel_policy="quarantine")
        if faulty:
            kw.update(snapshot_every=2, checkpoint_dir=os.path.join(ckdir, "chaos"))
        gw = StatsGateway(new_gateway_session(dev, users), GatewayConfig(**kw))
        src = SessionSource(users, args.seed + 21, dev, bins=bins)
        inj = chaos.FaultInjector(seed=args.seed).corrupt("ingest.payload",
                                                          calls={2 * users + victim})
        answers, rebuilt, victim_answer = [], None, None
        if faulty:
            chaos.install(inj)
        for t in range(ticks):
            host = src.next().cpu().numpy()
            if faulty and t == CHAOS_REBUILD_AT:
                rebuilt = gw.rebuild_tenant(victim)
                qf = gw.submit_query(victim)
                run(gw.tick())
                victim_answer = qf.result()
            futs = []
            for u in range(users):
                try:
                    futs.append(gw.submit_ingest(u, host[u]))
                except PoisonedChunk:
                    pass
            qfuts = [gw.submit_query(int(u)) for u in qset]
            run(gw.tick())
            rejected = [f for f in futs if f.exception() is not None]
            if rejected and not faulty:
                raise RuntimeError("a fault-free run rejected an ingest")
            answers.append([f.result() for f in qfuts])
        futs = [gw.submit_query(int(u)) for u in others]
        run(gw.tick())
        everyone = [f.result() for f in futs]
        chaos.clear()
        report = {"log": list(inj.log), "health": gw.health()["integrity"],
                  "rebuilt": rebuilt}
        run(gw.stop(final_snapshot=False))
        return answers, everyone, victim_answer, report

    faulty = drive(True, CHAOS_TICKS)
    clean = drive(False, CHAOS_TICKS)
    ticks_equal = [answers_equal(a, b) for a, b in zip(faulty[0], clean[0])]
    everyone_equal = answers_equal(faulty[1], clean[1])
    # what the rebuilt generation held: the victim's ticks 0 and 1
    gw = StatsGateway(new_gateway_session(dev, users),
                      GatewayConfig(max_pending_ingest=users, sentinel=True))
    src = SessionSource(users, args.seed + 21, dev, bins=bins)
    for _ in range(2):
        host = src.next().cpu().numpy()
        for u in range(users):
            gw.submit_ingest(u, host[u])
        run(gw.tick())
    qf = gw.submit_query(victim)
    run(gw.tick())
    want_victim = qf.result()
    run(gw.stop(final_snapshot=False))
    rep, rebuilt = faulty[3], faulty[3]["rebuilt"]
    victim_ok = faulty[2] is not None and answers_equal([faulty[2]], [want_victim])
    return {"victim": victim, "log": rep["log"], "health": rep["health"],
            "rebuilt": rebuilt, "ticks_bitwise": ticks_equal, "everyone_bitwise": everyone_equal,
            "victim_bitwise_generation": victim_ok,
            "ok": rep["log"] == [("ingest.payload", 2 * users + victim, "corrupt")]
            and rebuilt is not None and rebuilt["released"] and rebuilt["step"] == 3
            and rep["health"]["tenants_quarantined"] == 1 and rep["health"]["quarantined"] == []
            and all(ticks_equal) and everyone_equal and victim_ok}


def swa_kernel(args, dev) -> dict:
    """Phase 9: kernel 8 against the chunked plain version at the prefill's
    layer shape, lm_moe's, lm_mla's (q/k 192, v 128), lm_zamba's (112, G =
    1), lm_whisper's (64, G = 1), lm_llava's (128, G = 7) and one lm_tp
    rank's (128, G = 2), and over an edge grid with q/k and v of one width
    and of two (bf16 and f32), then timed at the seven layer shapes beside
    its bound, the plain version and SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.swa_attention import ops as sw, ref as swr

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 4)

    def qkv(b, s, h, kvh, d, dtype, dv=None):
        return tuple(torch.randn((b, s, n, w), generator=gen, device=dev).to(dtype)
                     for n, w in ((h, d), (kvh, d), (kvh, d if dv is None else dv)))

    def row_scale(q, k, v, window):
        return swr.swa_row_scale(v, window, q.shape[2])

    def rows_check(got, want, window):
        """(max, mean over the full-window rows) of the per-row norm error,
        and whether both are within their limits."""
        rows = row_norm_errors(got, want)
        worst, mean = rows.max().item(), rows[:, min(window, want.shape[1]) - 1:].mean().item()
        return worst, mean, worst <= SWA_ROW_TOL[want.dtype] and mean <= SWA_ROW_MEAN_TOL[want.dtype]

    def case(q, k, v, window, fault: bool = False, chunk: int = 512):
        tol, row_tol = SWA_TOL[q.dtype], SWA_ROW_TOL[q.dtype]
        got, again = sw.swa_attention(q, k, v, window), sw.swa_attention(q, k, v, window)
        torch.cuda.synchronize()
        want = swr.swa_attention_chunked(q, k, v, window, chunk=chunk)
        scale = row_scale(q, k, v, window)
        err, rel, finite = scaled_error(got, want, scale)
        worst, mean, rows_ok = rows_check(got, want, window)
        res = {"max_abs_err": err, "max_rel_err": rel, "tol": tol, "finite": finite,
               "row_norm_rel_err": worst, "row_norm_rel_err_full_window_mean": mean,
               "row_tol": row_tol, "row_mean_tol": SWA_ROW_MEAN_TOL[q.dtype],
               "bitwise_repeat": bool(torch.equal(got, again)),
               "planted_error_caught": planted_error_caught(got, want, scale, tol),
               "planted_row_error_caught": planted_row_error_caught(got, want, row_tol),
               "shape": list(got.shape)}
        res["ok"] = (finite and rel <= tol and rows_ok and res["bitwise_repeat"]
                     and res["planted_error_caught"] and res["planted_row_error_caught"])
        if fault:  # the kernel at W - SWA_FAULT held to the plain version at W
            bad = sw.swa_attention(q, k, v, window - SWA_FAULT)
            worst, mean, rows_ok = rows_check(bad, want, window)
            res["fault"] = {"window": window - SWA_FAULT,
                            "max_rel_err": scaled_error(bad, want, scale)[1],
                            "row_norm_rel_err": worst, "row_norm_rel_err_full_window_mean": mean,
                            "caught": not rows_ok}
            res["ok"] = res["ok"] and res["fault"]["caught"]
        return res

    full = qkv(SWA_B, SWA_S, SWA_H, SWA_KVH, SWA_D, torch.bfloat16)
    parity = {"layer_shape": case(*full, SWA_W, fault=True)}
    llama4 = qkv(*MOE_SWA, torch.bfloat16)  # lm_moe's prefill: W = S, G = 5
    parity["llama4_layer_shape"] = case(*llama4, MOE_SWA[1], fault=True)
    # lm_mla's prefill: q/k 192, v 128, G = 1, W = S (the plain version in
    # query chunks of MOE_PLAIN_CHUNK: 128 heads of (chunk x 8,000) logits)
    b, s, h, d, dv = MLA_SWA
    mla = qkv(b, s, h, h, d, torch.bfloat16, dv)
    parity["mla_layer_shape"] = case(*mla, s, fault=True, chunk=MOE_PLAIN_CHUNK)
    # lm_zamba's prefill: 32 heads of 112, G = 1, W = S (the (112, 112)
    # instantiation)
    b, s, h, d = ZAMBA_SWA
    zamba = qkv(b, s, h, h, d, torch.bfloat16)
    parity["zamba_layer_shape"] = case(*zamba, s, fault=True, chunk=ZAMBA_PLAIN_CHUNK)
    # lm_whisper's decoder prefill: 8 heads of 64, G = 1, W = S = 192 (the
    # (64, 64) instantiation); lm_llava's: 56 / 8 heads of 128, G = 7, W = S
    whisper = qkv(*WHISPER_SWA, torch.bfloat16)
    parity["whisper_layer_shape"] = case(*whisper, WHISPER_SWA[1], fault=True)
    llava = qkv(*LLAVA_SWA, torch.bfloat16)
    parity["llava_layer_shape"] = case(*llava, LLAVA_SWA[1], fault=True,
                                       chunk=LLAVA_PLAIN_CHUNK)
    # lm_tp's prefill on one model rank: 8 / 4 heads of 128, G = 2, W = S
    tp_qkv = qkv(*TP_SWA, torch.bfloat16)
    parity["tp_layer_shape"] = case(*tp_qkv, TP_SWA[1], fault=True)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for name, (s, w, g, d, *bk) in SWA_EDGE.items():
            b, kvh = bk or (1, 2)
            parity[f"{name}_{tag}"] = case(*qkv(b, s, kvh * g, kvh, d, dtype), w)
        for name, (s, w, g, d, dv) in SWA_EDGE_DV.items():
            parity[f"{name}_{tag}"] = case(*qkv(1, s, 2 * g, 2, d, dtype, dv), w)
    emit({"phase": "parity_swa_attention", "tolerance": "per entry: max|kernel - chunked "
          "plain| <= tol * the row's max|v| over its window; per output row: ||kernel - "
          "plain|| / ||plain|| <= row_tol, and <= row_mean_tol on average over the rows whose "
          "window is full; two launches bitwise equal; an error of 2 tol "
          "planted in one entry caught by each check; at the layer shape the kernel at "
          f"W - {SWA_FAULT} fails the row checks",
          "tol": {"bf16": SWA_TOL[torch.bfloat16], "f32": SWA_TOL[torch.float32]},
          "row_tol": {"bf16": SWA_ROW_TOL[torch.bfloat16], "f32": SWA_ROW_TOL[torch.float32]},
          "row_mean_tol": {"bf16": SWA_ROW_MEAN_TOL[torch.bfloat16],
                           "f32": SWA_ROW_MEAN_TOL[torch.float32]},
          "cases": parity})
    bad = [c for c, r in parity.items() if not r["ok"]]
    if bad:
        fail("kernel 8 parity", cases=bad)

    # timing at the layer shape (q 164 MB: it comes from device memory)
    q, k, v = full
    scale = SWA_D ** -0.5
    prep = sw.prepare_swa_attention(q, k, v, SWA_W, scale)
    samples = graph_ms([prep.launch])
    plain = swr.swa_attention_chunked(q, k, v, SWA_W)
    pos = torch.arange(SWA_S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - SWA_W)
    qt, kt, vt = (t.transpose(1, 2) for t in full)  # (B, heads, S, D) views
    gqa = "enable_gqa=True"

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True)

    try:
        lib_out = sdpa()
    except RuntimeError as err:  # this backend without GQA: repeat K/V before the call
        gqa = f"K/V repeated to {SWA_H} heads before the call ({str(err)[:80]})"
        kt = kt.repeat_interleave(SWA_H // SWA_KVH, dim=1)
        vt = vt.repeat_interleave(SWA_H // SWA_KVH, dim=1)

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                        attn_mask=band)

        lib_out = sdpa()
    lib_rel = scaled_error(lib_out.transpose(1, 2), plain, row_scale(q, k, v, SWA_W))[1]
    if lib_rel > SWA_TOL[torch.bfloat16]:
        fail("the SDPA yardstick disagrees with the plain version", max_rel_err=lib_rel)
    del lib_out, plain
    nbytes, flops = swa_work(SWA_B, SWA_S, SWA_H, SWA_KVH, SWA_D, SWA_W, 2)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
    ms = samples[len(samples) // 2]
    timing = {
        "ms": ms, "ms_samples": samples,
        "host_launch_ms": cuda_ms(prep.launch, 5, warmup=1),
        "wrapper_ms": cuda_ms(lambda: sw.swa_attention(q, k, v, SWA_W), 5, warmup=1),
        "plain_ms": cuda_ms(lambda: swr.swa_attention_chunked(q, k, v, SWA_W), 3, warmup=1),
        "library_ms": cuda_ms(sdpa, 3, warmup=1),
    }
    emit({"phase": "timing_swa_attention", "shape": f"q ({SWA_B}, {SWA_S}, {SWA_H}, {SWA_D}), "
          f"k/v ({SWA_B}, {SWA_S}, {SWA_KVH}, {SWA_D}) bf16, W={SWA_W}", **timing,
          "rate_reference": flash_rate_reference(full),
          "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
          "gbytes": nbytes / 1e9, "tflop": flops / 1e12, "tflop_per_s": flops / ms / 1e9,
          "library_call": f"F.scaled_dot_product_attention(band mask, {gqa}) under "
                          "sdpa_kernel(EFFICIENT_ATTENTION): all S^2 pairs",
          "library_max_rel_err": lib_rel,
          "note": "ms: median of CUDA-graph replays of the prepared launch; host_launch_ms, "
                  "wrapper_ms, plain_ms, library_ms: CUDA events around calls from the host"})
    return {"parity": parity, "timing": timing, "bound": (b_ms, b_by),
            "llama4": swa_llama4_timing(llama4),
            "mla": swa_causal_timing(mla, "timing_swa_attention_mla", MOE_PLAIN_CHUNK),
            "zamba": swa_causal_timing(zamba, "timing_swa_attention_zamba", ZAMBA_PLAIN_CHUNK),
            "whisper": swa_causal_timing(whisper, "timing_swa_attention_whisper", 512),
            "llava": swa_causal_timing(llava, "timing_swa_attention_llava", LLAVA_PLAIN_CHUNK),
            "tp": swa_causal_timing(tp_qkv, "timing_swa_attention_tp", 512)}


def swa_causal_timing(qkv, phase: str, chunk: int) -> dict:
    """Kernel 8 timed at a prefill layer shape with W = S (plain causal
    attention: lm_mla's q/k 192, v 128; lm_zamba's 112; lm_whisper's 64;
    lm_llava's 128 at G = 7) beside its bound, the chunked plain version
    (query chunks of ``chunk``) and the library call of the same function,
    ``F.scaled_dot_product_attention(is_causal=True)``, with
    ``enable_gqa=True`` where K/V have fewer heads: each backend is tried
    on the tensors as they are, FLASH (one head dim) on v padded with zero
    columns to q's width where v is narrower and its output sliced back;
    each must agree with the plain version, and the fastest is
    library_ms."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.swa_attention import ops as sw, ref as swr

    q, k, v = qkv
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[-1]
    gqa = {"enable_gqa": True} if kvh != h else {}
    scale = d ** -0.5
    prep = sw.prepare_swa_attention(q, k, v, s, scale)
    samples = graph_ms([prep.launch])
    qt, kt, vt = (t.transpose(1, 2) for t in qkv)  # (B, heads, S, D) views
    vpad = torch.nn.functional.pad(v, (0, d - dv)).transpose(1, 2) if dv < d else None

    def sdpa(backend, padded):
        def call():
            with sdpa_kernel(backend):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vpad if padded else vt, is_causal=True, scale=scale, **gqa)
            return out[..., :dv] if padded else out
        return call

    plain = swr.swa_attention_chunked(q, k, v, s, chunk=chunk)
    row = swr.swa_row_scale(v, s, h)
    library = {}
    flash = (f"FLASH_ATTENTION, v padded to {d}" if dv < d else "FLASH_ATTENTION", dv < d)
    for name, backend, padded in (("CUDNN_ATTENTION", SDPBackend.CUDNN_ATTENTION, False),
                                  ("EFFICIENT_ATTENTION", SDPBackend.EFFICIENT_ATTENTION, False),
                                  (flash[0], SDPBackend.FLASH_ATTENTION, flash[1])):
        call = sdpa(backend, padded)
        try:
            rel = scaled_error(call().transpose(1, 2), plain, row)[1]
        except RuntimeError as err:  # the backend refuses these shapes on this build
            library[name] = {"error": str(err)[:160]}
            continue
        library[name] = {"max_rel_err": rel, "agrees": rel <= SWA_TOL[torch.bfloat16],
                         "ms": cuda_ms(call, 5, warmup=1)}
    del plain
    agreeing = {n: r for n, r in library.items() if r.get("agrees")}
    if not agreeing:
        fail(f"no SDPA backend computes {phase}'s attention", backends=library)
    best = min(agreeing, key=lambda n: agreeing[n]["ms"])
    nbytes, flops = swa_work(b, s, h, kvh, d, s, 2, dv=dv)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
    ms = samples[len(samples) // 2]
    timing = {"ms": ms, "ms_samples": samples,
              "wrapper_ms": cuda_ms(lambda: sw.swa_attention(q, k, v, s), 5, warmup=1),
              "plain_ms": cuda_ms(lambda: swr.swa_attention_chunked(
                  q, k, v, s, chunk=chunk), 2, warmup=1),
              "library_ms": agreeing[best]["ms"]}
    call = "is_causal=True, enable_gqa=True" if gqa else "is_causal=True"
    emit({"phase": phase,
          "shape": f"q ({b}, {s}, {h}, {d}), k ({b}, {s}, {kvh}, {d}), v ({b}, {s}, {kvh}, "
                   f"{dv}) bf16, W=S={s}, G={h // kvh}",
          **timing, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
          "gbytes": nbytes / 1e9, "tflop": flops / 1e12, "tflop_per_s": flops / ms / 1e9,
          "library_call": f"F.scaled_dot_product_attention({call}) under {best}: the "
                          "same function", "library_backends": library,
          "note": "ms: median of CUDA-graph replays of the prepared launch; the others CUDA "
                  f"events around calls from the host; plain_ms in query chunks of {chunk}"})
    return {**timing, "bound_ms": b_ms, "bound_by": b_by, "library_call": best}


def swa_llama4_timing(qkv) -> dict:
    """Kernel 8 timed at lm_moe's prefill layer shape (W = S: plain causal
    attention) beside its bound, the chunked plain version and the library
    call of the same function, ``F.scaled_dot_product_attention(is_causal=
    True, enable_gqa=True)``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.swa_attention import ops as sw, ref as swr

    q, k, v = qkv
    b, s, h, kvh, d = MOE_SWA
    prep = sw.prepare_swa_attention(q, k, v, s, d ** -0.5)
    samples = graph_ms([prep.launch])
    qt, kt, vt = (t.transpose(1, 2) for t in qkv)

    def sdpa():  # K/V read as they are (KVH heads), as kernel 8 reads them
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)

    plain = swr.swa_attention_chunked(q, k, v, s)
    lib_rel = scaled_error(sdpa().transpose(1, 2), plain, swr.swa_row_scale(v, s, h))[1]
    del plain
    if lib_rel > SWA_TOL[torch.bfloat16]:
        fail("SDPA at the llama4 shape disagrees with the plain version", max_rel_err=lib_rel)
    nbytes, flops = swa_work(b, s, h, kvh, d, s, 2)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
    ms = samples[len(samples) // 2]
    timing = {"ms": ms, "ms_samples": samples,
              "wrapper_ms": cuda_ms(lambda: sw.swa_attention(q, k, v, s), 5, warmup=1),
              "plain_ms": cuda_ms(lambda: swr.swa_attention_chunked(q, k, v, s), 3, warmup=1),
              "library_ms": cuda_ms(sdpa, 5, warmup=1)}
    emit({"phase": "timing_swa_attention_llama4",
          "shape": f"q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {kvh}, {d}) bf16, W=S={s}",
          **timing, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
          "gbytes": nbytes / 1e9, "tflop": flops / 1e12, "tflop_per_s": flops / ms / 1e9,
          "library_call": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
                          "under FLASH_ATTENTION: the same function at W = S",
          "library_max_rel_err": lib_rel,
          "note": "ms: median of CUDA-graph replays of the prepared launch; the others CUDA "
                  "events around calls from the host"})
    return {**timing, "bound_ms": b_ms, "bound_by": b_by}


def flash_rate_reference(qkv) -> dict:
    """A rate yardstick for kernel 8, not its library_ms: PyTorch's
    FlashAttention-2 (F.scaled_dot_product_attention, is_causal=True, under
    SDPBackend.FLASH_ATTENTION) at the same q, k, v computes plain causal
    attention, another function; its TFLOP/s counts the causal pairs.  It
    shows what a tuned kernel reaches at this D on this card.  The port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.swa_attention.ref import valid_pairs

    qt, kt, vt = (t.transpose(1, 2) for t in qkv)  # (B, heads, S, D) views
    b, h, s, d = qt.shape

    def flash():  # K/V read as they are (KVH heads), as kernel 8 reads them
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
    ms = cuda_ms(flash, 5, warmup=1)
    pairs = valid_pairs(s, s) * b * h
    return {"call": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) under "
                    "FLASH_ATTENTION", "gqa": True, "ms": ms, "causal_pairs": pairs,
            "tflop_per_s": 4 * d * pairs / ms / 1e9,
            "note": "another function (causal, no window); not library_ms"}


def lm_serve(args, dev) -> dict:
    """Phase 10: serve h2o-danube-1.8b at full width and depth in bf16 with
    random weights from ``--seed``: 4 prompts of 8,000 tokens, 32 greedy
    new tokens each, through ``ServeEngine.generate``.  Checks the kernel
    path against the same model on the chunked plain attention, and that a
    window cut by SWA_FAULT keys fails that check; returns kernel 8's
    launches in the generate, and the model, prompts, tokens, first-step
    logits and prefill and decode times for the lm_quant phase."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, prefill

    cfg = get_arch(SERVE_ARCH)
    B, P, NEW = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    n_params = sum(t.numel() for t in params.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :1000], 2)  # warm-up: cuBLAS handles at these widths

    # the user's call, once, with the launch counts read around it
    launches = {}
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # the weights and what earlier phases left
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches["generate"] = launch_counts()["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    # the same work split: prefill alone, then the decode steps alone
    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = launch_counts()["swa_attention"]
    cache = eng._grow_cache(cache, B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, NEW):
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": P + i - 1}, cfg)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    launches["decode"] = launch_counts()["swa_attention"]
    # where the time goes: device time by kernel of one generate, of one
    # prefill and of one decode step (repeated at the same position, which
    # rewrites the same cache slot with the same values)
    split, busy_ms, wall_ms = device_split(lambda: eng.generate(prompts, NEW), calls=1)
    pre_split, pre_busy, pre_wall = device_split(
        lambda: prefill(params, {"tokens": prompts}, cfg), calls=1)
    step = {"tokens": tokens[:, NEW - 2], "pos": P + NEW - 2}
    dec_split, dec_busy, dec_wall = device_split(lambda: decode_step(params, cache, step, cfg),
                                                 calls=3)
    del cache

    # 1-2: the plain path (chunked attention), the kernel path's tokens forced
    plain_first, pcache = prefill(params, {"tokens": prompts}, cfg, attention=swa_attention_chunked)
    pcache = eng._grow_cache(pcache, B)
    steps = [plain_first]
    for i in range(1, NEW):
        logits, pcache = decode_step(params, pcache, {"tokens": tokens[:, i - 1],
                                                      "pos": P + i - 1}, cfg)
        steps.append(logits)
    del pcache
    plain = torch.stack([t.float() for t in steps], 1)  # (B, NEW, V)
    served = res.logits
    prefill_err = row_rel_errors(served[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(served[:, 1:], plain[:, 1:]).max().item()
    # 3: one prefill over the prompt and the first NEW - 1 tokens gives the
    # last decode step's logits (the ring cache at full width)
    reset_launch_counts()
    last, _ = prefill(params, {"tokens": torch.cat([prompts, tokens[:, :NEW - 1]], 1)}, cfg)
    launches["extended_prefill"] = launch_counts()["swa_attention"]
    ring_err = row_rel_errors(last, served[:, NEW - 1]).max().item()
    del last
    # a fault at full width: the kernel path with the window cut by SWA_FAULT
    # keys; its prefill logits must fail check 1 against the plain path's
    fault_cfg = dataclasses.replace(cfg, swa_window=cfg.swa_window - SWA_FAULT)
    fault_first, _ = prefill(params, {"tokens": prompts}, fault_cfg)
    fault_err = row_rel_errors(fault_first, plain[:, 0]).max().item()
    del fault_first
    # 4: greedy tokens equal the plain path's where its top-2 margin decides
    decided, wrong = greedy_disagreements(plain, tokens, SERVE_TOL)
    finite = bool(torch.isfinite(served).all() and torch.isfinite(plain).all())
    out = {
        "phase": "lm_serve", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.resolved_head_dim,
        "window": cfg.swa_window, "params": n_params, "dtype": "bfloat16",
        "batch": B, "prompt_len": P, "new_tokens": NEW, "init_ms": init_ms,
        "generate_ms": generate_ms, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "tokens_per_s": B * NEW / (generate_ms / 1e3),
        "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_reset_gb": held_gb,
        "profiled_generate": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                              "device_busy_share": busy_ms / wall_ms if wall_ms else None,
                              "device_ms_by_kernel": split},
        "profiled_prefill": {"wall_ms": pre_wall, "device_busy_ms": pre_busy,
                             "device_ms_by_kernel": pre_split},
        "profiled_decode_step": {"wall_ms": dec_wall, "device_busy_ms": dec_busy,
                                 "device_ms_by_kernel": dec_split},
        "launches": launches, "tol": SERVE_TOL,
        "checks": {"prefill_vs_plain_rel_err": prefill_err,
                   "teacher_forced_decode_vs_plain_rel_err": decode_err,
                   "extended_prefill_vs_last_decode_rel_err": ring_err,
                   "greedy_decided_steps": decided, "greedy_disagreements": wrong,
                   "finite": finite},
        "fault": {"window": fault_cfg.swa_window, "prefill_vs_plain_rel_err": fault_err,
                  "caught": fault_err > SERVE_TOL},
        "first_row_tokens": res.tokens[0][:8].tolist(),
    }
    out["ok"] = (serve_launches_ok(launches, cfg.n_layers) and finite
                 and tuple(res.tokens.shape) == (B, NEW)
                 and max(prefill_err, decode_err, ring_err) <= SERVE_TOL and wrong == 0
                 and out["fault"]["caught"])
    reading("lm_serve", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=False,
            prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_serve")
    return {"launches": launches["generate"], "params": params, "prompts": prompts,
            "tokens": res.tokens, "prefill_logits": served[:, 0], "prefill_ms": prefill_ms,
            "decode_ms": decode_ms}


# ------------------------------------------------- the paper's estimators
# Phase paper_var: each workload of configs/paper_var.py at its own n, d, p,
# q, bandwidth and block_size through the estimator it parameterises.  The
# dense workloads: a VAR(p) of companion radius 0.6, the full-batch fit
# (fit_ar_mle, PV_GD_STEPS steps, the workload's block size), a second fit
# with the closed-form precision update every PV_PRECISION_EVERY steps, and
# SGD (PV_SGD_STEPS steps of PV_SGD_BATCH windows).  Both fits take the step
# 2 / (m + L) of paper §6.3 from the extreme eigenvalues of their Hessian
# with Pi = I, the (p d, p d) covariance of the stacked lags
# (X_{t-1}, ..., X_{t-p}); fit_ar_mle's default step takes them from Cov(X)
# alone, which is the Hessian at p = 1 only and overshoots it at p = 3 on
# some draws (its NLL rises at d = 8, p = 3 on the CPU generator's seed 0).
# That default, the reference's, is mirrored by the port and listed as open
# in ROADMAP: a PV_DEFAULT_STEPS fit with it is reported (its NLL trace
# beside the checked fit's), not checked.
# The blocked value and gradient are held against the float64 serial
# map-reduce with autograd: the value relatively, each gradient entry
# against the same mean over |r| |x| (at the fit the gradient is a
# cancellation).  The NLL "falls" at a step when it rises by less than
# PV_NLL_RISE (tests/test_estimators.py:139-140).
# varma: gamma(0..30) by kernel 2, held against the plain version on the
# same rows at TOL["lag"], then fit_arma(2, 1, m=25), and fit_ma(1, m=20) on
# a VMA(1) series of the same n and d (its gamma held the same way); each
# finalizer held against the same finalizer on the CPU from the same gamma.
# var-banded-highd: the spatial phase's fit at d = 16,384, b = 4 with n cut
# to PV_BANDED_N (the simulation is one eager kernel-7 step a sample) and
# PV_BANDED_STEPS fit steps.  Differencing on the var-dense-wide series
# integrated once.
PV_GD_STEPS, PV_PRECISION_EVERY, PV_PRECISION_STEPS, PV_DEFAULT_STEPS = 200, 50, 100, 20
PV_SGD_STEPS, PV_SGD_BATCH = 2000, 256
PV_RADIUS, PV_MAX_ERR, PV_FALL_SHARE, PV_NLL_RISE, PV_TOL = 0.6, 0.03, 0.95, 1e-6, 1e-4
PV_ARMA = {"radius": (0.5, 0.4), "lags": 30, "m_arma": 25, "m_ma": 20, "rtol": 1e-4,
           "atol": 1e-5}
PV_BANDED_N, PV_BANDED_STEPS, PV_BANDED_PARTS = 32768, 20, 16
PV_FRAC_D, PV_FRAC_K = 0.4, 64

# Phase graphs: the paper's §11 example at city scale.  The traffic DBN on
# a corridor of GRAPH_LINKS links from occupancy 0.4 (the example's),
# GRAPH_STEPS steps, inflow GRAPH_INFLOW; with inflow 0 the mass is
# conserved up to rounding, so it may rise by at most GRAPH_MASS_SLACK a
# step, and the float32 trajectory is held to the float64 one within
# GRAPH_TRAJ_TOL.  The DBN conserves mass, so each step's rounding is
# carried along the corridor, not damped: summed over the steps, four
# roundings of half a float32 ulp of the capacity a link and step bound the
# drift by GRAPH_STEPS * 2^-22 (4.9e-4) and a step's mass rise by
# GRAPH_LINKS * 2^-22 (0.0156).  The readings sit far inside those bounds
# (from 0.4: drift 6.1e-6 on the CPU and 6.12e-6 on the H100, mass rise
# 3.1e-7; 3.2e-5 from uniform occupancy), so the limits are set at about 16
# and 32 times the readings from 0.4.  The partition: a GRAPH_GRID x GRAPH_GRID sensor lattice
# in GRAPH_PARTS parts with 1-hop halos; the map-reduce of the example's
# neighbour statistic over a (V, GRAPH_T) float32 series, held within
# GRAPH_RTOL of one float64 gather of every vertex's neighbours.
GRAPH_LINKS, GRAPH_STEPS, GRAPH_INFLOW, GRAPH_X0 = 65536, 2048, 0.08, 0.4
GRAPH_GRID, GRAPH_PARTS, GRAPH_T, GRAPH_RTOL = 256, 16, 2048, 1e-5
GRAPH_MASS_SLACK, GRAPH_TRAJ_TOL = 1e-5, 1e-4

# Phase lm_quant: lm_serve's model and prompts served with int8 weights.
QUANT_BYTES_RATIO = 0.6  # tests/test_quant_serving.py:47


def hessian_step(x, p: int) -> float:
    """2 / (m + L) of the stacked-lag covariance (ddof 1), float64: the
    Hessian of the conditional NLL in A with Pi = I."""
    n = x.shape[0]
    z = torch.cat([x[p - 1 - i: n - 1 - i] for i in range(p)], 1).double()
    ev = torch.linalg.eigvalsh(torch.cov(z.T))
    return float(2.0 / (ev[0] + ev[-1]))


def mle_plain(A, x) -> tuple:
    """(nll, d nll / d A, gradient scale) in float64 with Pi = I: the serial
    map-reduce with autograd, and mean_t |r_t| |x_{t-i}|^T, the scale of
    each gradient entry's sum."""
    from repro_torch.core.estimators.mle import ar_conditional_nll

    p, d = A.shape[0], A.shape[1]
    x64 = x.double()
    A64 = A.detach().double().requires_grad_(True)
    nll = ar_conditional_nll(A64, torch.eye(d, dtype=torch.float64, device=x.device), x64)
    (grad,) = torch.autograd.grad(nll, A64)
    n = x64.shape[0]
    lags = [x64[p - 1 - i: n - 1 - i] for i in range(p)]
    r = x64[p:] - sum(lg @ A64.detach()[i].T for i, lg in enumerate(lags))
    scale = torch.stack([r.abs().T @ lg.abs() for lg in lags]) / (n - p)
    return nll.detach(), grad, scale


def nll_fall_share(trace) -> float:
    """Share of steps whose NLL rises by less than PV_NLL_RISE."""
    return float((np.diff(np.asarray(trace, dtype=np.float64)) < PV_NLL_RISE).mean())


def sym_pd(P) -> dict:
    """Finite, symmetric within 1e-5 of max|P|, positive definite."""
    P64 = P.double()
    finite = bool(torch.isfinite(P64).all())
    asym = ((P64 - P64.T).abs().max() / P64.abs().max()).item() if finite else math.inf
    low = torch.linalg.eigvalsh((P64 + P64.T) / 2)[0].item() if finite else -math.inf
    return {"finite": finite, "asymmetry": asym, "min_eig": low,
            "ok": finite and asym <= 1e-5 and low > 0}


def within(got, want, rtol: float, atol: float) -> tuple:
    """(max |got - want|, every entry within atol + rtol |want|)."""
    diff = (got.double().cpu() - want.double().cpu()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.double().cpu().abs()).all())


def dense_fit(cfg, dev, seed: int) -> tuple:
    """One dense workload through fit_ar_mle and fit_ar_sgd: (report, the
    simulated series)."""
    from repro_torch.core.estimators import fit_ar_mle, fit_ar_sgd, optimal_step_size
    from repro_torch.core.estimators.mle import _Blocks, ar_nll_and_grad_blocked
    from repro_torch.timeseries import random_stable_var, simulate_var

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = random_stable_var(gen, cfg.p, cfg.d, radius=PV_RADIUS, device=dev)
    t0 = time.perf_counter()
    x = simulate_var(gen, A, cfg.n, device=dev)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) * 1e3
    lr, lr_default = hessian_step(x, cfg.p), float(optimal_step_size(x))
    eye = torch.eye(cfg.d, device=dev)
    t0 = time.perf_counter()
    fit = fit_ar_mle(x, cfg.p, n_steps=PV_GD_STEPS, block_size=cfg.block_size, step_size=lr)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    trace = fit.nll_trace.tolist()
    err = (fit.A - A).abs().max().item()
    plain = {}
    for name, Ap in (("zero", torch.zeros_like(A)), ("fitted", fit.A)):
        v, g = ar_nll_and_grad_blocked(Ap, eye, x, cfg.block_size)
        v64, g64, scale = mle_plain(Ap, x)
        g_err, g_rel, g_finite = scaled_error(g, g64, scale)
        v_rel = abs(v.item() - v64.item()) / abs(v64.item())
        plain[name] = {"nll": v.item(), "nll_rel_err": v_rel, "grad_max_abs_err": g_err,
                       "grad_max_rel_err": g_rel,
                       "ok": v_rel <= PV_TOL and g_rel <= PV_TOL and g_finite}
        del v64, g64, scale
    # one step's time and device share, on the fit's own blocks
    blocks = _Blocks(x, cfg.p, cfg.block_size)
    step = lambda: blocks.value_and_grad(fit.A, eye)  # noqa: E731
    split, busy_ms, wall_ms = device_split(step, calls=3)
    step_event_ms = cuda_ms(step, 3, warmup=1)
    del blocks
    nbytes = cfg.n * cfg.d * 4
    flops = 3 * 2 * cfg.n * cfg.d ** 2 * (cfg.p + 1)  # forward (prediction, r^T r), twice back
    bound = bound_ms(nbytes, flops)
    t0 = time.perf_counter()
    upd = fit_ar_mle(x, cfg.p, n_steps=PV_PRECISION_STEPS, block_size=cfg.block_size,
                     step_size=lr, update_precision_every=PV_PRECISION_EVERY)
    torch.cuda.synchronize()
    upd_ms = (time.perf_counter() - t0) * 1e3
    prec = sym_pd(upd.precision)
    default = fit_ar_mle(x, cfg.p, n_steps=PV_DEFAULT_STEPS, block_size=cfg.block_size)
    default_trace = default.nll_trace.tolist()
    t0 = time.perf_counter()
    sgd = fit_ar_sgd(x, cfg.p, n_steps=PV_SGD_STEPS, batch=PV_SGD_BATCH, lr0=lr, generator=gen)
    torch.cuda.synchronize()
    sgd_ms = (time.perf_counter() - t0) * 1e3
    sgd_trace = sgd.nll_trace.tolist()
    share = nll_fall_share(trace)
    out = {
        "n": cfg.n, "d": cfg.d, "p": cfg.p, "block_size": cfg.block_size, "simulate_ms": sim_ms,
        "step_size": lr, "default_step_size": lr_default, "gd_steps": PV_GD_STEPS,
        "fit_ms": fit_ms, "step_ms": fit_ms / PV_GD_STEPS,
        "step_device": {"events_ms": step_event_ms, "busy_ms": busy_ms, "wall_ms": wall_ms,
                        "busy_share": busy_ms / wall_ms if wall_ms else None,
                        "by_kernel_name": split},
        "step_bound_ms": bound[0], "step_bound_by": bound[1], "step_bytes": nbytes,
        "step_flops": flops,
        "nll_first_last": [trace[0], trace[-1]], "nll_fall_share": share,
        "max_abs_coef_err": err, "plain": plain,
        "precision_update": {"steps": PV_PRECISION_STEPS, "every": PV_PRECISION_EVERY,
                             "fit_ms": upd_ms, **prec},
        "default_step_fit": {"steps": PV_DEFAULT_STEPS, "step_size": lr_default,
                             "nll_trace": default_trace,
                             "nll_fall_share": nll_fall_share(default_trace),
                             "max_abs_coef_err": (default.A - A).abs().max().item()},
        "sgd": {"steps": PV_SGD_STEPS, "batch": PV_SGD_BATCH, "fit_ms": sgd_ms,
                "step_ms": sgd_ms / PV_SGD_STEPS, "nll_first_last": [sgd_trace[0], sgd_trace[-1]],
                "max_abs_coef_err": (sgd.A - A).abs().max().item()},
    }
    out["ok"] = (all(c["ok"] for c in plain.values()) and share >= PV_FALL_SHARE
                 and err < PV_MAX_ERR and prec["ok"] and sgd_trace[-1] < sgd_trace[0]
                 and all(math.isfinite(v) for v in trace + sgd_trace))
    return out, x


def varma_fits(cfg, dev, seed: int) -> dict:
    """gamma by kernel 2, then fit_arma and fit_ma, each against the same
    finalizer on the CPU from the same gamma."""
    from repro_torch.core.estimators import autocovariance, fit_arma, fit_ma
    from repro_torch.timeseries import random_invertible_ma, random_stable_var
    from repro_torch.timeseries import simulate_varma, simulate_vma

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ra, rb = PV_ARMA["radius"]
    A = random_stable_var(gen, cfg.p, cfg.d, radius=ra, device=dev)
    B = random_invertible_ma(gen, cfg.q, cfg.d, radius=rb, device=dev)
    x = simulate_varma(gen, A, B, cfg.n, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gamma = autocovariance(x, PV_ARMA["lags"], normalization="standard")
    torch.cuda.synchronize()
    gamma_ms = (time.perf_counter() - t0) * 1e3
    got = fit_arma(gamma, cfg.p, cfg.q, m=PV_ARMA["m_arma"])
    want = fit_arma(gamma.cpu(), cfg.p, cfg.q, m=PV_ARMA["m_arma"])
    xm = simulate_vma(gen, B, cfg.n, device=dev)
    gamma_m = autocovariance(xm, PV_ARMA["lags"], normalization="standard")
    got_ma = fit_ma(gamma_m, cfg.q, m=PV_ARMA["m_ma"])
    want_ma = fit_ma(gamma_m.cpu(), cfg.q, m=PV_ARMA["m_ma"])
    plain = {"varma": gamma_plain_check(x, gamma), "vma": gamma_plain_check(xm, gamma_m)}
    parity = {}
    for name, g, w in zip(("arma_A", "arma_B", "arma_sigma", "ma_B", "ma_sigma"),
                          got + got_ma, want + want_ma):
        err, ok = within(g, w, PV_ARMA["rtol"], PV_ARMA["atol"])
        parity[name] = {"max_abs_err": err, "ok": ok and bool(torch.isfinite(g).all())}
    return {"n": cfg.n, "d": cfg.d, "p": cfg.p, "q": cfg.q, "lags": PV_ARMA["lags"],
            "m": [PV_ARMA["m_arma"], PV_ARMA["m_ma"]], "gamma_ms": gamma_ms,
            "gamma_vs_plain": plain,
            "cpu_parity": parity, "rtol": PV_ARMA["rtol"], "atol": PV_ARMA["atol"],
            "true_err": {"arma_A": (got[0] - A).abs().max().item(),
                         "arma_B": (got[1] - B).abs().max().item(),
                         "ma_B": (got_ma[0] - B).abs().max().item()},
            "ok": all(v["ok"] for v in list(parity.values()) + list(plain.values()))}


def gamma_plain_check(x, got) -> dict:
    """gamma(0..PV_ARMA["lags"]) from kernel 2 against the plain version on
    the same rows (the torch backend's lagged sums, the same normalizer),
    normwise at TOL["lag"]."""
    from repro_torch.core.estimators import autocovariance

    want = autocovariance(x, PV_ARMA["lags"], normalization="standard", backend="torch")
    return compare(got, want, TOL["lag"])


def banded_highd(cfg, dev, seed: int) -> dict:
    """The §6 fit at the workload's d and bandwidth, held as the spatial
    phase holds its fit."""
    from repro_torch import banded_predict, fit_banded_ar
    from repro_torch.kernels import launch_counts

    d, b, T = cfg.d, cfg.bandwidth, PV_BANDED_N
    step_size = 2.0 / (1.0 + 1.0 / (1.0 - ((2 * b + 1) * TRUE_DIAG) ** 2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    valid = band_valid(d, b, dev)
    true_diags = (torch.rand((d, 2 * b + 1), generator=gen, device=dev) * 2 - 1) * TRUE_DIAG * valid
    before = dict(launch_counts())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs = torch.randn((T, d), generator=gen, device=dev)  # x_0, then the noise of each step
    for t in range(T - 1):  # x_{t+1} = A x_t + eps_t, kernel 7 at one right-hand side
        xs[t + 1] += banded_predict(true_diags, xs[t])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mid = dict(launch_counts())
    fit = fit_banded_ar(xs, b, n_steps=PV_BANDED_STEPS, step_size=step_size,
                        num_parts=PV_BANDED_PARTS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after = dict(launch_counts())
    sim_launches = mid["banded_matvec"] - before["banded_matvec"]
    fit_launches = {k: after[k] - mid[k] for k in ("banded_matvec", "band_gradient")}
    trace = fit.nll_trace.tolist()
    rises = [y - x for x, y in zip(trace, trace[1:])]
    descent = next((k for k, r in enumerate(rises) if r >= 0), len(rises))
    monotone = (descent >= NLL_MIN_DESCENT
                and all(r <= NLL_NOISE * abs(a) for r, a in zip(rises, trace)))
    rms = (fit.diags - true_diags)[valid].square().mean().sqrt().item()
    short = {be: fit_banded_ar(xs, b, n_steps=PLAIN_STEPS, step_size=step_size,
                               num_parts=PV_BANDED_PARTS, backend=be) for be in ("cuda", "torch")}
    plain_err = (short["cuda"].diags - short["torch"].diags).abs().max().item()
    plain_rel = ((short["cuda"].nll_trace - short["torch"].nll_trace).abs()
                 / short["torch"].nll_trace.abs()).max().item()
    out = {"n": cfg.n, "T": T, "d": d, "bandwidth": b, "p": cfg.p, "steps": PV_BANDED_STEPS,
           "cut": f"n {cfg.n} -> {T} (one eager kernel-7 step a sample), fit steps 300 -> "
                  f"{PV_BANDED_STEPS}",
           "series_gb": T * d * 4 / 1e9, "simulate_ms": (t1 - t0) * 1e3,
           "simulate_launches": sim_launches, "fit_ms": (t2 - t1) * 1e3,
           "fit_ms_per_step": (t2 - t1) * 1e3 / PV_BANDED_STEPS,
           "launches_per_step": {k: v / PV_BANDED_STEPS for k, v in fit_launches.items()},
           "nll_first_last": [trace[0], trace[-1]], "nll_monotone": monotone,
           "nll_strict_descent_steps": descent, "rms_coef_err": rms,
           "expected_rms_coef_err": 1 / math.sqrt(T), "plain_steps": PLAIN_STEPS,
           "plain_diags_max_abs_err": plain_err, "plain_nll_max_rel_err": plain_rel}
    out["ok"] = (monotone and rms < 0.05 and math.isfinite(rms) and sim_launches == T - 1
                 and fit_launches == {"banded_matvec": PV_BANDED_STEPS,
                                      "band_gradient": PV_BANDED_STEPS}
                 and plain_err <= 1e-5 and plain_rel <= 1e-5)
    return out


def fractional_plain(x, d: float, k: int) -> tuple:
    """(y, scale) in float64: y_t = sum_j w_j x_{t-j} with the float32
    weights, and sum_j |w_j| |x_{t-j}|, the scale of its rounding; one
    shifted product per lag."""
    from repro_torch.core.differencing import fractional_diff_weights

    w = fractional_diff_weights(d, k, device=x.device).double()
    x64 = x.double()
    m = x64.shape[0] - k
    y, scale = x64.new_zeros((m,) + x64.shape[1:]), x64.new_zeros((m,) + x64.shape[1:])
    for j in range(k + 1):
        rows = x64[k - j: k - j + m]
        y += w[j] * rows
        scale += w[j].abs() * rows.abs()
    return y, scale


def blocked_difference_rows(x, block: int) -> tuple:
    """difference_blocked of the (h_left = 1) overlapping blocks of ``x``
    and the rows of difference(x) they must equal bitwise: (got, want)."""
    from repro_torch.core import OverlapSpec, make_overlapping_blocks
    from repro_torch.core.differencing import difference, difference_blocked

    n = x.shape[0]
    spec = OverlapSpec(n=n, block_size=block, h_left=1, h_right=0)
    blocks, _ = make_overlapping_blocks(x, spec)
    got = difference_blocked(blocks).reshape(-1, x.shape[1])  # row j: x[j] - x[j-1]
    return got[1:n], difference(x)


def differencing_checks(x) -> dict:
    """On ``x`` integrated once: integrate(difference), difference_blocked
    bitwise, fractional_difference against float64."""
    from repro_torch.core.differencing import difference, fractional_difference, integrate

    X = torch.cumsum(x, 0)
    n = X.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dX = difference(X)
    back = integrate(dX, X[:1])
    torch.cuda.synchronize()
    roundtrip_ms = (time.perf_counter() - t0) * 1e3
    scale = X.abs().max().item() + 1.0  # tests/test_property_hypothesis.py:66-68, order 1
    diff = (back.double() - X.double()).abs()
    roundtrip_ok = bool((diff <= 1e-5 * scale + 1e-4 * X.double().abs()).all())
    roundtrip_err = diff.max().item()
    got, want = blocked_difference_rows(X, 4096)
    bitwise = torch.equal(got, want)
    del back, diff, got, want, dX
    frac = lambda: fractional_difference(X, PV_FRAC_D, PV_FRAC_K)  # noqa: E731
    y = frac()
    y64, yscale = fractional_plain(X, PV_FRAC_D, PV_FRAC_K)
    f_err, f_rel, f_finite = scaled_error(y, y64, yscale)
    frac_ms = cuda_ms(frac, 5, warmup=1)
    d = X.shape[1]
    nbytes = (n * d + (n - PV_FRAC_K) * d) * 4 + (PV_FRAC_K + 1) * 4
    bound = bound_ms(nbytes, 2 * (n - PV_FRAC_K) * d * (PV_FRAC_K + 1))
    return {"n": n, "d": d, "roundtrip_ms": roundtrip_ms, "roundtrip_max_abs_err": roundtrip_err,
            "roundtrip_atol": 1e-5 * scale, "roundtrip_ok": roundtrip_ok,
            "blocked_bitwise": bitwise,
            "fractional": {"d": PV_FRAC_D, "truncation": PV_FRAC_K, "shape": list(y.shape),
                           "max_abs_err": f_err, "max_rel_err": f_rel, "tol": PV_TOL,
                           "ms": frac_ms, "bound_ms": bound[0], "bound_by": bound[1]},
            "ok": roundtrip_ok and bitwise and f_finite and f_rel <= PV_TOL
            and tuple(y.shape) == (n - PV_FRAC_K, d)}


def paper_var_phase(args, dev, workloads=None) -> dict:
    """Phase paper_var: every workload of PAPER_VAR_CONFIGS through its
    estimator; returns the launches the phase made."""
    from repro_torch.configs import PAPER_VAR_CONFIGS
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfgs = workloads or PAPER_VAR_CONFIGS
    t_phase = time.perf_counter()
    reset_launch_counts()
    out = {"phase": "paper_var"}
    wide_x = None
    for i, key in enumerate(("var-dense-small", "var-dense-wide")):
        res, x = dense_fit(cfgs[key], dev, args.seed + 40 + i)
        out[key] = res
        if key == "var-dense-wide":
            wide_x = x
        del x
        gc.collect()
    out["varma"] = varma_fits(cfgs["varma"], dev, args.seed + 42)
    out["differencing"] = differencing_checks(wide_x)
    del wide_x
    gc.collect()
    torch.cuda.empty_cache()
    out["var-banded-highd"] = banded_highd(cfgs["var-banded-highd"], dev, args.seed + 43)
    torch.cuda.synchronize()
    launches = dict(launch_counts())
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["wall_ms"] = (time.perf_counter() - t_phase) * 1e3
    parts = ("var-dense-small", "var-dense-wide", "varma", "differencing", "var-banded-highd")
    out["ok"] = (all(out[k]["ok"] for k in parts) and launches["cross_window_stats"] >= 2
                 and launches["banded_matvec"] > 0 and launches["band_gradient"] > 0)
    emit(out)
    if not out["ok"]:
        fail("paper_var", bad=[k for k in parts if not out[k]["ok"]])
    return launches


def neighbour_statistic(xc, nb, mask):
    """examples/traffic_graph.py:45-50: sum_t x_v(t) * mean of the
    neighbours' x(t)."""
    nbm = torch.where(mask[:, None], nb, 0.0).sum(0) / torch.clamp(mask.sum(), min=1)
    return (xc * nbm).sum()


def neighbour_pair(xc, nb, mask):
    """A tuple statistic: the neighbour statistic and sum_t x_v(t)^2."""
    return neighbour_statistic(xc, nb, mask), (xc * xc).sum()


def graph_plain(kernel, x, g) -> object:
    """The map-reduce with no partition, in float64: one gather of every
    vertex's neighbours, the kernel vmapped over all vertices, one sum."""
    from repro_torch.core.mapreduce import tree_map

    nbrs = torch.from_numpy(g.nbrs).to(x.device).long()
    mask = nbrs >= 0
    x64 = x.double()
    nb = torch.where(mask[..., None], x64[nbrs.clamp(min=0)], 0.0)
    return tree_map(lambda leaf: leaf.sum(0), torch.func.vmap(kernel)(x64, nb, mask))


def mass_rise(traj) -> float:
    """Largest step-to-step rise of the total occupancy (float64 sums)."""
    m = traj.double().sum(1)
    return (m[1:] - m[:-1]).max().item()


def graphs_phase(args, dev) -> None:
    """Phase graphs: the traffic DBN on a corridor, the partition of a
    sensor lattice and the graph map-reduce over it."""
    from repro_torch.core import graphs as gr

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 50)
    line = gr.line_graph(GRAPH_LINKS)
    x0 = torch.full((GRAPH_LINKS,), GRAPH_X0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = gr.simulate_traffic_dbn(line, x0, GRAPH_STEPS, generator=gen,
                                   inflow_scale=GRAPH_INFLOW, device=dev)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) * 1e3
    bounded = bool(((traj >= 0) & (traj <= 1.0)).all())
    traffic = {"links": GRAPH_LINKS, "steps": GRAPH_STEPS, "inflow": GRAPH_INFLOW,
               "shape": list(traj.shape), "simulate_ms": sim_ms, "bounded": bounded,
               "occupancy_range": [traj.min().item(), traj.max().item()]}
    del traj
    closed = gr.simulate_traffic_dbn(line, x0, GRAPH_STEPS, generator=gen, inflow_scale=0.0,
                                     device=dev)
    closed64 = gr.simulate_traffic_dbn(line, x0.double(), GRAPH_STEPS, generator=gen,
                                       inflow_scale=0.0, device=dev)
    rise = mass_rise(closed)
    drift = (closed.double() - closed64).abs().max().item()
    traffic.update({"closed_mass_max_rise": rise, "mass_slack": GRAPH_MASS_SLACK,
                    "closed_vs_float64_max_abs_err": drift, "traj_tol": GRAPH_TRAJ_TOL,
                    "closed_bounded": bool(((closed >= 0) & (closed <= 1.0)).all())})
    traffic["ok"] = (bounded and traffic["closed_bounded"] and rise <= GRAPH_MASS_SLACK
                     and drift <= GRAPH_TRAJ_TOL)
    del closed, closed64

    grid = gr.grid_graph(GRAPH_GRID, GRAPH_GRID)
    t0 = time.perf_counter()
    part = gr.make_graph_partition(grid, GRAPH_PARTS, k=1)
    part_ms = (time.perf_counter() - t0) * 1e3
    halo = int((part.padded >= 0).sum()) - grid.num_vertices
    x = torch.randn((grid.num_vertices, GRAPH_T), generator=gen, device=dev)
    run = lambda kern: gr.graph_window_map_reduce(kern, x, grid, part)  # noqa: E731
    got = run(neighbour_statistic)
    mr_ms = cuda_ms(lambda: run(neighbour_statistic), 3, warmup=1)
    pair = run(neighbour_pair)
    want = graph_plain(neighbour_statistic, x, grid)
    want_pair = graph_plain(neighbour_pair, x, grid)
    rel = lambda a, b: abs(a.item() - b.item()) / abs(b.item())  # noqa: E731
    errs = {"statistic": rel(got, want), "pair_0": rel(pair[0], want_pair[0]),
            "pair_1": rel(pair[1], want_pair[1])}
    mapreduce = {"grid": [GRAPH_GRID, GRAPH_GRID], "parts": GRAPH_PARTS, "k": 1,
                 "series": [grid.num_vertices, GRAPH_T], "series_gb": x.numel() * 4 / 1e9,
                 "padded_width": part.padded.shape[1], "replicated_halo_vertices": halo,
                 "partition_host_ms": part_ms, "map_reduce_ms": mr_ms,
                 "statistic": got.item(), "rel_err": errs, "rtol": GRAPH_RTOL,
                 "ok": all(e <= GRAPH_RTOL for e in errs.values())}
    del x
    out = {"phase": "graphs", "traffic": traffic, "map_reduce": mapreduce,
           "wall_ms": (time.perf_counter() - t_phase) * 1e3,
           "ok": traffic["ok"] and mapreduce["ok"]}
    emit(out)
    if not out["ok"]:
        fail("graphs")


def lm_quant(args, dev, serve: dict) -> int:
    """Phase lm_quant: lm_serve's model and prompts through
    ``ServeEngine(quantize=True)``, held against a plain engine over
    dequantize_tree(quantize_tree(params)); returns kernel 8's launches in
    the quantized generate."""
    from repro_torch import ServeEngine, get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, params_from_tree, params_to_tree, prefill
    from repro_torch.core.mapreduce import tree_leaves
    from repro_torch.serving.quant import (QuantTensor, dequantize_tree, quantize_tree,
                                           tree_param_bytes)

    t_phase = time.perf_counter()
    cfg = get_arch(SERVE_ARCH)
    B, P, NEW = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    params, prompts = serve["params"], serve["prompts"]
    tree = params_to_tree(params)
    bf16_bytes = tree_param_bytes(tree)
    del tree
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # the bf16 weights and what else is held
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, quantize=True,
                      device=dev)
    torch.cuda.synchronize()
    quantize_ms = (time.perf_counter() - t0) * 1e3
    q_bytes = tree_param_bytes(eng.params)
    n_quant = sum(isinstance(leaf, QuantTensor) for leaf in tree_leaves(eng.params))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)
    dequant_ms = cuda_ms(eng.model, 3, warmup=1)
    # prefill and decode alone, each call dequantizing as the engine does
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = prefill(eng.model(), {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache = eng._grow_cache(cache, B)
    t0 = time.perf_counter()
    for i in range(1, NEW):
        _, cache = decode_step(eng.model(), cache, {"tokens": tokens[:, i - 1],
                                                    "pos": P + i - 1}, cfg)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    del cache
    # the plain engine over the dequantized weights
    deq = params_from_tree(dequantize_tree(quantize_tree(params_to_tree(params)),
                                           dtype=torch.bfloat16), cfg)
    plain = ServeEngine(cfg, deq, max_len=P + NEW, dtype=torch.bfloat16,
                        device=dev).generate(prompts, NEW, keep_logits=True)
    del deq
    same_tokens = bool((res.tokens == plain.tokens).all())
    logit_err = row_rel_errors(res.logits, plain.logits).max().item()
    bitwise = torch.equal(res.logits, plain.logits)
    bf16_first = serve["prefill_logits"]
    agree = (res.logits[:, 0].argmax(-1) == bf16_first.argmax(-1)).float().mean().item()
    out = {
        "phase": "lm_quant", "arch": cfg.name, "layers": cfg.n_layers, "batch": B,
        "prompt_len": P, "new_tokens": NEW, "engine_dtype": "bfloat16",
        "param_bytes": {"bf16": bf16_bytes, "int8": q_bytes, "ratio": q_bytes / bf16_bytes,
                        "bound": QUANT_BYTES_RATIO}, "quantized_leaves": n_quant,
        "quantize_ms": quantize_ms, "dequantize_ms": dequant_ms, "generate_ms": generate_ms,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "peak_memory_gb": peak_gb, "held_at_reset_gb": held_gb,
        "bf16": {"prefill_ms": serve["prefill_ms"], "decode_ms_per_step": serve["decode_ms"]},
        "launches": {"swa_attention": launches},
        "checks": {"tokens_equal_plain": same_tokens, "logits_vs_plain_rel_err": logit_err,
                   "logits_bitwise_plain": bitwise, "tol": SERVE_TOL,
                   "finite": bool(torch.isfinite(res.logits).all())},
        "prefill_argmax_agreement_with_bf16": agree,
        "tokens_equal_bf16_share": float((res.tokens == serve["tokens"]).mean()),
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (same_tokens and logit_err <= SERVE_TOL and out["checks"]["finite"]
                 and q_bytes < QUANT_BYTES_RATIO * bf16_bytes and launches == cfg.n_layers
                 and tuple(res.tokens.shape) == (B, NEW))
    reading("lm_quant", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=False,
            quantize=True, quant_bytes=q_bytes, bf16_bytes=bf16_bytes, prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_quant")
    return launches


def lm_moe(args, dev) -> int:
    """Phase lm_moe: llama4-maverick-400b-a17b at full width, depth cut to
    MOE_LAYERS, bf16 weights from ``--seed`` (the expert leaves drawn slab by
    slab), 4 x 8,000 prompt tokens and MOE_NEW greedy new tokens through
    ``ServeEngine.generate``.  Checks: (1) the served prefill and teacher-
    forced decode logits against the same model on the chunked plain
    attention, with the routes that differ between the two paths counted;
    (2) the first layer's MoE on its real prefill input against
    :func:`moe_plain`, and the dropped pairs against a host recount; (3) the
    same layer one slot short must fail (2); (4) the tokens' shape, finite
    logits.  Returns kernel 8's launches in the generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, moe_apply, prefill
    from repro_torch.models.moe import moe_capacity, moe_route

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    m = cfg.moe
    B, P, NEW = SERVE_BATCH, SERVE_PROMPT, MOE_NEW
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # what earlier phases left
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    weight_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :1000], 2)  # warm-up: cuBLAS handles at these widths

    launches = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches["generate"] = launch_counts()["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = launch_counts()["swa_attention"]
    cache = eng._grow_cache(cache, B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, NEW):
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": P + i - 1}, cfg)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    launches["decode"] = launch_counts()["swa_attention"]
    # where the time goes, by stage (one prefill; one decode step repeated
    # at the same position, which rewrites the same slot with the same values)
    step = {"tokens": tokens[:, NEW - 2], "pos": P + NEW - 2}
    pre_split = moe_device_split(lambda: prefill(params, {"tokens": prompts}, cfg))
    dec_split = moe_device_split(lambda: decode_step(params, cache, step, cfg), calls=3)
    dec_routes = []
    hooks = moe_routes(params, cfg, dec_routes)
    decode_step(params, cache, step, cfg)
    for hk in hooks:
        hk.remove()
    del cache
    routed_experts = [int(idx.unique().numel()) for idx, _ in dec_routes]
    capacity = moe_capacity(B * P, cfg)
    pre_bounds = work_bounds(moe_serve_work(cfg, B, P, P, capacity))
    dec_work = dict(cfg=cfg, b=B, q_len=1, kv_len=P + NEW - 1, capacity=moe_capacity(B, cfg))
    dec_bounds = work_bounds(moe_serve_work(**dec_work))
    routed_bounds = work_bounds(moe_serve_work(**dec_work, experts_read=max(routed_experts),
                                               expert_pairs=B * m.top_k * cfg.n_layers))

    # 1: the kernel path's and the plain path's routes, the plain path's
    # prefill and teacher-forced decode logits; layer 0's prefill input
    kernel_routes, plain_routes, first_in = [], [], []
    hooks = moe_routes(params, cfg, kernel_routes)
    hooks.append(params.layers[0].mlp_norm.register_forward_hook(
        lambda _m, _i, h: first_in.append(h)))
    again, _ = prefill(params, {"tokens": prompts}, cfg)
    for hk in hooks:
        hk.remove()
    hooks = moe_routes(params, cfg, plain_routes)
    plain_first, pcache = prefill(params, {"tokens": prompts}, cfg, attention=functools.partial(
        swa_attention_chunked, chunk=MOE_PLAIN_CHUNK))
    for hk in hooks:
        hk.remove()
    pcache = eng._grow_cache(pcache, B)
    steps = [plain_first]
    for i in range(1, NEW):
        logits, pcache = decode_step(params, pcache, {"tokens": tokens[:, i - 1],
                                                      "pos": P + i - 1}, cfg)
        steps.append(logits)
    del pcache
    plain = torch.stack([t.float() for t in steps], 1)
    served = res.logits
    prefill_err = row_rel_errors(served[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(served[:, 1:], plain[:, 1:]).max().item()
    routes = route_differences(kernel_routes, plain_routes)
    # the prefill's bound over the pairs its routing kept (sum over experts
    # of min(load, capacity), each layer), beside the all-slots bound
    kept_pairs = [int(kept.sum()) for _, kept in kernel_routes]
    kept_bounds = work_bounds(moe_serve_work(cfg, B, P, P, capacity,
                                             expert_pairs=sum(kept_pairs)))
    del plain, steps, kernel_routes, plain_routes

    # 2-3: the first MoE layer on its prefill input against the plain loop,
    # then the same layer one slot short
    layer, h = params.layers[0].mlp, first_in[0]
    xt = h.reshape(-1, cfg.d_model)
    got, _ = moe_apply(layer, h, cfg)
    want, plain_idx, plain_drops = moe_plain(layer, xt, m.top_k, capacity)
    idx, pos = moe_route(layer, xt, cfg)[3:]
    loads = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
    dispatch_err = row_rel_errors(got.reshape(-1, cfg.d_model), want).max().item()
    drops = {"moe_apply": int((pos >= capacity).sum()), "plain_loop": plain_drops,
             "host_recount": host_drops(idx.cpu().numpy(), capacity, m.num_experts)}
    fault_capacity = min(capacity, int(loads.max())) - 1
    bad, _ = moe_apply(layer, h, planted_capacity(cfg, B * P, fault_capacity))
    fault_err = row_rel_errors(bad.reshape(-1, cfg.d_model), want).max().item()
    del got, want, bad, first_in, h, xt
    finite = bool(torch.isfinite(served).all())
    out = {
        "phase": "lm_moe", "arch": cfg.name, "layers": cfg.n_layers,
        "cut": f"depth {cfg.n_layers} of 48 layers (the card's 80 GiB: 32.59 GB a layer)",
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.resolved_head_dim, "experts": m.num_experts, "top_k": m.top_k,
        "d_ff_expert": m.d_ff_expert, "shared": m.num_shared, "vocab": cfg.vocab,
        "capacity_factor": m.capacity_factor, "dispatch": m.dispatch, "dtype": "bfloat16",
        "weights_gb": weight_gb, "batch": B, "prompt_len": P, "new_tokens": NEW,
        "capacity": capacity, "init_ms": init_ms, "generate_ms": generate_ms,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "prefill_bound": pre_bounds,
        "prefill_bound_kept_pairs": {"kept_pairs_per_layer": kept_pairs, **kept_bounds},
        "decode_step_bound": dec_bounds,
        "shares_of_bound": {"prefill": pre_bounds["bound_ms"] / prefill_ms,
                            "prefill_kept_pairs": kept_bounds["bound_ms"] / prefill_ms,
                            "decode_step": dec_bounds["bound_ms"] / decode_ms,
                            "decode_step_routed_experts": routed_bounds["bound_ms"] / decode_ms},
        "decode_step_bound_routed_experts": {"experts_routed_per_layer": routed_experts,
                                             **routed_bounds},
        "profiled_prefill": pre_split, "profiled_decode_step": dec_split,
        "launches": launches, "tol": SERVE_TOL,
        "checks": {"prefill_vs_plain_rel_err": prefill_err,
                   "teacher_forced_decode_vs_plain_rel_err": decode_err,
                   "prefill_again_bitwise_generate": bool(torch.equal(again.float(),
                                                                      served[:, 0])), **routes,
                   "dispatch_vs_plain_rel_err": dispatch_err, "dispatch_tol": MOE_TOL,
                   "routing_equal_plain": bool(torch.equal(idx, plain_idx)),
                   "dropped_pairs": drops, "expert_load_max": int(loads.max()),
                   "expert_load_min": int(loads.min()), "finite": finite},
        "fault": {"capacity": fault_capacity,
                  "rule": "capacity - 1" if fault_capacity == capacity - 1 else
                          "fullest bucket - 1 (no bucket reached the capacity)",
                  "dispatch_vs_plain_rel_err": fault_err, "caught": fault_err > MOE_TOL},
        "first_row_tokens": res.tokens[0][:8].tolist(),
        "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (launches["generate"] == launches["prefill"] == cfg.n_layers
                 and launches["decode"] == 0 and finite
                 and tuple(res.tokens.shape) == (B, NEW)
                 and max(prefill_err, decode_err) <= SERVE_TOL and dispatch_err <= MOE_TOL
                 and out["checks"]["routing_equal_plain"]
                 and len(set(drops.values())) == 1 and out["fault"]["caught"])
    reading("lm_moe", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=True,
            prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_moe")
    return launches["generate"]


def mla_layer_check(got, want) -> dict:
    """Check 2 of lm_mla: a layer's attention output (B, S, d) through
    kernel 8 against the same layer on the plain attention, each token
    row's ||got - want|| / ||want|| within SWA_ROW_TOL at most and
    SWA_ROW_MEAN_TOL on average (bf16: the two round P at other points)."""
    rows = row_norm_errors(got, want)
    worst, mean = rows.max().item(), rows.mean().item()
    tol, mean_tol = SWA_ROW_TOL[torch.bfloat16], SWA_ROW_MEAN_TOL[torch.bfloat16]
    return {"row_norm_rel_err": worst, "row_norm_rel_err_mean": mean, "row_tol": tol,
            "row_mean_tol": mean_tol, "ok": worst <= tol and mean <= mean_tol}


def absorbed_check(absorbed, non_absorbed, tol: float) -> dict:
    """Check 3 of lm_mla at the logits: the decode steps' logits (B, T, V)
    with MLA in its absorbed form against the same steps in the
    non-absorbed form (:func:`mla_decode_non_absorbed`) from the same cache
    and tokens through the same routes (:func:`forced_routes`), each row
    within ``tol`` of its max|logit|; the same held one step off (a planted
    fault) must fail."""
    err = row_rel_errors(absorbed, non_absorbed).max().item()
    shifted = row_rel_errors(absorbed[:, :-1], non_absorbed[:, 1:]).max().item()
    return {"absorbed_vs_non_absorbed_rel_err": err, "one_step_off_rel_err": shifted,
            "tol": tol, "ok": err <= tol, "fault_caught": shifted > tol}


def mla_decode_non_absorbed(p, x, cfg, positions, *, cache, pos, **_):
    """One decode step of an MLA layer in the non-absorbed form, the
    prefill's math, written apart from `models/attention.py` and computed in
    float32 past the projections the two forms share (q and this token's
    latent, in the model's dtype): per-head keys [c_kv W_uk, k_rope] and
    values c_kv W_uv expanded from the whole latent cache (B, C, r + rope),
    which takes this token's latent at ``pos`` as the absorbed step writes
    it.  x (B, 1, d) -> (out (B, 1, d) in x's dtype, the cache)."""
    from repro_torch.models.layers import apply_rope, rms_norm

    m = cfg.mla
    b, h, c = x.shape[0], cfg.n_heads, cache["lat"].shape[1]
    n, rp, r, hv = m.nope_head_dim, m.rope_head_dim, m.kv_lora_rank, m.v_head_dim
    q = rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps) @ p.w_uq if p.wq is None else x @ p.wq
    q = q.view(b, 1, h, n + rp)
    q = torch.cat([q[..., :n], apply_rope(q[..., n:], positions, cfg.rope_theta)], -1)
    lat, cpos = cache["lat"], cache["pos"]
    lat[:, pos] = torch.cat([rms_norm(x @ p.w_dkv, p.kv_norm, cfg.norm_eps),
                             apply_rope(x @ p.w_kr, positions, cfg.rope_theta)], -1)[:, 0]
    cpos[pos] = pos
    c_kv = lat[..., :r].float()
    k = torch.cat([(c_kv @ p.w_uk.float()).view(b, c, h, n),
                   lat[:, :, None, r:].float().expand(b, c, h, rp)], -1)
    logits = torch.einsum("bhk,bshk->bhs", q[:, 0].float(), k) / math.sqrt(n + rp)
    del k
    logits = torch.where(((cpos <= pos) & (cpos >= 0))[None, None], logits, -1e30)
    v = (c_kv @ p.w_uv.float()).view(b, c, h, hv)
    ctx = torch.einsum("bhs,bshv->bhv", torch.softmax(logits, -1), v)
    return (ctx.reshape(b, 1, h * hv) @ p.wo.float()).to(x.dtype), cache


def layer0_decode_check(params, cache, tokens, cfg, pos0: int) -> dict:
    """Check 3 of lm_mla at layer 0, whose input at a decode step is the
    token's normed embedding alone: each step's attention output in the
    absorbed form (``mla_apply``) and in the non-absorbed form
    (:func:`mla_decode_non_absorbed`) on the same input, each against its
    own copy of layer 0's latent ``cache`` {"lat": (B, C, r + rope),
    "pos"}, held by :func:`mla_layer_check`.  ``tokens`` (B, T) are the
    steps' tokens, at positions pos0, pos0 + 1, ..."""
    from repro_torch.models.attention import mla_apply

    layer = params.layers[0]
    caches = [{k: v.clone() for k, v in cache.items()} for _ in range(2)]
    outs = ([], [])
    for i in range(tokens.shape[1]):
        h = layer.attn_norm(params.embed[tokens[:, i:i + 1]])
        at = torch.tensor([pos0 + i], dtype=torch.int32, device=h.device)
        for out, c, form in zip(outs, caches, (mla_apply, mla_decode_non_absorbed)):
            out.append(form(layer.attn, h, cfg, at, cache=c, pos=pos0 + i)[0])
    return mla_layer_check(torch.cat(outs[0], 1), torch.cat(outs[1], 1))


@contextlib.contextmanager
def non_absorbed_decoding():
    """Within the block, the transformer's decode steps run MLA in the
    non-absorbed form (:func:`mla_decode_non_absorbed`); its prefills are
    unchanged."""
    from unittest import mock

    from repro_torch.models import transformer

    apply = transformer.attention_apply

    def route(p, x, cfg, positions, cache=None, **kw):
        if cache is None:
            return apply(p, x, cfg, positions, **kw)
        return mla_decode_non_absorbed(p, x, cfg, positions, cache=cache, **kw)

    with mock.patch.object(transformer, "attention_apply", route):
        yield


def lm_mla(args, dev) -> int:
    """Phase lm_mla: deepseek-v2-236b at full width, depth cut to MLA_LAYERS,
    bf16 weights from ``--seed`` (the expert leaves drawn slab by slab), 4 x
    8,000 prompt tokens and MLA_NEW greedy new tokens through
    ``ServeEngine.generate``: the prefill's MLA in its non-absorbed form
    through kernel 8 (q/k 192, v 128), the decode absorbed against the
    latent cache.  Checks: (1) the served prefill and teacher-forced decode
    logits against the same model on the chunked plain attention, with the
    routes that differ between the two paths counted; (2) the first
    layer's attention on its real prefill input through kernel 8 against
    ``mla_apply`` on the plain attention (:func:`mla_layer_check`), and the
    kernel at W = S / 2 must fail it; (3) the absorbed decode against the
    non-absorbed form at the same steps, from the same cache and tokens
    (:func:`absorbed_check`);
    (4) the tokens' shape, finite logits, kernel 8 once a layer in each
    prefill and never in a decode step of either form.  Returns kernel 8's
    launches in the generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ops import swa_attention
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.attention import mla_apply
    from repro_torch.models.moe import moe_capacity

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(MLA_ARCH), n_layers=MLA_LAYERS)
    m, a = cfg.moe, cfg.mla
    B, P, NEW = SERVE_BATCH, SERVE_PROMPT, MLA_NEW
    plain_attention = functools.partial(swa_attention_chunked, chunk=MLA_PLAIN_CHUNK)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # what earlier phases left
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    weight_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 7)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :1000], 2)  # warm-up: cuBLAS handles at these widths

    launches = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches["generate"] = launch_counts()["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = launch_counts()["swa_attention"]
    cache = eng._grow_cache(cache, B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, NEW):
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": P + i - 1}, cfg)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    launches["decode"] = launch_counts()["swa_attention"]
    # where the time goes: each layer's attention and MoE in their ranges
    # (one prefill; one decode step repeated at the same position, which
    # rewrites the same slot with the same values)
    ranges = {MLA_RANGE: MLA_OPS, MOE_RANGE: MOE_OPS}
    step = {"tokens": tokens[:, NEW - 2], "pos": P + NEW - 2}
    pre_split = moe_device_split(lambda: prefill(params, {"tokens": prompts}, cfg),
                                 ranges=ranges)
    dec_split = moe_device_split(lambda: decode_step(params, cache, step, cfg), calls=3,
                                 ranges=ranges)
    del cache
    capacity = moe_capacity(B * P, cfg)
    pre_bounds = work_bounds(moe_serve_work(cfg, B, P, P, capacity))
    dec_bounds = work_bounds(moe_serve_work(cfg, B, 1, P + NEW - 1, moe_capacity(B, cfg)))

    def run(attention=None, form=contextlib.nullcontext, record=None, force=None,
            cache=None) -> tuple:
        """Logits (B, NEW, V) float32 of a prefill (``attention``) and the
        NEW - 1 decode steps on the served tokens (MLA in ``form``), or of
        the steps alone from ``cache`` (step 0's entry then None); the
        routes recorded into ``record`` or forced from ``force``; kernel
        8's launches in the decode steps."""
        hooks = [] if record is None else moe_routes(params, cfg, record)
        with contextlib.ExitStack() as stack:
            if force is not None:
                stack.enter_context(forced_routes(force))
            steps = [None]
            if cache is None:
                logits, cache = prefill(params, {"tokens": prompts}, cfg, attention=attention)
                steps = [logits.float()]
                cache = eng._grow_cache(cache, B)
            reset_launch_counts()
            with form():
                for i in range(1, NEW):
                    logits, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1],
                                                                "pos": P + i - 1}, cfg)
                    steps.append(logits.float())
        for hk in hooks:
            hk.remove()
        out = torch.stack(steps[1:], 1) if steps[0] is None else torch.stack(steps, 1)
        return out, launch_counts()["swa_attention"]

    # 1: the kernel path again with its routes recorded (its prefill's, then
    # its decode steps'), and layer 0's attention input; the plain path
    # with its own routes (read, not held: a top-6 route moved by rounding
    # moves the output by a whole expert's), then through the kernel path's
    # routes (held)
    served = res.logits
    kernel_routes, plain_routes, first_in = [], [], []
    hook = params.layers[0].attn_norm.register_forward_hook(lambda _m, _i, h: first_in.append(h))
    kernel, _ = run(record=kernel_routes)
    hook.remove()
    del first_in[1:]  # the prefill's input only
    plain_free, _ = run(attention=plain_attention, record=plain_routes)
    plain, _ = run(attention=plain_attention, force=kernel_routes)
    prefill_err = row_rel_errors(served[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(served[:, 1:], plain[:, 1:]).max().item()
    routes = route_differences(kernel_routes, plain_routes)
    free = {"prefill_vs_plain_rel_err": row_rel_errors(served[:, 0], plain_free[:, 0]).max().item(),
            "teacher_forced_decode_vs_plain_rel_err":
                row_rel_errors(served[:, 1:], plain_free[:, 1:]).max().item(), **routes}
    kept_pairs = [int(kept.sum()) for _, kept in kernel_routes[:cfg.n_layers]]
    finite = bool(torch.isfinite(served).all() and torch.isfinite(plain).all())
    rerun_bitwise = bool(torch.equal(kernel, served))
    del kernel, plain, plain_free, plain_routes

    # 2: the first layer's attention on its prefill input, kernel 8 against
    # the plain attention; the kernel at half the window must fail
    attn, h = params.layers[0].attn, first_in[0]
    positions = torch.arange(P, dtype=torch.int32, device=dev)
    got, _ = mla_apply(attn, h, cfg, positions)
    want, _ = mla_apply(attn, h, cfg, positions, attention=plain_attention)
    layer = mla_layer_check(got, want)
    bad, _ = mla_apply(attn, h, cfg, positions, attention=lambda q, k, v, w, scale: swa_attention(
        q, k, v, w // 2, scale=scale))
    layer["fault"] = {"window": P // 2, **mla_layer_check(bad, want)}
    layer["fault"]["caught"] = not layer["fault"].pop("ok")
    del got, want, bad, first_in, h

    # 3: the served decode steps again from the kernel path's prefill cache
    # in the non-absorbed form, through the absorbed steps' routes (held)
    # and with their own (read); layer 0's attention in both forms
    _, prefill_cache = prefill(params, {"tokens": prompts}, cfg)
    prefill_cache = eng._grow_cache(prefill_cache, B)
    copy = lambda: {k: v.clone() for k, v in prefill_cache.items()}  # noqa: E731
    own_routes = []
    non_absorbed, launches["non_absorbed_decode"] = run(
        form=non_absorbed_decoding, force=kernel_routes[cfg.n_layers:], cache=copy())
    non_absorbed_free, _ = run(form=non_absorbed_decoding, record=own_routes, cache=copy())
    absorbed = absorbed_check(served[:, 1:], non_absorbed, SERVE_TOL)
    absorbed["own_routes"] = {
        "absorbed_vs_non_absorbed_rel_err": row_rel_errors(served[:, 1:],
                                                           non_absorbed_free).max().item(),
        **route_differences(kernel_routes[cfg.n_layers:], own_routes)}
    absorbed["layer0"] = layer0_decode_check(
        params, {k: v[0] for k, v in prefill_cache.items()}, tokens[:, :NEW - 1], cfg, P)
    absorbed["ok"] = absorbed["ok"] and absorbed["layer0"]["ok"]
    del non_absorbed, non_absorbed_free, own_routes, kernel_routes, prefill_cache
    out = {
        "phase": "lm_mla", "arch": cfg.name, "layers": cfg.n_layers,
        "cut": f"depth {cfg.n_layers} of 60 layers (the card's 80 GiB: 7.946 GB a layer)",
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "mla": {"q_lora_rank": a.q_lora_rank, "kv_lora_rank": a.kv_lora_rank,
                "rope": a.rope_head_dim, "nope": a.nope_head_dim, "v": a.v_head_dim},
        "experts": m.num_experts, "top_k": m.top_k, "d_ff_expert": m.d_ff_expert,
        "shared": m.num_shared, "vocab": cfg.vocab, "capacity_factor": m.capacity_factor,
        "dispatch": m.dispatch, "dtype": "bfloat16", "weights_gb": weight_gb, "batch": B,
        "prompt_len": P, "new_tokens": NEW, "capacity": capacity, "init_ms": init_ms,
        "generate_ms": generate_ms, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "prefill_bound": pre_bounds, "decode_step_bound": dec_bounds,
        "shares_of_bound": {"prefill": pre_bounds["bound_ms"] / prefill_ms,
                            "decode_step": dec_bounds["bound_ms"] / decode_ms},
        "kept_pairs_per_layer": kept_pairs,
        "profiled_prefill": pre_split, "profiled_decode_step": dec_split,
        "launches": launches, "tol": SERVE_TOL,
        "checks": {"prefill_vs_plain_rel_err": prefill_err,
                   "teacher_forced_decode_vs_plain_rel_err": decode_err,
                   "kernel_path_again_bitwise_generate": rerun_bitwise,
                   "plain_path_own_routes": free,
                   "layer0_attention_vs_plain": layer, "absorbed_decode": absorbed,
                   "finite": finite},
        "first_row_tokens": res.tokens[0][:8].tolist(),
        "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (launches["generate"] == launches["prefill"] == cfg.n_layers
                 and launches["decode"] == launches["non_absorbed_decode"] == 0 and finite
                 and tuple(res.tokens.shape) == (B, NEW)
                 and max(prefill_err, decode_err) <= SERVE_TOL
                 and layer["ok"] and layer["fault"]["caught"]
                 and absorbed["ok"] and absorbed["fault_caught"])
    reading("lm_mla", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=True,
            prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_mla")
    return launches["generate"]


def lm_qwen3(args, dev) -> int:
    """Phase lm_qwen3: qwen3-0.6b at full width and depth in bf16 (qk_norm,
    no window: kernel 8 at W = S), QWEN_BATCH prompts of QWEN_PROMPT tokens
    and QWEN_NEW greedy new tokens through ``ServeEngine.generate``, held
    as lm_serve's checks 1-2 hold danube: the served prefill and teacher-
    forced decode logits against the chunked plain attention's.  Returns
    kernel 8's launches in the generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, prefill

    t_phase = time.perf_counter()
    cfg = get_arch(QWEN_ARCH)
    B, P, NEW = QWEN_BATCH, QWEN_PROMPT, QWEN_NEW
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # what earlier phases left
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 6)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :512], 2)  # warm-up
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)
    plain_first, pcache = prefill(params, {"tokens": prompts}, cfg,
                                  attention=swa_attention_chunked)
    pcache = eng._grow_cache(pcache, B)
    steps = [plain_first]
    for i in range(1, NEW):
        logits, pcache = decode_step(params, pcache, {"tokens": tokens[:, i - 1],
                                                      "pos": P + i - 1}, cfg)
        steps.append(logits)
    del pcache
    plain = torch.stack([t.float() for t in steps], 1)
    prefill_err = row_rel_errors(res.logits[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(res.logits[:, 1:], plain[:, 1:]).max().item()
    finite = bool(torch.isfinite(res.logits).all() and torch.isfinite(plain).all())
    out = {"phase": "lm_qwen3", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.resolved_head_dim, "qk_norm": cfg.qk_norm, "dtype": "bfloat16",
           "batch": B, "prompt_len": P, "new_tokens": NEW, "generate_ms": generate_ms,
           "peak_memory_gb": peak_gb, "held_at_start_gb": held_gb,
           "launches": {"generate": launches}, "tol": SERVE_TOL,
           "checks": {"prefill_vs_plain_rel_err": prefill_err,
                      "teacher_forced_decode_vs_plain_rel_err": decode_err, "finite": finite},
           "wall_ms": (time.perf_counter() - t_phase) * 1e3}
    out["ok"] = (launches == cfg.n_layers and finite and tuple(res.tokens.shape) == (B, NEW)
                 and max(prefill_err, decode_err) <= SERVE_TOL)
    reading("lm_qwen3", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=True,
            generate_ms=generate_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_qwen3")
    return launches


# ---------------------------------------------------------------- lm_train --


def train_work(cfg, n_seq: int, seq: int) -> dict:
    """The model work of one train step over ``n_seq`` sequences of ``seq``
    tokens (a dense GQA model): FLOPs 6 x the matmul weights (the
    projections, the MLP and lm_head; not the embedding or the norms) x
    the tokens, plus the causal attention's two products forward and
    backward, 3 x 2 S^2 H D a layer and sequence (half the S x S square);
    remat's recompute is not counted.  Bytes: the optimizer's pass over
    the parameters (bf16 read and written, the bf16 gradient read, float32
    m and v read and written).  The bound is the larger of the FLOPs over
    the bf16 peak and the bytes over the memory rate."""
    hd, d, layers = cfg.resolved_head_dim, cfg.d_model, cfg.n_layers
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 3 * d * cfg.d_ff)
    matmul_weights = layers * per_layer + d * cfg.vocab
    params = matmul_weights + cfg.vocab * d + (2 * layers + 1) * d + (
        2 * layers * hd if cfg.qk_norm else 0)
    tokens = n_seq * seq
    matmul = 6 * matmul_weights * tokens
    attention = layers * n_seq * 6 * seq * seq * cfg.n_heads * hd
    nbytes = params * (2 * 2 + 2 + 4 * 4)
    ms, by = bound_ms(nbytes, matmul + attention, PEAK_BF16)
    return {"matmul_weights": matmul_weights, "params": params, "tokens": tokens,
            "matmul_flops": matmul, "attention_flops": attention,
            "flops": matmul + attention, "bytes": nbytes, "bound_ms": ms, "bound_by": by}


@contextlib.contextmanager
def planted_detached_remat():
    """Check 2's planted fault: every block's checkpoint detaches its
    input, so no gradient reaches the layers below it."""
    from unittest import mock

    from repro_torch.models import layers, transformer

    def detached(fn, *args, policy="full"):
        return layers.remat(fn, *(a.detach() if isinstance(a, torch.Tensor) else a
                                  for a in args), policy=policy)

    with mock.patch.object(transformer, "remat", detached):
        yield


@contextlib.contextmanager
def planted_bf16_accumulation():
    """Check 3's planted fault: microbatch gradients added into bfloat16
    buffers (autograd's own dtype on the card) instead of float32."""
    from unittest import mock

    from repro_torch.training import train_step

    def bf16(named):
        return {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                for k, p in named.items()}

    with mock.patch.object(train_step, "grad_buffers", bf16):
        yield


@contextlib.contextmanager
def planted_noncausal_training():
    """Check 1's planted fault: the training forward's attention sees the
    keys after each query."""
    from unittest import mock

    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import transformer

    with mock.patch.object(transformer, "swa_attention_chunked",
                           functools.partial(swa_attention_chunked, causal=False)):
        yield


@contextlib.contextmanager
def served_attention(fn):
    """The served forward's prefill attention replaced by ``fn`` (the
    kernel wrapper is the default)."""
    from unittest import mock

    from repro_torch.models import attention

    with mock.patch.object(attention, "swa_attention", fn):
        yield


def f32_plain_attention(q, k, v, window, *, scale=None):
    """The chunked plain attention on float32 copies of q, k, v."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked

    return swa_attention_chunked(q.float(), k.float(), v.float(), window,
                                 scale=scale).to(q.dtype)


def served_loss(model, batch, cfg) -> tuple:
    """(the next-token cross-entropy of the served forward's logits, the
    first row's logits): the no-grad serving path, the loss one row at a
    time (each row counts S - 1 labels)."""
    from repro_torch.models import forward
    from repro_torch.models.layers import cross_entropy_loss

    logits = forward(model, {"tokens": batch["tokens"]}, cfg)
    rows = [cross_entropy_loss(logits[r:r + 1, :-1], batch["labels"][r:r + 1, 1:]).item()
            for r in range(logits.shape[0])]
    first = logits[0].clone()
    del logits
    return sum(rows) / len(rows), first


def training_loss(model, batch, cfg) -> tuple:
    """(the training forward's loss (remat, plain attention, fused CE),
    with gradients enabled as in a step; the first row's logits from the
    same forward)."""
    from repro_torch.models import train_forward
    from repro_torch.training import loss_fn

    with torch.enable_grad():
        loss = loss_fn(model, batch, cfg, fused=True)[0].item()
    with torch.no_grad():
        logits = train_forward(model, {"tokens": batch["tokens"][:1]}, cfg)[0][0]
    return loss, logits


def train_serve_check(model, batch, cfg) -> dict:
    """Check 1: the training forward against the served forward (kernel 8
    on the card): the float32 loss over the microbatch, and the first
    row's logits (max |diff| of a position over its max |logit|), each
    within TRAIN_SERVE_FACTOR x its floor (the served path with float32
    plain attention against bf16 plain: how far attention's rounding alone
    moves it); the served path with the training forward's own bf16 plain
    attention within TRAIN_SAME_TOL relative (the loss) and the logits'
    floor; the planted non-causal attention must fail it."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked

    train, train_logits = training_loss(model, batch, cfg)
    served, served_logits = served_loss(model, batch, cfg)
    with served_attention(swa_attention_chunked):
        plain, plain_logits = served_loss(model, batch, cfg)
    with served_attention(f32_plain_attention):
        plain32, plain32_logits = served_loss(model, batch, cfg)
    floor = abs(plain - plain32)
    logits_floor = row_rel_errors(plain_logits, plain32_logits).max().item()
    del plain32_logits
    tol, logits_tol = TRAIN_SERVE_FACTOR * floor, TRAIN_SERVE_FACTOR * logits_floor
    logits_err = row_rel_errors(train_logits, served_logits).max().item()
    same_logits = row_rel_errors(train_logits, plain_logits).max().item()
    del train_logits, plain_logits
    with planted_noncausal_training():
        fault, fault_logits = training_loss(model, batch, cfg)
    fault_logits_err = row_rel_errors(fault_logits, served_logits).max().item()
    del fault_logits, served_logits
    out = {"rows": int(batch["tokens"].shape[0]), "train_loss": train, "served_loss": served,
           "served_plain_loss": plain, "served_plain_f32_attention_loss": plain32,
           "floor": floor, "tol": tol, "err": abs(train - served),
           "same_attention_rel_err": abs(train - plain) / abs(plain),
           "same_attention_tol": TRAIN_SAME_TOL,
           "logits": {"rows": 1, "floor": logits_floor, "tol": logits_tol, "err": logits_err,
                      "same_attention_err": same_logits},
           "fault": {"loss": fault, "err": abs(fault - served), "logits_err": fault_logits_err,
                     "caught": abs(fault - served) > tol or fault_logits_err > logits_tol}}
    out["ok"] = (out["err"] <= tol and out["same_attention_rel_err"] <= TRAIN_SAME_TOL
                 and logits_err <= logits_tol and same_logits <= logits_floor
                 and all(math.isfinite(x) for x in (train, served, plain, plain32)))
    return out


def directional(grads, theta, coef) -> float:
    """sum_l c_l (g_l . theta_l): the gradient along the direction that
    scales each leaf of ``theta`` by (1 + e c_l), in float64."""
    return sum(coef[k] * float((g.double() * p.double()).sum())
               for (k, p), g in zip(theta.items(), grads))


def fd_check(model32, batch, cfg, *, dirs=TRAIN_FD_DIRS, eps=TRAIN_FD_EPS, seed=0,
             factor=TRAIN_FD_FACTOR) -> dict:
    """Check 2: the float32 gradient against central finite differences of
    the loss along ``dirs`` random directions, each scaling every leaf by
    (1 + e c_l), c_l standard normal (directions independent of the
    gradient that reach every leaf), at e = ``eps`` and ``eps`` / 2.  The
    floor is the largest difference of the two step sizes' estimates
    (truncation and rounding), the limit ``factor`` x the floor; the
    planted detached block input must fail it."""
    from repro_torch.training import loss_fn, named_parameters

    named = named_parameters(model32)
    orig = {k: p.detach().clone() for k, p in named.items()}

    def grads():
        loss = loss_fn(model32, batch, cfg, fused=True)[0]
        got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        # a leaf the planted fault cuts off has no gradient: zero
        return loss.item(), [torch.zeros_like(p) if g is None else g
                             for p, g in zip(named.values(), got)]

    loss0, g = grads()
    with planted_detached_remat():
        _, g_fault = grads()
    gen = torch.Generator().manual_seed(seed)
    rows = []

    @torch.no_grad()
    def loss_at(coef, e):
        for k, p in named.items():
            p.copy_(orig[k] * (1 + e * coef[k]))
        return loss_fn(model32, batch, cfg, fused=True)[0].item()

    for _ in range(dirs):
        coef = dict(zip(named, torch.randn(len(named), generator=gen,
                                            dtype=torch.float64).tolist()))
        fds = [(loss_at(coef, e) - loss_at(coef, -e)) / (2 * e) for e in (eps, eps / 2)]
        rows.append({"grad": directional(g, orig, coef),
                     "fault_grad": directional(g_fault, orig, coef),
                     "fd": fds[1], "fd_at_eps": fds[0]})
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(orig[k])
    del g, g_fault, orig
    floor = max(abs(r["fd_at_eps"] - r["fd"]) for r in rows)
    tol = factor * floor
    errs = [abs(r["grad"] - r["fd"]) for r in rows]
    fault = [abs(r["fault_grad"] - r["fd"]) for r in rows]
    return {"rows": int(batch["tokens"].shape[0]), "loss": loss0, "eps": eps,
            "directions": rows, "floor": floor, "tol": tol, "err": max(errs),
            "fault": {"err": max(fault), "caught": max(fault) > tol},
            "ok": max(errs) <= tol and all(math.isfinite(r["fd"]) for r in rows)}


def grad_rel(a: dict, b: dict) -> tuple:
    """(the largest over leaves of max |a - b| / max |b|, that leaf)."""
    errs = {k: float((a[k].float() - b[k].float()).abs().max()
                     / b[k].float().abs().max().clamp_min(1e-30)) for k in b}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def accum_check(model32, batch, cfg, *, factor=TRAIN_ACC_FACTOR) -> dict:
    """Check 3: the float32 mean gradient of accum = rows microbatches of
    one row against accum = 1 on the same rows, within ``factor`` x the
    floor: accum = 1 over the first row repeated rows times against that
    row alone, where the accumulated mean is exactly the row's gradient, so
    their difference is what one reduction over all the rows costs against
    one a microbatch (at least one float32 epsilon); the planted bf16
    accumulation must fail it."""
    from repro_torch.training import accumulate_grads

    k = int(batch["tokens"].shape[0])
    run = functools.partial(accumulate_grads, model32, cfg=cfg, fused_loss=True)
    _, _, g1 = run(batch, accum=1)
    _, _, one = run({n: t[:1] for n, t in batch.items()}, accum=1)
    _, _, dup = run({n: t[:1].expand(k, -1).contiguous() for n, t in batch.items()}, accum=1)
    floor, floor_leaf = grad_rel(dup, one)
    floor = max(floor, float(torch.finfo(torch.float32).eps))
    del one, dup
    _, _, gk = run(batch, accum=k)
    err, err_leaf = grad_rel(gk, g1)
    del gk
    with planted_bf16_accumulation():
        _, _, gf = run(batch, accum=k)
    fault, _ = grad_rel(gf, g1)
    tol = factor * floor
    return {"rows": k, "accum": k, "floor": floor, "floor_leaf": floor_leaf, "tol": tol,
            "err": err, "err_leaf": err_leaf, "fault": {"err": fault, "caught": fault > tol},
            "ok": err <= tol}


def optimizer_step_as_zero(opt):
    """Check 4's planted fault: the restored optimizer state with its step
    reset to 0 (the schedule's lr and the bias corrections restart)."""
    return opt._replace(step=torch.zeros_like(opt.step))


def finite_ok(values) -> bool:
    return all(math.isfinite(v) for v in values)


def train_group(ev, vocab: int) -> str:
    """The operator group of an ``aten::`` event of a training profile: the
    optimizer (inside TRAIN_OPT_RANGE); the cross-entropy (an input whose
    last dim is the vocabulary: its logits, their gradient, lm_head's
    products); the products, bmm the attention's and mm the projections',
    MLP's; the attention's elementwise passes (5-D inputs: (B, KVH, G, q,
    s) logits and the grouped q); the rest (norms, rope, SwiGLU, residual
    adds, the embedding, casts)."""
    parent = ev.cpu_parent
    while parent is not None:
        if parent.name == TRAIN_OPT_RANGE:
            return "optimizer"
        parent = parent.cpu_parent
    shapes = [s for s in (ev.input_shapes or []) if isinstance(s, (list, tuple)) and s]
    if any(s[-1] == vocab for s in shapes):
        return "cross_entropy"
    if ev.name in ("aten::bmm", "aten::baddbmm"):
        return "attention_products"
    if ev.name in ("aten::mm", "aten::addmm"):
        return "projection_and_mlp_gemms"
    if any(len(s) >= 5 for s in shapes):
        return "attention_elementwise"
    return "other"


def train_split(events, vocab: int) -> dict:
    """Device ms of a training profile by :func:`train_group`, each device
    kernel counted once at the ``aten::`` operator that launched it; the
    total over device kernels and what no operator launched."""
    out = {g: 0.0 for g in TRAIN_GROUPS}
    total = 0.0
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if not ev.name.startswith("aten::"):
                continue
            own = sum(k.duration for k in ev.kernels) / 1e3
            if own:
                out[train_group(ev, vocab)] += own
        elif not getattr(ev, "is_user_annotation", False) and ev.name != TRAIN_OPT_RANGE:
            total += ev.device_time_total / 1e3
    out["unattributed"] = total - sum(out.values())
    out["total"] = total
    return out


def train_profile(model, opt, cfg, batch) -> dict:
    """One microbatch's step (forward, backward, AdamW) profiled with its
    input shapes: device ms by group, the busy share, the wall ms."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.training import make_train_step, train_step

    inner = train_step.adamw_update

    def ranged(*a, **kw):
        with record_function(TRAIN_OPT_RANGE):
            return inner(*a, **kw)

    step = make_train_step(cfg, lr_fn=TRAIN_LR, accum=1, fused_loss=True)
    torch.cuda.synchronize()
    with mock.patch.object(train_step, "adamw_update", ranged), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    split = train_split(prof.events(), cfg.vocab)
    return {"rows": int(batch["tokens"].shape[0]), "wall_ms": wall,
            "device_busy_share": split["total"] / wall, "device_ms_by_group": split,
            "split_s": time.perf_counter() - t0}


def timed_batches(pipe, start: int, pool, times: list):
    """The pipeline's batches from ``start`` on, each built on ``pool``'s
    thread while the caller steps on the one before it, its build time
    appended to ``times`` (ms)."""
    def build(step):
        t0 = time.perf_counter()
        b = pipe.host_batch(step)
        times.append((time.perf_counter() - t0) * 1e3)
        return b

    step = start
    ahead = pool.submit(build, step)
    while True:
        batch = ahead.result()
        step += 1
        ahead = pool.submit(build, step)
        yield batch


def train_steps(model, opt, step_fn, batches, steps, dev, after=None):
    """Run ``steps`` on the batches -> (opt, a record per step: loss,
    gradient norm, lr, the ms waited for the batch, the step's ms)."""
    records = []
    for s in steps:
        t0 = time.perf_counter()
        hb = next(batches)
        wait = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
        model, opt, m = step_fn(model, opt, batch)
        m = {k: v.item() for k, v in m.items()}
        records.append({"step": s, "loss": m["loss"], "grad_norm": m["grad_norm"],
                        "lr": m["lr"], "wait_ms": wait,
                        "step_ms": (time.perf_counter() - t0) * 1e3})
        if after is not None:
            after(s, opt)
    return opt, records


def lm_train_process(args) -> dict:
    """:func:`lm_train` in a child process with ``CUBLAS_WORKSPACE_CONFIG``
    = TRAIN_CUBLAS, on the library this run built; its lines are printed
    here, and a failed child fails the run.  Returns its launches."""
    from repro_torch import get_arch

    code = (f"import argparse, sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
            f"cs.train_child(argparse.Namespace(seed={args.seed}))")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=TRAIN_CUBLAS)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=TRAIN_TIMEOUT_S)
    sys.stderr.write(proc.stderr[-20000:])
    launches = None
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if line.startswith('{"phase": "lm_train"'):
            got = json.loads(line)
            launches = got["lm_train_launches"]
            reading("lm_train", get_arch(TRAIN_ARCH), micro=TRAIN_MICRO, accum=TRAIN_ACCUM,
                    seq=TRAIN_SEQ, step_ms=got["median_step_ms_after_first"],
                    peak_gb=got["peak_memory_gb"], held_gb=got["held_at_start_gb"])
    if proc.returncode != 0 or launches is None:
        fail("lm_train", returncode=proc.returncode)
    return launches


def train_child(args) -> None:
    """The child of :func:`lm_train_process`: load the built library,
    initialise CUDA, run the phase."""
    from repro_torch.kernels import _build

    _build.library()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # CUDA up before the phase's memory-stat reset
    lm_train(args, dev)


def lm_train(args, dev) -> dict:
    """Phase lm_train: qwen3-0.6b trained at full width and depth (see
    TRAIN_ARCH): TRAIN_STEPS steps of a global batch of TRAIN_MICRO x
    TRAIN_ACCUM sequences of TRAIN_SEQ tokens from the pipeline, bf16
    weights from ``--seed``, float32 AdamW moments, full remat, the fused
    cross-entropy; under ``torch.use_deterministic_algorithms(True)``.
    Reported: each step's ms (and their median after the first) against
    the bound of :func:`train_work`, tokens a second, the loss and
    gradient-norm trace, peak GB, the data pipeline's ms a batch and the
    ms a step waited for it, the checkpoint's bytes and save and restore
    ms, one microbatch step's device ms by operator group and busy share
    (:func:`train_profile`), and each kernel's launches through the steps
    (none: no kernel has a backward, so the path runs none).  Checks, each
    with a planted fault caught in the same run: (1) the training loss
    against the served forward's (:func:`train_serve_check`); (2) the
    float32 gradient against finite differences (:func:`fd_check`); (3)
    accumulation in float32 (:func:`accum_check`); (4) the state after
    step 0 restored into a model of another seed and steps 1-2 run again:
    losses, parameters, m and v bitwise the unbroken run's, and the step
    restored as 0 (:func:`optimizer_step_as_zero`) must differ; (5) every
    loss and gradient norm finite.  Returns each kernel's launches."""
    import concurrent.futures
    import shutil
    import tempfile

    from repro_torch import get_arch, init_params
    from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree
    from repro_torch.data.tokens import SyntheticTokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import trainable
    from repro_torch.training import adamw_init, cosine_schedule, make_train_step
    from repro_torch.training import named_parameters

    t_phase = time.perf_counter()
    mark = time.perf_counter
    sections = {}
    cfg = get_arch(TRAIN_ARCH)
    rows = TRAIN_MICRO * TRAIN_ACCUM
    work = train_work(cfg, rows, TRAIN_SEQ)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    ckdir = tempfile.mkdtemp(prefix="lm_train_ckpt.")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        t0 = mark()
        pipe = SyntheticTokenPipeline(vocab=TRAIN_DATA_VOCAB, seq_len=TRAIN_SEQ,
                                      global_batch=rows, seed=args.seed)
        pipe_ms = (mark() - t0) * 1e3
        data_ms = []

        def fresh(seed):
            model = trainable(init_params(cfg, seed=seed, dtype=torch.bfloat16, device=dev))
            return model, named_parameters(model)

        model, named = fresh(args.seed)
        n_params = sum(p.numel() for p in named.values())
        step_fn = make_train_step(cfg, lr_fn=cosine_schedule(TRAIN_LR, warmup=1,
                                                            total=TRAIN_STEPS),
                                  accum=TRAIN_ACCUM, fused_loss=True)
        saved = {}
        mgr = CheckpointManager(ckdir)

        def after(s, opt):
            if s == 0:  # the state after step 0: a checkpoint
                t0 = mark()
                mgr.save({"params": {k: p.detach() for k, p in named.items()}, "opt": opt}, s)
                mgr.flush()
                saved["save_ms"] = (mark() - t0) * 1e3
            if s == 1:
                saved["params_after_1"] = {k: p.detach().clone() for k, p in named.items()}

        reset_launch_counts()
        opt, records = train_steps(model, adamw_init(named), step_fn,
                                   timed_batches(pipe, 0, pool, data_ms), range(TRAIN_STEPS),
                                   dev, after)
        launches = dict(launch_counts())
        mgr.close()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        sections["steps"] = mark() - t_phase
        ck_bytes = sum(os.path.getsize(os.path.join(root, f))
                       for root, _, files in os.walk(ckdir) for f in files)

        # 4: the restart, and the step restored as 0
        t_check = mark()

        m2, n2 = fresh(args.seed + 1)
        t0 = mark()
        state = restore_pytree({"params": {k: p.detach() for k, p in n2.items()},
                                "opt": adamw_init(n2)}, ckdir, 0)

        def load(n):
            with torch.no_grad():
                for k, p in n.items():
                    p.copy_(state["params"][k])

        load(n2)
        torch.cuda.synchronize()
        restore_ms = (mark() - t0) * 1e3
        # the step replaces m and v with new tensors: state's stay as restored
        o2, again = train_steps(m2, state["opt"], step_fn,
                                timed_batches(pipe, 1, pool, data_ms), range(1, TRAIN_STEPS),
                                dev)
        same_params = all(torch.equal(p, named[k]) for k, p in n2.items())
        same_m = all(torch.equal(o2.m[k], opt.m[k]) for k in named)
        same_v = all(torch.equal(o2.v[k], opt.v[k]) for k in named)
        del o2
        load(n2)  # the restored state again, its step as 0
        _, bad = train_steps(m2, optimizer_step_as_zero(state["opt"]), step_fn,
                             timed_batches(pipe, 1, pool, data_ms), [1], dev)
        fault_same = all(torch.equal(p, saved["params_after_1"][k]) for k, p in n2.items())
        del m2, n2, state, saved["params_after_1"]
        restart = {"resumed_from_step": 0, "rerun_steps": [1, TRAIN_STEPS - 1],
                   "losses": [r["loss"] for r in again],
                   "losses_equal": [r["loss"] for r in again] == [r["loss"] for r in records[1:]],
                   "params_bitwise": same_params, "m_bitwise": same_m, "v_bitwise": same_v,
                   "restore_ms": restore_ms,
                   "fault": {"step_restored_as_0": True, "loss": bad[0]["loss"],
                             "params_equal": fault_same, "caught": not fault_same}}
        restart["ok"] = (restart["losses_equal"] and same_params and same_m and same_v)
        sections["check4"], t_check = mark() - t_check, mark()

        # 1: the training loss against the served forward's, one microbatch
        hb = pipe.host_batch(0)
        mb = {k: torch.from_numpy(v[:TRAIN_MICRO]).to(dev) for k, v in hb.items()}
        serve_check = train_serve_check(model, mb, cfg)
        sections["check1"], t_check = mark() - t_check, mark()

        # 2, 3: a float32 copy of the trained weights
        f32 = trainable(float_model(model, cfg, dev))
        fd = fd_check(f32, {k: v[:1] for k, v in mb.items()}, cfg, seed=args.seed)
        sections["check2"], t_check = mark() - t_check, mark()
        acc = accum_check(f32, {k: v[:TRAIN_ACC_ROWS] for k, v in mb.items()}, cfg)
        del f32
        sections["check3"], t_check = mark() - t_check, mark()

        # where the time goes: one microbatch's step (it moves the weights:
        # last)
        prof = train_profile(model, opt, cfg, mb)
        sections["profile"] = mark() - t_check
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.use_deterministic_algorithms(was_deterministic)

    step_ms = [r["step_ms"] for r in records]
    median_ms = float(np.median(step_ms[1:]))
    values = [r[k] for r in records + again for k in ("loss", "grad_norm")]
    finite = {"ok": finite_ok(values), "fault_caught": not finite_ok(values + [math.inf])}
    out = {
        "phase": "lm_train", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.resolved_head_dim,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": n_params, "dtype": "bfloat16",
        "optimizer": "AdamW, float32 m and v", "remat": cfg.remat_policy,
        "loss": "fused chunked cross-entropy, chunk 256", "seq": TRAIN_SEQ,
        "micro_batch": TRAIN_MICRO, "accum": TRAIN_ACCUM, "global_batch": rows,
        "cuts": {"global_batch": f"{rows} of train_4k's {TRAIN_GLOBAL_BATCH} sequences "
                                 f"(accum {TRAIN_ACCUM} of {TRAIN_GLOBAL_BATCH // TRAIN_MICRO}): "
                                 f"the phase's time",
                 "data_vocab": f"the pipeline's bigram vocabulary {TRAIN_DATA_VOCAB} of "
                               f"{cfg.vocab}: its dense (V, V) tables"},
        "width_depth_seq": "full: no cut",
        "steps": records, "step_ms": step_ms, "median_step_ms_after_first": median_ms,
        "tokens_per_s": work["tokens"] / (median_ms / 1e3), "work": work,
        "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
        "share_of_bound": work["bound_ms"] / median_ms, "profile": prof,
        "busy_share": prof["device_busy_share"], "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "data": {"pipeline_init_ms": pipe_ms, "batch_ms": data_ms},
        "checkpoint": {"bytes": ck_bytes, "save_ms": saved.get("save_ms"),
                       "restore_ms": restore_ms},
        "lm_train_launches": launches,
        "checks": {"train_vs_served_loss": serve_check, "gradient_vs_fd": fd,
                   "accumulation": acc, "restart": restart, "finite": finite},
        "section_s": sections, "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    checks = out["checks"]
    out["ok"] = (all(n == 0 for n in launches.values()) and finite["ok"]
                 and finite["fault_caught"]
                 and all(checks[c]["ok"] and checks[c]["fault"]["caught"]
                         for c in ("train_vs_served_loss", "gradient_vs_fd", "accumulation",
                                   "restart")))
    emit(out)
    if not out["ok"]:
        fail("lm_train")
    return launches


def tp_launches_ok(stages: dict, layers: int) -> bool:
    """Kernel 8 once a layer in each rank's tensor-parallel prefill, never in
    a decode step."""
    return (all(st["launches"] == layers for st in stages["prefill"])
            and all(st["launches"] == 0 for st in stages["decode"]))


def tp_setup(rehearse: bool):
    """lm_tp's (config, prompt length, decode steps): qwen3-0.6b whole on
    the card; the reduced config at TP_REHEARSAL's sizes in the phase's CPU
    rehearsal (the phase on a CPU device, ``--rehearse`` for a rank)."""
    from repro_torch import get_arch

    cfg = get_arch(TP_ARCH)
    return (cfg.reduced(), *TP_REHEARSAL) if rehearse else (cfg, TP_PROMPT, TP_STEPS)


def tp_rank_results(args, dev, phase: str = "lm_tp", world: int = TP_MODEL,
                    timeout_s: float = TP_TIMEOUT_S, meanwhile=None) -> list:
    """Start tools/tp_phase.py once for each of ``world`` ranks (a
    ``file://`` rendezvous in a temporary directory; ``--train`` for
    lm_tp_train), run ``meanwhile()`` here while they run, wait for every
    one, and load what each wrote; a rank that fails or outlives
    ``timeout_s`` fails the phase, its log's tail printed."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix=phase + "_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, os.path.join(ROOT, "tools", "tp_phase.py"), "--rank", str(r),
                   "--init", init, "--out", tmp, "--seed", str(args.seed)] + (
                       ["--rehearse"] if dev.type == "cpu" else []) + (
                       ["--train"] if phase == "lm_tp_train" else [])
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.perf_counter() + timeout_s
        if meanwhile is not None:
            meanwhile()
        rcs = []
        for proc, _ in procs:
            try:
                rcs.append(proc.wait(timeout=max(1.0, deadline - time.perf_counter())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        if rcs != [0] * world:
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    sys.stderr.write(f"--- {phase} rank {r}:\n{f.read()[-6000:]}\n")
            fail(phase, returncodes=rcs, timeout_s=timeout_s)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def lm_tp(args, dev, swa=None) -> int:
    """Phase lm_tp: qwen3-0.6b at full width and depth served over TP_MODEL
    model ranks on the one card (tensor parallelism, `parallel.tensor`;
    the ranks are tools/tp_phase.py's processes over the gloo transport),
    TP_BATCH prompts of TP_PROMPT tokens (lm_qwen3's) through build_cell's
    tensor-parallel prefill, then TP_STEPS greedy decode steps; rank 0 then
    serves the whole model on one rank.  Checks: (1) each rank's vocab
    shard of the prefill logits (and of every decode step's, the one-rank
    run fed the same tokens) against the matching slice of the one-rank
    logits, within TP_FLOOR_FACTOR x the floor (rank 0's kernel prefill
    against its plain-attention prefill, this run); (2) the greedy tokens
    against the one-rank logits' argmax wherever its top-2 margin exceeds
    that limit (:func:`greedy_disagreements`); (3) the ranks' residuals into
    the final norm and their tokens bitwise equal; (4) 2L + 1 model-axis
    collectives a prefill and a decode step and one a pick, their payload
    the dry run's count of the same cell on ``make_test_mesh(1, TP_MODEL)``;
    (5) kernel 8 once a layer in each rank's prefill (its per-rank shape,
    TP_SWA, held against its plain version in swa_kernel: ``swa``); (6) the
    two planted faults (rank 1 slicing ``wq`` with rank 0's heads, one
    block's row-parallel reduction skipped) each failing check 1; and the
    phase within TP_LIMIT_S.  On a CPU device the phase is its rehearsal
    (:func:`tp_setup`).  Returns kernel 8's launches in rank 0's
    prefill."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.costing import trace_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.tensor import head_layout

    t_phase = time.perf_counter()
    cfg, prompt, steps = tp_setup(dev.type == "cpu")
    res = tp_rank_results(args, dev)
    r0 = res[0]
    single = r0["single_logits"]  # (B, steps + 1, V): the whole model, the same tokens
    vl = cfg.vocab // TP_MODEL
    shard = [slice(r * vl, (r + 1) * vl) for r in range(TP_MODEL)]
    floor = row_rel_errors(single[:, 0], r0["plain_logits"]).max().item()
    limit = TP_FLOOR_FACTOR * floor

    def err(r, got, step):
        return row_rel_errors(got, single[:, step, shard[r]]).max().item()

    prefill_err = [err(r, x["logits"][:, 0], 0) for r, x in enumerate(res)]
    decode_err = [err(r, x["logits"][:, 1:], slice(1, None)) for r, x in enumerate(res)]
    decided, wrong = greedy_disagreements(single, r0["tokens"], limit)
    bitwise = {"residual": all(torch.equal(x["residual"], r0["residual"]) for x in res[1:]),
               "tokens": all(torch.equal(x["tokens"], r0["tokens"]) for x in res[1:])}
    n = 2 * cfg.n_layers + 1
    mesh = make_test_mesh(1, TP_MODEL)
    # one rank's prefill and its decode step over the cache's last position,
    # on the counting mesh; the dryrun phase reads the same traces
    pred = {"prefill": trace_cell(cfg, ShapeConfig("lm_tp_prefill", prompt, TP_BATCH,
                                                   "prefill"), mesh=mesh),
            "decode": trace_cell(cfg, ShapeConfig("lm_tp_decode", prompt + steps, TP_BATCH,
                                                  "decode"), mesh=mesh)}
    collectives = {}
    for stage, tr in pred.items():  # the port's executed gathers
        seen = {(st["count"], st["bytes"]) for x in res for st in x["stages"][stage]}
        want = (tr.executed_collective_counts.get("all-gather", 0),
                tr.executed_collective_payload.get("all-gather", 0.0))
        collectives[stage] = {"measured": sorted(seen), "dry_run": want, "per_step": n,
                              "ok": seen == {want} and want[0] == n}
    picks_ok = all(x["pick_counts"] == [1] * (steps + 1) for x in res)
    faults = {}
    for name in ("wq", "skip"):
        errs = [err(r, x[f"fault_{name}_logits"], 0) for r, x in enumerate(res)]
        faults[name] = {"prefill_err": errs, "caught": max(errs) > limit}
    faults["skip"]["call"] = r0["fault_skip_call"]
    launches = [x["stages"]["prefill"][0]["launches"] for x in res]
    finite = all(bool(torch.isfinite(x["logits"]).all()) for x in res) and bool(
        torch.isfinite(single).all())
    decode_ms = sorted(r0["decode_ms"])[len(r0["decode_ms"]) // 2]
    ranks = [{"peak_memory_gb": x["peak_gb"], "busy": x.get("busy"), "start_s": x["start_s"],
              "seconds": x["seconds"],
              "collective_share": {k: x["collective_ms"][k] / x["instrumented_ms"][k]
                                   for k in ("prefill", "decode")},
              "collective_ms": x["collective_ms"], "instrumented_ms": x["instrumented_ms"]}
             for x in res]
    seconds = time.perf_counter() - t_phase
    out = {"phase": "lm_tp", "arch": cfg.name, "layers": cfg.n_layers, "mesh": r0["mesh"],
           "transport": r0["transport"], "heads_per_rank": list(head_layout(cfg, TP_MODEL)),
           "dtype": "bfloat16", "batch": TP_BATCH, "prompt_len": prompt,
           "decode_steps": steps, "prefill_ms": r0["prefill_ms"],
           "decode_ms_median": decode_ms, "decode_ms": r0["decode_ms"],
           "one_rank_ms": {"prefill": r0["single_ms"]["prefill"],
                           "decode_median": sorted(r0["single_ms"]["decode"])[steps // 2]},
           "ranks": ranks, "launches": {"prefill": launches, "decode": 0},
           "kernel8_rank_shape": swa,
           "floor": floor, "floor_factor": TP_FLOOR_FACTOR, "limit": limit,
           "checks": {"prefill_vs_one_rank_rel_err": prefill_err,
                      "decode_vs_one_rank_rel_err": decode_err,
                      "greedy": {"decided": decided, "disagreeing": wrong,
                                 "share_equal_to_one_rank_argmax": (
                                     r0["single_tokens"] == r0["tokens"]).float().mean().item()},
                      "bitwise_across_ranks": bitwise, "collectives": collectives,
                      "pick_gathers": picks_ok, "finite": finite, "faults": faults},
           "note": "gloo stages each collective through the host: the collective share is a "
                   "correctness run's, not an NVLink figure",
           "seconds": seconds, "limit_s": TP_LIMIT_S}
    out["ok"] = (finite and max(prefill_err + decode_err) <= limit and wrong == 0
                 and all(bitwise.values()) and all(c["ok"] for c in collectives.values())
                 and picks_ok and all(f["caught"] for f in faults.values())
                 and tp_launches_ok(r0["stages"], cfg.n_layers)
                 and tp_launches_ok(res[-1]["stages"], cfg.n_layers)
                 and r0["transport"] == "gloo" and seconds <= TP_LIMIT_S)
    reading("lm_tp", cfg, batch=TP_BATCH, prompt=prompt, new=steps + 1, model=TP_MODEL,
            prefill_ms=r0["prefill_ms"], decode_ms=decode_ms, traces=pred,
            collectives=collectives)
    emit(out)
    if not out["ok"]:
        fail("lm_tp")
    return launches[0]


def tp_train_setup(rehearse: bool):
    """lm_tp_train's (config, sequence): qwen3-0.6b whole at train_4k's
    sequence on the card; the reduced config at TP_TRAIN_REHEARSAL's in the
    phase's CPU rehearsal (the phase on a CPU device, ``--rehearse`` for a
    rank)."""
    from repro_torch import get_arch

    cfg = get_arch(TP_ARCH)
    return (cfg.reduced(), TP_TRAIN_REHEARSAL) if rehearse else (cfg, TP_TRAIN_SEQ)


@contextlib.contextmanager
def planted_partial_norms():
    """lm_tp_train's first planted fault: the q_norm / k_norm gradients left
    as each rank's partial (their model-axis sum skipped)."""
    from unittest import mock

    from repro_torch.parallel import tensor as tp

    kept = tp.combine_model_grads

    def skipping(grads, cfg, mesh):
        out = kept(grads, cfg, mesh)
        return {k: (grads[k] if tp.grad_role(k, cfg, tp.model_size(mesh)) == "partial" else g)
                for k, g in out.items()}

    with mock.patch.object(tp, "combine_model_grads", skipping):
        yield


@contextlib.contextmanager
def planted_local_clip():
    """The second: the clip by the rank's own gradients' norm, not the
    whole model's across shards."""
    from unittest import mock

    from repro_torch.parallel import tensor as tp
    from repro_torch.training import global_norm

    with mock.patch.object(tp, "global_norm", lambda grads, cfg, mesh: global_norm(grads)):
        yield


def tp_train_traces(cfg, seq: int) -> dict:
    """One rank's float32 and bf16 train step of lm_tp_train on the counting
    mesh ``make_test_mesh(*TP_TRAIN_MESH)``: {dtype name: CellTrace}."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.costing import trace_cell
    from repro_torch.launch.mesh import make_test_mesh

    shape = ShapeConfig("lm_tp_train", seq, TP_TRAIN_MESH[0] * TP_TRAIN_ROWS, "train")
    return {name: trace_cell(cfg, shape, dtype=dtype, fused_loss=True,
                             mesh=make_test_mesh(*TP_TRAIN_MESH))
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}


def stages_match(measured: dict, trace) -> bool:
    """Each stage's (count, bytes) of a rank's step equal to the trace's."""
    want = {}
    for key, v in trace.executed_collective_stages.items():
        stage, what = key.rsplit(".", 1)
        want.setdefault(stage, [0, 0.0])[what == "bytes"] = v
    return {k: (float(n), float(b)) for k, (n, b) in measured.items()} == {
        k: (float(n), float(b)) for k, (n, b) in want.items()}


def lm_tp_train(args, dev) -> dict:
    """Phase lm_tp_train: qwen3-0.6b trained at full width and depth over a
    (data, model) mesh of TP_TRAIN_MESH ranks on the one card (the dense
    family's tensor-parallel train step, ``make_train_step(mesh=)``: the
    backward through the model-axis collectives, the gradient combine, the
    norm across shards, ZeRO-1 moments; the ranks are tools/tp_phase.py
    --train processes over gloo), TP_TRAIN_ROWS sequences of TP_TRAIN_SEQ a
    data rank, weights from ``--seed``.  Checks: (1) one float32 step,
    clipped (the norm above TP_TRAIN_CLIP, printed): every rank's gradient
    shard, updated shard and ZeRO-1 slices of m and v normwise per leaf, the
    loss and grad_norm relatively, against the one-rank step on the whole
    batch, within max(TP_TRAIN_MIN_LIMIT, TP_TRAIN_FLOOR_FACTOR x floor) (the
    floor: the one-rank gradients at accumulation 1 against 2); (2) after
    every step the residual-side norm leaves equal across the model ranks,
    every leaf across the data ranks and the clip scale on all ranks,
    bitwise; (3) each stage's collectives (forward, recompute, backward,
    combine, norm, ZeRO-1 gather) equal in count and bytes to the counting
    mesh's trace of the same step; (4) a rank's moments half the whole
    moments' bytes and the rule tables' ZeRO-1 ``opt_bytes``; (5)
    TP_TRAIN_BF16_STEPS bf16 steps: finite losses, check 2, step 0's loss
    within TP_TRAIN_FLOOR_FACTOR x the floor of the one-rank bf16 loss (the
    floor: the one-rank bf16 loss of each sequence against its float32
    loss, the largest); the two planted
    faults (the q_norm / k_norm sum skipped; the clip by the rank's local
    norm) each failing check 1; and the phase within TP_TRAIN_LIMIT_S.
    Readings: the bf16 step's ms, its collective and busy shares, peak and
    moment GB a rank, tokens a second, the share of the bound.  On a CPU
    device the phase is its rehearsal (:func:`tp_train_setup`).  Returns
    each kernel's launches in a bf16 step, the most of any rank (none: no
    kernel has a backward)."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch.dryrun import cell_memory
    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    cfg, seq = tp_train_setup(dev.type == "cpu")
    traces = {}
    res = tp_rank_results(args, dev, "lm_tp_train", world=math.prod(TP_TRAIN_MESH),
                          timeout_s=TP_TRAIN_TIMEOUT_S,
                          meanwhile=lambda: traces.update(tp_train_traces(cfg, seq)))
    r0 = res[0]
    floor = r0["floor"][0]
    limit = max(TP_TRAIN_MIN_LIMIT, TP_TRAIN_FLOOR_FACTOR * floor)
    worst_errs = {k: max(x["f32"]["errors"][k] if k in ("loss", "grad_norm")
                         else x["f32"]["errors"][k][0] for x in res)
                  for k in ("grads", "params", "m", "v", "loss", "grad_norm")}
    faults = {}
    for name in r0["faults"]:
        errs = {k: max(x["faults"][name][k] if k in ("loss", "grad_norm")
                       else x["faults"][name][k][0] for x in res)
                for k in worst_errs}
        faults[name] = {"errors": errs, "caught": max(errs.values()) > limit}
    norm = r0["f32"]["grad_norm"]
    check1 = {"errors": worst_errs, "per_rank": [x["f32"]["errors"] for x in res],
              "floor": r0["floor"], "limit": limit, "clip_norm": TP_TRAIN_CLIP,
              "grad_norm": norm, "clip_acts": norm > TP_TRAIN_CLIP,
              "one_rank_f32": r0["one_rank_f32"],
              "ok": max(worst_errs.values()) <= limit and norm > TP_TRAIN_CLIP}
    bitwise = {"f32": [x["f32"]["bitwise"] for x in res],
               "bf16": [[st["bitwise"] for st in x["bf16"]] for x in res]}
    check2 = {"ok": all(all(b.values()) for b in bitwise["f32"])
              and all(all(b.values()) for steps in bitwise["bf16"] for b in steps),
              "after_each_step": bitwise}
    check3 = {"f32": all(stages_match(x["f32"]["stages"], traces["f32"]) for x in res),
              "bf16": all(stages_match(st["stages"], traces["bf16"]) for x in res
                          for st in x["bf16"]),
              "measured": {k: list(v) for k, v in r0["bf16"][0]["stages"].items()},
              "dry_run": traces["bf16"].executed_collective_stages}
    check3["ok"] = check3["f32"] and check3["bf16"]
    rules = cell_memory(cfg, SHAPES_BY_NAME["train_4k"], make_test_mesh(*TP_TRAIN_MESH))
    held = [x["f32"]["moment_bytes"] for x in res]
    check4 = {"moment_bytes": held, "whole_moment_bytes": [x["f32"]["whole_moment_bytes"]
                                                           for x in res],
              "rule_tables_opt_bytes": rules["opt_bytes"],
              "ok": all(2 * h == x["f32"]["whole_moment_bytes"] and h == rules["opt_bytes"]
                        for h, x in zip(held, res))}
    one_bf16, one_f32 = r0["one_rank_bf16_loss"], r0["one_rank_f32"]["loss"]
    # the floor: the one-rank bf16 loss against the float32 one, the most of
    # any one sequence (the sequences' differences cancel in the whole
    # batch's: 8.6e-6-1.55e-5 each and 1.5e-7 together on an H100, 30x
    # under the tensor-parallel step's)
    seq_losses = r0["one_rank_seq_losses"]
    floor5 = max(abs(b / f - 1) for b, f in zip(seq_losses["bf16"], seq_losses["f32"]))
    losses = [[st["loss"] for st in x["bf16"]] for x in res]
    err5 = max(abs(x["bf16"][0]["loss"] / one_bf16 - 1) for x in res)
    check5 = {"losses": losses, "one_rank_bf16_loss": one_bf16, "one_rank_f32_loss": one_f32,
              "one_rank_seq_losses": seq_losses, "floor": floor5,
              "whole_batch_difference": abs(one_bf16 / one_f32 - 1), "step0_rel_err": err5,
              "finite": all(math.isfinite(v) for row in losses for v in row)}
    check5["ok"] = check5["finite"] and err5 <= TP_TRAIN_FLOOR_FACTOR * floor5
    launches = {}
    for x in res:
        for st in x["bf16"]:
            for k, n in st["launches"].items():
                launches[k] = max(launches.get(k, 0), n)
    step_ms = r0["bf16"][0]["ms"]
    tokens = TP_TRAIN_MESH[0] * TP_TRAIN_ROWS * seq
    rank_bound = dryrun_bound_ms(dryrun_tp_train({"traces": traces})["step"])
    ranks = [{"coords": x["coords"], "bf16_step_ms": [st["ms"] for st in x["bf16"]],
              "collective_share": x["bf16"][1]["collective_ms"] / x["bf16"][1]["ms"]
              if len(x["bf16"]) > 1 else None,
              "busy": x.get("busy"), "peak_memory_gb": x["peak_gb"],
              "moment_gb": x["moment_gb"], "start_s": x["start_s"], "seconds": x["seconds"]}
             for x in res]
    seconds = time.perf_counter() - t_phase
    out = {"phase": "lm_tp_train", "arch": cfg.name, "layers": cfg.n_layers,
           "mesh": r0["mesh"], "transport": r0["transport"], "dtype": "bfloat16 (check 1: float32)",
           "seq": seq, "rows_per_data_rank": TP_TRAIN_ROWS,
           "global_batch": TP_TRAIN_MESH[0] * TP_TRAIN_ROWS,
           "cuts": {"global_batch": f"{TP_TRAIN_MESH[0] * TP_TRAIN_ROWS} of train_4k's "
                                    f"{TRAIN_GLOBAL_BATCH} sequences: the phase's time",
                    "mesh": "one card, the four ranks sharing it over host-staged gloo"},
           "lr": TP_TRAIN_LR, "remat": cfg.remat_policy, "loss": "fused chunked cross-entropy",
           "bf16_step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "rank_bound_ms": rank_bound, "card_bound_ms": len(res) * rank_bound,
           "share_of_bound": len(res) * rank_bound / step_ms, "ranks": ranks,
           "lm_tp_train_launches": launches,
           "checks": {"one_rank_f32": check1, "bitwise": check2, "collectives": check3,
                      "moments": check4, "bf16_steps": check5, "faults": faults},
           "note": "gloo stages each collective through the host and the four ranks share "
                   "the card: the collective share is a correctness run's, not an NVLink "
                   "figure",
           "seconds": seconds, "limit_s": TP_TRAIN_LIMIT_S}
    out["ok"] = (check1["ok"] and check2["ok"] and check3["ok"] and check4["ok"]
                 and check5["ok"] and all(f["caught"] for f in faults.values())
                 and all(n == 0 for n in launches.values())
                 and r0["transport"] == "gloo" and seconds <= TP_TRAIN_LIMIT_S)
    reading("lm_tp_train", cfg, seq=seq, rows=TP_TRAIN_ROWS, mesh=TP_TRAIN_MESH,
            step_ms=step_ms, traces=traces, collectives=check3)
    emit(out)
    if not out["ok"]:
        fail("lm_tp_train")
    return launches


def lm_zamba(args, dev) -> int:
    """Phase lm_zamba: zamba2-7b at full width and full depth (81 Mamba2
    layers, the shared attention block at 14 of them), bf16 weights from
    ``--seed``, 4 x 8,000 prompt tokens and ZAMBA_NEW greedy new tokens
    through ``ServeEngine.generate``.  Timed: init, the generate, a prefill
    and each decode step, each profiled with its device busy share and
    device ms by operator group (:func:`zamba_groups`) beside its bound
    (:func:`zamba_work`).  Checks: (1a) each application's attention on the
    kernel path's own q, k, v, kernel 8 against the plain version
    (:func:`checked_attention`), and the window cut by SWA_FAULT keys must
    fail; (1b) the served prefill and teacher-forced decode logits against
    the same model on the chunked plain attention, within
    ZAMBA_FLOOR_FACTOR times the floor the same path with float32 attention
    reads (at least SERVE_TOL), the greedy tokens wherever the plain top-2
    margin decides at that limit; (3) layer 0's chunked SSD against its
    recurrence (:func:`ssd_recurrence_check`), and the reference's unmasked
    decay planted must give NaN and fail it; (4) the first decode step's
    logits against the full forward over the prompt and the first token
    (one row), at check 1b's limit; (5) kernel 8 once an application in
    each prefill, never in decode; every logit finite.  Check 2 (kernel 8
    alone at this layer shape) is phase 9's.  Returns kernel 8's launches
    in the generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, prefill, ssm, zamba
    from repro_torch.models.transformer import _block

    t_phase = time.perf_counter()
    cfg = get_arch(ZAMBA_ARCH)
    m = cfg.ssm
    B, P, NEW = SERVE_BATCH, SERVE_PROMPT, ZAMBA_NEW
    apps = -(-cfg.n_layers // cfg.shared_attn_every)
    plain_attention = functools.partial(swa_attention_chunked, chunk=ZAMBA_PLAIN_CHUNK)
    ranges = dict(ZAMBA_OPS)
    profile = functools.partial(moe_device_split, ranges=ranges)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # what earlier phases left
    torch.cuda.reset_peak_memory_stats(dev)
    made = []
    init = profile(lambda: made.append(init_params(cfg, seed=args.seed, dtype=torch.bfloat16,
                                                   device=dev)), warm=False)
    params = made.pop()
    n_params = sum(t.numel() for t in params.parameters())
    weight_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 8)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :1000], 2)  # warm-up: cuBLAS handles at these widths

    launches = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches["generate"] = launch_counts()["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = launch_counts()["swa_attention"]
    cache = eng._grow_cache(cache, B)
    reset_launch_counts()
    step_ms = []
    for i in range(1, NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": P + i - 1}, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = sum(step_ms) / len(step_ms)
    launches["decode"] = launch_counts()["swa_attention"]
    # where the time goes: one prefill; one decode step repeated at the same
    # position (it rewrites the same KV slot with the same values; the SSD
    # state moves on, which changes no shape or operation)
    step = {"tokens": tokens[:, NEW - 2], "pos": P + NEW - 2}
    profiled = {"init": init,
                "prefill": profile(lambda: prefill(params, {"tokens": prompts}, cfg)),
                "decode_step": profile(lambda: decode_step(params, cache, step, cfg), calls=3)}
    for prof in profiled.values():
        prof["device_ms_by_group"] = zamba_groups(prof["device_ms"])
    del cache
    bounds = {"prefill": zamba_bounds(zamba_work(cfg, B, P)),
              "decode_step": zamba_bounds(zamba_work(cfg, B, 1, P + NEW - 1))}

    # 1a: each application's attention on the kernel path's own q, k, v,
    # kernel 8 against the plain version; the window cut by SWA_FAULT keys
    # at the first application must fail
    in_situ, fault_rows = [], []
    prefill(params, {"tokens": prompts}, cfg,
            attention=checked_attention(plain_attention, in_situ))
    positions = torch.arange(P, dtype=torch.int32, device=dev)
    _block(params.shared_attn, params.embed[prompts], cfg, positions,
           attention=checked_attention(plain_attention, fault_rows, cut=SWA_FAULT))
    layer = {"row_norm_rel_err": [r[0] for r in in_situ],
             "row_norm_rel_err_mean": [r[1] for r in in_situ],
             "row_tol": SWA_ROW_TOL[torch.bfloat16],
             "row_mean_tol": SWA_ROW_MEAN_TOL[torch.bfloat16], "ok": in_situ_ok(in_situ),
             "fault": {"window": P - SWA_FAULT, "row_norm_rel_err": fault_rows[0][0],
                       "row_norm_rel_err_mean": fault_rows[0][1],
                       "caught": not in_situ_ok(fault_rows)}}

    # 1b: the plain path (chunked attention), the kernel path's tokens
    # forced, against the floor: the plain path with float32 attention
    def teacher_forced(attention):
        logits, c = prefill(params, {"tokens": prompts}, cfg, attention=attention)
        c = eng._grow_cache(c, B)
        steps = [logits.float()]
        for i in range(1, NEW):
            logits, c = decode_step(params, c, {"tokens": tokens[:, i - 1], "pos": P + i - 1},
                                    cfg)
            steps.append(logits.float())
        del c, logits
        return torch.stack(steps, 1)

    def float32_attention(q, k, v, window, scale=None):
        return plain_attention(q.float(), k.float(), v.float(), window,
                               scale=scale).to(q.dtype)

    served = res.logits
    plain = teacher_forced(plain_attention)
    prefill_err = row_rel_errors(served[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(served[:, 1:], plain[:, 1:]).max().item()
    rounded = teacher_forced(float32_attention)
    floor = {"prefill": row_rel_errors(rounded[:, 0], plain[:, 0]).max().item(),
             "decode": row_rel_errors(rounded[:, 1:], plain[:, 1:]).max().item()}
    limit = max(SERVE_TOL, ZAMBA_FLOOR_FACTOR * max(floor.values()))
    decided, wrong = greedy_disagreements(plain, tokens, limit)
    finite = bool(torch.isfinite(served).all() and torch.isfinite(plain).all()
                  and torch.isfinite(rounded).all())
    del plain, rounded

    # 4: prefill hands its state to decode: the full forward over the
    # prompt and the first token against the first decode step (row 0)
    hidden = zamba.zamba_forward(params, torch.cat([prompts[:1], tokens[:1, :1]], 1), cfg,
                                 return_hidden=True)[:, -1]
    full = (hidden @ params.lm_head).float()
    handoff_err = row_rel_errors(served[0, 1], full[0]).item()
    finite = finite and bool(torch.isfinite(full).all())
    del hidden, full

    # 3: layer 0's SSD, chunked against its recurrence, in float32; then the
    # reference's unmasked decay planted in its place
    first = params.mamba_layers[0]
    x = _block(params.shared_attn, params.embed[prompts[:, :ZAMBA_SSD_STEPS]], cfg,
               positions[:ZAMBA_SSD_STEPS], attention=plain_attention)[0]
    x = first.norm(x).float()
    mixer = ssm.Mamba2(*(getattr(first.mixer, k).float() for k in ssm.NAMES))
    t0 = time.perf_counter()
    ssd, recurrence = ssd_recurrence_check(mixer, x, cfg)
    ssd["wall_ms"] = (time.perf_counter() - t0) * 1e3
    with planted_unmasked_decay():
        fault, _ = ssd_recurrence_check(mixer, x, cfg, step=recurrence)
    ssd["fault"] = {"nan_share": fault["nan_share"], "rel_err": fault["rel_err"],
                    "caught": not fault["ok"] and fault["nan_share"] > 0}
    del mixer, x, recurrence

    out = {
        "phase": "lm_zamba", "arch": cfg.name, "layers": cfg.n_layers,
        "cut": f"none: full width and depth, {cfg.n_layers} layers",
        "d_model": cfg.d_model, "ssm": {"d_inner": m.expand * cfg.d_model,
                                        "heads": m.expand * cfg.d_model // m.head_dim,
                                        "head_dim": m.head_dim, "state": m.state_dim,
                                        "conv": m.conv_width, "chunk": m.chunk},
        "shared_block": {"every": cfg.shared_attn_every, "applications": apps,
                         "heads": [cfg.n_heads, cfg.n_kv_heads],
                         "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff},
        "vocab": cfg.vocab, "params": n_params, "dtype": "bfloat16", "weights_gb": weight_gb,
        "batch": B, "prompt_len": P, "new_tokens": NEW, "init_ms": init["wall_ms"],
        "generate_ms": generate_ms, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_step_ms": step_ms, "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "bounds": bounds,
        "shares_of_bound": {"prefill": bounds["prefill"]["bound_ms"] / prefill_ms,
                            "decode_step": bounds["decode_step"]["bound_ms"] / decode_ms},
        "profiled": profiled, "launches": launches,
        "tol": {"serve": SERVE_TOL, "floor_factor": ZAMBA_FLOOR_FACTOR, "logits": limit},
        "checks": {"attention_in_situ_vs_plain": layer,
                   "prefill_vs_plain_rel_err": prefill_err,
                   "teacher_forced_decode_vs_plain_rel_err": decode_err,
                   "floor_float32_attention_vs_plain_rel_err": floor,
                   "greedy_decided_steps": decided, "greedy_disagreements": wrong,
                   "first_decode_vs_full_forward_rel_err": handoff_err,
                   "ssd_chunked_vs_recurrence": ssd, "finite": finite},
        "first_row_tokens": res.tokens[0][:8].tolist(),
        "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (zamba_launches_ok(launches, cfg) and finite
                 and tuple(res.tokens.shape) == (B, NEW)
                 and layer["ok"] and layer["fault"]["caught"]
                 and max(prefill_err, decode_err, handoff_err) <= limit and wrong == 0
                 and ssd["ok"] and ssd["fault"]["caught"])
    reading("lm_zamba", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=True,
            prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_zamba")
    return launches["generate"]


def lm_xlstm(args, dev) -> dict:
    """Phase lm_xlstm: xlstm-125m at full width and full depth (6 pairs of
    mLSTM -> sLSTM), bf16 weights from ``--seed``, XLSTM_BATCH x
    XLSTM_PROMPT prompt tokens and XLSTM_NEW greedy new tokens through
    ``ServeEngine.generate``.  Timed: init, the generate, a prefill and each
    decode step, each profiled with its device busy share and device ms by
    group (:func:`xlstm_groups`) beside its bound (:func:`xlstm_work`).
    Checks, in float32 on a copy of the weights: (1) the card against the
    CPU, logits within XLSTM_LOGITS_TOL of each row's max|logit|; (2) layer
    0's chunked mLSTM against its recurrence
    (:func:`mlstm_recurrence_check`), the causal mask dropped must fail it;
    (3) layer 1's sLSTM carried across two segments
    (:func:`slstm_carry_check`), the second restarted from the fresh state
    must fail it; (4) greedy tokens against greedy by full forward where
    the top-2 margin decides, and the prefill and first decode step against
    the full forward; (5) the bf16 serve finite and of its shape, its
    distance from float32 on the same weights reported (a floor, not held);
    (6) no kernel of the port launched through the generate, a prefill or
    decode.  Returns each kernel's launches in the generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, forward, prefill, xlstm
    from repro_torch.models.xlstm_lm import _n_pairs

    t_phase = time.perf_counter()
    cfg = get_arch(XLSTM_ARCH)
    B, P, NEW = XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW
    profile = functools.partial(moe_device_split, ranges=dict(XLSTM_OPS))
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    made = []
    init = profile(lambda: made.append(init_params(cfg, seed=args.seed, dtype=torch.bfloat16,
                                                   device=dev)), warm=False)
    params = made.pop()
    n_params = sum(t.numel() for t in params.parameters())
    weight_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 9)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :100], 2)  # warm-up: cuBLAS handles at these widths

    launches = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = dict(launch_counts())
    launches["generate"] = sum(by_kernel.values())
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = sum(launch_counts().values())
    cache_gb = sum(t.numel() * t.element_size() for g in cache.values() for t in g.values()) / 1e9
    reset_launch_counts()
    step_ms = []
    for i in range(1, NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": P + i - 1}, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = sum(step_ms) / len(step_ms)
    launches["decode"] = sum(launch_counts().values())
    # where the time goes: one prefill (of XLSTM_PROFILE_PROMPT tokens); one
    # decode step repeated (the states move on, which changes no shape or
    # operation)
    step = {"tokens": tokens[:, NEW - 2], "pos": P + NEW - 2}
    short = prompts[:, :XLSTM_PROFILE_PROMPT]
    t0 = time.perf_counter()
    profiled = {"init": init,
                "prefill": profile(lambda: prefill(params, {"tokens": short}, cfg), warm=False)}
    profile_s = time.perf_counter() - t0
    profiled["decode_step"] = profile(lambda: decode_step(params, cache, step, cfg), calls=3)
    for prof in profiled.values():
        prof["device_ms_by_group"] = xlstm_groups(prof["device_ms"])
    profiled["prefill"].update(prompt_len=XLSTM_PROFILE_PROMPT, record_and_split_s=profile_s)
    del cache
    bounds = {"prefill": zamba_bounds(xlstm_work(cfg, B, P)),
              "decode_step": zamba_bounds(xlstm_work(cfg, B, 1))}

    sections = {"serve_and_profile": time.perf_counter() - t_phase}
    mark = time.perf_counter

    # float32 copies of the weights: on the card for checks 1-5, on the CPU
    # for check 1's comparison
    f32 = float_model(params, cfg, dev)
    eng32 = ServeEngine(cfg, f32, max_len=XLSTM_CHECK_PROMPT + XLSTM_GREEDY_NEW, device=dev)

    # 1: the card against the CPU, teacher-forced on the card's tokens
    t_check = mark()
    short = prompts[:1, :XLSTM_CHECK_PROMPT]
    served32 = eng32.generate(short, XLSTM_GREEDY_NEW, keep_logits=True)
    tokens32 = torch.from_numpy(served32.tokens).to(dev)
    card = served32.logits[:, :XLSTM_CHECK_STEPS + 1]
    t0 = time.perf_counter()
    cpu = teacher_forced(float_model(params, cfg, torch.device("cpu")), cfg, short.cpu(),
                               tokens32[:, :XLSTM_CHECK_STEPS + 1].cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    card_cpu = row_rel_errors(card.cpu(), cpu)
    check_cpu = {"rows": tuple(card.shape[:2]), "row_rel_err_max": card_cpu.max().item(),
                 "row_rel_err": card_cpu[0].tolist(), "tol": XLSTM_LOGITS_TOL,
                 "cpu_wall_ms": cpu_ms,
                 "ok": card_cpu.max().item() <= XLSTM_LOGITS_TOL
                 and bool(torch.isfinite(cpu).all())}
    del cpu
    sections["check1"], t_check = mark() - t_check, mark()

    # 2: layer 0's mLSTM, chunked against its recurrence, in float32 over the
    # prompts (the pad runs); then the causal mask dropped
    first = f32.pairs[0]
    x0 = f32.embed[prompts]
    h0 = first.m_norm(x0)
    t0 = time.perf_counter()
    mlstm_check, recurrence = mlstm_recurrence_check(first.mlstm, h0, cfg)
    mlstm_check["wall_ms"] = (time.perf_counter() - t0) * 1e3
    with planted_unmasked_log_weights():
        fault, _ = mlstm_recurrence_check(first.mlstm, h0, cfg, step=recurrence)
    mlstm_check["fault"] = {"rel_err": fault["rel_err"], "caught": not fault["ok"]}
    del recurrence
    sections["check2"], t_check = mark() - t_check, mark()

    # 3: layer 1 (pair 0's sLSTM) carried across two segments; then the
    # second segment restarted from the fresh state
    xs = first.s_norm(x0 + xlstm.mlstm_apply(first.mlstm, h0, cfg)[0])
    slstm_check = slstm_carry_check(first.slstm, xs, cfg, XLSTM_SPLIT)
    fault = slstm_carry_check(first.slstm, xs, cfg, XLSTM_SPLIT, restart=True)
    slstm_check["fault"] = {"excess_over_tol": fault["excess_over_tol"],
                            "caught": not fault["ok"]}
    del x0, h0, xs
    sections["check3"], t_check = mark() - t_check, mark()

    # 4: greedy generation against greedy by full forward (prompt + the
    # tokens before each step), and the prefill and first decode step
    # against the full forward's rows
    full = []
    for i in range(XLSTM_GREEDY_NEW):
        seq = torch.cat([short, tokens32[:, :i]], 1)
        full.append(forward(f32, {"tokens": seq}, cfg)[:, -1].float())
    full = torch.stack(full, 1)
    decided, wrong = greedy_disagreements(full, tokens32, XLSTM_LOGITS_TOL)
    rows = row_rel_errors(served32.logits, full)[0]
    greedy = {"new_tokens": XLSTM_GREEDY_NEW, "decided_steps": decided, "disagreements": wrong,
              "prefill_vs_forward_rel_err": rows[0].item(),
              "first_decode_vs_forward_rel_err": rows[1].item(),
              "max_step_vs_forward_rel_err": rows.max().item(), "tol": XLSTM_LOGITS_TOL}
    greedy["ok"] = (wrong == 0 and max(rows[0].item(), rows[1].item()) <= XLSTM_LOGITS_TOL
                    and bool(torch.isfinite(full).all()))
    del full
    sections["check4"], t_check = mark() - t_check, mark()

    # 5: the bf16 serve finite and of its shape; its distance from float32 on
    # the same weights, teacher-forced on the served tokens: the floor
    served = res.logits
    plain32 = teacher_forced(f32, cfg, prompts, tokens)
    floor = {"prefill": row_rel_errors(served[:, 0], plain32[:, 0]).max().item(),
             "decode": row_rel_errors(served[:, 1:], plain32[:, 1:]).max().item()}
    decided16, wrong16 = greedy_disagreements(plain32, tokens, max(floor.values()))
    finite = bool(torch.isfinite(served).all())
    del plain32, f32, eng32
    sections["check5"] = mark() - t_check

    out = {
        "phase": "lm_xlstm", "arch": cfg.name, "layers": cfg.n_layers, "pairs": _n_pairs(cfg),
        "cut": f"none: full width and depth, {cfg.n_layers} layers",
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "mlstm": {"d_inner": 2 * cfg.d_model, "head_dim": 2 * cfg.d_model // cfg.n_heads,
                  "chunk": 64},
        "slstm": {"head_dim": cfg.d_model // cfg.n_heads, "ffn": 2 * cfg.d_model},
        "vocab": cfg.vocab, "params": n_params, "dtype": "bfloat16", "weights_gb": weight_gb,
        "cache_gb": cache_gb, "batch": B, "prompt_len": P, "new_tokens": NEW,
        "init_ms": init["wall_ms"], "generate_ms": generate_ms, "prefill_ms": prefill_ms,
        "decode_ms_per_step": decode_ms, "decode_step_ms": step_ms,
        "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "bounds": bounds,
        "shares_of_bound": {"prefill": bounds["prefill"]["bound_ms"] / prefill_ms,
                            "decode_step": bounds["decode_step"]["bound_ms"] / decode_ms},
        "profiled": profiled, "launches": launches,
        "checks": {"card_vs_cpu_float32": check_cpu,
                   "mlstm_chunked_vs_recurrence": mlstm_check,
                   "slstm_segment_carry": slstm_check, "greedy_vs_full_forward": greedy,
                   "bf16_vs_float32_floor": {**floor, "decided_steps": decided16,
                                             "disagreements": wrong16, "held": False},
                   "finite": finite},
        "first_row_tokens": res.tokens[0][:8].tolist(), "section_s": sections,
        "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (all(n == 0 for n in launches.values()) and finite
                 and tuple(res.tokens.shape) == (B, NEW)
                 and check_cpu["ok"] and greedy["ok"]
                 and mlstm_check["ok"] and mlstm_check["fault"]["caught"]
                 and slstm_check["ok"] and slstm_check["fault"]["caught"])
    reading("lm_xlstm", cfg, batch=B, prompt=P, new=NEW, max_len=P + NEW, init=True,
            prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_xlstm")
    return by_kernel


def lm_whisper(args, dev) -> dict:
    """Phase lm_whisper: whisper-base at full width and full depth (6 + 6
    layers), bf16 weights from ``--seed``, WHISPER_BATCH clips of
    WHISPER_FRAMES stub frames, WHISPER_PROMPT prompt tokens and
    WHISPER_NEW greedy new tokens each through ``ServeEngine.generate``
    (``extra={"frames": ...}``).  Timed: init, the encoder alone, the
    prefill, each decode step and the generate, each profiled with its
    device busy share and device ms by group (:func:`whisper_groups`)
    beside its bound (:func:`whisper_work`).  Checks: (1) the card against
    the CPU in float32 over WHISPER_CHECK_BATCH clips, logits within
    WHISPER_LOGITS_TOL of each row's max|logit|; (2) each decoder layer's
    attention in situ, kernel 8 against the plain version
    (:func:`checked_attention`), the window cut by SWA_FAULT keys must
    fail, and the served logits against the plain path within
    ZAMBA_FLOOR_FACTOR times the floor its float32 attention reads (at
    least SERVE_TOL); (3) the encoder made causal
    (:func:`planted_causal_encoder`) must fail check 1's limit; (4) the
    cross K/V padded by WHISPER_CROSS_PAD zero positions
    (:func:`padded_cross`) must fail check 1's limit; (5) greedy tokens
    against a teacher-forced full forward wherever the top-2 margin decides
    at check 2's limit, and the prefill and first decode step against that
    forward; (6) kernel 8 once a decoder layer a prefill, never in the
    encoder, a cross-attention or decode, the other kernels never
    (:func:`prefill_launches_ok`).  Returns each kernel's launches in the
    generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, encdec, encode, fake_frame_embeds, forward, prefill

    t_phase = time.perf_counter()
    cfg = get_arch(WHISPER_ARCH)
    B, F, P, NEW = WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW
    profile = functools.partial(moe_device_split, ranges=dict(WHISPER_OPS),
                                ranged=whisper_ranged)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    made = []
    init = profile(lambda: made.append(init_params(cfg, seed=args.seed, dtype=torch.bfloat16,
                                                   device=dev)), warm=False)
    params = made.pop()
    n_params = sum(t.numel() for t in params.parameters())
    weight_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 10)
    frames = fake_frame_embeds(gen, B, F, cfg.d_model, dtype=torch.bfloat16, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    extra = {"frames": frames}
    eng = ServeEngine(cfg, params, max_len=WHISPER_MAX_LEN, dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:, :16], 2, extra=extra)  # warm-up: cuBLAS handles at these widths

    def swa_launches():
        return launch_counts()["swa_attention"]

    launches = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, extra=extra, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = dict(launch_counts())
    launches["generate"] = by_kernel["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    enc_out = encode(params, frames, cfg)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    launches["encode"] = swa_launches()
    layer0 = params.dec_layers[0]
    enc_kv = encdec._cross_kv(layer0.xattn, enc_out, cfg)
    reset_launch_counts()
    encdec._cross_attn(layer0.xattn, params.embed[prompts], cfg, enc_kv)
    torch.cuda.synchronize()
    launches["cross_attention"] = swa_launches()
    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts, **extra}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = swa_launches()
    cache = eng._grow_cache(cache, B)
    cache_gb = sum(t.numel() * t.element_size() for g in cache.values() for t in g.values()) / 1e9
    reset_launch_counts()
    step_ms = []
    for i in range(1, NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": P + i - 1}, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = sum(step_ms) / len(step_ms)
    launches["decode"] = swa_launches()
    # where the time goes: the encoder, one prefill, one decode step
    # repeated at the same position (it rewrites the same self K/V slot),
    # the whole generate
    step = {"tokens": tokens[:, NEW - 2], "pos": P + NEW - 2}
    profiled = {"init": init, "encoder": profile(lambda: encode(params, frames, cfg)),
                "prefill": profile(lambda: prefill(params, {"tokens": prompts, **extra}, cfg)),
                "decode_step": profile(lambda: decode_step(params, cache, step, cfg), calls=3),
                "generate": profile(lambda: eng.generate(prompts, NEW, extra=extra),
                                    warm=False)}
    for prof in profiled.values():
        prof["device_ms_by_group"] = whisper_groups(prof["device_ms"])
    del cache
    bounds = {"encoder": zamba_bounds(whisper_work(cfg, B, F)),
              "prefill": zamba_bounds(whisper_work(cfg, B, F, P)),
              "decode_step": zamba_bounds(whisper_work(cfg, B, F, 1, P + NEW - 1))}
    sections = {"serve_and_profile": time.perf_counter() - t_phase}
    mark = time.perf_counter

    # 2: each decoder layer's attention on the kernel path's own q, k, v,
    # kernel 8 against the plain version; the window cut by SWA_FAULT keys
    # at the first layer must fail; then the served logits against the
    # plain path, the kernel path's tokens forced, held to the floor the
    # plain path with float32 attention reads
    t_check = mark()
    in_situ, fault_rows = [], []
    prefill(params, {"tokens": prompts, **extra}, cfg,
            attention=checked_attention(swa_attention_chunked, in_situ))
    positions = torch.arange(P, dtype=torch.int32, device=dev)
    encdec._decoder_layer(layer0, params.embed[prompts], cfg, positions, enc_kv,
                          attention=checked_attention(swa_attention_chunked, fault_rows,
                                                      cut=SWA_FAULT))
    del enc_out, enc_kv
    layer = {"row_norm_rel_err": [r[0] for r in in_situ],
             "row_norm_rel_err_mean": [r[1] for r in in_situ],
             "row_tol": SWA_ROW_TOL[torch.bfloat16],
             "row_mean_tol": SWA_ROW_MEAN_TOL[torch.bfloat16], "ok": in_situ_ok(in_situ),
             "calls": len(in_situ),
             "fault": {"window": P - SWA_FAULT, "row_norm_rel_err": fault_rows[0][0],
                       "row_norm_rel_err_mean": fault_rows[0][1],
                       "caught": not in_situ_ok(fault_rows)}}

    def float32_attention(q, k, v, window, scale=None):
        return swa_attention_chunked(q.float(), k.float(), v.float(), window,
                                     scale=scale).to(q.dtype)

    forced = functools.partial(teacher_forced, params, cfg, prompts, tokens, extra,
                               grow=eng._grow_cache)
    served = res.logits
    plain = forced(attention=swa_attention_chunked)
    prefill_err = row_rel_errors(served[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(served[:, 1:], plain[:, 1:]).max().item()
    rounded = forced(attention=float32_attention)
    floor = {"prefill": row_rel_errors(rounded[:, 0], plain[:, 0]).max().item(),
             "decode": row_rel_errors(rounded[:, 1:], plain[:, 1:]).max().item()}
    limit = max(SERVE_TOL, ZAMBA_FLOOR_FACTOR * max(floor.values()))
    finite = bool(torch.isfinite(served).all() and torch.isfinite(plain).all()
                  and torch.isfinite(rounded).all())
    del plain, rounded
    sections["check2"], t_check = mark() - t_check, mark()

    # 5: greedy tokens against one teacher-forced full forward over the
    # prompt and the generated tokens (the encoder run again)
    full = forward(params, {"tokens": torch.cat([prompts, tokens[:, :-1]], 1), **extra},
                   cfg)[:, P - 1:].float()
    decided, wrong = greedy_disagreements(full, tokens, limit)
    rows = row_rel_errors(served, full)
    greedy = {"new_tokens": NEW, "decided_steps": decided, "disagreements": wrong,
              "prefill_vs_forward_rel_err": rows[:, 0].max().item(),
              "first_decode_vs_forward_rel_err": rows[:, 1].max().item(),
              "max_step_vs_forward_rel_err": rows.max().item(), "tol": limit}
    greedy["ok"] = (wrong == 0 and max(greedy["prefill_vs_forward_rel_err"],
                                       greedy["first_decode_vs_forward_rel_err"]) <= limit
                    and bool(torch.isfinite(full).all()))
    del full
    sections["check5"], t_check = mark() - t_check, mark()

    # 1, 3, 4: float32 copies of the weights on the card and on the CPU,
    # WHISPER_CHECK_BATCH clips; the card's generate against the CPU's
    # teacher-forced steps on its tokens; then the causal encoder and the
    # padded cross K/V, each against the same CPU steps
    f32 = float_model(params, cfg, dev)
    eng32 = ServeEngine(cfg, f32, max_len=WHISPER_MAX_LEN, device=dev)
    nb, steps = WHISPER_CHECK_BATCH, WHISPER_CHECK_STEPS + 1
    short = {"frames": frames[:nb].float()}
    served32 = eng32.generate(prompts[:nb], steps, extra=short, keep_logits=True)
    tokens32 = torch.from_numpy(served32.tokens).to(dev)
    t0 = time.perf_counter()
    cpu_model = float_model(params, cfg, torch.device("cpu"))
    cpu = teacher_forced(cpu_model, cfg, prompts[:nb].cpu(), tokens32.cpu(),
                         {"frames": short["frames"].cpu()},
                         grow=ServeEngine(cfg, cpu_model, max_len=WHISPER_MAX_LEN,
                                          device="cpu")._grow_cache)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    del cpu_model
    card_cpu = row_rel_errors(served32.logits.cpu(), cpu)
    check_cpu = {"rows": tuple(card_cpu.shape), "row_rel_err_max": card_cpu.max().item(),
                 "tol": WHISPER_LOGITS_TOL, "cpu_wall_ms": cpu_ms,
                 "ok": card_cpu.max().item() <= WHISPER_LOGITS_TOL
                 and bool(torch.isfinite(cpu).all())}
    with planted_causal_encoder():
        causal = teacher_forced(f32, cfg, prompts[:nb], tokens32, short,
                                grow=eng32._grow_cache)
    causal_err = row_rel_errors(causal.cpu(), cpu).max().item()
    with_pad = padded_cross(eng32._grow_cache, WHISPER_CROSS_PAD)
    padded = teacher_forced(f32, cfg, prompts[:nb], tokens32, short, grow=with_pad)
    # the prefill's logits come before the cache is grown: the pad shows
    # from the first decode step
    pad_err = row_rel_errors(padded[:, 1:].cpu(), cpu[:, 1:]).max().item()
    faults = {"causal_encoder": {"row_rel_err_max": causal_err,
                                 "caught": causal_err > WHISPER_LOGITS_TOL},
              "padded_cross": {"pad": WHISPER_CROSS_PAD, "row_rel_err_max": pad_err,
                               "caught": pad_err > WHISPER_LOGITS_TOL}}
    del f32, eng32, cpu, causal, padded
    sections["checks134"] = mark() - t_check

    launch_report = {"swa_attention": launches,
                     "other_kernels": {k: n for k, n in by_kernel.items()
                                       if k != "swa_attention"}}
    out = {
        "phase": "lm_whisper", "arch": cfg.name,
        "layers": {"encoder": cfg.enc_layers, "decoder": cfg.n_layers},
        "cut": f"none: full width and depth, {cfg.enc_layers} + {cfg.n_layers} layers",
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "params": n_params, "dtype": "bfloat16", "weights_gb": weight_gb, "cache_gb": cache_gb,
        "batch": B, "frames": F, "prompt_len": P, "new_tokens": NEW,
        "max_len": WHISPER_MAX_LEN, "init_ms": init["wall_ms"], "encode_ms": encode_ms,
        "generate_ms": generate_ms, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_step_ms": step_ms, "prefill_clips_per_s": B / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "bounds": bounds,
        "shares_of_bound": {"encoder": bounds["encoder"]["bound_ms"] / encode_ms,
                            "prefill": bounds["prefill"]["bound_ms"] / prefill_ms,
                            "decode_step": bounds["decode_step"]["bound_ms"] / decode_ms},
        "profiled": profiled, "launches": launch_report,
        "tol": {"card_vs_cpu": WHISPER_LOGITS_TOL, "serve": SERVE_TOL,
                "floor_factor": ZAMBA_FLOOR_FACTOR, "logits": limit},
        "checks": {"card_vs_cpu_float32": check_cpu,
                   "attention_in_situ_vs_plain": layer,
                   "prefill_vs_plain_rel_err": prefill_err,
                   "teacher_forced_decode_vs_plain_rel_err": decode_err,
                   "floor_float32_attention_vs_plain_rel_err": floor,
                   "planted_faults": faults, "greedy_vs_full_forward": greedy,
                   "finite": finite},
        "first_row_tokens": res.tokens[0][:8].tolist(), "section_s": sections,
        "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (prefill_launches_ok(launch_report, cfg.n_layers) and finite
                 and tuple(res.tokens.shape) == (B, NEW)
                 and check_cpu["ok"] and layer["ok"] and layer["fault"]["caught"]
                 and max(prefill_err, decode_err) <= limit
                 and all(f["caught"] for f in faults.values()) and greedy["ok"])
    reading("lm_whisper", cfg, batch=B, prompt=P, new=NEW, max_len=WHISPER_MAX_LEN, frames=F,
            init=True, prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_whisper")
    return by_kernel


def lm_llava(args, dev) -> dict:
    """Phase lm_llava: llava-next-34b at full width, depth LLAVA_LAYERS,
    bf16 weights from ``--seed``, LLAVA_BATCH requests of one image's 2,880
    stub patch embeddings and LLAVA_PROMPT text tokens, LLAVA_NEW greedy new
    tokens each, through ``ServeEngine.generate`` (``extra={"patch_embeds":
    ...}``).  Timed: init, the generate, the prefill and each decode step,
    each profiled with its device busy share and device ms by group
    (:func:`llava_groups`) beside its bound (:func:`llava_work`).  Checks:
    (1) each layer's attention in situ, kernel 8 against the plain version,
    the window cut by SWA_FAULT keys must fail, and the served logits
    against the plain path within ZAMBA_FLOOR_FACTOR times the floor its
    float32 attention reads (at least SERVE_TOL); (2) decode from pos0 =
    S_text (the patches forgotten) must leave the served decode logits by
    more than check 1's limit; (3) greedy tokens against a teacher-forced
    full forward wherever the top-2 margin decides at that limit, and the
    prefill and first decode step against that forward; (4) kernel 8 once a
    layer a prefill, never in decode; every logit finite.  Returns each
    kernel's launches in the generate."""
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, fake_patch_embeds, forward, prefill
    from repro_torch.models.transformer import _block, _embed_inputs

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(LLAVA_ARCH), n_layers=LLAVA_LAYERS)
    B, P, NEW, NP = LLAVA_BATCH, LLAVA_PROMPT, LLAVA_NEW, cfg.n_patches
    S = NP + P
    max_len = S + NEW
    plain_attention = functools.partial(swa_attention_chunked, chunk=LLAVA_PLAIN_CHUNK)
    profile = functools.partial(moe_device_split, ranges=dict(LLAVA_OPS))
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    made = []
    init = profile(lambda: made.append(init_params(cfg, seed=args.seed, dtype=torch.bfloat16,
                                                   device=dev)), warm=False)
    params = made.pop()
    n_params = sum(t.numel() for t in params.parameters())
    weight_gb = sum(t.numel() * t.element_size() for t in params.parameters()) / 1e9
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 11)
    patches = fake_patch_embeds(gen, B, NP, cfg.d_model, dtype=torch.bfloat16, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    extra = {"patch_embeds": patches}
    eng = ServeEngine(cfg, params, max_len=max_len, dtype=torch.bfloat16, device=dev)
    # warm-up: cuBLAS handles at these widths (one request, 16 text tokens)
    eng.generate(prompts[:1, :16], 2, extra={"patch_embeds": patches[:1]})

    launches = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, NEW, extra=extra, keep_logits=True)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = dict(launch_counts())
    launches["generate"] = by_kernel["swa_attention"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = torch.from_numpy(res.tokens).to(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    _, cache = prefill(params, {"tokens": prompts, **extra}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"] = launch_counts()["swa_attention"]
    cache = eng._grow_cache(cache, B)
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    reset_launch_counts()
    step_ms = []
    for i in range(1, NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1], "pos": S + i - 1}, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = sum(step_ms) / len(step_ms)
    launches["decode"] = launch_counts()["swa_attention"]
    step = {"tokens": tokens[:, NEW - 2], "pos": S + NEW - 2}
    profiled = {"init": init,
                "prefill": profile(lambda: prefill(params, {"tokens": prompts, **extra}, cfg)),
                "decode_step": profile(lambda: decode_step(params, cache, step, cfg), calls=3)}
    for prof in profiled.values():
        prof["device_ms_by_group"] = llava_groups(prof["device_ms"])
    del cache
    bounds = {"prefill": zamba_bounds(llava_work(cfg, B, P)),
              "decode_step": zamba_bounds(llava_work(cfg, B, P, S + NEW - 1))}
    sections = {"serve_and_profile": time.perf_counter() - t_phase}
    mark = time.perf_counter

    # 1: each layer's attention in situ, kernel 8 against the plain
    # version; the window cut by SWA_FAULT keys at the first layer must
    # fail; the served logits against the plain path and its floor
    t_check = mark()
    in_situ, fault_rows = [], []
    prefill(params, {"tokens": prompts, **extra}, cfg,
            attention=checked_attention(plain_attention, in_situ))
    x = _embed_inputs(params, prompts, patches)
    _block(params.layers[0], x, cfg, torch.arange(S, dtype=torch.int32, device=dev),
           attention=checked_attention(plain_attention, fault_rows, cut=SWA_FAULT))
    del x
    layer = {"row_norm_rel_err": [r[0] for r in in_situ],
             "row_norm_rel_err_mean": [r[1] for r in in_situ],
             "row_tol": SWA_ROW_TOL[torch.bfloat16],
             "row_mean_tol": SWA_ROW_MEAN_TOL[torch.bfloat16], "ok": in_situ_ok(in_situ),
             "calls": len(in_situ),
             "fault": {"window": S - SWA_FAULT, "row_norm_rel_err": fault_rows[0][0],
                       "row_norm_rel_err_mean": fault_rows[0][1],
                       "caught": not in_situ_ok(fault_rows)}}

    def float32_attention(q, k, v, window, scale=None):
        return plain_attention(q.float(), k.float(), v.float(), window,
                               scale=scale).to(q.dtype)

    forced = functools.partial(teacher_forced, params, cfg, prompts, tokens, extra,
                               grow=eng._grow_cache)
    served = res.logits
    plain = forced(attention=plain_attention)
    prefill_err = row_rel_errors(served[:, 0], plain[:, 0]).max().item()
    decode_err = row_rel_errors(served[:, 1:], plain[:, 1:]).max().item()
    rounded = forced(attention=float32_attention)
    floor = {"prefill": row_rel_errors(rounded[:, 0], plain[:, 0]).max().item(),
             "decode": row_rel_errors(rounded[:, 1:], plain[:, 1:]).max().item()}
    limit = max(SERVE_TOL, ZAMBA_FLOOR_FACTOR * max(floor.values()))
    finite = bool(torch.isfinite(served).all() and torch.isfinite(plain).all()
                  and torch.isfinite(rounded).all())
    del plain, rounded
    sections["check1"], t_check = mark() - t_check, mark()

    # 2: decode from pos0 = S_text, the patches forgotten: its first step
    # writes over a patch's slot and masks the text out
    forgot = teacher_forced(params, cfg, prompts, tokens[:, :2], extra, grow=eng._grow_cache,
                            pos0=P)
    forgot_err = row_rel_errors(forgot[:, 1], served[:, 1]).max().item()
    positions = {"pos0": S, "forgotten_pos0": P, "first_step_row_rel_err": forgot_err,
                 "caught": forgot_err > limit}
    del forgot
    sections["check2"], t_check = mark() - t_check, mark()

    # 3: greedy tokens against one teacher-forced full forward over the
    # patches, the prompt and the generated tokens
    full = forward(params, {"tokens": torch.cat([prompts, tokens[:, :-1]], 1), **extra},
                   cfg)[:, S - 1:].float()
    decided, wrong = greedy_disagreements(full, tokens, limit)
    rows = row_rel_errors(served, full)
    greedy = {"new_tokens": NEW, "decided_steps": decided, "disagreements": wrong,
              "prefill_vs_forward_rel_err": rows[:, 0].max().item(),
              "first_decode_vs_forward_rel_err": rows[:, 1].max().item(),
              "max_step_vs_forward_rel_err": rows.max().item(), "tol": limit}
    greedy["ok"] = (wrong == 0 and max(greedy["prefill_vs_forward_rel_err"],
                                       greedy["first_decode_vs_forward_rel_err"]) <= limit
                    and bool(torch.isfinite(full).all()))
    del full
    sections["check3"] = mark() - t_check

    launch_report = {"swa_attention": launches,
                     "other_kernels": {k: n for k, n in by_kernel.items()
                                       if k != "swa_attention"}}
    out = {
        "phase": "lm_llava", "arch": cfg.name, "layers": cfg.n_layers,
        "cut": ("none: full width and depth" if cfg.n_layers == get_arch(LLAVA_ARCH).n_layers
                else f"depth cut to {cfg.n_layers} of {get_arch(LLAVA_ARCH).n_layers}"),
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "n_patches": NP, "params": n_params, "dtype": "bfloat16", "weights_gb": weight_gb,
        "cache_gb": cache_gb, "batch": B, "prompt_len": P, "sequence": S, "new_tokens": NEW,
        "max_len": max_len, "init_ms": init["wall_ms"], "generate_ms": generate_ms,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms, "decode_step_ms": step_ms,
        "prefill_tokens_per_s": B * S / (prefill_ms / 1e3),
        "decode_tokens_per_s": B / (decode_ms / 1e3), "peak_memory_gb": peak_gb,
        "held_at_start_gb": held_gb, "bounds": bounds,
        "shares_of_bound": {"prefill": bounds["prefill"]["bound_ms"] / prefill_ms,
                            "decode_step": bounds["decode_step"]["bound_ms"] / decode_ms},
        "profiled": profiled, "launches": launch_report,
        "tol": {"serve": SERVE_TOL, "floor_factor": ZAMBA_FLOOR_FACTOR, "logits": limit},
        "checks": {"attention_in_situ_vs_plain": layer,
                   "prefill_vs_plain_rel_err": prefill_err,
                   "teacher_forced_decode_vs_plain_rel_err": decode_err,
                   "floor_float32_attention_vs_plain_rel_err": floor,
                   "forgotten_patches_decode": positions, "greedy_vs_full_forward": greedy,
                   "finite": finite},
        "first_row_tokens": res.tokens[0][:8].tolist(), "section_s": sections,
        "phase_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "wall_ms": (time.perf_counter() - t_phase) * 1e3,
    }
    out["ok"] = (prefill_launches_ok(launch_report, cfg.n_layers) and finite and tuple(res.tokens.shape) == (B, NEW)
                 and layer["ok"] and layer["fault"]["caught"]
                 and max(prefill_err, decode_err) <= limit and positions["caught"]
                 and greedy["ok"])
    reading("lm_llava", cfg, batch=B, prompt=P, new=NEW, max_len=max_len, init=True,
            prefill_ms=prefill_ms, decode_ms=decode_ms, peak_gb=peak_gb, held_gb=held_gb)
    emit(out)
    if not out["ok"]:
        fail("lm_llava")
    return by_kernel


# ----------------------------------------------------------------- dryrun --
# Phase dryrun: the dry run's count (`repro_torch.launch.costing`, traced on
# the host's meta device; `launch.roofline`'s bound on the H100) of every LM
# phase at that phase's own configuration, batch, lengths and depth, held
# against what the phase measured in this run: (a) the function's FLOPs and
# bytes of its prefill and decode step (lm_train: its step) against the
# phase's hand-written count within DRYRUN_TOL, after the named conventions
# of :func:`dryrun_hand` (each an exact closed form); (b) the phase's
# measured prefill and decode ms (lm_qwen3: its generate; lm_train: its
# median step) not below the bound, its share at most 100%; (c) the
# phase's max_memory_allocated within DRYRUN_PEAK_BAND of the prediction:
# what was allocated when the phase reset its peak, plus the traced peak of
# its window (:func:`dryrun_window`).  Two planted counts of lm_serve's
# prefill must fail (a): one that drops attention's products
# (:func:`planted_dropped_attention`), one that counts the plain
# attention's whole squares where kernel 8 runs
# (:func:`planted_whole_square`).  No card work, under DRYRUN_LIMIT_S.  The
# xLSTM's prefill (12,000 serial sLSTM steps, slow to trace) is traced at
# DRYRUN_XLSTM_PROMPTS and extrapolated linearly to its prompt: every count
# of its prefill is linear in the prompt (no attention; the chunked mLSTM's
# chunk of 64 divides both), its peak is not quite (extrapolated 0.733 GB
# above the held bytes where the whole 2,000-token trace reads 0.804, and
# from 64 and 128 tokens 1.010: the pair chosen keeps the ratio in band).
DRYRUN_TOL = 0.02
DRYRUN_PEAK_BAND = (0.8, 1.25)
DRYRUN_LIMIT_S = 90.0
DRYRUN_XLSTM_PROMPTS = (128, 256)
READINGS: dict = {}  # LM phase -> what it measured (:func:`reading`)


def reading(phase: str, cfg, **kw) -> None:
    """Record what an LM phase measured, for the dryrun phase: its config,
    batch, prompt, new tokens, the cache's max_len, its times, its peak and
    what was allocated when it reset the peak (``held_gb``), ``init`` when
    the weights were drawn inside that window."""
    READINGS[phase] = dict(cfg=cfg, **kw)


def _stage(cfg, model, mode, batch, out, cache_read=None) -> dict:
    """One traced stage's function work and executed counts."""
    from repro_torch.launch.costing import param_read_bytes, serve_bytes

    flops = {k: float(v) for k, v in mode.function_flops.items()}
    return {"flops_by_dtype": flops, "flops": sum(flops.values()),
            "bytes": float(serve_bytes(cfg, model, mode, batch, out, cache_read)),
            "params_read": float(param_read_bytes(model, cfg, batch["tokens"].numel(), mode)),
            "executed_flops": float(sum(mode.executed_flops.values())),
            "executed_bytes": float(mode.executed_bytes)}


def dryrun_window(r: dict, prompt: int) -> dict:
    """One serving phase's window traced on the meta device: its init when
    the weights were drawn inside it, the engine (quantizing, for
    lm_quant), then ServeEngine.generate(keep_logits=True)'s prefill and
    first decode step -> {"prefill": work, "decode": work, "peaks": the
    live bytes' peak in each stage: "init" (the weights when drawn in the
    window, the engine), "prefill" (and the cache grown to max_len),
    "decode", "end"}.  Later decode steps repeat the first one's transient
    over a cache of the same size, each keeping one more (B, V) float32 row
    of logits, and the generate ends by stacking them: "decode" and "end"
    add those rows.  The warm-up generate before the timed one (a shorter
    prompt) is not traced."""
    from repro_torch import ServeEngine
    from repro_torch.launch.costing import CountingMode, attention_boundaries, meta_model
    from repro_torch.models import decode_step, fake_frame_embeds, fake_patch_embeds, prefill

    cfg, b, new = r["cfg"], r["batch"], r["new"]
    max_len = r["max_len"] - r["prompt"] + prompt
    mode = CountingMode()
    model = None if r["init"] else meta_model(cfg)
    with attention_boundaries(mode), mode, torch.no_grad():
        if model is None:
            model = meta_model(cfg)
        gen, extra = torch.Generator(), {}
        if cfg.family == "encdec":
            extra["frames"] = fake_frame_embeds(gen, b, r["frames"], cfg.d_model,
                                                dtype=torch.bfloat16, device="meta")
        if cfg.family == "vlm":
            extra["patch_embeds"] = fake_patch_embeds(gen, b, cfg.n_patches, cfg.d_model,
                                                      dtype=torch.bfloat16, device="meta")
        prompts = torch.empty((b, prompt), dtype=torch.int64, device="meta")
        eng = ServeEngine(cfg, model, max_len=max_len, dtype=torch.bfloat16,
                          quantize=r.get("quantize", False), device="meta")
        batch = {"tokens": prompts, **extra}
        peaks = {"init": mode.peak}
        mode.reset_counts()
        out = prefill(eng.model(), batch, cfg)
        stages = {"prefill": _stage(cfg, model, mode, batch, out)}
        logits, cache = out
        del out
        cache = eng._grow_cache(cache, b)
        kept = [logits.float()]
        step = {"tokens": eng._sample(logits, 0.0, None),
                "pos": prompt + (cfg.n_patches if cfg.family == "vlm" else 0)}
        del logits
        peaks["prefill"] = mode.peak
        cache_read = sum(t.nbytes for _, t in leaves(cache))
        mode.reset_counts()
        out = decode_step(eng.model(), cache, step, cfg)
        stages["decode"] = _stage(cfg, model, mode, step, out, cache_read)
        kept.append(out[0].float())
        del out
        row = kept[-1].nbytes
        peaks["decode"] = mode.peak + (new - 2) * row
        peaks["end"] = mode.live + (new - 2) * row + new * row  # every row kept, then stacked
    return {**stages, "peaks": {k: float(v) for k, v in peaks.items()}}


def dryrun_tp(r: dict) -> dict:
    """lm_tp's rank program as lm_tp traced it on the counting mesh (check 4:
    ``make_test_mesh(1, model)``, `launch.costing.trace_cell`): one rank's
    prefill and its decode step over the cache's last position -> {stage:
    work}."""
    out = {}
    for stage, tr in r["traces"].items():
        flops = {k: float(v) for k, v in tr.function_flops.items()}
        out[stage] = {"flops_by_dtype": flops, "flops": sum(flops.values()),
                      "bytes": tr.function_bytes, "executed_flops": tr.executed_flops}
    return out


def dryrun_tp_train(r: dict) -> dict:
    """lm_tp_train's bf16 step of one rank as it was traced on the counting
    mesh (check 3) -> {"step": work}."""
    tr = r["traces"]["bf16"]
    flops = {k: float(v) for k, v in tr.function_flops.items()}
    return {"step": {"flops_by_dtype": flops, "flops": sum(flops.values()),
                     "bytes": tr.function_bytes, "executed_flops": tr.executed_flops}}


def _extrapolated(a, b, xa: float, xb: float, x: float):
    """Every number of ``a`` (at xa) and ``b`` (at xb), nested in dicts,
    linearly extrapolated to x."""
    if isinstance(a, dict):
        return {k: _extrapolated(a[k], b[k], xa, xb, x) for k in a}
    return a + (b - a) * (x - xa) / (xb - xa)


def dryrun_train(r: dict) -> dict:
    """lm_train's window traced on the meta device: its init, the AdamW
    state, then one step of TRAIN_ACCUM microbatches traced as a step of two
    (the function's FLOPs scale by TRAIN_ACCUM / 2: each microbatch's work
    is the same; the peak is a microbatch's transient over the same float32
    buffers), and the copy of the parameters check 4 holds through the last
    step -> {"step": work, "peaks": {"init", "steps"}: bytes}."""
    from repro_torch.launch.costing import CountingMode, attention_boundaries, meta_model
    from repro_torch.models import trainable
    from repro_torch.training import adamw_init, cosine_schedule, make_train_step
    from repro_torch.training import named_parameters

    cfg, micro, seq = r["cfg"], r["micro"], r["seq"]
    mode = CountingMode(train=True)
    with attention_boundaries(mode), mode:
        model = trainable(meta_model(cfg))
        named = named_parameters(model)
        opt = adamw_init(named)
        peak_init = mode.peak
        step_fn = make_train_step(cfg, lr_fn=cosine_schedule(TRAIN_LR, warmup=1,
                                                            total=TRAIN_STEPS),
                                  accum=2, fused_loss=True)
        batch = {k: torch.empty((2 * micro, seq), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        mode.reset_counts()
        model, opt, _ = step_fn(model, opt, batch)
        param_bytes = sum(p.nbytes for p in named.values())
        opt_bytes = sum(t.nbytes for _, t in leaves({"m": opt.m, "v": opt.v}))
    scale = r["accum"] / 2
    flops = {k: float(v) * scale for k, v in mode.function_flops.items()}
    # the optimizer's pass: parameters read and written, the float32
    # gradient buffers read, float32 m and v read and written
    nbytes = 2 * param_bytes + opt_bytes // 2 + 2 * opt_bytes
    return {"step": {"flops_by_dtype": flops, "flops": sum(flops.values()), "bytes": float(nbytes),
                     "executed_flops": float(sum(mode.executed_flops.values())) * scale},
            "peaks": {"init": float(peak_init), "steps": float(mode.peak + param_bytes)},
            "param_bytes": param_bytes}


def dense_work(cfg, b: int, q_len: int, kv_len: int = None) -> dict:
    """A dense GQA model's hand count: :func:`llava_work`'s terms without
    its patch projection (n_patches 0)."""
    work = llava_work(dataclasses.replace(cfg, n_patches=0), b, q_len, kv_len)
    work.pop("patch_proj", None)
    return work


def dryrun_hand(name: str, r: dict) -> dict:
    """{stage: (the phase's hand count {op: (bytes, operations, ...)}, the
    named conventions {name: (bytes, operations)} added to it)}: where the
    dry run counts by design otherwise, each an exact closed form.

      embed_write: the hand counts write the gathered embedding rows as
        well as read them; the dry run reads them (an input of the first
        layer, not an output of the step);
      window (h2o-danube): kernel 8 and the ring cache see min(W, .) keys,
        llava_work's dense terms every causal pair and every cached key;
      mlstm_decode_update (xlstm): the decode step's outer product v k^T
        added into C is elementwise, not a product the dry run counts;
      chunk_padding (xlstm): the prefill's chunked scan at the prompt's
        length (the extrapolation's), xlstm_work's over it padded to the
        chunk;
      fp32_gradients (lm_train): accumulated over TRAIN_ACCUM microbatches,
        the optimizer reads float32 gradient buffers; train_work a bf16
        gradient."""
    from repro_torch.kernels.swa_attention.ref import valid_pairs
    from repro_torch.models.moe import moe_capacity

    cfg = r["cfg"]
    if name == "lm_tp":  # one model rank: its heads, its ff columns, its vocab shard
        from repro_torch.parallel.tensor import head_layout

        m = r["model"]
        hq, hkv = head_layout(cfg, m)
        cfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                  head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff // m,
                                  vocab=cfg.vocab // m)
    if name == "lm_train":
        w = train_work(cfg, r["micro"] * r["accum"], r["seq"])
        return {"step": ({"train_work": (w["bytes"], w["flops"])},
                         {"fp32_gradients": (2 * w["params"], 0)})}
    if name == "lm_tp_train":  # one rank: its rows, heads, ff columns, vocab shard
        from repro_torch.parallel.tensor import head_layout

        data, m = r["mesh"]
        hq, hkv = head_layout(cfg, m)
        rank_cfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                       head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff // m,
                                       vocab=cfg.vocab // m)
        w = train_work(rank_cfg, r["rows"], r["seq"])
        return {"step": ({"train_work": (w["bytes"], w["flops"])},
                         {"zero1_moments": (-w["params"] * 4 * 4 * (data - 1) // data, 0)})}
    b, p, new = r["batch"], r["prompt"], r["new"]
    kv = p + new - 1
    d = cfg.d_model
    if name in ("lm_serve", "lm_quant", "lm_qwen3", "lm_tp"):
        hand = {"prefill": dense_work(cfg, b, p), "decode": dense_work(cfg, b, p, kv)}
    elif name in ("lm_moe", "lm_mla"):
        hand = {"prefill": moe_serve_work(cfg, b, p, p, moe_capacity(b * p, cfg)),
                "decode": moe_serve_work(cfg, b, 1, kv, moe_capacity(b, cfg))}
    elif name == "lm_zamba":
        hand = {"prefill": zamba_work(cfg, b, p), "decode": zamba_work(cfg, b, 1, kv)}
    elif name == "lm_xlstm":
        hand = {"prefill": xlstm_work(cfg, b, p), "decode": xlstm_work(cfg, b, 1)}
    elif name == "lm_whisper":
        hand = {"prefill": whisper_work(cfg, b, r["frames"], p),
                "decode": whisper_work(cfg, b, r["frames"], 1, kv)}
    else:  # lm_llava: kv counts the patches
        hand = {"prefill": llava_work(cfg, b, p),
                "decode": llava_work(cfg, b, p, cfg.n_patches + kv)}
    conv = {"prefill": {"embed_write": (-b * p * d * 2, 0)},
            "decode": {"embed_write": (-b * d * 2, 0)}}
    if cfg.swa_window:
        w, L, hd = cfg.swa_window, cfg.n_layers, cfg.resolved_head_dim
        kv_row, ops = cfg.n_kv_heads * hd * 2 * 2, 4 * hd * b * cfg.n_heads * L
        conv["prefill"]["window"] = (L * b * (min(w, p) - p) * kv_row,
                                     ops * (valid_pairs(p, w) - p * (p + 1) // 2))
        conv["decode"]["window"] = (L * b * (min(w, kv) - kv) * kv_row, ops * (min(w, kv) - kv))
    if cfg.family == "ssm":
        from repro_torch.models.xlstm_lm import _n_pairs

        pairs, nh, hm = _n_pairs(cfg), cfg.n_heads, 2 * d // cfg.n_heads
        conv["decode"]["mlstm_decode_update"] = (0, -2 * pairs * b * nh * hm * hm)
        chunk = min(64, p)
        padded = -(-p // chunk) * chunk
        conv["prefill"]["chunk_padding"] = (
            0, -pairs * b * nh * (padded - p) * (4 * chunk * hm + 4 * hm * hm + 4 * hm))
    return {k: (hand[k], conv[k]) for k in hand}


def _work_check(dry: dict, hand: dict, conv: dict) -> dict:
    """(a) for one stage: the dry run's FLOPs and bytes against the hand
    count plus its conventions."""
    h_bytes = sum(w[0] for w in hand.values()) + sum(c[0] for c in conv.values())
    h_flops = sum(w[1] for w in hand.values()) + sum(c[1] for c in conv.values())
    rel = {"flops": dry["flops"] / h_flops - 1, "bytes": dry["bytes"] / h_bytes - 1}
    return {"dry": {"flops": dry["flops"], "bytes": dry["bytes"]},
            "hand": {"flops": h_flops, "bytes": h_bytes},
            "conventions": {k: {"bytes": c[0], "flops": c[1]} for k, c in conv.items()},
            "rel": rel, "ok": all(abs(v) <= DRYRUN_TOL for v in rel.values())}


def dryrun_bound_ms(work: dict) -> float:
    """max(each dtype's FLOPs over its peak, bytes over the HBM rate), ms."""
    from repro_torch.launch.roofline import roofline_terms

    terms = roofline_terms(work["flops_by_dtype"], work["bytes"], 0.0)
    return max(terms.values()) * 1e3


@contextlib.contextmanager
def planted_dropped_attention():
    """The dryrun phase's first planted count: attention's products
    dropped (every attention boundary counts 0)."""
    from repro_torch.launch import costing

    saved = costing._attention_flops
    costing._attention_flops = lambda q, v, pairs: 0
    try:
        yield
    finally:
        costing._attention_flops = saved


@contextlib.contextmanager
def planted_whole_square():
    """The second: kernel 8's calls traced through the plain chunked
    attention, whose whole (chunk, keys) squares are counted as the
    function's work."""
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.launch import costing
    from repro_torch.models import attention, encdec

    saved = costing.attention_boundaries

    @contextlib.contextmanager
    def boundaries(mode):
        with saved(mode):
            kept = attention.swa_attention, encdec.swa_attention
            attention.swa_attention = encdec.swa_attention = swa_attention_chunked
            try:
                yield
            finally:
                attention.swa_attention, encdec.swa_attention = kept

    costing.attention_boundaries = boundaries
    try:
        yield
    finally:
        costing.attention_boundaries = saved


def dryrun_phase(args) -> dict:
    """Phase dryrun (see DRYRUN_TOL's comment): for every LM phase that ran,
    its dry run's work against its hand count, its measured time against
    the bound, its peak against the prediction; the two planted counts."""
    t_phase = time.perf_counter()
    rows, dries = {}, {}
    for name, r in READINGS.items():
        hand = dryrun_hand(name, r)
        if name == "lm_train":
            dry = dryrun_train(r)
            stages = {"step": r["step_ms"]}
        elif name == "lm_tp":
            dry = dryrun_tp(r)
            stages = {"prefill": r["prefill_ms"], "decode": r["decode_ms"]}
        elif name == "lm_tp_train":
            dry = dryrun_tp_train(r)
            stages = {"step": r["step_ms"]}
        elif r["cfg"].family == "ssm":
            xa, xb = DRYRUN_XLSTM_PROMPTS
            dry = _extrapolated(dryrun_window(r, xa), dryrun_window(r, xb), xa, xb, r["prompt"])
            stages = {"prefill": r["prefill_ms"], "decode": r["decode_ms"]}
        else:
            dry = dryrun_window(r, r["prompt"])
            stages = ({"generate": r["generate_ms"]} if "generate_ms" in r else
                      {"prefill": r["prefill_ms"], "decode": r["decode_ms"]})
        if name == "lm_quant":
            # lm_serve's model and shapes: its work, the weights read as the
            # engine's int8 codes and float32 scales (the bound's bytes);
            # the engine dequantizes every call, so its trace reads no
            # weight of the model
            ratio = r["quant_bytes"] / r["bf16_bytes"]
            for k in ("prefill", "decode"):
                dry[k] = dict(dries["lm_serve"][k])
                dry[k]["bytes"] -= dry[k]["params_read"] * (1 - ratio)
            work = {k: dict(v, note="lm_serve's (a); the bound reads the int8 weights")
                    for k, v in rows["lm_serve"]["work"].items()}
        else:
            work = {k: _work_check(dry[k], *hand[k]) for k in hand}
        dries[name] = dry
        bounds = {k: dryrun_bound_ms(dry[k]) for k in hand}
        if "generate" in stages:
            bounds["generate"] = bounds["prefill"] + (r["new"] - 1) * bounds["decode"]
        shares = {k: bounds[k] / ms for k, ms in stages.items()}
        rows[name] = {
            "work": work, "bound_ms": {k: bounds[k] for k in stages}, "measured_ms": stages,
            "share": shares, "executed_flops": {k: dry[k]["executed_flops"] for k in hand},
            "ok": (all(w["ok"] for w in work.values())
                   and all(s <= 1.0 for s in shares.values()))}
        if name == "lm_tp":
            # lm_tp's check 4 held each rank's counted collectives against
            # these traces; its verdict is carried here (rank 0 also holds
            # the whole model for its one-rank run: no peak is predicted)
            rows[name]["collectives"] = r["collectives"]
            rows[name]["ok"] = rows[name]["ok"] and all(
                c["ok"] for c in r["collectives"].values())
            continue
        if name == "lm_tp_train":
            # the four ranks share the card: the bound is four ranks' work
            # (each rank's the same); check 3's verdict is carried here, and
            # no peak is predicted (the ranks also run the one-rank step)
            bound = math.prod(r["mesh"]) * bounds["step"]
            rows[name]["bound_ms"] = {"step": bound, "rank": bounds["step"]}
            rows[name]["share"] = {"step": bound / r["step_ms"]}
            rows[name]["collectives"] = {k: v for k, v in r["collectives"].items()
                                         if k in ("f32", "bf16", "ok")}
            rows[name]["ok"] = (all(w["ok"] for w in work.values()) and bound <= r["step_ms"]
                                and r["collectives"]["ok"])
            continue
        predicted = r["held_gb"] * 1e9 + max(dry["peaks"].values())
        peak_ratio = r["peak_gb"] * 1e9 / predicted
        rows[name]["peak"] = {"predicted_gb": predicted / 1e9, "measured_gb": r["peak_gb"],
                              "held_gb": r["held_gb"], "ratio": peak_ratio}
        rows[name]["ok"] = (rows[name]["ok"]
                            and DRYRUN_PEAK_BAND[0] <= peak_ratio <= DRYRUN_PEAK_BAND[1])
    # the planted counts, on lm_serve's prefill
    faults = {}
    if "lm_serve" in READINGS:
        r = READINGS["lm_serve"]
        hand, conv = dryrun_hand("lm_serve", r)["prefill"]
        for fault, planted in (("dropped_attention", planted_dropped_attention),
                               ("whole_square", planted_whole_square)):
            with planted():
                check = _work_check(dryrun_window(r, r["prompt"])["prefill"], hand, conv)
            faults[fault] = {"rel": check["rel"], "caught": not check["ok"]}
    seconds = time.perf_counter() - t_phase
    out = {"phase": "dryrun", "tol": DRYRUN_TOL, "peak_band": DRYRUN_PEAK_BAND,
           "phases": rows, "faults": faults, "seconds": seconds}
    out["ok"] = (bool(rows) and all(row["ok"] for row in rows.values())
                 and len(faults) == 2 and all(f["caught"] for f in faults.values())
                 and seconds < DRYRUN_LIMIT_S)
    emit(out)
    if not out["ok"]:
        fail("dryrun")
    return out


# ------------------------------------------------- the backend policy layer
def calibration_phase(args, dev):
    """Phase 11: `repro_torch.core.calibrate.calibrate` at the reference's
    default grid with the block search, written to CALIB_PATH.  Prints the
    medians of "torch" and "cuda" per primitive and size, the crossovers,
    each block_t candidate's median; checks the table round trip and that
    ``python -m repro_torch.core.calibrate --show`` reads the same
    crossovers from the file."""
    from repro_torch.core import calibrate as cal

    started = time.perf_counter()
    table = cal.calibrate(tune_blocks=True, save=True, path=CALIB_PATH)
    calibrate_seconds = time.perf_counter() - started
    medians = {prim: {str(n): {be: t * 1e3 for be, t in m.items()} for n, m in sizes.items()}
               for prim, sizes in table.timings["crossover"].items()}
    candidates = {prim: {param: {str(c): (t if isinstance(t, str) else t * 1e3)
                                 for c, t in cands.items()} for param, cands in params.items()}
                  for prim, params in table.timings["blocks"].items()}
    checks = {}
    previous = os.environ.get("REPRO_TORCH_CALIB_CACHE")
    os.environ["REPRO_TORCH_CALIB_CACHE"] = CALIB_PATH
    try:
        loaded = cal.load_table()
    finally:
        if previous is None:
            del os.environ["REPRO_TORCH_CALIB_CACHE"]
        else:
            os.environ["REPRO_TORCH_CALIB_CACHE"] = previous
    checks["round_trip"] = {"ok": loaded is not None and loaded.thresholds == table.thresholds
                            and loaded.blocks == table.blocks and loaded.device == table.device
                            and loaded.platform == table.platform}
    env = {**os.environ, "REPRO_TORCH_CALIB_CACHE": CALIB_PATH,
           "PYTHONPATH": os.path.join(ROOT, "src")}
    show = subprocess.run([sys.executable, "-m", "repro_torch.core.calibrate", "--show"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    want_lines = [f"  {prim:<22s} {table.crossover(prim)!r:>10}" for prim in cal.PRIMITIVES]
    lines = show.stdout.splitlines()
    checks["cli_show"] = {"rc": show.returncode, "stderr": show.stderr[-400:],
                          "ok": show.returncode == 0 and "source: cache" in show.stdout
                          and all(w in lines for w in want_lines)}
    finite = all(math.isfinite(t) and t > 0 for sizes in medians.values()
                 for m in sizes.values() for t in m.values())
    checks["medians"] = {"ok": finite and set(medians) == set(cal.PRIMITIVES)
                         and all(len(v) == 4 for v in medians.values())}
    emit({"phase": "calibration", "device": torch.cuda.get_device_name(0), "table": CALIB_PATH,
          "grid": {"sizes": [512, 2048, 8192, 32768], "d": 8, "max_lag": 8, "window": 64,
                   "nperseg": 256, "bandwidth": 8, "iters": 3, "warmup": 1},
          "median_ms": medians,
          "crossover": {p: (None if math.isinf(v) else v) for p, v in table.thresholds.items()},
          "blocks": table.blocks, "block_candidate_ms": candidates,
          "calibrate_seconds": calibrate_seconds,
          "phase_seconds": time.perf_counter() - started, "checks": checks})
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        fail("calibration checks failed", failed=bad)
    return table


class CheckedAuto:
    """The "auto" backend with every call held against the "cuda" backend
    on the same inputs: where "auto" routed to "cuda", bitwise and with the
    same kernel launches; where it routed to "torch", within PRIMITIVE_TOL
    and with no launch.  ``calls`` collects (primitive, route, size, the
    size of one problem on the trailing axes (mask rows, or segments x
    segment length; None for the rest), problems on the leading axes, ok,
    worst error)."""

    def __init__(self, auto):
        from repro_torch.core.backend import CudaBackend

        self.auto, self.cuda, self.calls = auto, CudaBackend(), []
        self.name = "auto_checked"

    def __getattr__(self, prim):
        if prim not in PRIMITIVE_KERNEL:
            raise AttributeError(prim)
        from repro_torch.kernels import launch_counts

        def call(*a, **kw):
            before = dict(self.auto.routes)
            c0 = launch_counts()
            got = getattr(self.auto, prim)(*a, **kw)
            c1 = launch_counts()
            want = getattr(self.cuda, prim)(*a, **kw)
            c2 = launch_counts()
            (key,) = [k for k, v in self.auto.routes.items() if v != before.get(k, 0)]
            auto_l = {k: c1[k] - c0[k] for k in c0 if c1[k] != c0[k]}
            cuda_l = {k: c2[k] - c1[k] for k in c1 if c2[k] != c1[k]}
            if key[1] == "cuda":
                ok, worst = bitwise_equal(got, want) and auto_l == cuda_l, 0.0
            else:
                parts = got if prim in ("fused_plan_update", "fused_lagged_moments") else (got,)
                wparts = want if len(parts) > 1 else (want,)
                reps = [compare(g, w, t) for g, w, t in zip(parts, wparts, PRIMITIVE_TOL[prim])
                        if w is not None]
                ok = not auto_l and all(r["ok"] for r in reps)
                worst = max(r["max_rel_err"] for r in reps)
            if prim.startswith("segment"):
                one, problems = a[0].shape[-3] * a[0].shape[-2], math.prod(a[0].shape[:-3])
            elif prim in ("masked_lagged_sums", "fused_lagged_moments", "fused_plan_update"):
                one, problems = a[1].shape[-1], math.prod(a[1].shape[:-1])
            else:
                one, problems = None, 1
            self.calls.append((prim, key[1], key[2], one, problems, ok, worst))
            return got

        return call


def route_report(calls: list) -> dict:
    """CheckedAuto's calls by (primitive, route): counts, sizes, problems,
    whether every one was held, the worst error."""
    out = {}
    for prim, route, size, _, problems, ok, worst in calls:
        r = out.setdefault(f"{prim}/{route}", {"calls": 0, "sizes": [], "problems": [],
                                               "ok": True, "worst_err": 0.0})
        r["calls"] += 1
        r["ok"] &= ok
        r["worst_err"] = max(r["worst_err"], worst)
        if size not in r["sizes"]:
            r["sizes"].append(size)
        if problems not in r["problems"]:
            r["problems"].append(problems)
    return out


def auto_phase(args, dev, table) -> None:
    """Phase 12: "auto" with the measured table installed, over the main
    path's plan (AUTO_CHUNKS chunks) and one session tick of 65,536 tenants
    with a query of SESSION_QUERY.  Prints every (primitive, backend)
    route with its call count and sizes; every call held against the "cuda"
    backend (CheckedAuto); the end results against the "cuda" backend's
    run: bitwise with equal launches (on the main path also equal device
    kernels per run in one of KPC_PAIRS back-to-back profiles,
    kernels_per_call, and equal aten operators, ops_per_call) when every
    route was "cuda", within
    the members' tolerances otherwise.  The session's calls are sized by
    one tenant's problem on the trailing axes (rows, or segments x segment
    length), never by the tenants; a primitive whose "cuda" won at every
    grid size is routed to "cuda" there.  Uninstalls the table on return."""
    from repro_torch import SeriesFrame
    from repro_torch.core import calibrate as cal
    from repro_torch.core.backend import AutoBackend
    from repro_torch.kernels import launch_counts, reset_launch_counts

    started = time.perf_counter()
    cal.set_active_table(table)  # a tuned block_t changes kernel 1's Welch tiling
    checks, out = {}, {}
    series = make_series(AUTO_CHUNKS * CHUNK, D, args.seed, dev)
    chunks = list(series.split(CHUNK))

    def plan_run(backend):
        frame = declare_plan(SeriesFrame.from_chunks(chunks, backend=backend, device=dev))
        res = frame.collect()
        torch.cuda.synchronize()
        return res

    # ---- the main path's plan
    auto = AutoBackend(table=table)
    plan_run(auto)  # warm-up
    auto.routes.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = plan_run(auto)
    auto_ms = (time.perf_counter() - t0) * 1e3
    auto_launches = launch_counts()
    routes = {f"{p}/{r}/{n}": c for (p, r, n), c in sorted(auto.routes.items())}
    reset_launch_counts()
    t0 = time.perf_counter()
    want = plan_run("cuda")
    cuda_ms = (time.perf_counter() - t0) * 1e3
    cuda_launches = launch_counts()
    checked = CheckedAuto(AutoBackend(table=table))
    plan_run(checked)
    all_cuda = all(r == "cuda" for (_, r, _) in auto.routes)
    if all_cuda:
        # the device kernels of one run each, profiled back to back: a
        # profile's counts of PyTorch's kernels can step by one or two
        # between two runs of the same code (on the H100 1 of 8 auto phases
        # saw 90 / 88 kernels of one arange kernel), so up to KPC_PAIRS
        # pairs; a kernel that "auto" adds shows in every pair.  The aten
        # operators each run dispatches are counted exactly.
        pairs = []
        while len(pairs) < KPC_PAIRS and (not pairs or pairs[-1]["auto"] != pairs[-1]["cuda"]):
            pairs.append({"auto": kernels_per_call(lambda: plan_run(auto), 1),
                          "cuda": kernels_per_call(lambda: plan_run("cuda"), 1)})
        kpc = pairs[-1]
        opc = {"auto": ops_per_call(lambda: plan_run(auto)),
               "cuda": ops_per_call(lambda: plan_run("cuda"))}
        ends = {"bitwise": bitwise_equal(got, want), "launches_equal": auto_launches ==
                cuda_launches, "kernels_per_call_equal": kpc["auto"] == kpc["cuda"],
                "ops_per_call_equal": opc["auto"] == opc["cuda"]}
        ends_ok = all(ends.values())
        ends["profile_pairs"] = [{k: (p["auto"].get(k), p["cuda"].get(k))
                                  for k in sorted(set(p["auto"]) | set(p["cuda"]))
                                  if p["auto"].get(k) != p["cuda"].get(k)} for p in pairs]
        ends["ops_per_call"] = sum(opc["cuda"].values())
    else:
        kpc = None
        members = {name: compare(got[name], want[name], tol) for name, tol in MEMBER_TOL.items()}
        ends = {"members": members, "note": "some calls routed to torch: held at the members' "
                "plain tolerances, not bitwise"}
        ends_ok = all(r["ok"] for r in members.values())
    calls = route_report(checked.calls)
    checks["main_path"] = {"every_route_cuda": all_cuda, "end_results": ends,
                           "calls": calls, "ok": ends_ok and all(v["ok"] for v in calls.values())}
    out["main_path"] = {"chunks": AUTO_CHUNKS, "rows_per_chunk": CHUNK, "channels": D,
                        "routes": routes, "auto_collect_ms": auto_ms,
                        "cuda_collect_ms": cuda_ms, "launches": {"auto": auto_launches,
                                                                 "cuda": cuda_launches},
                        "kernels_per_call": kpc}
    del series, chunks, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one session tick at 65,536 tenants, then a query of SESSION_QUERY
    users = SESSION_USERS
    ids = np.arange(users)
    x = SessionSource(users, args.seed, dev).next()
    sample = np.sort(np.random.default_rng(args.seed + 22).choice(users, SESSION_QUERY,
                                                                   replace=False))
    checked = CheckedAuto(AutoBackend(table=table))
    sess_auto = new_session(dev, users, backend=checked)
    sess_auto.ingest(ids, x)
    torch.cuda.synchronize()
    tick_calls, checked.calls = checked.calls, []
    sess_auto.query_batch(sample)
    torch.cuda.synchronize()
    query_calls = checked.calls
    sessions = {}
    for label, backend in (("auto", AutoBackend(table=table)), ("cuda", "cuda")):
        sess = new_session(dev, users, backend=backend)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.ingest(ids, x)
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) * 1e3
        tick_launches = launch_counts()
        reset_launch_counts()
        t0 = time.perf_counter()
        answer = sess.query_batch(sample)
        torch.cuda.synchronize()
        sessions[label] = {"session": sess, "tick_ms": tick_ms, "tick_launches": tick_launches,
                           "query": answer, "query_ms": (time.perf_counter() - t0) * 1e3,
                           "query_launches": launch_counts()}
    session_routes = {f"{p}/{r}/{n}": c for (p, r, n), c in
                      sorted(sessions["auto"]["session"]._backend.routes.items())}
    every_cuda = all(c[1] == "cuda" for c in tick_calls + query_calls)
    lanes = [s["session"].state_template()["group_0"]["lanes"].flatten()
             for s in (sessions["auto"], sessions["cuda"])]
    if every_cuda:
        ends = {"bitwise_state": all(torch.equal(a, b) for a, b in zip(*lanes)),
                "bitwise_query": bitwise_equal(sessions["auto"]["query"],
                                               sessions["cuda"]["query"]),
                "launches_equal": all(sessions["auto"][k] == sessions["cuda"][k]
                                      for k in ("tick_launches", "query_launches"))}
        ends_ok = all(ends.values())
    else:
        rep = session_compare(sessions["auto"]["query"], sessions["cuda"]["query"])
        ends = {"members": rep, "tenants": len(sample), "note": "some calls routed to "
                "torch: held at SESSION_TOL, not bitwise"}
        ends_ok = session_ok(rep)
    # sized per problem: every call's size is that of one tenant's problem
    # on the trailing axes, with the tenants on a leading axis
    sized = {"tick": all(one is None or size == one for _, _, size, one, _, _, _ in tick_calls)
             and any(n == users for *_, n, _, _ in tick_calls),
             "query": all(one is None or size == one
                          for _, _, size, one, _, _, _ in query_calls)
             and any(n == len(sample) for *_, n, _, _ in query_calls)}
    # a primitive whose "cuda" won at every grid size goes to "cuda" at any size
    won_everywhere = sorted(p for p, m in table.timings["crossover"].items()
                            if all(v["cuda"] <= v["torch"] for v in m.values()))
    routed_cuda = all(route == "cuda" for prim, route, *_ in tick_calls + query_calls
                      if prim in won_everywhere)
    tick_report, query_report = route_report(tick_calls), route_report(query_calls)
    checks["session"] = {"every_route_cuda": every_cuda, "end_results": ends,
                         "tick_calls": tick_report, "query_calls": query_report,
                         "sized_per_tenant": sized, "won_everywhere": won_everywhere,
                         "won_everywhere_routed_cuda": routed_cuda,
                         "ok": ends_ok and all(sized.values()) and routed_cuda
                         and all(v["ok"] for r in (tick_report, query_report)
                                 for v in r.values())}
    out["session"] = {"tenants": users, "d": SESSION_D, "rows": SESSION_ROWS,
                      "queried": len(sample), "routes": session_routes,
                      **{f"{label}_{k}": v[k] for label, v in sessions.items()
                         for k in ("tick_ms", "query_ms", "tick_launches", "query_launches")}}
    del sessions, sess_auto, lanes, x, checked
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - started
    emit({"phase": "auto", "device": torch.cuda.get_device_name(0),
          "crossover": {p: (None if math.isinf(v) else v) for p, v in table.thresholds.items()},
          "blocks": table.blocks, **out, "phase_seconds": seconds, "checks": checks})
    cal.set_active_table(None)
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        fail("auto checks failed", failed=bad)


def tear(path: str) -> None:
    """Overwrite bytes in the middle of a file (a torn write)."""
    with open(path, "r+b") as f:
        f.seek(max(os.path.getsize(path) // 2, 0))
        f.write(b"\x00TORN\x00")


def plan_call_args(dev, rows: int = 1000, d: int = 8) -> tuple:
    """One ``fused_plan_update`` call's arguments on ``dev``: ``rows``
    starts of a seeded (rows + 63, d) series, H = 8, moments(16), Welch
    64 / 32."""
    g = torch.Generator(device=dev)
    g.manual_seed(rows)
    y = torch.randn((rows + 63, d), generator=g, device=dev)
    mask = torch.ones((rows,), dtype=torch.bool, device=dev)
    z0 = torch.zeros((), dtype=torch.int32, device=dev)
    taper = torch.hann_window(64, periodic=False, device=dev)
    return (y, mask, z0, 8, (16,), (64,), (32,), (taper,))


def breaker_phase(args, dev) -> None:
    """Phase 13: the scenario of tests/test_chaos.py:602 on the card through
    StatsGateway at CHAOS_USERS tenants, the gateway phase's plan.  Run (a):
    a (cuda, cuda) breaker, ``backend.fused_plan_update`` failing every
    call, generation 1 torn, tick 2 stalled: every answer bitwise the
    fault-free gateway's, one trip, the restart identical, and after
    generation 3 is torn the restore walks back past [3, 1].  Run (b): a
    (cuda, cuda) breaker whose first three firings fail: one trip, two
    failed probes, one recovery, every answer bitwise the fault-free run's.
    Run (c): the default (cuda, torch) breaker on the card's tensors: the
    injected failure is re-raised, the open breaker refuses rather than
    serve from the plain version, and the probe after the cooldown is
    bitwise "cuda" and closes it."""
    import asyncio
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import list_steps
    from repro_torch.core.backend import CircuitBreakerBackend, CudaBackend
    from repro_torch.runtime import chaos
    from repro_torch.serving.gateway import Degraded, GatewayConfig, StatsGateway

    started = time.perf_counter()
    users = CHAOS_USERS
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 23)
    bins = torch.randint(GATEWAY_BINS[0], GATEWAY_BINS[1] + 1, (users,), generator=g,
                         device=dev)
    src = SessionSource(users, args.seed + 23, dev, bins=bins)
    rounds = [src.next().cpu().numpy() for _ in range(4)]
    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    ckdir = tempfile.mkdtemp(prefix="breaker_ckpt_")
    checks, metrics = {}, {}

    async def drive(gw, do_rounds, tick_s=None):
        answers = []
        for host in do_rounds:
            futs = [gw.submit_ingest(u, host[u]) for u in range(users)]
            qfuts = [gw.submit_query(u) for u in range(users)]
            t0 = time.perf_counter()
            await gw.tick()
            if tick_s is not None:
                tick_s.append(time.perf_counter() - t0)
            await asyncio.gather(*futs)
            answers.append(list(await asyncio.gather(*qfuts)))
        return answers

    async def query_all(gw):
        qfuts = [gw.submit_query(u) for u in range(users)]
        await gw.tick()
        return list(await asyncio.gather(*qfuts))

    try:
        base_cfg = dict(max_pending_ingest=users, max_pending_query=users)
        free_gw = StatsGateway(new_gateway_session(dev, users), GatewayConfig(**base_cfg))
        free_ticks = []
        free = run(drive(free_gw, rounds, free_ticks))  # free[k]: after round k + 1
        run(free_gw.stop(final_snapshot=False))
        del free_gw
        metrics["fault_free_tick_ms"] = [t * 1e3 for t in free_ticks]

        # ---- run (a): (cuda, cuda), bitwise
        # the watchdog's budget: three steady fault-free ticks (tick 0 pays
        # the plan's first use), never below the reference's 0.05 s
        deadline = max(3 * max(free_ticks[1:]), 0.05)
        cfg = GatewayConfig(**base_cfg, checkpoint_dir=ckdir, snapshot_every=1,
                            keep_checkpoints=3, tick_deadline=0.0, degraded_recovery=1)

        def chaos_gateway():
            br = CircuitBreakerBackend(primary=CudaBackend(), fallback=CudaBackend(),
                                       trip_after=1, cooldown_calls=2)
            return StatsGateway(new_gateway_session(dev, users, backend=br), cfg)

        inj = chaos.FaultInjector(seed=args.seed)
        inj.fail("backend.fused_plan_update", calls=range(10**6))
        inj.corrupt("checkpoint.payload", calls={1})
        inj.stall("gateway.tick", calls={BREAKER_STALL_TICK}, seconds=2 * deadline)
        a = {}
        gw = chaos_gateway()
        chaos.install(inj)
        got = run(drive(gw, rounds[:2]))
        a["ticks_bitwise"] = [answers_equal(got[0], free[0]), answers_equal(got[1], free[1])]
        gw.config.tick_deadline = deadline
        got2 = run(drive(gw, rounds[2:3]))
        a["ticks_bitwise"].append(answers_equal(got2[0], free[2]))
        a["degraded"] = gw.health()["state"] == "degraded"
        a["snapshots_deferred"] = gw.counters["snapshots_deferred"]
        try:
            gw.submit_query(0)
            a["shed"] = False
        except Degraded:
            a["shed"] = True
        run(gw.tick())  # tick 3: clean -> ok + snapshot
        a["recovered"] = gw.health()["state"] == "ok"
        a["ticks_bitwise"].append(answers_equal(run(query_all(gw)), free[2]))  # tick 4
        bm = gw.health()["breaker"]
        a["breaker"] = {k: bm[k] for k in ("trips", "recoveries", "fallback_calls", "open")}
        a["fused_plan_update"] = {k: v for k, v in bm["primitives"]["fused_plan_update"].items()
                                  if k != "last_error"}
        gw._loop_rt.manager.flush()
        gw.config.tick_deadline = 0.0
        run(gw.stop(final_snapshot=False))
        del gw
        gw2 = chaos_gateway()
        a["restart"] = {"restored": gw2.counters["restored_from_snapshot"],
                        "skipped": gw2._loop_rt.last_restore_skipped,
                        "bitwise": answers_equal(run(query_all(gw2)), free[2]),
                        "programs_ingest": gw2.counters["programs_ingest"]}
        run(gw2.stop(final_snapshot=False))
        del gw2
        a["generations"] = list_steps(ckdir)
        tear(os.path.join(ckdir, "step_0000000003", "arrays.npz"))
        gw3 = chaos_gateway()
        a["walk_back"] = {"restored": gw3.counters["restored_from_snapshot"],
                          "skipped": gw3._loop_rt.last_restore_skipped, "tick": gw3._tick,
                          "bitwise": answers_equal(run(query_all(gw3)), free[0])}
        run(gw3.stop(final_snapshot=False))
        del gw3
        chaos.clear()
        a["log_has_first_fault"] = ("backend.fused_plan_update", 0, "fail") in inj.log
        a["ok"] = (all(a["ticks_bitwise"]) and a["degraded"] and a["snapshots_deferred"] == 1
                   and a["shed"] and a["recovered"] and a["breaker"]["trips"] == 1
                   and a["breaker"]["fallback_calls"] > 0
                   and a["fused_plan_update"]["primary_calls"] == 0
                   and a["restart"] == {"restored": 1, "skipped": [], "bitwise": True,
                                        "programs_ingest": 0}
                   and a["generations"] == [0, 1, 3]
                   and a["walk_back"] == {"restored": 1, "skipped": [3, 1], "tick": 1,
                                          "bitwise": True}
                   and a["log_has_first_fault"])
        a["deadline_s"] = deadline
        checks["run_a_cuda_cuda"] = a

        # ---- run (b): (cuda, cuda), the first three firings fail
        br = CircuitBreakerBackend(primary=CudaBackend(), fallback=CudaBackend(),
                                   trip_after=1, cooldown_calls=2)
        gw = StatsGateway(new_gateway_session(dev, users, backend=br), GatewayConfig(**base_cfg))
        inj_b = chaos.FaultInjector(seed=args.seed).fail("backend.fused_plan_update",
                                                           calls={0, 1, 2})
        chaos.install(inj_b)
        got = run(drive(gw, rounds))
        chaos.clear()
        bm = gw.health()["breaker"]
        run(gw.stop(final_snapshot=False))
        del gw
        b = {"ticks_bitwise": [answers_equal(x, y) for x, y in zip(got, free)],
             "breaker": {k: bm[k] for k in ("trips", "recoveries", "fallback_calls", "open")},
             "fused_plan_update": {k: v for k, v in bm["primitives"]["fused_plan_update"].items()
                                   if k != "last_error"},
             "log": [list(e) for e in inj_b.log]}
        b["ok"] = (all(b["ticks_bitwise"]) and bm["trips"] == 1 and bm["recoveries"] == 1
                   and b["fused_plan_update"]["probes"] == 3 and bm["open"] == [])
        checks["run_b_trip_and_recover"] = b
        del got, free, rounds

        # ---- run (c): a "torch" fallback never serves the card's tensors
        c = {}
        br = CircuitBreakerBackend(trip_after=1, cooldown_calls=2)  # (cuda, torch)
        plan = plan_call_args(dev)
        want = CudaBackend().fused_plan_update(*plan)
        with chaos.scoped(chaos.FaultInjector().fail("backend.fused_plan_update", calls={0})):
            for step in ("failure_reraised", "open_refuses"):
                try:
                    br.fused_plan_update(*plan)
                    c[step] = False
                except chaos.InjectedFault:
                    c[step] = step == "failure_reraised"
                except RuntimeError as e:
                    c[step] = step == "open_refuses" and "CPU tensors only" in str(e)
            c["probe_bitwise"] = bitwise_equal(br.fused_plan_update(*plan), want)
        bm = br.breaker_metrics()
        c["breaker"] = {k: bm[k] for k in ("trips", "recoveries", "fallback_calls", "open")}
        c["ok"] = (c["failure_reraised"] and c["open_refuses"] and c["probe_bitwise"]
                   and c["breaker"] == {"trips": 1, "recoveries": 1, "fallback_calls": 0,
                                        "open": []})
        checks["run_c_torch_fallback_refused"] = c
    finally:
        chaos.clear()
        loop.close()
        shutil.rmtree(ckdir, ignore_errors=True)
    seconds = time.perf_counter() - started
    emit({"phase": "breaker", "device": torch.cuda.get_device_name(0), "tenants": users,
          "d": SESSION_D, "rows_per_tick": SESSION_ROWS, "metrics": metrics,
          "phase_seconds": seconds, "checks": checks})
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        fail("breaker checks failed", failed=bad)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=64, help="chunks of 65,536 rows")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)

    # ---------------------------------------------------- 1. device, build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          "nvidia-smi: no output", flush=True)
    lagmom_fault = start_lagmom_fault_build()  # beside the library's own nvcc processes
    path, nvcc_s, log = _build.build(verbose=True)
    _build.library()
    # registers and spills per kernel, and ptxas's notes of wgmma serialized
    # or setmaxnreg ignored (kernel 8's warp specialisation needs neither)
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(key in ln for key in ("registers", "spill", "Compiling entry",
                                          "Performance Loss", "setmaxnreg"))]
    emit({"phase": "build", "nvcc_seconds": nvcc_s, "library": os.path.relpath(path, ROOT),
          "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "ptxas": ptxas})

    # phases 2-8 (the statistics paths, kernels 1-7); their multi-GB
    # tensors are freed on return
    stats = stats_paths(args, dev, lagmom_fault)
    gc.collect()
    torch.cuda.empty_cache()
    # the overlapping block store: kernels 1 and 2 batched over its blocks
    store = store_phase(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the distribution layer: the store's path on a one-rank NCCL mesh
    mesh = mesh_phase(args, dev, store)
    del store["collect"], store["after"], store["replan"]
    gc.collect()
    torch.cuda.empty_cache()
    # the multi-tenant session: kernels 1-4 batched over tenants
    session_phase(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the gateway over a session with forecasts: checkpoints, restart, chaos
    gateway = gateway_phase(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 9-10: kernel 8 alone, then the LM serving path through it, then
    # the same model and prompts with int8 weights
    swa = swa_kernel(args, dev)
    serve = lm_serve(args, dev)
    serve_launches = serve["launches"]
    quant_launches = lm_quant(args, dev, serve)
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    # the MoE family: llama4-maverick at full width, depth cut (69.3 GB of
    # weights: danube's are gone), then qwen3-0.6b at full width and depth
    moe_launches = lm_moe(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # multi-head latent attention: deepseek-v2 at full width, depth cut
    # (57.72 GB of weights: llama4's are gone), kernel 8 at q/k 192, v 128
    mla_launches = lm_mla(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    qwen_launches = lm_qwen3(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # training: qwen3-0.6b at full width and depth, sequence 4,096, AdamW
    # steps under deterministic algorithms (in a child process); no kernel
    # on the path
    train_launches = lm_train_process(args)
    gc.collect()
    torch.cuda.empty_cache()
    # tensor parallelism: qwen3-0.6b at full width and depth over two model
    # ranks on the card (two processes, gloo), kernel 8 on each rank's heads
    tp_launches = lm_tp(args, dev, swa["tp"])
    gc.collect()
    torch.cuda.empty_cache()
    # the tensor-parallel train step: qwen3-0.6b at full width and depth over
    # a (2, 2) mesh on the card (four processes, gloo); no kernel on the path
    tp_train_launches = lm_tp_train(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the Mamba2 / shared-attention hybrid: zamba2-7b at full width and
    # depth (13.50 GB of weights: qwen3's are gone), kernel 8 at 112, G = 1
    zamba_launches = lm_zamba(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the xLSTM family: xlstm-125m at full width and depth, no kernel on its
    # path (both mixers are plain PyTorch)
    xlstm_launches = lm_xlstm(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the encoder-decoder: whisper-base at full width and depth, kernel 8
    # once a decoder layer (64, G = 1); then the VLM: llava-next-34b at full
    # width (68.9 GB of weights at full depth), kernel 8 at 128, G = 7
    whisper_launches = lm_whisper(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    llava_launches = lm_llava(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run of every LM phase above, on the host (no card work)
    dryrun_phase(args)
    # the paper's last estimators at its VAR workload sizes, then graphs
    paper_var_launches = paper_var_phase(args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    graphs_phase(args, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # phases 11-13: the backend policy layer -- the calibration measured on
    # the card, "auto" with its table, the counted circuit breaker
    auto_phase(args, dev, calibration_phase(args, dev))
    breaker_phase(args, dev)

    # ------------------------------------------------ 14. the kernels line
    # launches: each kernel's count from the run of its own path (kernel 8:
    # the lm_serve generate, one prefill)
    parity = {**stats["parity"], "swa_attention": swa["parity"]}
    timing = {**stats["timing"], "swa_attention": swa["timing"]}
    bounds = {**stats["bounds"], "swa_attention": swa["bound"]}
    path_launches = {**stats["launches"], "swa_attention": serve_launches}
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in parity[name].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": t["library_ms"],
            "store_launches": store["launches"].get(name, 0),
            "mesh_launches": mesh["launches"].get(name, 0),
            "gateway_launches_per_tick": gateway["launches_per_tick"].get(name, 0),
            "gateway_launches_per_query": gateway["launches_per_query"].get(name, 0),
            "paper_var_launches": paper_var_launches.get(name, 0),
            "lm_quant_launches": quant_launches if name == "swa_attention" else 0,
            "lm_moe_launches": moe_launches if name == "swa_attention" else 0,
            "lm_mla_launches": mla_launches if name == "swa_attention" else 0,
            "lm_qwen3_launches": qwen_launches if name == "swa_attention" else 0,
            "lm_train_launches": train_launches.get(name, 0),
            "lm_tp_launches_a_rank": tp_launches if name == "swa_attention" else 0,
            "lm_tp_train_launches": tp_train_launches.get(name, 0),
            "lm_zamba_launches": zamba_launches if name == "swa_attention" else 0,
            "lm_xlstm_launches": xlstm_launches.get(name, 0),
            "lm_whisper_launches": whisper_launches.get(name, 0),
            "lm_llava_launches": llava_launches.get(name, 0),
        })
        if name == "swa_attention":  # lm_moe's prefill, W = S; lm_mla's, q/k 192, v 128;
            kernels[-1]["llama4_shape"] = swa["llama4"]  # lm_zamba's, 112, G = 1;
            kernels[-1]["mla_shape"] = swa["mla"]  # lm_whisper's, 64, G = 1;
            kernels[-1]["zamba_shape"] = swa["zamba"]  # lm_llava's, 128, G = 7;
            kernels[-1]["whisper_shape"] = swa["whisper"]  # lm_tp's, 128, G = 2,
            kernels[-1]["llava_shape"] = swa["llava"]  # on one model rank
            kernels[-1]["tp_shape"] = swa["tp"]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
