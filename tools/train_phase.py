#!/usr/bin/env python3
"""Run chip_smoke.py's training phase alone.

    python3 tools/train_phase.py [--seed 0]

Builds the kernels (check 1 holds the training forward against the served
one, whose prefill runs the attention kernel), then runs ``lm_train``
(qwen3-0.6b trained at full width and depth, sequence 4,096), printing its
JSON line as in a whole ``chip_smoke.py`` run, in about a third of that
run's time.  Exits non-zero if the phase fails.  Needs an NVIDIA GPU.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# the phase runs under deterministic algorithms: cuBLAS's fixed workspace
# must be set before the first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", cs.TRAIN_CUBLAS)

import torch  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.zeros(1, device=dev)  # CUDA initialised before the phase's memory-stat reset
    t0 = time.perf_counter()
    cs.lm_train(args, dev)
    print(f"lm_train {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
