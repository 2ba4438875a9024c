#!/usr/bin/env python3
"""Run chip_smoke.py's attention and serving phases of the MoE slice alone.

    python3 tools/serving_phases.py [--seed 0]

Builds the kernels, then runs ``swa_kernel`` (kernel 8 against its plain
version, timed at danube's and llama4-maverick's layer shapes),
``lm_moe`` (llama4-maverick-400b-a17b at full width, 2 of 48 layers) and
``lm_qwen3`` (qwen3-0.6b at full width and depth), each printing its JSON
line as in a whole ``chip_smoke.py`` run, in about a third of its time.
Exits non-zero if a phase fails.  Needs an NVIDIA GPU.
"""
import argparse
import gc
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


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
    for phase in (cs.swa_kernel, cs.lm_moe, cs.lm_qwen3):
        t0 = time.perf_counter()
        phase(args, dev)
        print(f"{phase.__name__} {time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
