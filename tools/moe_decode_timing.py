#!/usr/bin/env python3
"""Time the decode step of chip_smoke.py's lm_moe model, repeat by repeat.

    PYTHONPATH=src python3 tools/moe_decode_timing.py [--repeats 5] [--seed 0]

llama4-maverick-400b-a17b at full width with its depth cut to 2 of 48
layers, bf16 weights from ``--seed``, 4 prompts of 8,000 tokens prefilled
on the chunked plain attention (no kernel is built: a decode step runs no
kernel of the port), then ``--repeats`` runs of 15 greedy decode steps
from the same cache.  Prints one JSON line: the ms a step of each repeat
and their median, and one profiled step's device ms and busy share.  The
``repro_torch`` on ``PYTHONPATH`` is the one timed, so two trees compare
in one call by running the script under each in turn.  Needs an NVIDIA GPU.
"""
import argparse
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

STEPS = 15


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    import repro_torch
    from repro_torch import ServeEngine, get_arch, init_params
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.models import decode_step, prefill

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    cfg = dataclasses.replace(get_arch(cs.MOE_ARCH), n_layers=cs.MOE_LAYERS)
    b, p = cs.SERVE_BATCH, cs.SERVE_PROMPT
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    eng = ServeEngine(cfg, params, max_len=p + STEPS + 1, dtype=torch.bfloat16, device=dev)
    logits, cache = prefill(params, {"tokens": prompts}, cfg, attention=functools.partial(
        swa_attention_chunked, chunk=cs.MOE_PLAIN_CHUNK))
    cache = eng._grow_cache(cache, b)
    first = logits.argmax(-1)
    # every repeat writes the same slots with the same values from the same tokens
    per_step = []
    for _ in range(args.repeats + 1):  # the first warms up
        tok = first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            logits, cache = decode_step(params, cache, {"tokens": tok, "pos": p + i}, cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3 / STEPS)
    step = {"tokens": first, "pos": p}
    split = cs.moe_device_split(lambda: decode_step(params, cache, step, cfg), calls=3)
    print(json.dumps({
        "card": smi.stdout.strip(), "torch": torch.__version__,
        "repro_torch": os.path.dirname(repro_torch.__file__), "arch": cfg.name,
        "layers": cfg.n_layers, "batch": b, "prompt_len": p, "steps": STEPS,
        "decode_ms_per_step": per_step[1:], "median_ms": statistics.median(per_step[1:]),
        "profiled_step": {"wall_ms": split["wall_ms"], "device_ms": split["device_ms"]["total"],
                          "device_busy_share": split["device_busy_share"]}}), flush=True)


if __name__ == "__main__":
    main()
