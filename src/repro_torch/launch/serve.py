"""Serving from the command line: batched generation with a dense-family architecture
(port of `repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch danube --reduced \
      --batch 8 --prompt-len 32 --max-new 32 [--dtype bf16|f32] [--device cpu]

Weights and prompts come from ``--seed``.  Runs on the card unless
``--device cpu`` is given.  Generates twice (cold, then warm) and prints one
summary line.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch
from ..core.backend import resolve_device
from ..models import init_params
from ..serving.engine import ServeEngine

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    params = init_params(cfg, seed=args.seed, dtype=dtype, device=dev)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.max_new, dtype=dtype,
                      device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    sample = None
    if args.temperature > 0:
        sample = torch.Generator(device=dev)

    def run():
        if sample is not None:
            sample.manual_seed(args.seed + 2)
        _sync(dev)
        t0 = time.perf_counter()
        out = eng.generate(prompts, args.max_new, temperature=args.temperature, generator=sample)
        _sync(dev)
        return out, time.perf_counter() - t0

    _, cold = run()
    out, warm = run()
    tps = args.batch * args.max_new / warm
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} {args.dtype} on {where}: {args.batch}×{args.max_new} tokens — "
          f"cold {cold:.2f}s, warm {warm:.2f}s ({tps:.0f} tok/s); "
          f"first row: {out.tokens[0][:10].tolist()}")
    return tps


if __name__ == "__main__":
    main()
