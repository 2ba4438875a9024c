#!/usr/bin/env python3
"""How far two numerically different but mathematically equal MLA serving
paths drift apart in bf16, on the CPU: the noise floor that
``chip_smoke.py``'s lm_mla checks 1 and 3 are held against.

deepseek-v2 at its full width of attention (d_model 5,120, 128 heads, MLA
ranks q 1,536 / kv 512, rope 64, nope 128, v 128) with fewer layers and
experts than the card run (``--layers``, ``--experts`` of 1,536, top-6, two
shared) and a vocabulary of 16,384, random bf16 weights from ``--seed``,
2 prompts of ``--prompt`` tokens and ``--new`` decode steps on tokens the
model served.  Prints, as max |a - b| / max |b| of each logits row:

  free    the prefill and decode on the kernel wrapper's path (on the CPU the
          chunked plain attention, P rounded to bf16) against the dense plain
          attention (P in float32), each routing on its own, with the
          (token, layer) routes that differ;
  forced  the same with the dense path through the first path's routes
          (``chip_smoke.forced_routes``);
  forms   the absorbed decode against ``chip_smoke.mla_decode_non_absorbed``
          (float32) from one prefill cache, through the absorbed run's routes;
  layer0  layer 0's attention output in both forms at each step
          (``chip_smoke.layer0_decode_check``: row norms).

    PYTHONPATH=src python3 tools/mla_noise_probe.py [--layers 7] [--experts 16]

About 8 GB of bf16 weights at 7 layers and 16 experts; a few minutes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402
from repro_torch import ServeEngine, get_arch, init_params  # noqa: E402
from repro_torch.kernels.swa_attention.ref import swa_attention_ref  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--experts", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--new", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    full = get_arch("deepseek-v2")
    cfg = dataclasses.replace(full, n_layers=args.layers, vocab=16384,
                              moe=dataclasses.replace(full.moe, num_experts=args.experts))
    params = init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device="cpu")
    P, NEW = args.prompt, args.new
    prompts = torch.randint(0, cfg.vocab, (2, P),
                            generator=torch.Generator().manual_seed(args.seed + 1))
    eng = ServeEngine(cfg, params, max_len=P + NEW, dtype=torch.bfloat16, device="cpu")
    tokens = torch.from_numpy(eng.generate(prompts, NEW).tokens)
    dense = lambda q, k, v, w, scale: swa_attention_ref(q, k, v, w, scale)  # noqa: E731

    def run(attention=None, record=None, force=None, form=contextlib.nullcontext, cache=None):
        hooks = cs.moe_routes(params, cfg, record) if record is not None else []
        with contextlib.ExitStack() as stack:
            if force is not None:
                stack.enter_context(cs.forced_routes(force))
            steps = []
            if cache is None:
                logits, cache = prefill(params, {"tokens": prompts}, cfg, attention=attention)
                steps.append(logits.float())
                cache = eng._grow_cache(cache, 2)
            with form():
                for i in range(1, NEW):
                    logits, cache = decode_step(params, cache, {"tokens": tokens[:, i - 1],
                                                                "pos": P + i - 1}, cfg)
                    steps.append(logits.float())
        for hk in hooks:
            hk.remove()
        return torch.stack(steps, 1)

    kernel_routes, dense_routes = [], []
    kernel = run(record=kernel_routes)
    print("free", cs.row_rel_errors(kernel, run(dense, record=dense_routes)).tolist(),
          cs.route_differences(kernel_routes, dense_routes))
    print("forced", cs.row_rel_errors(kernel, run(dense, force=kernel_routes)).tolist())
    _, cache = prefill(params, {"tokens": prompts}, cfg)
    cache = eng._grow_cache(cache, 2)
    forms = run(form=cs.non_absorbed_decoding, force=kernel_routes[cfg.n_layers:],
                cache={k: v.clone() for k, v in cache.items()})
    print("forms", cs.row_rel_errors(kernel[:, 1:], forms).tolist())
    print("layer0", cs.layer0_decode_check(params, {k: v[0] for k, v in cache.items()},
                                           tokens[:, :NEW - 1], cfg, P))


if __name__ == "__main__":
    main()
