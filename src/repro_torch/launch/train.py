"""Training from the command line: real optimizer steps on the pipeline's
tokens, checkpointed (port of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3 --reduced \
      --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT [--device cpu] [--f32]

Runs on the card unless ``--device cpu`` is given (without a card it
raises).  Weights come from seed 0, in bf16 unless ``--f32``; the tokens
from `data.tokens.SyntheticTokenPipeline`, whose dense bigram table is
(vocab, vocab): ``--data-vocab`` draws them from a smaller vocabulary
(qwen3-0.6b's 151,936 would need two 92 GB tables).  The loop is
`runtime.fault.FaultTolerantLoop`: a checkpoint every ``--ckpt-every``
steps (the parameters, the optimizer's float32 moments and its step; a
bf16 leaf is stored losslessly), and a run started again over the same
directory resumes after the newest intact one.  The learning rate warms up
over 10 steps, then follows a cosine.  The loss is the chunked
cross-entropy over the final hidden states (the reference's fused loss:
the (B, S, V) logits never exist, 19.9 GB in float32 for qwen3-0.6b at 8 x
4,096).  Prints the reference's step lines and returns the last loss.

Like the reference's, the command line supplies no frontend input: the
encoder-decoder (``frames``) and the VLM (``patch_embeds``) raise.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import get_arch
from ..core.backend import resolve_device
from ..data.tokens import SyntheticTokenPipeline
from ..models import init_params, trainable
from ..models.layers import DTYPE
from ..runtime.fault import FaultTolerantLoop
from ..training.optimizer import adamw_init, cosine_schedule
from ..training.train_step import make_train_step, named_parameters
from .serve import FRONTEND_INPUT


def _host_safe(t: torch.Tensor) -> torch.Tensor:
    """A tensor the checkpoint writer may read later: a CPU parameter is
    updated in place by the next step, so it is copied (a card's tensor is
    copied to the host by the save itself)."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--f32", action="store_true", help="float32 params")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-vocab", type=int, default=None,
                    help="the pipeline's vocabulary (default: the model's)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if cfg.family in FRONTEND_INPUT:
        raise ValueError(f"{cfg.name}: the command line supplies no "
                         f"{FRONTEND_INPUT[cfg.family]!r} input; train it from Python with "
                         f"training.make_train_step and a batch that holds it")
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else DTYPE

    pipe = SyntheticTokenPipeline(vocab=args.data_vocab or cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch)
    model = trainable(init_params(cfg, seed=0, dtype=dtype, device=dev))
    named = named_parameters(model)
    opt = adamw_init(named)
    step_fn = make_train_step(cfg, lr_fn=cosine_schedule(args.lr, warmup=10, total=args.steps),
                              accum=args.accum, fused_loss=True)

    loop = FaultTolerantLoop(args.ckpt_dir, every=args.ckpt_every)
    state, start = loop.restore_or({"params": {k: p.detach() for k, p in named.items()},
                                    "opt": opt})
    if start:
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(state["params"][k])
        opt = state["opt"]
        print(f"[train] resumed from step {start}")

    t0 = time.time()
    metrics = None
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.host_batch(step).items()}
        model, opt, metrics = step_fn(model, opt, batch)
        loop.after_step(step, {"params": {k: _host_safe(p) for k, p in named.items()},
                               "opt": opt})
        if step % 10 == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"lr={m['lr']:.2e} ({time.time() - t0:.1f}s)")
    loop.checkpoint_now()
    loop.close()
    print(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"checkpoints in {args.ckpt_dir}")
    return float(metrics["loss"]) if metrics is not None else float("nan")


if __name__ == "__main__":
    main()
