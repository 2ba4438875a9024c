#!/usr/bin/env python3
"""chip_smoke.py's tensor-parallel phase, ``lm_tp``: run it alone, or be
one of its model ranks.

    python3 tools/tp_phase.py [--seed 0]
    python3 tools/tp_phase.py --rank R --init file:///tmp/x/rdv --out DIR [--seed 0] \\
        [--rehearse]

Alone, it builds the kernels and runs ``chip_smoke.lm_tp``, which starts
this script once for each model rank and checks what the ranks write
(about a tenth of a whole ``chip_smoke.py`` run).  As a rank, it joins a
``("data", "model")`` mesh of 1 x ``chip_smoke.TP_MODEL`` ranks over the
gloo transport (the ranks share one card; NCCL refuses two ranks on one
device), makes the whole model (``chip_smoke.tp_setup``) from ``--seed``
on the device, keeps its shard (``parallel.tensor.shard_params``) and
serves ``TP_BATCH`` prompts through ``launch.steps.build_cell``'s
tensor-parallel prefill, then the greedy decode steps (``parallel.tensor.
greedy_pick``), timed; then a pass with every collective timed, the
device's busy share, and the two planted faults (rank 1 slicing ``wq``
with rank 0's heads; one block's row-parallel reduction skipped).  Rank 0
then runs the whole model on one rank on the same prompts: its kernel
prefill, decode steps fed the tensor-parallel tokens, and its prefill on
the plain chunked attention (the floor).  Each rank writes ``rank<R>.pt``
into ``--out``.  Needs an NVIDIA GPU; ``--rehearse`` runs a rank of the
phase's CPU rehearsal instead (the reduced config, a short prompt).
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def grow(cache: dict, capacity: int) -> dict:
    """The prefill cache padded to the decode capacity: K/V with zeros, the
    positions with -1 (as ``ServeEngine`` grows it)."""
    c = cache["k"].shape[2]
    if c >= capacity:
        return cache
    pad = lambda t, v: torch.cat(  # noqa: E731
        [t, t.new_full(t.shape[:2] + (capacity - c,) + t.shape[3:], v)], 2)
    pos = cache["pos"]
    return {"k": pad(cache["k"], 0), "v": pad(cache["v"], 0),
            "pos": torch.cat([pos, pos.new_full((pos.shape[0], capacity - c), -1)], 1)}


def serve(prefill_fn, decode_fn, model, prompts, steps: int, capacity: int, pick,
          forced=None, sync=lambda: None) -> dict:
    """Prefill, then ``steps`` decode steps, each fed the last pick (or
    ``forced``'s token) -> {"tokens" (B, steps + 1), "logits" (B, steps +
    1, V or V / tp) float32, "prefill_ms", "decode_ms" (each step)}."""
    p = prompts.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill_fn(model, {"tokens": prompts})
    tok = pick(logits)
    sync()
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "decode_ms": []}
    toks, kept = [tok], [logits.float()]
    cache = grow(cache, capacity)
    for i in range(steps):
        feed = tok if forced is None else forced[:, i]
        t0 = time.perf_counter()
        logits, cache = decode_fn(model, cache, {"tokens": feed, "pos": p + i})
        tok = pick(logits)
        sync()
        out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
        kept.append(logits.float())
    out["tokens"] = torch.stack(toks, 1)
    out["logits"] = torch.stack(kept, 1)
    return out


def rank_main(a) -> None:
    dev = torch.device("cpu") if a.rehearse else torch.device("cuda", 0)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.library()  # built by the caller
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sync = torch.cuda.synchronize
    else:
        sync = lambda: None  # noqa: E731
    from repro_torch import init_params
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import decode_step, prefill
    from repro_torch.parallel import collective_bytes, collective_count, reset_collective_count
    from repro_torch.parallel import tensor as tp

    t_start = time.perf_counter()
    mesh = tp.model_mesh(1, cs.TP_MODEL, a.rank, a.init, device=dev.type, transport="gloo")
    cfg, p, steps = cs.tp_setup(a.rehearse)
    b = cs.TP_BATCH
    whole = init_params(cfg, seed=a.seed, dtype=torch.bfloat16, device=dev)
    shard = tp.shard_params(whole, mesh)
    # rank 0's query heads' wq columns: rank 1's planted fault
    rank0_wq = ([blk.attn.wq for blk in tp.shard_params(whole, mesh, rank=0).layers]
                if a.rank == 1 else None)
    if a.rank != 0:
        del whole
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed + 6)  # lm_qwen3's prompts
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    pre = build_cell(cfg, ShapeConfig("lm_tp_prefill", p, b, "prefill"), mesh=mesh)
    dec = build_cell(cfg, ShapeConfig("lm_tp_decode", p + steps, b, "decode"), mesh=mesh)
    capacity = dec.inputs["cache"]["k"].shape[2]
    pick = lambda logits: tp.greedy_pick(logits, mesh)  # noqa: E731
    res = {"transport": tp.mesh_transport(mesh), "mesh": list(mesh.mesh.shape),
           "model_rank": tp.model_rank(mesh), "start_s": time.perf_counter() - t_start}

    # warm-up: a short prompt, two steps
    serve(pre.fn, dec.fn, shard, prompts[:, :min(p, 256)], 2, capacity, pick, sync=sync)

    # the timed run: each stage's collectives and kernel launches, and the
    # replicated residual into the final norm
    stages = {"prefill": [], "decode": []}
    resid = []
    hook = shard.final_norm.register_forward_hook(lambda m, i, o: resid.append(i[0].clone()))

    def counted(fn, stage):
        def run(*args):
            reset_collective_count()
            reset_launch_counts()
            out = fn(*args)
            stages[stage].append({"count": collective_count(),
                                  "bytes": collective_bytes()["all-gather"],
                                  "launches": launch_counts()["swa_attention"]})
            return out
        return run

    picks = []

    def counted_pick(logits):
        reset_collective_count()
        tok = pick(logits)
        picks.append(collective_count())
        return tok

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = serve(counted(pre.fn, "prefill"), counted(dec.fn, "decode"), shard, prompts, steps,
                capacity, counted_pick, sync=sync)
    hook.remove()
    res.update(prefill_ms=run["prefill_ms"], decode_ms=run["decode_ms"], tokens=run["tokens"],
               logits=run["logits"], stages=stages, pick_counts=picks,
               residual=torch.cat(resid, 1))
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0

    # every collective timed (a synchronize on each side of each), over a
    # prefill and four decode steps
    saved, spent = tp._gather, []

    def timed_gather(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = saved(*args, **kw)
        sync()
        spent.append(time.perf_counter() - t0)
        return out

    tp._gather = timed_gather
    try:
        timed = serve(pre.fn, dec.fn, shard, prompts, 4, capacity, pick, sync=sync)
    finally:
        tp._gather = saved
    n_pre = 2 * cfg.n_layers + 2  # the prefill's reductions and its pick
    res["collective_ms"] = {"prefill": sum(spent[:n_pre]) * 1e3,
                            "decode": sum(spent[n_pre:]) * 1e3 / 4}
    res["instrumented_ms"] = {"prefill": timed["prefill_ms"],
                              "decode": sum(timed["decode_ms"]) / 4}

    # the device's busy share of a prefill and of a decode step
    if dev.type == "cuda":
        cache = grow(pre.fn(shard, {"tokens": prompts})[1], capacity)
        tok = run["tokens"][:, 0]
        busy = {}
        for stage, fn in (("prefill", lambda: pre.fn(shard, {"tokens": prompts})),
                          ("decode", lambda: dec.fn(shard, cache, {"tokens": tok, "pos": p}))):
            _, device_ms, wall_ms = cs.device_split(fn, calls=1 if stage == "prefill" else 4)
            busy[stage] = {"device_ms": device_ms, "wall_ms": wall_ms,
                           "busy_share": device_ms / wall_ms}
        res["busy"] = busy
        del cache

    # the planted faults: each rank's prefill logits
    if a.rank == 1:
        kept = [blk.attn.wq for blk in shard.layers]
        for blk, wq in zip(shard.layers, rank0_wq):
            blk.attn.wq = wq
    res["fault_wq_logits"] = pre.fn(shard, {"tokens": prompts})[0].float()
    if a.rank == 1:
        for blk, wq in zip(shard.layers, kept):
            blk.attn.wq = wq
    skip = 1 + 2 * (cfg.n_layers // 2)  # the attention reduction of the middle block
    reduce, calls = tp.reduce_model, []

    def skipping(x, m):
        calls.append(1)
        return x if len(calls) == skip + 1 else reduce(x, m)

    tp.reduce_model = skipping
    try:
        res["fault_skip_logits"] = pre.fn(shard, {"tokens": prompts})[0].float()
    finally:
        tp.reduce_model = reduce
    res["fault_skip_call"] = skip

    # rank 0: the whole model on one rank, the same prompts
    if a.rank == 0:
        one = serve(lambda m, bt: prefill(m, bt, cfg),
                    lambda m, c, bt: decode_step(m, c, bt, cfg), whole, prompts, steps,
                    capacity, lambda logits: logits.argmax(-1), forced=run["tokens"][:, :-1],
                    sync=sync)
        res["single_logits"], res["single_tokens"] = one["logits"], one["tokens"]
        res["single_ms"] = {"prefill": one["prefill_ms"], "decode": one["decode_ms"]}
        res["plain_logits"] = prefill(whole, {"tokens": prompts}, cfg,
                                      attention=swa_attention_chunked)[0].float()
    res["seconds"] = time.perf_counter() - t_start
    torch.save({k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in res.items()},
               os.path.join(a.out, f"rank{a.rank}.pt"))
    torch.distributed.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true")
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a)
        return
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.lm_tp(a, torch.device("cuda", 0))
    print(f"lm_tp {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
