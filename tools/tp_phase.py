#!/usr/bin/env python3
"""chip_smoke.py's tensor-parallel phases, ``lm_tp`` and (``--train``)
``lm_tp_train``: run one alone, or be one of its ranks.

    python3 tools/tp_phase.py [--seed 0] [--train]
    python3 tools/tp_phase.py --rank R --init file:///tmp/x/rdv --out DIR [--seed 0] \\
        [--rehearse] [--train]

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

With ``--train`` (no kernel to build: the training path runs none), a
rank joins the (data, model) mesh of ``chip_smoke.TP_TRAIN_MESH``, draws
the whole model from ``--seed`` and keeps its bf16 and float32 shards;
each rank in turn runs the one-rank float32 step on the whole batch and
keeps its shard of the result (rank 0 also at accumulation 2: the floor,
and the one-rank bf16 loss, with each sequence's in bf16 and float32:
check 5's floor); then the tensor-parallel float32 step, held
against it leaf by leaf, the same step under the two planted faults
(``chip_smoke.planted_partial_norms``, ``planted_local_clip``), and the
bf16 steps (the second with every collective timed, then one more
profiled), checking bitwise equality across ranks after each.
"""
import argparse
import contextlib
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


# ------------------------------------------------------------ lm_tp_train --


def shard_of(model, tensors: dict, mesh) -> dict:
    """{name: the rank's shard} of whole tensors named as ``model``'s
    parameters (gradients, moments), by ``shard_params``' layout."""
    from repro_torch.parallel import tensor as tp

    params = dict(model.named_parameters())
    saved = {k: p.data for k, p in params.items()}
    try:
        for k, p in params.items():
            p.data = tensors[k]
        return {k: p.detach() for k, p in tp.shard_params(model, mesh).named_parameters()}
    finally:
        for k, p in params.items():
            p.data = saved[k]


class Captured:
    """Patches the optimizer call of `training.train_step` (``name``) to
    keep the gradients and the norm it is given."""

    def __init__(self, name: str):
        from repro_torch.training import train_step

        self.module, self.name, self.got = train_step, name, {}

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def keep(grads, *args, **kw):
            self.got["grads"], self.got["norm"] = grads, kw.get("norm")
            return self.saved(grads, *args, **kw)

        setattr(self.module, self.name, keep)
        return self.got

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def normwise(got: dict, want: dict) -> dict:
    """{name: ||got - want|| / ||want||} of each tensor, in float32."""
    out = {}
    for k, w in want.items():
        w = w.float()
        out[k] = float(torch.linalg.vector_norm(got[k].float() - w)
                       / torch.linalg.vector_norm(w).clamp_min(1e-30))
    return out


def worst(errs: dict) -> list:
    """[the largest error, its leaf]."""
    k = max(errs, key=errs.get)
    return [errs[k], k]


def same_across(tensors: dict, group) -> bool:
    """Whether every rank of ``group`` holds the same bits of each tensor
    (one all-gather a tensor, not counted among the step's collectives)."""
    import torch.distributed as dist

    ok = True
    for t in tensors.values():
        t = t.detach().contiguous()
        out = [torch.empty_like(t) for _ in range(group.size())]
        dist.all_gather(out, t, group=group)
        ok = ok and all(torch.equal(o, out[0]) for o in out)
    return ok


def bitwise_checks(named: dict, norm, cfg, mesh) -> dict:
    """Check 2 after a step: the residual-side norm leaves (and the summed
    q_norm / k_norm) equal across the model ranks, every leaf across the
    data ranks, the clip scale on all four ranks."""
    import torch.distributed as dist

    from repro_torch.parallel import tensor as tp

    tp_size = tp.model_size(mesh)
    norms = {k: p for k, p in named.items()
             if tp.grad_role(k, cfg, tp_size) in ("replicated", "partial")}
    scale = torch.clamp(cs.TP_TRAIN_CLIP / (norm.float() + 1e-9), max=1.0)[None]
    return {"norm_leaves_across_model": same_across(norms, mesh.get_group("model")),
            "every_leaf_across_data": same_across(named, mesh.get_group("data")),
            "clip_scale_across_ranks": same_across({"scale": scale}, dist.group.WORLD)}


def train_rank_main(a) -> None:
    """One rank of lm_tp_train (chip_smoke.lm_tp_train's docstring)."""
    import copy

    import torch.distributed as dist

    dev = torch.device("cpu") if a.rehearse else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        sync = torch.cuda.synchronize
    else:
        sync = lambda: None  # noqa: E731
    from repro_torch import init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import trainable
    from repro_torch.parallel import collective_stages, reset_collective_count
    from repro_torch.parallel import tensor as tp
    from repro_torch.training import (adamw_init, init_state, loss_fn, make_train_step,
                                      named_parameters, zero1_plan)

    t_start = time.perf_counter()
    data, model = cs.TP_TRAIN_MESH
    mesh = tp.model_mesh(data, model, a.rank, a.init, device=dev.type, transport="gloo")
    cfg, seq = cs.tp_train_setup(a.rehearse)
    rows = cs.TP_TRAIN_ROWS
    drank = tp.data_rank(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed + 7)
    tokens = torch.randint(0, cfg.vocab, (data * rows, seq), generator=gen, device=dev)
    whole_batch = {"tokens": tokens, "labels": tokens}
    mine = {k: v[drank * rows:(drank + 1) * rows] for k, v in whole_batch.items()}
    kw = dict(lr_fn=cs.TP_TRAIN_LR, clip_norm=cs.TP_TRAIN_CLIP, fused_loss=True)
    res = {"transport": tp.mesh_transport(mesh), "mesh": list(mesh.mesh.shape),
           "coords": [drank, tp.model_rank(mesh)]}

    whole = init_params(cfg, seed=a.seed, dtype=torch.bfloat16, device=dev)
    shard_bf16 = trainable(tp.shard_params(whole, mesh))
    master = cs.float_model(whole, cfg, dev)  # the float32 copy of the seed's weights
    pristine = trainable(tp.shard_params(master, mesh))
    if a.rank == 0:
        with torch.no_grad():  # check 5's one-rank bf16 loss, and each sequence's
            res["one_rank_bf16_loss"] = float(loss_fn(whole, whole_batch, cfg, fused=True)[0])
            seqs = [{k: v[i:i + 1] for k, v in whole_batch.items()} for i in range(len(tokens))]
            res["one_rank_seq_losses"] = {
                "bf16": [float(loss_fn(whole, b, cfg, fused=True)[0]) for b in seqs],
                "f32": [float(loss_fn(master, b, cfg, fused=True)[0]) for b in seqs]}
    del whole
    res["start_s"] = time.perf_counter() - t_start

    # check 1's reference: the one-rank float32 step on the whole batch, each
    # rank in turn, kept as the rank's shard (and ZeRO-1 slices)
    def one_rank(accum):
        m = trainable(copy.deepcopy(master))
        named = named_parameters(m)
        with Captured("adamw_update") as cap:
            _, opt, met = make_train_step(cfg, accum=accum, **kw)(m, adamw_init(named),
                                                                  whole_batch)
        return m, met, cap["grads"], opt

    plan = zero1_plan(named_parameters(pristine), cfg, mesh)
    ref = None
    for turn in range(data * model):
        if a.rank == turn:
            t0 = time.perf_counter()
            m, met, grads, opt = one_rank(1)
            ref = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                   "grads": shard_of(m, grads, mesh),
                   "params": {k: p.detach() for k, p in tp.shard_params(m, mesh)
                              .named_parameters()},
                   "m": {k: plan.take(k, t) for k, t in shard_of(m, opt.m, mesh).items()
                         if plan.held(k)},
                   "v": {k: plan.take(k, t) for k, t in shard_of(m, opt.v, mesh).items()
                         if plan.held(k)}}
            res["one_rank_f32"] = {"loss": ref["loss"], "grad_norm": ref["grad_norm"],
                                   "ms": (time.perf_counter() - t0) * 1e3}
            del m, met, opt
            if a.rank == 0:  # the floor: the same function at accumulation 2
                res["floor"] = worst(normwise(one_rank(2)[2], grads))
            del grads
            if dev.type == "cuda":  # the next rank's turn needs the card's memory
                res["one_rank_f32"]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                torch.cuda.empty_cache()
        dist.barrier()
    del master

    # check 1: the tensor-parallel float32 step, then the planted faults
    def tp_f32(fault):
        shard = copy.deepcopy(pristine)
        named = named_parameters(shard)
        state = init_state(shard, cfg, mesh)
        step = make_train_step(cfg, mesh=mesh, **kw)
        reset_collective_count()
        with Captured("zero1_update") as cap, fault():
            _, state, met = step(shard, state, mine)
        errs = {"grads": worst(normwise(cap["grads"], ref["grads"])),
                "params": worst(normwise(named, ref["params"])),
                "m": worst(normwise(state.m, ref["m"])), "v": worst(normwise(state.v, ref["v"])),
                "loss": abs(float(met["loss"]) / ref["loss"] - 1),
                "grad_norm": abs(float(met["grad_norm"]) / ref["grad_norm"] - 1)}
        return shard, named, state, met, errs

    shard, named, state, met, errs = tp_f32(contextlib.nullcontext)
    res["f32"] = {"errors": errs, "stages": collective_stages(), "loss": float(met["loss"]),
                  "grad_norm": float(met["grad_norm"]),
                  "bitwise": bitwise_checks(named, met["grad_norm"], cfg, mesh),
                  "moment_bytes": sum(t.nbytes for t in list(state.m.values())
                                      + list(state.v.values())),
                  "whole_moment_bytes": 2 * 4 * sum(p.numel() for p in named.values())}
    del shard, named, state
    res["faults"] = {}
    for name, fault in (("partial_norms_unreduced", cs.planted_partial_norms),
                        ("local_norm_clip", cs.planted_local_clip)):
        res["faults"][name] = tp_f32(fault)[-1]
    del pristine, ref

    # check 5: bf16 steps, each timed; step 1 with every collective timed
    step = make_train_step(cfg, mesh=mesh, **kw)
    state = init_state(shard_bf16, cfg, mesh)
    named = named_parameters(shard_bf16)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    saved, spent, steps = tp._gather, [], []

    def timed_gather(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = saved(*args, **kwargs)
        sync()
        spent.append(time.perf_counter() - t0)
        return out

    for i in range(cs.TP_TRAIN_BF16_STEPS):
        reset_collective_count()
        reset_launch_counts()
        if i == 1:
            tp._gather = timed_gather
        sync()
        t0 = time.perf_counter()
        try:
            _, state, met = step(shard_bf16, state, mine)
            sync()
        finally:
            tp._gather = saved
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"ms": ms, "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                      "stages": collective_stages(), "launches": dict(launch_counts()),
                      "collective_ms": sum(spent) * 1e3 if i == 1 else None,
                      "bitwise": bitwise_checks(named, met["grad_norm"], cfg, mesh)})
    res["bf16"] = steps
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    res["moment_gb"] = sum(t.nbytes for t in list(state.m.values())
                           + list(state.v.values())) / 1e9
    if dev.type == "cuda":  # the device's busy share of one more step
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(shard_bf16, state, mine)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        device_ms = sum(getattr(ev, "self_device_time_total", 0)
                        for ev in prof.key_averages()) / 1e3
        res["busy"] = {"device_ms": device_ms, "wall_ms": wall, "busy_share": device_ms / wall}
    res["seconds"] = time.perf_counter() - t_start
    torch.save(res, os.path.join(a.out, f"rank{a.rank}.pt"))
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--train", action="store_true", help="lm_tp_train (four ranks)")
    a = ap.parse_args()
    if a.rank is not None:
        (train_rank_main if a.train else rank_main)(a)
        return
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda, flush=True)
    if not a.train:
        t0 = time.perf_counter()
        _build.build()
        _build.library()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase = cs.lm_tp_train if a.train else cs.lm_tp
    phase(a, torch.device("cuda", 0))
    print(f"{phase.__name__} {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
