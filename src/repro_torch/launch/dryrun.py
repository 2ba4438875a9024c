"""Dry run of every (architecture x input shape x mesh) cell on the host
(port of `repro.launch.dryrun`).

For each cell: its per-device memory from the rule tables
(`parallel.sharding`: parameters, gradients, ZeRO-1 moments, caches) and,
where the port has the cell's step, a trace of that step on the ``meta``
device (`launch.costing`, depth-calibrated) for its FLOPs, bytes, peak
memory and collectives, and its roofline on the H100 (`launch.roofline`).
No card is touched; nothing is allocated.

Meshes (`launch.mesh`):

  * ``h100x1``: one H100;
  * ``h100x4``: ``make_test_mesh(4, 1)``, four cards of pure data
    parallelism, the optimizer moments sharded ZeRO-1 by ``zero1_pspecs``
    (the port's data-parallel step holds whole moments on every rank; the
    JSON reports that peak too);
  * ``pod16x16``, ``pod2x16x16``: the reference's production meshes.

A cell's status is ``ok``, ``skipped`` (``cell_is_runnable``'s reason),
``partial`` or ``error``.  On a mesh with a model axis above 1 the dense
family's train, prefill and decode cells are traced as one
tensor-parallel rank's step (`parallel.tensor`: the rank's shard of the
model on the counting mesh, its share of the batch, a train step's ZeRO-1
moments, each collective counted by kind and payload, and a train step's
by stage as ``executed_collectives.stages``; ``t_collective`` on
``NVLINK_BW`` from the function's collectives, an all-reduce of each
partial, and the port's rank-ordered gathers beside it as
``executed_collectives``), with the step's own parameter, moment and
cache bytes per device beside the rule tables' (the step holds whole
heads: GSPMD may cut one).  ``partial``: another family on a model axis,
a layout the heads, ``d_ff`` or the vocabulary do not allow, or the
sequence-parallel layout -- each waits for a later slice, and its
``reason`` says which; its FLOPs, activations and collectives are not
traced, and only its parameter, gradient, optimizer and cache bytes per
device (exact, from the rule tables) are written.

Results are JSON files under ``results/dryrun_torch/``, one a cell, which
`launch.report` renders.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3 --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh h100x1 ...]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict

import torch

from ..configs import SHAPES, SHAPES_BY_NAME, cell_is_runnable, get_arch
from ..configs.registry import ARCHS
from ..models import cache_spec
from ..parallel import sharding as shr
from ..parallel import tensor
from .costing import calibrated_cost, meta_model
from .mesh import make_production_mesh, make_test_mesh, mesh_device_count
from .roofline import HBM_BYTES, NVLINK_BW, collective_stats, compute_roofline
from .steps import cache_axes, use_sequence_parallel

__all__ = ["RESULTS_DIR", "MESHES", "cell_tag", "cell_memory", "run_cell", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")

MESHES: Dict[str, Callable[[], Any]] = {
    "h100x1": lambda: make_test_mesh(1, 1),
    "h100x4": lambda: make_test_mesh(4, 1),
    "pod16x16": lambda: make_production_mesh(),
    "pod2x16x16": lambda: make_production_mesh(multi_pod=True),
}


def cell_tag(arch_name: str, shape_name: str, mesh_tag: str) -> str:
    return f"{get_arch(arch_name).name}__{shape_name}__{mesh_tag}"


def _cache_pspecs(cache: Dict[str, Any], axes: Dict[str, Any], mesh) -> Dict[str, Any]:
    return {k: (_cache_pspecs(v, axes[k], mesh) if isinstance(v, dict)
                else shr.logical_to_spec(axes[k], v.shape, mesh)) for k, v in cache.items()}


def cell_memory(cfg, shape, mesh) -> Dict[str, float]:
    """Per-device bytes of the cell's parameters, gradients (train),
    optimizer moments (train: float32, ZeRO-1) and cache (decode), from the
    rule tables on the stacked params tree; call under the cell's SP mode."""
    tree = shr.param_tree(meta_model(cfg))
    pspecs = shr.param_pspecs(tree, mesh)
    mem = {"param_bytes": float(shr.tree_shard_bytes(tree, pspecs, mesh))}
    if shape.kind == "train":
        zspecs = shr.zero1_pspecs(tree, mesh)
        mem["grad_bytes"] = mem["param_bytes"]
        mem["opt_bytes"] = float(2 * shr.tree_shard_bytes(tree, zspecs, mesh, torch.float32))
        mem["opt_bytes_replicated"] = float(
            2 * shr.tree_shard_bytes(tree, pspecs, mesh, torch.float32))
    if shape.kind == "decode":
        spec = cache_spec(cfg, shape.global_batch, shape.seq_len)
        mem["cache_bytes"] = float(shr.tree_shard_bytes(
            spec, _cache_pspecs(spec, cache_axes(spec), mesh), mesh))
    return mem


def _traced(cfg, shape, mesh, mem: Dict[str, float], fused_loss: bool) -> Dict[str, Any]:
    """The calibrated trace of one data-parallel (or, with a model axis,
    tensor-parallel) rank's step -> the roofline dicts and the memory per
    device."""
    dp = shr.mesh_axis_size(mesh, ("pod", "data"))
    if tensor.model_size(mesh) > 1:
        cal = calibrated_cost(cfg, shape, mesh, fused_loss=fused_loss)
    else:
        cal = calibrated_cost(cfg, shape, mesh, batch=shape.global_batch // dp, world=dp,
                              fused_loss=fused_loss)
    tr = cal.trace
    mem = dict(mem)
    # what the step holds, exactly from the rule tables (ZeRO-1 moments),
    # and the calibrated peak above it
    mem["argument_bytes"] = (mem["param_bytes"] + mem.get("opt_bytes", 0.0)
                             + mem.get("cache_bytes", 0.0) + tr.input_bytes)
    mem["temp_bytes"] = tr.temp_bytes
    mem["peak_bytes"] = mem["argument_bytes"] + tr.temp_bytes
    if tensor.model_size(mesh) > 1:
        # the tensor-parallel step holds whole heads: its own weights and
        # cache, beside the rule tables'
        mem["param_bytes_port_step"] = tr.param_bytes
        if shape.kind == "decode":
            mem["cache_bytes_port_step"] = tr.cache_bytes
        if shape.kind == "train":
            mem["opt_bytes_port_step"] = tr.opt_bytes
        mem["peak_bytes_port_step"] = (tr.param_bytes + mem.get("cache_bytes_port_step", 0.0)
                                       + mem.get("opt_bytes_port_step", 0.0)
                                       + tr.input_bytes + tr.temp_bytes)
    else:
        # the port's data-parallel step holds whole moments on every rank
        mem["peak_bytes_port_step"] = (mem["peak_bytes"] + mem.get("opt_bytes_replicated", 0.0)
                                       - mem.get("opt_bytes", 0.0))
    coll = collective_stats(tr.collective_counts, tr.collective_payload)
    roof = compute_roofline(tr.function_flops, tr.function_bytes, cfg, shape,
                            mesh_device_count(mesh), collectives=coll,
                            executed_flops=tr.executed_flops, executed_bytes=tr.executed_bytes,
                            memory_per_device=mem)
    out = roof.to_dict()
    if tensor.model_size(mesh) > 1:
        # the bound's collectives are the function's (an all-reduce of each
        # partial); the port's rank-ordered reduction gathers every rank's
        # partial instead, its payload written beside as executed
        ex = collective_stats(tr.executed_collective_counts, tr.executed_collective_payload)
        out["executed_collectives"] = {"counts": ex.counts, "payload_bytes": ex.payload_bytes,
                                       "wire_bytes": ex.wire_bytes,
                                       "t_collective": ex.wire_bytes / NVLINK_BW,
                                       "stages": tr.executed_collective_stages}
    calibrated = {
        "flops": cal.flops, "hbm_bytes": cal.hbm_bytes, "wire_bytes": cal.wire_bytes,
        "t_compute": roof.t_compute, "t_memory": roof.t_memory,
        "t_collective": roof.t_collective, "bottleneck": roof.bottleneck,
        "model_flops": roof.model_flops, "useful_flops_ratio": roof.useful_flops_ratio,
        "collective_counts": cal.collective_counts, "calibration_raw": cal.raw,
    }
    return {"roofline": out, "roofline_calibrated": calibrated}


def run_cell(arch_name: str, shape_name: str, mesh_tag: str = "h100x1",
             out_dir: str = RESULTS_DIR, fused_loss: bool = False) -> Dict[str, Any]:
    cfg = get_arch(arch_name)
    shape = SHAPES_BY_NAME[shape_name]
    tag = f"{cfg.name}__{shape.name}__{mesh_tag}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, tag + ".json")

    def write(result):
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        return result

    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        print(f"[dryrun] {tag}: SKIPPED ({why})")
        return write({"cell": tag, "status": "skipped", "reason": why})

    t0 = time.time()
    try:
        mesh = MESHES[mesh_tag]()
        dp = shr.mesh_axis_size(mesh, ("pod", "data"))
        tp = shr.mesh_axis_size(mesh, ("model",))
        sp = use_sequence_parallel(shape, dp)
        shr.set_sp_mode(sp)
        try:
            mem = cell_memory(cfg, shape, mesh)
        finally:
            shr.set_sp_mode(False)
        result = {"cell": tag, "status": "ok", "arch": cfg.name, "shape": shape.name,
                  "mesh": mesh_tag, "sp_mode": sp}
        why = None
        if sp:
            why = (f"global batch {shape.global_batch} over {dp} data ranks takes the "
                   f"sequence-parallel layout: sequence parallelism waits for a later slice")
        elif tp > 1:
            why = tensor.layout_reason(cfg, tp)
        if why:
            result.update(status="partial", reason=why + " (FLOPs, activations and "
                          "collectives not traced; bytes per device from the rule tables)",
                          memory_per_device=mem,
                          fits=mem["param_bytes"] + mem.get("opt_bytes", 0.0)
                          + mem.get("grad_bytes", 0.0) + mem.get("cache_bytes", 0.0)
                          <= HBM_BYTES)
            result["seconds"] = {"rules": time.time() - t0}
            print(f"[dryrun] {tag}: PARTIAL ({why})")
            return write(result)
        result.update(_traced(cfg, shape, mesh, mem, fused_loss))
        roof = result["roofline"]
        result["fits"] = roof["memory_per_device"]["peak_bytes"] <= HBM_BYTES
        result["seconds"] = {"trace": time.time() - t0}
        result["fits_port_step"] = (roof["memory_per_device"]["peak_bytes_port_step"]
                                    <= HBM_BYTES)
        print(f"[dryrun] {tag}: OK  bottleneck={roof['bottleneck']} "
              f"T=(c {roof['t_compute']:.3e}, m {roof['t_memory']:.3e}, "
              f"n {roof['t_collective']:.3e})s useful={roof['useful_flops_ratio']:.2f} "
              f"peak={roof['memory_per_device']['peak_bytes'] / 1e9:.1f} GB "
              f"trace={result['seconds']['trace']:.0f}s")
        return write(result)
    except Exception as e:
        print(f"[dryrun] {tag}: ERROR {type(e).__name__}: {str(e)[:300]}")
        return write({"cell": tag, "status": "error", "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or alias (see configs)")
    ap.add_argument("--shape", default=None, choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", action="append", choices=list(MESHES),
                    help="mesh tag (repeatable; default: every mesh)")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh alone")
    ap.add_argument("--both-meshes", action="store_true", help="the two production meshes")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fused-loss", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    meshes = list(args.mesh or [])
    if args.multi_pod:
        meshes.append("pod2x16x16")
    if args.both_meshes:
        meshes += ["pod16x16", "pod2x16x16"]
    meshes = list(dict.fromkeys(meshes)) or list(MESHES)
    if args.all:
        cells = [(a, s.name, m) for a in sorted(ARCHS) for s in SHAPES for m in meshes]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    statuses = {}
    for a, s, m in cells:
        tag = cell_tag(a, s, m)
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped", "partial"):
                print(f"[dryrun] {tag}: cached ({prev['status']})")
                statuses[tag] = prev["status"]
                continue
        statuses[tag] = run_cell(a, s, m, args.out, fused_loss=args.fused_loss)["status"]

    n = {k: sum(1 for v in statuses.values() if v == k)
         for k in ("ok", "partial", "skipped", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['partial']} partial, {n['skipped']} skipped, "
          f"{n['error']} errors")
    return 0 if n["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
