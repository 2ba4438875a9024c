"""Render the dry run's tables from results/dryrun_torch/*.json (port of
`repro.launch.report`).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR] > tables.md
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from ..configs import SHAPES
from ..configs.registry import ARCHS, get_arch
from .dryrun import MESHES, RESULTS_DIR
from .roofline import CARD, CARD_POWER_LIMIT, HBM_BYTES

__all__ = ["dryrun_table", "roofline_table", "collective_table", "summary_table",
           "tensor_parallel_table", "render", "main"]

_IMPROVEMENT_NOTE = {
    ("compute", "train"): "raise MFU: larger per-device batch or reduce remat recompute",
    ("compute", "prefill"): "fuse attention (flash) to cut non-matmul overhead",
    ("compute", "decode"): "decode is tiny-compute; batch more requests per step",
    ("memory", "train"): "cut HBM traffic: fuse norms/rope into matmuls, microbatch to keep "
                         "the working set in shared memory",
    ("memory", "prefill"): "KV/activation layout: keep heads-last tiles resident, fuse "
                           "softmax chain",
    ("memory", "decode"): "decode is weight/cache-bandwidth-bound: quantize cache (int8) or "
                          "shard cache further",
    ("collective", "train"): "re-shard to cut resharding collectives; overlap grad "
                             "all-reduce with backward",
    ("collective", "prefill"): "avoid logits all-gather: keep vocab-sharded softmax local",
    ("collective", "decode"): "replicate small activations instead of gathering; "
                              "halo-exchange for weak-memory ops",
}

_HBM_GB = HBM_BYTES / 1e9


def _load(mesh_tag: str, results_dir: str = RESULTS_DIR) -> Dict[Tuple[str, str], dict]:
    out = {}
    for arch in ARCHS:
        name = get_arch(arch).name
        for s in SHAPES:
            path = os.path.join(results_dir, f"{name}__{s.name}__{mesh_tag}.json")
            if os.path.exists(path):
                with open(path) as f:
                    out[(name, s.name)] = json.load(f)
    return out


def fmt_t(x: float) -> str:
    return f"{x:.3g}"


def _fits(peak_gb: float) -> str:
    return "YES" if peak_gb <= _HBM_GB else f"no ({peak_gb / _HBM_GB:.2f}x)"


def dryrun_table(mesh_tag: str, results_dir: str = RESULTS_DIR) -> List[str]:
    data = _load(mesh_tag, results_dir)
    lines = [
        f"| arch | shape | status | sp | arg GB/dev | temp GB/dev | peak GB/dev "
        f"| fits H100 {_HBM_GB:.0f} GB? | trace s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(data.items()):
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | skipped — {r['reason'].split(' (')[0]} "
                         f"| | | | | | |")
            continue
        if r["status"] == "partial":
            m = r["memory_per_device"]
            held = (m["param_bytes"] + m.get("grad_bytes", 0) + m.get("opt_bytes", 0)
                    + m.get("cache_bytes", 0)) / 1e9
            lines.append(f"| {arch} | {shape} | partial (rule tables) | "
                         f"{'SP' if r.get('sp_mode') else 'DP'} | {held:.1f} | not traced "
                         f"| ≥ {held:.1f} | {_fits(held)} | |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | ERROR | | | | | | |")
            continue
        mem = r["roofline"]["memory_per_device"]
        arg = mem.get("argument_bytes", 0) / 1e9
        temp = mem.get("temp_bytes", 0) / 1e9
        peak = mem.get("peak_bytes", 0) / 1e9
        lines.append(
            f"| {arch} | {shape} | ok | {'SP' if r.get('sp_mode') else 'DP'} "
            f"| {arg:.1f} | {temp:.1f} | {peak:.1f} | {_fits(peak)} "
            f"| {r['seconds']['trace']:.0f} |"
        )
    return lines


def roofline_table(mesh_tag: str = "h100x1", results_dir: str = RESULTS_DIR) -> List[str]:
    data = _load(mesh_tag, results_dir)
    lines = [
        "| arch | shape | T_comp s | T_mem s | T_coll s | bottleneck | MODEL_FLOPS/dev "
        "| useful ratio | roofline frac | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(data.items()):
        if r["status"] != "ok":
            continue
        rc = r["roofline"]
        kind = next(s.kind for s in SHAPES if s.name == shape)
        dom = rc["bottleneck"]
        t_dom = max(rc["t_compute"], rc["t_memory"], rc["t_collective"])
        frac = rc["t_compute"] / t_dom if t_dom else 0.0
        note = _IMPROVEMENT_NOTE.get((dom, kind), "")
        lines.append(
            f"| {arch} | {shape} | {fmt_t(rc['t_compute'])} | {fmt_t(rc['t_memory'])} "
            f"| {fmt_t(rc['t_collective'])} | **{dom}** | {rc['model_flops']:.3g} "
            f"| {rc['useful_flops_ratio']:.2f} | {frac:.2f} | {note} |"
        )
    return lines


def collective_table(mesh_tag: str = "h100x4", results_dir: str = RESULTS_DIR) -> List[str]:
    data = _load(mesh_tag, results_dir)
    lines = [
        "| arch | shape | all-gather | all-reduce | reduce-scatter | all-to-all | permute "
        "| wire GB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(data.items()):
        if r["status"] != "ok":
            continue
        src = r["roofline"]
        c = src["collective_counts"]
        lines.append(
            f"| {arch} | {shape} | {c.get('all-gather', 0):.0f} | {c.get('all-reduce', 0):.0f} "
            f"| {c.get('reduce-scatter', 0):.0f} | {c.get('all-to-all', 0):.0f} "
            f"| {c.get('collective-permute', 0):.0f} | {src['wire_bytes'] / 1e9:.2f} |"
        )
    return lines


def tensor_parallel_table(results_dir: str = RESULTS_DIR,
                          meshes=("pod16x16", "pod2x16x16")) -> List[str]:
    """One row a traced cell of a mesh with a model axis: one rank's
    function FLOPs and bytes, its three roofline terms (the collectives the
    function needs, all-reduces of the partials, on NVLINK_BW), their count
    and wire bytes, the port's executed collectives (the rank-ordered
    reduction's all-gathers) and their time beside, and the parameter,
    cache and peak bytes per device of the rule tables beside the step's
    own (whole heads)."""
    lines = [
        "| arch | shape | mesh | TFLOP/dev | HBM GB/dev | T_comp s | T_mem s | T_coll s "
        "| bottleneck | collectives | wire GB/dev | port's wire GB/dev (T s) "
        "| params GB: rules / step | cache GB: rules / step | peak GB: rules / step |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for tag in meshes:
        for (arch, shape), r in sorted(_load(tag, results_dir).items()):
            if r["status"] != "ok":
                continue
            rc, mem = r["roofline"], r["roofline"]["memory_per_device"]
            gb = lambda k: mem.get(k, 0.0) / 1e9  # noqa: E731
            n = sum(rc["collective_counts"].values())
            ex = rc["executed_collectives"]
            lines.append(
                f"| {arch} | {shape} | {tag} | {rc['flops'] / 1e12:.4g} "
                f"| {rc['hbm_bytes'] / 1e9:.3g} | {fmt_t(rc['t_compute'])} "
                f"| {fmt_t(rc['t_memory'])} | {fmt_t(rc['t_collective'])} | {rc['bottleneck']} "
                f"| {n:.0f} | {rc['wire_bytes'] / 1e9:.3g} "
                f"| {ex['wire_bytes'] / 1e9:.3g} ({fmt_t(ex['t_collective'])}) "
                f"| {gb('param_bytes'):.3g} / {gb('param_bytes_port_step'):.3g} "
                f"| {gb('cache_bytes'):.3g} / {gb('cache_bytes_port_step'):.3g} "
                f"| {gb('peak_bytes'):.3g} / {gb('peak_bytes_port_step'):.3g} |")
    return lines


def summary_table(results_dir: str = RESULTS_DIR) -> List[str]:
    """One row a runnable cell: its peak per device and fit on one H100 and
    on four (data parallel, ZeRO-1 moments), its bound and bottleneck on
    one, its model FLOPs and useful ratio."""
    one, four = _load("h100x1", results_dir), _load("h100x4", results_dir)
    lines = [
        "| arch | shape | 1 x H100: peak GB | fits | bound s (by) | model TFLOP "
        "| useful | 4 x H100: peak GB/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(one.items()):
        if r["status"] != "ok":
            continue
        rc = r["roofline"]
        peak = rc["memory_per_device"]["peak_bytes"] / 1e9
        t_dom = max(rc["t_compute"], rc["t_memory"], rc["t_collective"])
        r4 = four.get((arch, shape), {})
        if r4.get("status") == "ok":
            p4 = r4["roofline"]["memory_per_device"]["peak_bytes"] / 1e9
            four_cols = f"{p4:.1f} | {_fits(p4)}"
        else:
            four_cols = f"{r4.get('status', 'not run')} (SP) | "
        lines.append(
            f"| {arch} | {shape} | {peak:.1f} | {_fits(peak)} | {fmt_t(t_dom)} "
            f"({rc['bottleneck']}) | {rc['model_flops'] / 1e12:.4g} "
            f"| {rc['useful_flops_ratio']:.2f} | {four_cols} |"
        )
    return lines


_MESH_TITLE = {"h100x1": "one H100", "h100x4": "four H100s, data parallel (ZeRO-1 moments)",
               "pod16x16": "16x16 (256 devices); dense prefill and decode traced "
                           "tensor-parallel, the rest rule tables only",
               "pod2x16x16": "2x16x16 (512 devices); dense prefill and decode traced "
                             "tensor-parallel, the rest rule tables only"}


def render(results_dir: str = RESULTS_DIR) -> str:
    out = [f"Card constants: {CARD}, {CARD_POWER_LIMIT} (`launch.roofline`).", "",
           "## Every runnable cell on one H100 and on four", ""]
    out += summary_table(results_dir) + [""]
    for tag in MESHES:
        out += [f"## Dry run — {_MESH_TITLE[tag]} (`{tag}`)", ""]
        out += dryrun_table(tag, results_dir) + [""]
    for tag in ("h100x1", "h100x4"):
        out += [f"## Roofline — {_MESH_TITLE[tag]}, depth-calibrated", ""]
        out += roofline_table(tag, results_dir) + [""]
    out += ["## Collective schedule — four H100s, data parallel", ""]
    out += collective_table("h100x4", results_dir) + [""]
    out += ["## Tensor-parallel cells — one model rank of the production meshes", ""]
    out += tensor_parallel_table(results_dir)
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    print(render(ap.parse_args(argv).dir))


if __name__ == "__main__":
    main()
