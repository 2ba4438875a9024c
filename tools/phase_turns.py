#!/usr/bin/env python3
"""Time chip_smoke.py's session and gateway phases of two checkouts in turns.

    python3 tools/phase_turns.py OLD NEW [--pairs 3]

OLD and NEW are checkout roots (e.g. the parent commit unpacked with ``git
archive`` into ``build/parent``, and ``.``).  Both build their kernels
first, side by side; then each turn runs, in a fresh process in that
checkout, ``session_phase`` and ``gateway_phase`` of its own
``chip_smoke.py`` as a user's process runs them (no calibration table
installed), in the order OLD NEW NEW OLD OLD NEW ... (``--pairs`` pairs).
Prints one JSON line per turn with ``session.metrics.ingest_ms_per_tick``,
``session.metrics.query_batch_ms`` and ``gateway.metrics.tick_ms_median``,
then the medians per checkout.
Needs an NVIDIA GPU.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = """
import argparse, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
args = argparse.Namespace(seed=0, chunks=64)
dev = torch.device("cuda", 0)
cs.session_phase(args, dev)
cs.gateway_phase(args, dev)
"""
BUILD = "import sys; sys.path.insert(0, 'src'); from repro_torch.kernels import _build; _build.build()"


def turn(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                          text=True, timeout=900)
    out = {"root": root, "rc": proc.returncode}
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if obj.get("phase") == "session":
            out["ingest_ms_per_tick"] = obj["metrics"]["ingest_ms_per_tick"]
            out["query_batch_ms"] = obj["metrics"]["query_batch_ms"]
        elif obj.get("phase") == "gateway":
            out["gateway_tick_ms_median"] = obj["metrics"]["tick_ms_median"]
        elif obj.get("phase") == "failed":
            out["failed"] = obj
    if proc.returncode:
        out["stderr"] = proc.stderr[-2000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=r,
                               stdout=subprocess.DEVNULL) for r in roots.values()]
    if any(b.wait(timeout=900) for b in builds):
        print(json.dumps({"error": "a build failed"}))
        return 1
    order = []
    for i in range(args.pairs):
        order += ["old", "new"] if i % 2 == 0 else ["new", "old"]
    runs = {"old": [], "new": []}
    for label in order:
        res = turn(roots[label])
        print(json.dumps({"turn": label, **res}), flush=True)
        if res["rc"]:
            return 1
        runs[label].append(res)
    summary = {label: {key: {"median": statistics.median(r[key] for r in rs),
                             "all": [r[key] for r in rs]}
                       for key in ("ingest_ms_per_tick", "query_batch_ms",
                                   "gateway_tick_ms_median")}
               for label, rs in runs.items()}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
