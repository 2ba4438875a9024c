#!/usr/bin/env python3
"""The distribution layer across cards: chip_smoke.py's store path on an
NCCL mesh of one process a card.

    python3 tools/mesh_cards.py [--world 4] [--chunks 64] [--seed 0] [--device cuda]

The parent builds the kernels, then starts ``--world`` rank processes
(spawn), which meet through a ``file://`` rendezvous in a temporary
directory.  Each rank makes chip_smoke.py's series (``--chunks`` x 65,536
rows of 64 channels: 2^22 by default) from the seed on its card, then on
the mesh of every rank:

  collect   ``SeriesFrame.from_sharded(x, mesh=)`` with chip_smoke's plan
            (the store placed, kernel 1 once on the rank's 512 / w blocks,
            one ``psum_tree``), and the same over a mesh store placed
            beforehand; held against the plan on one card (rank 0) within
            chip_smoke's member tolerances; timed, 3 times each;
  halo      ``halo_exchange`` of the rank's rows, the line and the ring, at
            the plan's halo (0, 1,023) and at (4, 5): bitwise the rows it
            must hold; timed;
  stores    ``map_reduce`` of w[0] * w[-1] in both halo modes (exchange
            bitwise replicate), ``autocovariance_sharded`` at H = 16
            against ``autocovariance_blocked`` on one card;
  psum_tree of the collect's statistics, timed;
  restore   the replicate store's blocks saved (every rank; rank 0
            writes) and restored with Shard(0) shardings, bitwise.

Every rank's results are compared by a sha256 of their bytes: bitwise alike
on every rank.  Rank 0 prints the card's name and power limit, then one
JSON line with the measurements and the checks; the exit code is non-zero
when a check fails.  ``--device cpu`` rehearses the same on gloo ranks (the
kernels' plain versions; no launch counts).
"""
import argparse
import datetime
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def digest(tree) -> str:
    import chip_smoke as cs

    h = hashlib.sha256()
    for path, leaf in cs.leaves(tree):
        h.update(path.encode())
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_main(rank: int, args, tmp: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    import chip_smoke as cs
    from repro_torch import SeriesFrame, TimeSeriesStore
    from repro_torch.checkpoint.manager import restore_pytree, save_pytree
    from repro_torch.core.estimators.stats import autocovariance_blocked, autocovariance_sharded
    from repro_torch.core.halo import halo_exchange_grouped
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import (collective_count, data_mesh, psum_tree,
                                      reset_collective_count)

    torch.set_num_threads(1 if args.device == "cpu" else torch.get_num_threads())
    w, on_card = args.world, args.device == "cuda"
    res, digests, bad = {}, {}, []

    def sync(every_rank):
        if on_card:
            torch.cuda.synchronize()
        if every_rank:
            dist.barrier()

    def timed(fn, repeat=1, every_rank=True):
        """(fn's last value, sorted ms samples); the clock starts and stops
        with every rank (``every_rank``) or this rank alone."""
        samples, value = [], None
        for _ in range(repeat):
            sync(every_rank)
            t0 = time.perf_counter()
            value = fn()
            sync(every_rank)
            samples.append((time.perf_counter() - t0) * 1e3)
        return value, sorted(samples)

    def join():
        # a collective that waits past 3 minutes fails the run instead of hanging it
        if on_card:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if on_card else "gloo",
                                init_method="file://" + os.path.join(tmp, "rdv"),
                                world_size=w, rank=rank, timeout=datetime.timedelta(minutes=3))
        return data_mesh(w, rank, "", device=args.device)

    def note(what):
        print(f"rank {rank}: {what} at {time.perf_counter() - started:.1f} s", file=sys.stderr,
              flush=True)

    started = time.perf_counter()
    mesh = join()  # before any CUDA call: the rank's card is set first
    mesh_ms = [(time.perf_counter() - started) * 1e3]
    note("mesh")
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    _, first = timed(lambda: psum_tree(torch.ones(1, device=dev), mesh))
    res["init"] = {"mesh_ms": mesh_ms[0], "first_collective_ms": first[0],
                   "backend": dist.get_backend()}
    n = args.chunks * cs.CHUNK
    x = cs.make_series(n, cs.D, args.seed, dev)
    rows = n // w

    note("series")

    # ---- collect: the frame over the series, then over a placed mesh store
    def frame_collect(data):
        frame = SeriesFrame.from_sharded(data, mesh=mesh, block_size=cs.STORE_BLOCK,
                                         device=args.device)
        return cs.declare_plan(frame).collect()

    reset_launch_counts()
    reset_collective_count()
    got, collect_ms = timed(lambda: frame_collect(x))
    counts = {k: v for k, v in launch_counts().items() if v}
    res["collect"] = {"ms": collect_ms, "launches": counts, "collectives": collective_count()}
    if collective_count() != 1 or (on_card and counts.get("fused_plan_megakernel") != 1):
        bad.append("collect counts")
    digests["collect"] = digest(got)
    store = TimeSeriesStore.from_series(x, cs.STORE_BLOCK, 0, cs.CARRY, mesh=mesh,
                                        device=args.device)
    again, traverse_ms = timed(lambda: frame_collect(store), repeat=3)
    res["collect"]["traverse_ms"] = traverse_ms
    res["collect"]["local_blocks"] = store.blocks.to_local().shape[0]
    if digest(again) != digests["collect"]:
        bad.append("collect over the placed store")
    states = cs.declare_plan(SeriesFrame.from_sharded(store, device=args.device))
    states.collect()
    s0 = states._states[0]
    stat_tree = (s0.stat, s0.sample_sum, torch.cat([s0.head, s0.tail]))
    _, psum_ms = timed(lambda: psum_tree(stat_tree, mesh), repeat=20)
    nbytes = sum(t.numel() * t.element_size() for _, t in cs.leaves(stat_tree))
    res["psum_tree"] = {"bytes": nbytes, "ms": psum_ms}
    del states, again

    note("collect")

    # ---- halo exchange of the rank's rows
    local = x[rank * rows: (rank + 1) * rows]
    res["halo"] = {}
    for hl, hr in ((0, cs.CARRY), (4, 5)):
        for ring in (False, True):
            got_h, ms = timed(lambda: halo_exchange_grouped(local, hl, hr, mesh, ring=ring),
                              repeat=5)
            idx = torch.arange(rank * rows - hl, (rank + 1) * rows + hr, device=dev)
            want = x[idx.remainder(n)]
            if not ring:
                want[(idx < 0) | (idx >= n)] = 0.0
            ok = torch.equal(got_h, want)
            res["halo"][f"({hl}, {hr}) {'ring' if ring else 'line'}"] = {"ms": ms, "ok": ok}
            if not ok:
                bad.append(f"halo ({hl}, {hr}) ring={ring}")
    del got_h, want

    note("halo")

    # ---- stores in both halo modes, autocovariance_sharded
    kern = lambda v: v[0] * v[-1]  # noqa: E731  (the products at lag CARRY, per channel)
    sums = {}
    for mode in ("replicate", "exchange"):
        st = store if mode == "replicate" else TimeSeriesStore.from_series(
            x, cs.STORE_BLOCK, 0, cs.CARRY, mesh=mesh, halo_mode=mode, device=args.device)
        sums[mode], ms = timed(lambda: st.map_reduce(kern))
        res.setdefault("map_reduce_ms", {})[mode] = ms[0]
    if not torch.equal(sums["replicate"], sums["exchange"]):
        bad.append("exchange != replicate")
    digests["map_reduce"] = digest(sums["replicate"])
    del st
    st16 = TimeSeriesStore.from_series(x, cs.STORE_BLOCK, 0, cs.H, mesh=mesh,
                                       device=args.device)
    reset_launch_counts()
    acov, acov_ms = timed(lambda: autocovariance_sharded(st16.blocks, st16.spec, cs.H, mesh))
    res["autocovariance_sharded"] = {"ms": acov_ms[0],
                                     "launches": {k: v for k, v in launch_counts().items() if v}}
    digests["autocovariance"] = digest(acov)
    del st16

    note("stores")

    # ---- restore of the replicate store's blocks
    blocks = store.blocks
    ckdir = os.path.join(tmp, "ckpt")
    _, save_ms = timed(lambda: save_pytree({"blocks": blocks}, ckdir, 0))
    back, restore_ms = timed(lambda: restore_pytree({"blocks": blocks}, ckdir,
                                                    shardings={"blocks": (mesh, [Shard(0)])}))
    res["restore"] = {"save_ms": save_ms[0], "restore_ms": restore_ms[0],
                      "bitwise": isinstance(back["blocks"], DTensor)
                      and torch.equal(back["blocks"].to_local(), blocks.to_local())}
    if not res["restore"]["bitwise"]:
        bad.append("restore")
    del back, blocks, store

    note("restore")

    # ---- one card: the same plan, map-reduce and autocovariance (rank 0)
    if rank == 0:
        def one_card():
            return cs.declare_plan(SeriesFrame.from_sharded(x, block_size=cs.STORE_BLOCK,
                                                            device=dev)).collect()

        one_card()
        want, one_ms = timed(one_card, repeat=3, every_rank=False)
        res["one_card"] = {"collect_ms": one_ms}
        res["members"] = {name: cs.compare(got[name], want[name], tol)
                          for name, tol in cs.MEMBER_TOL.items()}
        if not all(r["ok"] for r in res["members"].values()):
            bad.append("members against one card")
        free = TimeSeriesStore.from_series(x, cs.STORE_BLOCK, 0, cs.CARRY, device=dev)
        res["map_reduce_vs_one_card"] = cs.compare(sums["replicate"], free.map_reduce(kern),
                                                   cs.TOL["lag"])
        del free
        res["autocovariance_vs_blocked"] = cs.compare(
            acov, autocovariance_blocked(x, cs.H, cs.STORE_BLOCK), cs.TOL["lag"])
        for key in ("map_reduce_vs_one_card", "autocovariance_vs_blocked"):
            if not res[key]["ok"]:
                bad.append(key)

    everyone = [None] * w
    dist.all_gather_object(everyone, {"digests": digests, "res": res, "bad": bad})
    dist.destroy_process_group()
    if rank == 0:
        alike = all(e["digests"] == digests for e in everyone)
        report = {"world": w, "device": args.device, "samples_per_channel": n,
                  "channels": cs.D, "ranks_bitwise_alike": alike,
                  "bad": sorted({b for e in everyone for b in e["bad"]}
                                | (set() if alike else {"ranks differ"})),
                  "rank0": res, "ranks": [e["res"] for e in everyone[1:]]}
        with open(out, "w") as f:
            json.dump(report, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--chunks", type=int, default=64, help="chunks of 65,536 rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            print(f"needs {args.world} GPUs, found {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip(), flush=True)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # no network: one host
        from repro_torch.kernels import _build

        _build.build()  # once, before the ranks load it
    tmp = tempfile.mkdtemp(prefix="mesh_cards_")
    out = os.path.join(tmp, "report.json")
    try:
        import torch.multiprocessing as mp

        mp.start_processes(rank_main, args=(args, tmp, out), nprocs=args.world, join=True,
                           start_method="spawn")
        with open(out) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report), flush=True)
    return 1 if report["bad"] else 0


if __name__ == "__main__":
    sys.exit(main())
