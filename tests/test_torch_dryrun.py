"""The port's dry run (`repro_torch.launch.dryrun`), its depth calibration
(`launch.costing.calibrated_cost`) and its report (`launch.report`).

The calibration's extrapolation from two reduced depths equals a trace at
the full depth exactly, in FLOPs (function and executed) and bytes
(function and executed), for the dense family (qwen3), the hybrid (zamba2
at a depth that is a multiple of its shared block's period), the xLSTM
(whole mLSTM / sLSTM pairs) and the encoder-decoder (encoder and decoder
depths co-scaled), in train, prefill and decode cells; and in peak bytes
too, except the xLSTM's (its peak above the held bytes is not linear in
the depth).  A data-parallel train step at gloo world 2 counts the
collective payload bytes the dry run predicts for its cell.  chip_smoke's
dryrun phase holds lm_serve's prefill and lm_train's step at full width
against their hand counts and catches its two planted counts.  ``run_cell``
writes the reference's skip reasons and JSON keys; on the production
meshes the dense family's train, prefill and decode cells are traced as
one tensor-parallel rank (the step's own bytes beside the rule tables',
a train step's collectives by stage), and the cells that wait for a later
slice are ``partial`` with their reason;
the counting mesh's collective payload equals the hand count; the report
renders its tables from written cells; the two modules import with no
jax.  The reference's ``repro.launch.dryrun`` is never
imported here: it sets XLA_FLAGS to 512 host devices at import.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES_BY_NAME
from repro.configs.base import cell_is_runnable as ref_cell_is_runnable
from repro.configs.registry import get_arch as ref_get_arch
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun, report
from repro_torch.launch.costing import _reduced, calibrated_cost, trace_cell
from repro_torch.launch.mesh import make_test_mesh
from test_torch_mesh import ROOT, _finish, _start

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

CALIB = {"qwen3": dict(n_layers=6), "zamba2": dict(n_layers=9),
         "xlstm": dict(n_layers=6), "whisper": dict(n_layers=5, enc_layers=5)}
CELLS = (ShapeConfig("t", 48, 2, "train"), ShapeConfig("p", 48, 2, "prefill"),
         ShapeConfig("d", 48, 2, "decode"))


@pytest.mark.parametrize("arch", list(CALIB))
@pytest.mark.parametrize("shape", CELLS, ids=[s.kind for s in CELLS])
def test_depth_calibration_is_exact(arch, shape):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **CALIB[arch])
    cal = calibrated_cost(cfg, shape)
    full = trace_cell(_reduced(cfg, cfg.n_layers), shape).scalars()
    got = cal.trace.scalars()
    linear = set(full) - ({"peak_bytes", "temp_bytes"} if arch == "xlstm" else set())
    assert {k: got[k] for k in linear} == {k: full[k] for k in linear}
    assert cal.flops == cal.trace.flops and cal.hbm_bytes == full["function_bytes"]
    assert cal.raw["depths"] == ([3, 6] if arch == "zamba2" else [2, 4])


RANK = textwrap.dedent(r'''
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, rdv, out, src = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
    sys.path.insert(0, src)
    import json, numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import (collective_bytes, collective_count, data_mesh,
                                      reset_collective_count)
    from repro_torch.training import adamw_init, make_train_step, named_parameters

    mesh = data_mesh(world, rank, "file://" + rdv, device="cpu")
    cfg = get_arch("qwen3").reduced()
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    per = B // world
    mine = torch.from_numpy(tok[rank * per:(rank + 1) * per])
    model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    step = make_train_step(cfg, lr_fn=1e-3, mesh=mesh, accum=ACCUM)
    opt = adamw_init(named_parameters(model))
    reset_collective_count()
    step(model, opt, {"tokens": mine, "labels": mine})
    with open(out, "w") as f:
        json.dump({"count": collective_count(), "bytes": collective_bytes()}, f)
    dist.destroy_process_group()
''')


@pytest.mark.parametrize("accum", [1, 2])
def test_collective_bytes_match_prediction(tmp_path, accum):
    b, s, world = 8, 32, 2
    code = f"B, S, ACCUM = {b}, {s}, {accum}\n" + RANK
    started = []
    for r in range(world):
        log = tmp_path / f"r{r}.log"
        started.append((_start(code, [r, world, tmp_path / "rdv", tmp_path / f"r{r}.json",
                                      ROOT / "src"], log), log, f"rank {r}"))
    try:
        cfg = get_arch("qwen3").reduced()
        pred = trace_cell(cfg, ShapeConfig("t", s, b, "train"), batch=b // world, world=world,
                          accum=accum, dtype=torch.float32)
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    for r in range(world):
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["count"] == pred.collective_counts["all-gather"]
        assert got["bytes"]["all-gather"] == pred.collective_payload["all-gather"]
        assert sum(got["bytes"].values()) == got["bytes"]["all-gather"]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    cells = {m: dryrun.run_cell("qwen3", "decode_32k", m, out) for m in dryrun.MESHES}
    cells["skipped"] = dryrun.run_cell("glm4", "long_500k", "h100x1", out)
    cells["sp"] = dryrun.run_cell("zamba2", "long_500k", "h100x4", out)
    cells["heads"] = dryrun.run_cell("phi3", "decode_32k", "pod16x16", out)
    cells["tp_train"] = dryrun.run_cell("qwen3", "train_4k", "pod16x16", out)
    return out, cells


def test_run_cell_statuses_and_keys(written):
    out, cells = written
    ok = cells["h100x1"]
    assert ok["status"] == "ok"
    assert {"cell", "status", "arch", "shape", "mesh", "sp_mode", "seconds", "roofline",
            "roofline_calibrated"} <= set(ok)
    roof = ok["roofline"]
    assert {"flops", "hbm_bytes", "wire_bytes", "t_compute", "t_memory", "t_collective",
            "bottleneck", "model_flops", "useful_flops_ratio", "collective_counts",
            "memory_per_device", "executed_flops", "executed_bytes"} <= set(roof)
    assert roof["bottleneck"] == "memory"  # decode reads its whole cache
    mem = roof["memory_per_device"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] >= mem["param_bytes"] + mem["cache_bytes"]
    assert cells["h100x4"]["status"] == "ok" and cells["h100x4"]["sp_mode"] is False
    for tag in ("pod16x16", "pod2x16x16"):  # one tensor-parallel rank's decode step
        tp_roof = cells[tag]["roofline"]
        assert cells[tag]["status"] == "ok" and cells[tag]["fits_port_step"]
        assert tp_roof["collective_counts"]["all-reduce"] == 2 * 28 + 1
        assert tp_roof["executed_collectives"]["counts"]["all-gather"] == 2 * 28 + 1
        assert tp_roof["t_collective"] > 0 and "peak_bytes_port_step" in tp_roof[
            "memory_per_device"]
    assert cells["heads"]["status"] == "partial"
    assert cells["heads"]["reason"].startswith(
        "phi3-medium-14b: 40 query heads do not split over a model axis of 16")
    # one tensor-parallel rank's train step: 2L + 1 reductions in the
    # backward, L in the recompute (remat stops once the saved tensors are
    # back: the block's last reduction is not rerun), ZeRO-1 moments
    assert cells["tp_train"]["status"] == "ok", cells["tp_train"].get("error")
    stages = cells["tp_train"]["roofline"]["executed_collectives"]["stages"]
    assert stages["backward.count"] == 2 * 28 + 1 and stages["recompute.count"] == 28
    assert stages["zero1.count"] == 1 and stages["norm.count"] == 1
    mem = cells["tp_train"]["roofline"]["memory_per_device"]
    assert mem["opt_bytes"] < mem["opt_bytes_port_step"] < mem["opt_bytes_replicated"] / 8
    assert cells["sp"]["status"] == "partial" and cells["sp"]["sp_mode"] is True
    assert "sequence parallelism waits for a later slice" in cells["sp"]["reason"]
    skip = cells["skipped"]
    _, why = ref_cell_is_runnable(ref_get_arch("glm4"), REF_SHAPES_BY_NAME["long_500k"])
    assert skip == {"cell": "glm4-9b__long_500k__h100x1", "status": "skipped", "reason": why}
    for cell in cells.values():
        with open(os.path.join(out, cell["cell"] + ".json")) as f:
            assert json.load(f) == json.loads(json.dumps(cell))


def test_cell_memory_from_rule_tables(written):
    _, cells = written
    one = cells["h100x1"]["roofline"]["memory_per_device"]
    four = cells["h100x4"]["roofline"]["memory_per_device"]
    pod = cells["pod16x16"]["roofline"]["memory_per_device"]
    assert four["param_bytes"] == one["param_bytes"]  # data parallel: whole replicas
    cfg = get_arch("qwen3")
    pos = cfg.n_layers * 32768 * 4  # the replicated int32 positions of each layer
    kv = one["cache_bytes"] - pos
    assert four["cache_bytes"] == kv / 4 + pos  # the batch of 128 over 4 ranks
    # (16, 16): the batch over 16 data ranks; 8 KV heads do not divide the
    # 16-way model axis and stay whole
    assert pod["cache_bytes"] == kv / 16 + pos
    assert pod["param_bytes"] < one["param_bytes"] / 8
    # the tensor-parallel step holds whole heads: one KV head a rank (the
    # rules keep all 8 in the cache), and wk / wv of 128 columns a rank
    # where the rules cut a head to 64
    assert pod["cache_bytes_port_step"] == kv / 16 / 8 + pos
    hd = cfg.resolved_head_dim
    assert pod["param_bytes_port_step"] - pod["param_bytes"] == (
        cfg.n_layers * 2 * cfg.d_model * (hd - cfg.n_kv_heads * hd // 16) * 2)


def test_report_renders_written_cells(written):
    out, _ = written
    text = report.render(out)
    assert "fits H100 80 GB?" in text and "NVIDIA H100 80GB HBM3, 700.00 W" in text
    row = [ln for ln in report.dryrun_table("h100x1", out) if ln.startswith("| qwen3-0.6b")]
    assert len(row) == 1 and "| decode_32k | ok |" in row[0]
    assert any("skipped — pure full-attention arch" in ln
               for ln in report.dryrun_table("h100x1", out))
    assert any("partial" in ln for ln in report.dryrun_table("pod16x16", out))
    tp_rows = report.tensor_parallel_table(out)
    assert len(tp_rows) == 5 and tp_rows[2].startswith("| qwen3-0.6b | decode_32k | pod16x16 |")
    assert "| 57 |" in tp_rows[2]
    assert tp_rows[3].startswith("| qwen3-0.6b | train_4k | pod16x16 |")
    assert "## Tensor-parallel cells" in text
    roof = report.roofline_table("h100x1", out)
    assert len(roof) == 3 and "**memory**" in roof[2]
    coll = report.collective_table("h100x4", out)
    assert len(coll) == 3
    summary = report.summary_table(out)
    assert len(summary) == 3 and summary[2].startswith("| qwen3-0.6b | decode_32k |")
    assert "no (6.15x)" in summary[2]  # 491.8 GB: the 128 x 32,768 cache


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_counting_mesh_payload_equals_hand_count(kind, mesh):
    """One tensor-parallel rank traced on the counting mesh: 2L + 1
    reductions (two a block, one for the embedding) of a partial (batch /
    data, tokens, d) residual: to the function an all-reduce of it, as
    executed an all-gather of the model axis's tp of them."""
    cfg = get_arch("qwen3").reduced()
    b, s = 4, 32
    tr = trace_cell(cfg, ShapeConfig("c", s, b, kind), dtype=torch.bfloat16,
                    mesh=make_test_mesh(*mesh))
    tokens = s if kind == "prefill" else 1
    n = 2 * cfg.n_layers + 1
    partial = (b // mesh[0]) * tokens * cfg.d_model * 2
    assert tr.collective_counts == {"all-reduce": n}
    assert tr.collective_payload == {"all-reduce": n * partial}
    assert tr.executed_collective_counts == {"all-gather": n}
    assert tr.executed_collective_payload == {"all-gather": n * mesh[1] * partial}


DENSE_TP = [(a, s, m) for a in ("qwen3", "danube", "glm4", "phi3")
            for s in ("prefill_32k", "decode_32k", "train_4k")
            for m in ("pod16x16", "pod2x16x16")]


@pytest.mark.parametrize("arch,shape,mesh", DENSE_TP, ids=["-".join(c) for c in DENSE_TP])
def test_dense_production_cells_traced(tmp_path, arch, shape, mesh):
    """The dense family's train, prefill and decode cells of the production
    meshes are traced tensor-parallel, but phi3-medium-14b's, whose 40
    heads do not split over 16."""
    cell = dryrun.run_cell(arch, shape, mesh, str(tmp_path))
    if arch == "phi3":
        assert cell["status"] == "partial" and "40 query heads" in cell["reason"]
        return
    roof = cell["roofline"]
    assert cell["status"] == "ok", cell.get("error")
    cfg = get_arch(arch)
    assert roof["wire_bytes"] > 0 and roof["flops"] > 0 and roof["hbm_bytes"] > 0
    ex = roof["executed_collectives"]
    mem = roof["memory_per_device"]
    assert mem["peak_bytes_port_step"] > mem["param_bytes_port_step"] > 0
    if shape == "train_4k":
        # the forward's 2L + 1 and the loss's two a chunk, the backward's
        # 2L + 1, the recompute's L; the data axis's loss gather, gradient
        # sum and ZeRO-1 gather
        stages = ex["stages"]
        assert stages["backward.count"] == 2 * cfg.n_layers + 1
        assert stages["forward.count"] == 2 * cfg.n_layers + 1 + 2 + 1
        assert stages["recompute.count"] == cfg.n_layers
        assert stages["zero1.count"] == 1 and stages["norm.count"] == 1
        assert mem["opt_bytes_port_step"] >= mem["opt_bytes"]
        return
    assert roof["collective_counts"]["all-reduce"] == 2 * cfg.n_layers + 1
    # the all-reduce's wire bytes (twice its payload) against the port's
    # gathers of 16 partials: 8x
    assert ex["counts"]["all-gather"] == 2 * cfg.n_layers + 1
    assert ex["wire_bytes"] == pytest.approx(8 * roof["wire_bytes"], rel=1e-9)


def test_main_and_imports_without_jax(tmp_path):
    code = textwrap.dedent(f'''
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(ROOT / "src")!r})
        import repro_torch.launch.dryrun as d, repro_torch.launch.report as r
        rc = d.main(["--arch", "glm4", "--shape", "long_500k", "--mesh", "h100x1",
                     "--out", {str(tmp_path)!r}])
        assert rc == 0
        r.main(["--dir", {str(tmp_path)!r}])
    ''')
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SKIPPED" in res.stdout and "| glm4-9b | long_500k | skipped" in res.stdout
    assert (tmp_path / "glm4-9b__long_500k__h100x1.json").exists()


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_dryrun_checks():
    """chip_smoke's dryrun phase on lm_serve's prefill and lm_train's step at
    full width (meta tensors: no memory): the work within 2% of the hand
    counts with the named conventions, both planted counts caught, and the
    conventions each what they name (the window's and the float32
    gradients' deltas as closed forms)."""
    from repro_torch.kernels.swa_attention.ref import valid_pairs

    cs = _smoke()
    cfg = get_arch("danube")
    b, p, new = cs.SERVE_BATCH, cs.SERVE_PROMPT, cs.SERVE_NEW
    cs.reading("lm_serve", cfg, batch=b, prompt=p, new=new, max_len=p + new, init=False)
    r = cs.READINGS["lm_serve"]
    hand, conv = cs.dryrun_hand("lm_serve", r)["prefill"]
    w, hd = cfg.swa_window, cfg.resolved_head_dim
    assert conv["window"][1] == 4 * hd * b * cfg.n_heads * cfg.n_layers * (
        valid_pairs(p, w) - p * (p + 1) // 2)
    assert conv["embed_write"] == (-b * p * cfg.d_model * 2, 0)
    dry = cs.dryrun_window(r, p)
    check = cs._work_check(dry["prefill"], hand, conv)
    assert check["ok"] and abs(check["rel"]["flops"]) < 1e-3, check["rel"]
    assert cs._work_check(dry["decode"], *cs.dryrun_hand("lm_serve", r)["decode"])["ok"]
    for planted in (cs.planted_dropped_attention, cs.planted_whole_square):
        with planted():
            faulty = cs._work_check(cs.dryrun_window(r, p)["prefill"], hand, conv)
        assert not faulty["ok"] and abs(faulty["rel"]["flops"]) > 0.05, planted.__name__
    cfg = get_arch("qwen3")
    cs.reading("lm_train", cfg, micro=cs.TRAIN_MICRO, accum=cs.TRAIN_ACCUM, seq=cs.TRAIN_SEQ)
    r = cs.READINGS["lm_train"]
    (hand, conv), = cs.dryrun_hand("lm_train", r).values()
    work = cs.train_work(cfg, r["micro"] * r["accum"], r["seq"])
    assert conv == {"fp32_gradients": (2 * work["params"], 0)}
    dry = cs.dryrun_train(r)
    assert dry["param_bytes"] == work["params"] * 2
    assert cs._work_check(dry["step"], hand, conv)["ok"]
