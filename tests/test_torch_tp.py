"""Tensor parallelism over the model axis (`repro_torch.parallel.tensor`)
on gloo meshes of CPU ranks, against the reference's one-device functions.

Reduced qwen3-0.6b (4 query heads over 2 KV heads, qk_norm, no window) and
reduced h2o-danube-1.8b (4 over 1 KV head, window 16) in float32, the
reference's params carried across, at (data, model) meshes (1, 2), (2, 2)
and (1, 4): qwen3 splits its KV heads at model 2 and replicates each over
two ranks at 4; danube replicates its one KV head at every model axis.
Each rank (``sys.executable -c``, never importing jax or repro:
tests/test_torch_mesh.py's harness) runs its shard on its rows of the
batch through ``launch.steps.build_cell(..., mesh=)``: the forward-only
loss (logits and fused), the prefill, three decode steps and the greedy
pick.  GSPMD preserves the function (tests/test_distributed.py:119), so
the reference is ``loss_fn``, ``prefill`` and ``decode_step`` on one
device, here.  Tolerances: the loss within 1e-5 of its value; logits and
caches rtol 1e-4, atol 1e-5 (the float32 tolerances of tests/test_backend.py;
the sums run over another split of the same terms).  Every model rank's
replicated outputs (the final norm's input, the loss, the pick) are
bitwise equal; a prefill and a decode step each make 2L + 1 collectives
(the pick one more), whose payload the counting mesh of the dry run
predicts to the byte.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import decode_step as jdecode, init_params as jinit, prefill as jprefill
from repro.training.train_step import loss_fn as jloss_fn
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch.costing import trace_cell
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import init_params, prefill
from repro_torch.parallel import (abstract_mesh, collective_stages, reset_collective_count,
                                  tensor as tp)
from repro_torch.training import make_train_step
from test_torch_mesh import ROOT, _finish, _start

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

ARCHS = ("qwen3", "danube")
MESHES = ((1, 2), (2, 2), (1, 4))
B, S, NEW = 4, 24, 3  # S > danube's reduced window of 16: its ring cache wraps
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = 1e-5
SEED = {"qwen3": 0, "danube": 1}


def _tokens(cfg):
    rng = np.random.default_rng(7)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (NEW, B)).astype(np.int32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{name}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


# The rank body: both archs at one mesh; results flattened into "<arch>/<key>".
RANK = textwrap.dedent(r'''
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, data, rdv, out, params, src = (int(sys.argv[1]), int(sys.argv[2]),
                                                int(sys.argv[3]), *sys.argv[4:8])
    sys.path.insert(0, src)
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import params_from_numpy
    from repro_torch.parallel import collective_bytes, collective_count, reset_collective_count
    from repro_torch.parallel import tensor as tp

    mesh = tp.model_mesh(data, world // data, rank, "file://" + rdv, device="cpu",
                         transport="gloo")
    assert tp.mesh_transport(mesh) == "gloo"
    flat = dict(np.load(params))
    res = {}

    def tree_of(arch):
        tree = {}
        for key, a in flat.items():
            if key.startswith(arch + "/"):
                *path, leaf = key.split("/")[1:]
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = a
        return tree

    def grow(cache, capacity):  # the decode capacity, as ServeEngine grows it
        c = cache["k"].shape[2]
        if c >= capacity:
            return cache
        pad = lambda t, v: torch.cat([t, t.new_full(t.shape[:2] + (capacity - c,)
                                                    + t.shape[3:], v)], 2)
        return {"k": pad(cache["k"], 0), "v": pad(cache["v"], 0),
                "pos": torch.cat([cache["pos"], cache["pos"].new_full(
                    (cache["pos"].shape[0], capacity - c), -1)], 1)}

    drank, per = mesh.get_local_rank("data"), B // data
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        shard = tp.shard_params(params_from_numpy(tree_of(arch), cfg, device="cpu"), mesh)
        prompts = torch.from_numpy(flat[f"tokens/{arch}"][drank * per:(drank + 1) * per])
        steps = torch.from_numpy(flat[f"steps/{arch}"][:, drank * per:(drank + 1) * per])
        pre = build_cell(cfg, ShapeConfig("p", S, B, "prefill"), mesh=mesh, dtype=torch.float32)
        dec = build_cell(cfg, ShapeConfig("d", S + NEW, B, "decode"), mesh=mesh,
                         dtype=torch.float32)
        batch = {"tokens": prompts, "labels": prompts}
        res[f"{arch}/loss"] = pre.loss(shard, batch)[0].numpy()
        res[f"{arch}/loss_fused"] = build_cell(
            cfg, ShapeConfig("p", S, B, "prefill"), mesh=mesh, fused_loss=True).loss(
            shard, batch)[0].numpy()
        resid = []
        hook = shard.final_norm.register_forward_hook(lambda m, i, o: resid.append(i[0]))
        reset_collective_count()
        logits, cache = pre.fn(shard, {"tokens": prompts})
        res[f"{arch}/prefill/count"] = collective_count()
        res[f"{arch}/prefill/bytes"] = collective_bytes()["all-gather"]
        res[f"{arch}/prefill/logits"] = logits.numpy()
        res[f"{arch}/prefill/gathered"] = tp.gather_vocab(logits, mesh).numpy()
        for k, t in cache.items():  # copies: decode writes the ring cache in place
            res[f"{arch}/prefill/cache/{k}"] = t.numpy().copy()
        cache = grow(cache, dec.inputs["cache"]["k"].shape[2])
        counts = []
        for i in range(NEW):
            reset_collective_count()
            logits, cache = dec.fn(shard, cache, {"tokens": steps[i], "pos": S + i})
            counts.append(collective_count())
            res[f"{arch}/decode/{i}/logits"] = logits.numpy()
        for k, t in cache.items():
            res[f"{arch}/decode/cache/{k}"] = t.numpy()
        res[f"{arch}/decode/counts"] = np.array(counts)
        hook.remove()
        res[f"{arch}/residual"] = torch.cat([r.reshape(r.shape[0], -1) for r in resid], 1).numpy()
        reset_collective_count()
        res[f"{arch}/pick"] = tp.greedy_pick(logits, mesh).numpy()
        res[f"{arch}/pick/count"] = collective_count()
    res["coords"] = np.array([drank, tp.model_rank(mesh)])
    np.savez(out, **res)
    dist.destroy_process_group()
''')


def _grow_ref(cache, capacity):
    cache = {k: np.asarray(v) for k, v in cache.items()}
    c = cache["k"].shape[2]
    if c >= capacity:
        return cache
    pad = [(0, 0), (0, 0), (0, capacity - c), (0, 0), (0, 0)]
    return {"k": np.pad(cache["k"], pad), "v": np.pad(cache["v"], pad),
            "pos": np.pad(cache["pos"], [(0, 0), (0, capacity - c)], constant_values=-1)}


def _reference(arch, params, tokens, steps):
    """The reference's loss (logits and fused), prefill logits and cache,
    and three decode steps' logits and cache, on one device."""
    jcfg = jget_arch(arch).reduced()
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    out = {"loss": float(jax.jit(lambda p, b: jloss_fn(p, b, jcfg)[0])(params, batch)),
           "loss_fused": float(jax.jit(lambda p, b: jloss_fn(p, b, jcfg, fused=True)[0])(
               params, batch))}
    logits, cache = jprefill(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    out["prefill/logits"] = np.asarray(logits)
    out.update({f"prefill/cache/{k}": np.asarray(v) for k, v in cache.items()})
    capacity = min(jcfg.swa_window or S + NEW, S + NEW)  # a window keeps its ring
    cache = {k: jnp.asarray(v) for k, v in _grow_ref(cache, capacity).items()}
    for i in range(NEW):
        logits, cache = jdecode(params, cache, {"tokens": jnp.asarray(steps[i]),
                                                "pos": jnp.asarray(S + i, jnp.int32)}, jcfg)
        out[f"decode/{i}/logits"] = np.asarray(logits)
    out.update({f"decode/cache/{k}": np.asarray(v) for k, v in cache.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {(data, model): [rank results]}, "ref": {arch: the
    reference's}, "params": {arch: the numpy tree}}: every mesh's ranks
    started together, the reference computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    trees, flat = {}, {}
    for arch in ARCHS:
        jcfg = jget_arch(arch).reduced()
        trees[arch] = jinit(jax.random.PRNGKey(SEED[arch]), jcfg, dtype=jnp.float32)
        tokens, steps = _tokens(get_arch(arch).reduced())
        flat.update({f"{arch}/{k}": v for k, v in _flat(trees[arch]).items()})
        flat[f"tokens/{arch}"], flat[f"steps/{arch}"] = tokens, steps
    np.savez(tmp / "params.npz", **flat)
    code = f"B, S, NEW, ARCHS = {B}, {S}, {NEW}, {ARCHS!r}\n" + RANK
    started = []
    for data, model in MESHES:
        world = data * model
        for r in range(world):
            log = tmp / f"m{data}x{model}_r{r}.log"
            started.append((_start(code, [r, world, data, tmp / f"rdv{data}x{model}",
                                          tmp / f"m{data}x{model}_r{r}.npz", tmp / "params.npz",
                                          ROOT / "src"], log),
                            log, f"mesh {data}x{model} rank {r}"))
    try:
        ref = {arch: _reference(arch, trees[arch], flat[f"tokens/{arch}"], flat[f"steps/{arch}"])
               for arch in ARCHS}
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    ranks = {(d, m): [dict(np.load(tmp / f"m{d}x{m}_r{r}.npz")) for r in range(d * m)]
             for d, m in MESHES}
    return {"ranks": ranks, "ref": ref,
            "params": {a: jax.tree.map(np.asarray, t) for a, t in trees.items()}}


CASES = [(m, a) for m in MESHES for a in ARCHS]
IDS = [f"{m[0]}x{m[1]}-{a}" for m, a in CASES]


def _kv_heads(cfg, tp_size, mrank):
    hq, hkv = tp.head_layout(cfg, tp_size)
    kv0 = mrank * hq // (cfg.n_heads // cfg.n_kv_heads)
    return slice(kv0, kv0 + hkv)


def _slices(cfg, mesh, res):
    """(the rank's rows of the batch, its vocab columns, its KV heads)."""
    data, model = mesh
    drank, mrank = (int(c) for c in res["coords"])
    per, vl = B // data, cfg.vocab // model
    return (slice(drank * per, (drank + 1) * per), slice(mrank * vl, (mrank + 1) * vl),
            _kv_heads(cfg, model, mrank))


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_loss_matches_reference(runs, mesh, arch):
    ref = runs["ref"][arch]
    for res in runs["ranks"][mesh]:
        for key in ("loss", "loss_fused"):
            got = float(res[f"{arch}/{key}"])
            assert abs(got - ref[key]) <= LOSS_TOL * abs(ref[key]), (key, got, ref[key])


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_prefill_logits_and_cache_match_reference(runs, mesh, arch):
    cfg, ref = get_arch(arch).reduced(), runs["ref"][arch]
    for res in runs["ranks"][mesh]:
        rows, voc, kv = _slices(cfg, mesh, res)
        np.testing.assert_allclose(res[f"{arch}/prefill/logits"],
                                   ref["prefill/logits"][rows, voc], **TOL)
        # every shard gathered: the whole vocabulary, the rank's shard in place
        np.testing.assert_allclose(res[f"{arch}/prefill/gathered"], ref["prefill/logits"][rows],
                                   **TOL)
        np.testing.assert_array_equal(res[f"{arch}/prefill/gathered"][:, voc],
                                      res[f"{arch}/prefill/logits"])
        for name in ("k", "v"):
            np.testing.assert_allclose(res[f"{arch}/prefill/cache/{name}"],
                                       ref[f"prefill/cache/{name}"][:, rows, :, kv], **TOL)
        np.testing.assert_array_equal(res[f"{arch}/prefill/cache/pos"], ref["prefill/cache/pos"])


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_decode_steps_match_reference(runs, mesh, arch):
    cfg, ref = get_arch(arch).reduced(), runs["ref"][arch]
    for res in runs["ranks"][mesh]:
        rows, voc, kv = _slices(cfg, mesh, res)
        for i in range(NEW):
            np.testing.assert_allclose(res[f"{arch}/decode/{i}/logits"],
                                       ref[f"decode/{i}/logits"][rows, voc], **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(res[f"{arch}/decode/cache/{name}"],
                                       ref[f"decode/cache/{name}"][:, rows, :, kv], **TOL)
        np.testing.assert_array_equal(res[f"{arch}/decode/cache/pos"], ref["decode/cache/pos"])
        want = ref[f"decode/{NEW - 1}/logits"][rows].argmax(-1)
        np.testing.assert_array_equal(res[f"{arch}/pick"], want)


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_model_ranks_bitwise_equal(runs, mesh, arch):
    """The replicated outputs -- the residual into the final norm at the
    prefill's last position and every decode step, the greedy pick -- are
    the same bits on every model rank of a data rank; the loss on every
    rank."""
    ranks = runs["ranks"][mesh]
    by_data = {}
    for res in ranks:
        by_data.setdefault(int(res["coords"][0]), []).append(res)
    for group in by_data.values():
        assert len(group) == mesh[1]
        for res in group[1:]:
            for key in ("residual", "pick"):
                np.testing.assert_array_equal(res[f"{arch}/{key}"], group[0][f"{arch}/{key}"])
    for res in ranks[1:]:
        for key in ("loss", "loss_fused"):
            assert res[f"{arch}/{key}"].tobytes() == ranks[0][f"{arch}/{key}"].tobytes()


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_collectives_are_two_per_layer_and_one(runs, mesh, arch):
    """2L + 1 rank-ordered reductions a prefill and a decode step (two a
    block, one for the embedding), one gather a pick; the prefill's
    payload equals the counting mesh's trace of the same cell."""
    cfg = get_arch(arch).reduced()
    want = 2 * cfg.n_layers + 1
    pred = trace_cell(cfg, ShapeConfig("p", S, B, "prefill"), dtype=torch.float32,
                      mesh=make_test_mesh(*mesh))
    # the function's all-reduces (the bound's) and the port's gathers
    assert pred.collective_counts == {"all-reduce": want}
    assert pred.executed_collective_counts == {"all-gather": want}
    assert pred.executed_collective_payload["all-gather"] == (
        mesh[1] * pred.collective_payload["all-reduce"])
    for res in runs["ranks"][mesh]:
        assert int(res[f"{arch}/prefill/count"]) == want
        assert res[f"{arch}/decode/counts"].tolist() == [want] * NEW
        assert int(res[f"{arch}/pick/count"]) == 1
        assert float(res[f"{arch}/prefill/bytes"]) == pred.executed_collective_payload[
            "all-gather"]


LEAVES = {"wq": ("cols", "q"), "wk": ("cols", "kv"), "wv": ("cols", "kv"), "wo": ("rows", "q"),
          "w_gate": ("cols", "ff"), "w_up": ("cols", "ff"), "w_down": ("rows", "ff")}


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_slices_every_leaf(arch, model_axis):
    cfg = get_arch(arch).reduced()
    whole = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    mesh = abstract_mesh((1, model_axis), ("data", "model"))
    hd = cfg.resolved_head_dim
    for r in range(model_axis):
        shard = tp.shard_params(whole, mesh, rank=r)
        assert shard.shard == tp.ModelShard(r, model_axis)
        hq = cfg.n_heads // model_axis
        kv = _kv_heads(cfg, model_axis, r)
        ranges = {"q": slice(r * hq * hd, (r + 1) * hq * hd),
                  "kv": slice(kv.start * hd, kv.stop * hd),
                  "ff": slice(r * cfg.d_ff // model_axis, (r + 1) * cfg.d_ff // model_axis)}
        for got, want in zip(shard.layers, whole.layers):
            for name, (how, rng) in LEAVES.items():
                mod = "attn" if name[0] == "w" and name[1] in "qkvo" else "mlp"
                g, w = getattr(getattr(got, mod), name), getattr(getattr(want, mod), name)
                w = w[:, ranges[rng]] if how == "cols" else w[ranges[rng]]
                assert torch.equal(g, w), (name, r)
            for norm in ("attn_norm", "mlp_norm"):
                assert torch.equal(getattr(got, norm).weight, getattr(want, norm).weight)
            if cfg.qk_norm:
                assert torch.equal(got.attn.q_norm, want.attn.q_norm)
                assert torch.equal(got.attn.k_norm, want.attn.k_norm)
        vl = cfg.vocab // model_axis
        assert torch.equal(shard.embed, whole.embed[r * vl:(r + 1) * vl])
        assert torch.equal(shard.lm_head, whole.lm_head[:, r * vl:(r + 1) * vl])
        assert torch.equal(shard.final_norm.weight, whole.final_norm.weight)


def test_kv_layout_split_replicated_and_refused():
    """KV heads split when the model axis divides them, one a rank
    (replicated) when they divide it, else ValueError naming the arch."""
    qwen = get_arch("qwen3")
    assert tp.head_layout(qwen, 2) == (8, 4) and tp.head_layout(qwen, 16) == (1, 1)
    assert tp.head_layout(get_arch("glm4"), 16) == (2, 1)
    assert [_kv_heads(qwen, 16, r).start for r in range(16)] == [r // 2 for r in range(16)]
    with pytest.raises(ValueError, match="phi3-medium-14b: 40 query heads"):
        tp.head_layout(get_arch("phi3"), 16)
    import dataclasses

    odd = dataclasses.replace(get_arch("qwen3").reduced(), n_heads=6, n_kv_heads=3)
    with pytest.raises(ValueError, match="3 KV heads neither split over a model axis of 2"):
        tp.check_layout(odd, 2)
    assert tp.layout_reason(get_arch("danube"), 16) is None
    assert tp.layout_reason(get_arch("llama4"), 2) == \
        "tensor parallelism: moe waits for a later slice"


@pytest.mark.parametrize("arch", ["llama4", "deepseek-v2", "zamba2", "xlstm", "whisper",
                                  "llava"])
def test_other_families_raise_on_a_model_axis(arch):
    cfg = get_arch(arch).reduced()
    mesh = make_test_mesh(1, 2)
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tok = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match=f"tensor parallelism: {cfg.family} waits"):
        tp.shard_params(model, mesh)
    with pytest.raises(NotImplementedError, match=f"tensor parallelism: {cfg.family} waits"):
        prefill(model, {"tokens": tok}, cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match=f"tensor parallelism: {cfg.family} waits"):
        build_cell(cfg, ShapeConfig("p", 8, 2, "prefill"), mesh=mesh)


def test_train_step_and_mismatches_raise():
    """A non-dense train step on a model axis raises (the dense one runs:
    tests/test_torch_tp_train.py), as do the sequence-parallel layout and
    a shard and mesh that do not match."""
    cfg = get_arch("qwen3").reduced()
    mesh = make_test_mesh(1, 2)
    moe = get_arch("llama4").reduced()
    with pytest.raises(NotImplementedError, match="tensor parallelism: moe waits"):
        make_train_step(moe, mesh=mesh)
    with pytest.raises(NotImplementedError, match="tensor parallelism: moe waits"):
        build_cell(moe, ShapeConfig("t", 8, 2, "train"), mesh=mesh)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        build_cell(cfg, ShapeConfig("d", 64, 1, "decode"), mesh=make_test_mesh(2, 2))
    whole = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    shard = tp.shard_params(whole, mesh)
    tok = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="call it with mesh="):
        prefill(shard, {"tokens": tok}, cfg)
    with pytest.raises(ValueError, match="the model is whole"):
        prefill(whole, {"tokens": tok}, cfg, mesh=mesh)
    with pytest.raises(ValueError, match=r"\(0, 2\)"):
        prefill(shard, {"tokens": tok}, cfg, mesh=make_test_mesh(1, 4))
    # the backward runs through the collectives (the counting mesh only
    # counts: the gradient's shape, one reduction of the model axis)
    reset_collective_count()
    x = torch.ones(3, requires_grad=True)
    tp.replicated(x, mesh).sum().backward()
    assert x.grad.shape == (3,) and collective_stages() == {"backward": (1, 2 * 3 * 4.0)}


def test_model_mesh_takes_the_named_transport():
    with pytest.raises(ValueError, match="is not one of"):
        tp.model_mesh(1, 2, 0, "file:///nonexistent", device="cpu", transport="mpi")
    with pytest.raises(ValueError, match="the nccl transport runs on the card"):
        tp.model_mesh(1, 2, 0, "file:///nonexistent", device="cpu", transport="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.model_mesh(1, 2, 0, "file:///nonexistent")
    assert tp.mesh_transport(make_test_mesh(1, 2)) == "count"


def test_chip_smoke_lm_tp_rehearsal(monkeypatch):
    """chip_smoke's lm_tp on the CPU, its rehearsal at the reduced config
    (``tp_setup``): two rank processes of tools/tp_phase.py over gloo, each
    rank's checks as on the card.  Here both of rank 0's prefills run the plain attention (the
    kernel wrapper's CPU version), so the floor is 0 and the phase must
    fail on checks 1 and 5 alone: the collectives against the dry run's
    count, the ranks bitwise, the greedy picks and both planted faults
    hold."""
    import argparse
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", str(ROOT / "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    lines, failed = [], []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(cs, "fail", lambda msg, **kw: failed.append(msg))
    cs.lm_tp(argparse.Namespace(seed=0), torch.device("cpu"))
    out, = lines
    checks = out["checks"]
    assert failed == ["lm_tp"] and out["floor"] == 0.0 and out["transport"] == "gloo"
    assert out["launches"] == {"prefill": [0, 0], "decode": 0}
    assert all(c["ok"] for c in checks["collectives"].values())
    assert checks["collectives"]["prefill"]["measured"] == [
        (5, 5 * 2 * 2 * 40 * 64 * 2.0)]  # 2L + 1 gathers of (B, S, d) bf16 partials
    assert checks["bitwise_across_ranks"] == {"residual": True, "tokens": True}
    assert checks["pick_gathers"] and checks["finite"] and checks["greedy"]["disagreeing"] == 0
    assert all(f["caught"] for f in checks["faults"].values())
    assert max(checks["prefill_vs_one_rank_rel_err"]) < 0.1  # bf16 at width 64
    assert cs.READINGS["lm_tp"]["collectives"] == checks["collectives"]
    dry = cs.dryrun_tp(cs.READINGS["lm_tp"])  # the dryrun phase reads lm_tp's traces
    assert dry["prefill"]["flops"] > dry["decode"]["flops"] > 0
