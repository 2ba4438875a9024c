"""The dense family's train step on a ``("data", "model")`` mesh
(`repro_torch.training.make_train_step(mesh=)`) on gloo meshes of CPU
ranks, against the reference's one-device ``make_train_step`` on the whole
batch.

Reduced qwen3-0.6b (4 query heads over 2 KV heads, qk_norm) and reduced
h2o-danube-1.8b (4 over 1 KV head, window 16) in float32, the reference's
params carried across (``params_from_numpy``), at (data, model) meshes
(1, 2), (2, 2) and (1, 4): qwen3 splits its KV heads at model 2 and
replicates each over two ranks at 4; danube replicates its one KV head at
every model axis.  Each rank (``sys.executable -c``, never importing jax
or repro: tests/test_torch_mesh.py's harness) takes two steps on its rows
of the batch, labels with some -1 (the data ranks hold unequal counts),
``clip_norm`` below the gradients' norm (the clip acts), weight decay
0.1; accumulation 2 on a data-axis-1 mesh and on (2, 2) (where a data
rank's i-th row lies in the reference's i-th microbatch only on data
rank 0, and the microbatches' label counts differ), remat ``"full"`` everywhere
but one ``"dots"`` case, the fused and the logits cross-entropy.  GSPMD
preserves the function (tests/test_distributed.py:119), so the reference
is the one-device step.  The learning rate is 1e-4: Adam's first update
g / (|g| + eps) is a step function near g = 0, and at 1e-3 one entry of
4,096 (a step-0 gradient of 5.7e-9 where the median is 5.1e-3) moved its
parameter 2.6e-5 from the reference's for a float32 rounding of that
gradient.  Tolerances: the loss within 1e-5 of its value;
``grad_norm``, each rank's updated shard and its ZeRO-1 slices of ``m``
and ``v`` at rtol 1e-4, atol 1e-5 (the float32 tolerances of
tests/test_backend.py, as tests/test_torch_tp.py uses).  Bitwise: the
residual-side norm leaves across model ranks, the shared KV copies, every
leaf across data ranks, and the ZeRO-1 update against ``adamw_update``
with whole moments on the same gradients.  The backward makes 2L + 1
model-axis reductions a microbatch, and every stage's collectives equal
the counting mesh's trace to the byte.
"""
import dataclasses
import importlib.util
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit
from repro.training.optimizer import adamw_init as jadamw_init
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch.costing import trace_cell
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import init_params, params_from_numpy
from repro_torch.parallel import tensor as tp
from repro_torch.training import make_train_step, named_parameters, zero1_plan
from test_torch_mesh import ROOT, _finish, _start

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

ARCHS = ("qwen3", "danube")
MESHES = ((1, 2), (2, 2), (1, 4))
B, S, STEPS = 4, 24, 2
LR, CLIP, WD = 1e-4, 0.5, 0.1
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = 1e-5
SEED = {"qwen3": 0, "danube": 1}
# (accum, remat policy, fused loss) of each (mesh, arch)
CASE = {((1, 2), "qwen3"): (2, "dots", False), ((1, 2), "danube"): (1, "full", True),
        ((2, 2), "qwen3"): (1, "full", True), ((2, 2), "danube"): (2, "full", False),
        ((1, 4), "qwen3"): (1, "full", False), ((1, 4), "danube"): (1, "full", True)}


def _batch(cfg):
    """Tokens, and labels with some -1: the data ranks' rows hold unequal
    counts of labels."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[0, 3:9] = -1
    labels[1, 20:] = -1
    labels[3, 5] = -1
    return tokens, labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{name}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _tree(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


# The rank body: both archs at one mesh; results flattened into "<arch>/<key>".
RANK = textwrap.dedent(r'''
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, data, rdv, out, params, src = (int(sys.argv[1]), int(sys.argv[2]),
                                                int(sys.argv[3]), *sys.argv[4:8])
    sys.path.insert(0, src)
    import copy, dataclasses
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.models import params_from_numpy, trainable
    from repro_torch.parallel import collective_stages, psum_tree, reset_collective_count
    from repro_torch.parallel import tensor as tp
    from repro_torch.training import (accumulate_grads, adamw_init, adamw_update, init_state,
                                      make_train_step, named_parameters, zero1_init,
                                      zero1_plan, zero1_update)

    mesh = tp.model_mesh(data, world // data, rank, "file://" + rdv, device="cpu",
                         transport="gloo")
    flat = dict(np.load(params))
    res = {}

    def tree_of(prefix):
        tree = {}
        for key, a in flat.items():
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = a
        return tree

    drank, per = tp.data_rank(mesh), B // data
    for arch in ARCHS:
        accum, policy, fused = CASE[arch]
        cfg = dataclasses.replace(get_arch(arch).reduced(), remat_policy=policy)
        whole = params_from_numpy(tree_of(arch), cfg, device="cpu")
        shard = trainable(tp.shard_params(whole, mesh))
        rows = slice(drank * per, (drank + 1) * per)
        batch = {"tokens": torch.from_numpy(flat[f"tokens/{arch}"][rows]).long(),
                 "labels": torch.from_numpy(flat[f"labels/{arch}"][rows]).long()}
        kw = dict(accum=accum, clip_norm=CLIP, weight_decay=WD, fused_loss=fused)
        step = make_train_step(cfg, lr_fn=LR, mesh=mesh, **kw)
        named = named_parameters(shard)
        plan = zero1_plan(named, cfg, mesh)

        # the ZeRO-1 pin: step 0's update on the same gradients and norm,
        # ZeRO-1 moments against whole ones
        loss, _, grads = accumulate_grads(shard, batch, cfg, accum=accum, fused_loss=fused,
                                          mesh=mesh)
        grads = tp.combine_model_grads(grads, cfg, mesh)
        if data > 1:
            grads = psum_tree(grads, mesh)
        norm = tp.global_norm(grads, cfg, mesh)
        a, b = copy.deepcopy(shard), copy.deepcopy(shard)
        na, nb = named_parameters(a), named_parameters(b)
        _, za = zero1_update(grads, zero1_init(na, plan), na, mesh, lr=LR, norm=norm,
                             weight_decay=WD, clip_norm=CLIP)
        _, wb = adamw_update(grads, adamw_init(nb), nb, lr=LR, norm=norm, weight_decay=WD,
                             clip_norm=CLIP)
        res[f"{arch}/zero1_params_bitwise"] = np.array(all(
            torch.equal(na[k], nb[k]) for k in na))
        res[f"{arch}/zero1_moments_bitwise"] = np.array(all(
            torch.equal(za.m[k], plan.take(k, wb.m[k])) and
            torch.equal(za.v[k], plan.take(k, wb.v[k])) for k in za.m))
        del a, b, grads

        state = init_state(shard, cfg, mesh)
        for i in range(STEPS):
            reset_collective_count()
            _, state, metrics = step(shard, state, batch)
            for k, v in metrics.items():
                res[f"{arch}/{i}/{k}"] = v.numpy()
            for stage, (n, nbytes) in collective_stages().items():
                res[f"{arch}/{i}/stage/{stage}"] = np.array([n, nbytes])
        for k, p in named.items():
            res[f"{arch}/p/{k}"] = p.detach().numpy()
        for k in state.m:
            res[f"{arch}/m/{k}"] = state.m[k].numpy()
            res[f"{arch}/v/{k}"] = state.v[k].numpy()
    res["coords"] = np.array([drank, tp.model_rank(mesh)])
    np.savez(out, **res)
    dist.destroy_process_group()
''')


def _reference(arch, params, tokens, labels, accum, fused):
    """The reference's two steps on one device: each step's metrics, then
    the params and moments."""
    jcfg = jget_arch(arch).reduced()
    step = jax.jit(jmake_train_step(jcfg, lr_fn=LR, accum=accum, clip_norm=CLIP,
                                    weight_decay=WD, fused_loss=fused))
    p, opt = params, jadamw_init(params)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    out = {}
    for i in range(STEPS):
        grads_norm = _ref_grad_norm(jcfg, p, batch, accum, fused)
        p, opt, m = step(p, opt, batch)
        out.update({f"{i}/{k}": float(v) for k, v in m.items()})
        out[f"{i}/grad_norm"] = grads_norm
    out["params"] = jax.tree.map(np.asarray, p)
    out["m"], out["v"] = jax.tree.map(np.asarray, opt.m), jax.tree.map(np.asarray, opt.v)
    return out


def _ref_grad_norm(jcfg, params, batch, accum, fused):
    """The global norm of the reference step's gradients (its metrics do
    not report it): the mean of the microbatches' gradients, as its step
    takes them."""
    import functools

    from repro.training.optimizer import global_norm
    from repro.training.train_step import loss_fn

    grad = jax.jit(jax.grad(lambda p, b: functools.partial(loss_fn, fused=fused)(p, b, jcfg)[0]))
    per = B // accum
    gs = [grad(params, {k: v[i * per:(i + 1) * per] for k, v in batch.items()})
          for i in range(accum)]
    mean = jax.tree.map(lambda *x: sum(x) / accum, *gs)
    return float(global_norm(mean))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {(data, model): [rank results]}, "ref": {(mesh, arch): the
    reference's}}: every mesh's ranks started together, the reference
    computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_train")
    flat, trees, batches = {}, {}, {}
    for arch in ARCHS:
        trees[arch] = jinit(jax.random.PRNGKey(SEED[arch]), jget_arch(arch).reduced(),
                            dtype=jnp.float32)
        batches[arch] = _batch(get_arch(arch).reduced())
        flat.update({f"{arch}/{k}": v for k, v in _flat(trees[arch]).items()})
        flat[f"tokens/{arch}"], flat[f"labels/{arch}"] = batches[arch]
    np.savez(tmp / "params.npz", **flat)
    started = []
    for mesh in MESHES:
        data, model = mesh
        world = data * model
        case = {a: CASE[(mesh, a)] for a in ARCHS}
        code = (f"B, S, STEPS, ARCHS, CASE = {B}, {S}, {STEPS}, {ARCHS!r}, {case!r}\n"
                f"LR, CLIP, WD = {LR}, {CLIP}, {WD}\n" + RANK)
        for r in range(world):
            log = tmp / f"m{data}x{model}_r{r}.log"
            started.append((_start(code, [r, world, data, tmp / f"rdv{data}x{model}",
                                          tmp / f"m{data}x{model}_r{r}.npz", tmp / "params.npz",
                                          ROOT / "src"], log),
                            log, f"mesh {data}x{model} rank {r}"))
    try:
        ref, done = {}, {}
        for (mesh, arch), (accum, _, fused) in CASE.items():
            key = (arch, accum, fused)
            if key not in done:
                done[key] = _reference(arch, trees[arch], *batches[arch], accum, fused)
            ref[(mesh, arch)] = done[key]
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    ranks = {(d, m): [dict(np.load(tmp / f"m{d}x{m}_r{r}.npz")) for r in range(d * m)]
             for d, m in MESHES}
    return {"ranks": ranks, "ref": ref}


CASES = [(m, a) for m in MESHES for a in ARCHS]
IDS = [f"{m[0]}x{m[1]}-{a}" for m, a in CASES]


def _cfg(mesh, arch):
    return dataclasses.replace(get_arch(arch).reduced(), remat_policy=CASE[(mesh, arch)][1])


def _rank_view(cfg, tree, mesh, coords):
    """{name: the rank's shard of the reference tree's leaf}, and the
    rank's ZeRO-1 plan."""
    whole = params_from_numpy(tree, cfg, device="cpu")
    shard = tp.shard_params(whole, make_test_mesh(*mesh), rank=int(coords[1]))
    named = dict(shard.named_parameters())
    plan = zero1_plan(named, cfg, make_test_mesh(*mesh))._replace(rank=int(coords[0]))
    return named, plan


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_loss_and_grad_norm_match_reference(runs, mesh, arch):
    ref = runs["ref"][(mesh, arch)]
    for res in runs["ranks"][mesh]:
        for i in range(STEPS):
            got = float(res[f"{arch}/{i}/loss"])
            want = ref[f"{i}/loss"]
            assert abs(got - want) <= LOSS_TOL * abs(want), (i, got, want)
            np.testing.assert_allclose(float(res[f"{arch}/{i}/grad_norm"]),
                                       ref[f"{i}/grad_norm"], **TOL)
            assert float(res[f"{arch}/{i}/grad_norm"]) > CLIP  # the clip acts
            assert float(res[f"{arch}/{i}/lr"]) == np.float32(LR)


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_updated_shards_and_moment_slices_match_reference(runs, mesh, arch):
    """After two steps: each rank's shard of every leaf, and its ZeRO-1
    slices of ``m`` and ``v`` (on a data axis of 1, whole moments)."""
    cfg, ref = _cfg(mesh, arch), runs["ref"][(mesh, arch)]
    for res in runs["ranks"][mesh]:
        params, plan = _rank_view(cfg, ref["params"], mesh, res["coords"])
        for k, p in params.items():
            np.testing.assert_allclose(res[f"{arch}/p/{k}"], p.numpy(), **TOL, err_msg=k)
        held = [k for k in params if plan.held(k)]
        assert sorted(held) == sorted(k[len(arch) + 3:] for k in res if k.startswith(
            f"{arch}/m/"))
        for which in ("m", "v"):
            moments, _ = _rank_view(cfg, ref[which], mesh, res["coords"])
            for k in held:
                np.testing.assert_allclose(res[f"{arch}/{which}/{k}"],
                                           plan.take(k, moments[k]).numpy(), **TOL,
                                           err_msg=f"{which} {k}")


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_bitwise_across_ranks_and_zero1(runs, mesh, arch):
    """The residual-side norms are the same bits on every model rank, a
    shared KV head's copies on the ranks that share it, every leaf on every
    data rank; the ZeRO-1 update is ``adamw_update``'s with whole moments."""
    cfg, ranks = _cfg(mesh, arch), runs["ranks"][mesh]
    data, model = mesh
    by = {tuple(int(c) for c in res["coords"]): res for res in ranks}
    names = [k[len(arch) + 3:] for k in ranks[0] if k.startswith(f"{arch}/p/")]
    for k in names:
        role = tp.grad_role(k, cfg, model)
        for (d, m), res in by.items():
            got = res[f"{arch}/p/{k}"]
            np.testing.assert_array_equal(got, by[(0, m)][f"{arch}/p/{k}"], err_msg=k)
            if role in ("replicated", "partial"):
                np.testing.assert_array_equal(got, by[(d, 0)][f"{arch}/p/{k}"], err_msg=k)
            if role == "shared":
                first = m // (model // cfg.n_kv_heads) * (model // cfg.n_kv_heads)
                np.testing.assert_array_equal(got, by[(d, first)][f"{arch}/p/{k}"], err_msg=k)
    for res in ranks:
        for i in range(STEPS):
            for key in ("loss", "grad_norm"):
                assert res[f"{arch}/{i}/{key}"].tobytes() == ranks[0][f"{arch}/{i}/{key}"].tobytes()
        assert bool(res[f"{arch}/zero1_params_bitwise"])
        assert bool(res[f"{arch}/zero1_moments_bitwise"])
    # the replicated KV layout is exercised: danube everywhere, qwen3 at 4
    roles = {tp.grad_role(k, cfg, model) for k in names}
    assert ("shared" in roles) == (cfg.n_kv_heads % model != 0)


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_collectives_by_stage_match_counting_mesh(runs, mesh, arch):
    """2L + 1 model-axis reductions in each microbatch's backward; every
    stage's count and bytes equal the counting mesh's trace of the same
    step."""
    cfg = _cfg(mesh, arch)
    accum, _, fused = CASE[(mesh, arch)]
    pred = trace_cell(cfg, ShapeConfig("t", S, B, "train"), dtype=torch.float32,
                      accum=accum, fused_loss=fused, mesh=make_test_mesh(*mesh))
    want = pred.executed_collective_stages
    assert want["backward.count"] == accum * (2 * cfg.n_layers + 1)
    assert ("zero1.count" in want) == (mesh[0] > 1)
    for res in runs["ranks"][mesh]:
        for i in range(STEPS):
            got = {}
            for key, (n, nbytes) in ((k.rsplit("/", 1)[1], v) for k, v in res.items()
                                     if k.startswith(f"{arch}/{i}/stage/")):
                got[f"{key}.count"], got[f"{key}.bytes"] = float(n), float(nbytes)
            assert got == want, (i, got, want)


def test_other_families_refuse_a_model_axis():
    mesh = make_test_mesh(1, 2)
    for arch in ("llama4", "deepseek-v2", "zamba2", "xlstm", "whisper", "llava"):
        cfg = get_arch(arch).reduced()
        with pytest.raises(NotImplementedError, match=f"tensor parallelism: {cfg.family} waits"):
            make_train_step(cfg, mesh=mesh)
        with pytest.raises(NotImplementedError, match=f"tensor parallelism: {cfg.family} waits"):
            build_cell(cfg, ShapeConfig("t", 8, 2, "train"), mesh=mesh)


@pytest.mark.parametrize("mesh", [(2, 2), (16, 16)], ids=["2x2", "16x16"])
def test_zero1_moment_bytes_equal_the_rule_tables(mesh):
    """The moments a rank holds (qwen3-0.6b, model axis 2 or 16) are the
    rule tables' ZeRO-1 ``opt_bytes`` at (2, 2); at (16, 16) the step
    holds whole heads where the rules cut one, as its parameters do."""
    from repro_torch.launch.dryrun import cell_memory
    from repro_torch.models import trainable
    from repro_torch.training import init_state

    from repro_torch.configs import SHAPES_BY_NAME

    cfg = get_arch("qwen3")
    m = make_test_mesh(*mesh)
    whole = init_params(cfg, generator=torch.Generator(), dtype=torch.bfloat16, device="meta")
    shard = trainable(tp.shard_params(whole, m))
    state = init_state(shard, cfg, m)
    held = sum(t.nbytes for t in list(state.m.values()) + list(state.v.values()))
    rules = cell_memory(cfg, SHAPES_BY_NAME["train_4k"], m)["opt_bytes"]
    named = named_parameters(shard)
    if mesh == (2, 2):
        assert held == rules
        assert 2 * held == 2 * 4 * sum(p.numel() for p in named.values())  # half of whole
    else:
        assert held >= rules


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lm_tp_train_rehearsal(monkeypatch):
    """chip_smoke's lm_tp_train on the CPU, its rehearsal at the reduced
    config (``tp_train_setup``): four rank processes of tools/tp_phase.py
    --train over gloo, every check as on the card, both planted faults
    caught; the dryrun phase holds the rank's counted work against its hand
    count."""
    import argparse

    cs = _smoke()
    lines, failed = [], []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(cs, "fail", lambda msg, **kw: failed.append(msg))
    cs.lm_tp_train(argparse.Namespace(seed=0), torch.device("cpu"))
    out, = lines
    checks = out["checks"]
    assert failed == [] and out["ok"] and out["transport"] == "gloo"
    assert checks["one_rank_f32"]["clip_acts"] and checks["one_rank_f32"]["limit"] == 1e-4
    assert all(checks[k]["ok"] for k in ("one_rank_f32", "bitwise", "collectives", "moments",
                                         "bf16_steps"))
    assert all(f["caught"] for f in checks["faults"].values())
    assert checks["collectives"]["measured"]["backward"][0] == 2 * 2 + 1
    assert set(out["lm_tp_train_launches"].values()) == {0}
    r = cs.READINGS["lm_tp_train"]
    (hand, conv), = cs.dryrun_hand("lm_tp_train", r).values()
    assert cs._work_check(cs.dryrun_tp_train(r)["step"], hand, conv)["ok"]
