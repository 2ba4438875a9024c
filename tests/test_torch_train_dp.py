"""Data-parallel training on a gloo mesh of CPU ranks (the reference's
``data`` mesh axis, tests/test_distributed.py:91,119): each rank steps on
its slice of the global batch, its loss weighted by its share of the
labels that are not -1 (the reference's whole-batch mean), the gradients
summed over the ranks in rank order before AdamW, and every rank ends with
the same parameters, bitwise.  Worlds 1 and 2 as ``sys.executable -c`` rank
processes (tests/test_torch_mesh.py's harness), never importing jax or
repro; the one-process step here is the reference: the loss and the
updated parameters to 1e-5 (float32 sums over half the rows, then added).
``error_feedback_allreduce`` at world 2: one call, bitwise the codes
summed and the scales averaged here, each rank's residual what its own
codes lost.  (The mean code times the mean scale is the reference's
decompression; where the ranks' block scales differ it is not their mean
gradient, and the residual, local by construction, does not carry that
difference: tests/test_torch_train.py holds the unbiased carry at world 1,
as tests/test_training.py does.)
"""
import textwrap

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import init_params, trainable
from repro_torch.training import (adamw_init, compress_int8, decompress_int8, make_train_step,
                                  named_parameters)
from test_torch_mesh import ROOT, _finish, _start

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs
WORLDS = (1, 2)
B, S = 4, 32

RANK = textwrap.dedent(r'''
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, rdv, out, src = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
    sys.path.insert(0, src)
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import data_mesh
    from repro_torch.training import (adamw_init, error_feedback_allreduce, make_train_step,
                                      named_parameters)

    mesh = data_mesh(world, rank, "file://" + rdv, device="cpu")
    cfg = get_arch("qwen3").reduced()
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    per = B // world
    mine = torch.from_numpy(tok[rank * per:(rank + 1) * per])
    model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    named = named_parameters(model)
    step = make_train_step(cfg, lr_fn=1e-3, mesh=mesh)
    _, opt, m = step(model, adamw_init(named), {"tokens": mine, "labels": mine})
    res = {"loss": m["loss"].numpy(), "ce": m["ce"].numpy(), "step": opt.step.numpy()}
    res.update({"p/" + k: p.detach().numpy() for k, p in named.items()})
    res.update({"m/" + k: v.numpy() for k, v in opt.m.items()})
    g = {"w": torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(700)
                               .astype(np.float32))}
    red, r = error_feedback_allreduce(g, {"w": torch.zeros(700)})
    res["ef_reduced"], res["ef_residual"] = red["w"].numpy(), r["w"].numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
''')


def _one_process():
    cfg = get_arch("qwen3").reduced()
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    named = named_parameters(model)
    _, opt, m = make_train_step(cfg, lr_fn=1e-3)(model, adamw_init(named),
                                                  {"tokens": tok, "labels": tok})
    return float(m["loss"]), {k: p.detach().numpy() for k, p in named.items()}


def test_data_parallel_step_equals_one_process(tmp_path):
    code = f"B, S = {B}, {S}\n" + RANK
    started = []
    for w in WORLDS:
        for r in range(w):
            log = tmp_path / f"w{w}_r{r}.log"
            started.append((_start(code, [r, w, tmp_path / f"rdv{w}",
                                          tmp_path / f"w{w}_r{r}.npz", ROOT / "src"], log),
                            log, f"world {w} rank {r}"))
    try:
        loss, params = _one_process()
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    res = {w: [dict(np.load(tmp_path / f"w{w}_r{r}.npz")) for r in range(w)] for w in WORLDS}
    for w in WORLDS:
        first = res[w][0]
        for other in res[w][1:]:  # every rank applies the same update
            for k in first:
                if not k.startswith("ef_"):
                    np.testing.assert_array_equal(other[k], first[k], err_msg=k)
        assert abs(float(first["loss"]) - loss) <= 1e-5 * abs(loss)
        assert int(first["step"]) == 1
        for k, p in params.items():
            np.testing.assert_allclose(first["p/" + k], p, rtol=0, atol=1e-5, err_msg=k)
    # world 1 is the one-process step, bitwise
    for k, p in params.items():
        np.testing.assert_array_equal(res[1][0]["p/" + k], p, err_msg=k)

    # error feedback at world 2: the int32 codes summed, the scales averaged
    targets = [torch.from_numpy(np.random.default_rng(10 + r).standard_normal(700)
                                .astype(np.float32)) for r in range(2)]
    packed = [compress_int8(t) for t in targets]
    codes = sum(c.to(torch.int32) for c, _ in packed)
    scale = (packed[0][1] + packed[1][1]) / 2
    want = decompress_int8(codes.float() / 2, scale, (700,)).numpy()
    for r, rank in enumerate(res[2]):
        np.testing.assert_array_equal(rank["ef_reduced"], want)
        own = decompress_int8(*packed[r], (700,)).numpy()
        np.testing.assert_array_equal(rank["ef_residual"], targets[r].numpy() - own)


# Rows whose labels hold different counts of -1 on the two ranks, against
# the reference's one-device step; and with every label valid, the step
# against the mean of the ranks' own-mean gradients (what the step took
# before it weighted by label counts), bitwise.  At a learning rate of
# 1e-3 one entry of 8,192 moved 1.5e-5 from the reference's: Adam's first
# update g / (|g| + eps) turns the rounding of a near-zero gradient into a
# step of up to lr (tests/test_torch_tp_train.py), so 1e-4.
LABELS_LR = 1e-4
RANK_LABELS = textwrap.dedent(r'''
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, rdv, out, params, src = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7]
    sys.path.insert(0, src)
    import copy
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.models import params_from_numpy, trainable
    from repro_torch.parallel import data_mesh, psum_tree
    from repro_torch.training import (accumulate_grads, adamw_init, adamw_update,
                                      make_train_step, named_parameters)

    mesh = data_mesh(world, rank, "file://" + rdv, device="cpu")
    cfg = get_arch("qwen3").reduced()
    flat = dict(np.load(params))
    tree = {}
    for key, a in flat.items():
        if key.startswith("p/"):
            *path, leaf = key[2:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    per = B // world
    rows = slice(rank * per, (rank + 1) * per)
    tok = torch.from_numpy(flat["tokens"][rows]).long()
    res = {}
    for name, labels in (("unequal", torch.from_numpy(flat["labels"][rows]).long()),
                         ("valid", tok)):
        model = trainable(params_from_numpy(tree, cfg, device="cpu"))
        named = named_parameters(model)
        before = copy.deepcopy(model)
        _, opt, m = make_train_step(cfg, lr_fn=LR, mesh=mesh)(
            model, adamw_init(named), {"tokens": tok, "labels": labels})
        res[name + "/loss"] = m["loss"].numpy()
        res.update({f"{name}/p/{k}": p.detach().numpy() for k, p in named.items()})
        # the unweighted mean of the ranks' own-mean gradients and losses
        loss, _, grads = accumulate_grads(before, {"tokens": tok, "labels": labels}, cfg)
        mean = psum_tree({"grads": grads, "loss": loss}, mesh)
        grads = {k: g / world for k, g in mean["grads"].items()}
        old = named_parameters(before)
        adamw_update(grads, adamw_init(old), old, lr=LR)
        res[name + "/old_loss"] = (mean["loss"] / world).numpy()
        res.update({f"{name}/old/{k}": p.detach().numpy() for k, p in old.items()})
    # two microbatches: the rank's i-th row lies in the reference's i-th
    # microbatch of the whole batch only on rank 0
    model = trainable(params_from_numpy(tree, cfg, device="cpu"))
    named = named_parameters(model)
    _, opt, m = make_train_step(cfg, lr_fn=LR, mesh=mesh, accum=2)(
        model, adamw_init(named), {"tokens": tok,
                                   "labels": torch.from_numpy(flat["labels"][rows]).long()})
    res["accum2/loss"] = m["loss"].numpy()
    res.update({f"accum2/p/{k}": p.detach().numpy() for k, p in named.items()})
    np.savez(out, **res)
    dist.destroy_process_group()
''')


def test_label_counts_weight_the_ranks(tmp_path):
    """World 2, the two ranks' rows holding 6 and 13 labels of -1: the
    step is the reference's one-device step on the whole batch (loss and
    params to 1e-5), where the unweighted mean of the ranks' means is not;
    with every label valid it is that mean, bitwise.  At two microbatches
    (the reference's: the whole batch's first and second halves, each
    with its own label count) the same, against the reference's step at
    accum 2."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.models import init_params as jinit
    from repro.training.optimizer import adamw_init as jadamw_init
    from repro.training.train_step import make_train_step as jmake_train_step

    world = 2
    jcfg = jget_arch("qwen3").reduced()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = tok.copy()
    labels[0, 4:10] = -1  # rank 0: 6
    labels[2, 10:20] = -1  # rank 1: 13
    labels[3, 25:28] = -1
    flat = {"tokens": tok, "labels": labels}
    stack = [("p", tree)]
    while stack:
        prefix, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, dict):
                stack.append((f"{prefix}/{k}", v))
            else:
                flat[f"{prefix}/{k}"] = v
    np.savez(tmp_path / "in.npz", **flat)
    code = f"B, S, LR = {B}, {S}, {LABELS_LR}\n" + RANK_LABELS
    started = [(_start(code, [r, world, tmp_path / "rdv", tmp_path / f"r{r}.npz",
                              tmp_path / "in.npz", ROOT / "src"], tmp_path / f"r{r}.log"),
                tmp_path / f"r{r}.log", f"rank {r}") for r in range(world)]
    try:
        step = jax.jit(jmake_train_step(jcfg, lr_fn=LABELS_LR))
        params, _, m = step(tree, jadamw_init(tree), {"tokens": jnp.asarray(tok),
                                                      "labels": jnp.asarray(labels)})
        loss = float(m["loss"])
        want = params_to_named(params)
        step2 = jax.jit(jmake_train_step(jcfg, lr_fn=LABELS_LR, accum=2))
        params2, _, m2 = step2(tree, jadamw_init(tree), {"tokens": jnp.asarray(tok),
                                                         "labels": jnp.asarray(labels)})
        loss2 = float(m2["loss"])
        want2 = params_to_named(params2)
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    res = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(world)]
    for r in res:
        assert abs(float(r["unequal/loss"]) - loss) <= 1e-5 * abs(loss)
        assert abs(float(r["unequal/old_loss"]) - loss) > 1e-3 * abs(loss)  # the fault repaired
        for k, p in want.items():
            np.testing.assert_allclose(r["unequal/p/" + k], p, rtol=0, atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(r["unequal/p/" + k], res[0]["unequal/p/" + k])
            np.testing.assert_array_equal(r["valid/p/" + k], r["valid/old/" + k], err_msg=k)
            np.testing.assert_allclose(r["accum2/p/" + k], want2[k], rtol=0, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_array_equal(r["accum2/p/" + k], res[0]["accum2/p/" + k])
        assert r["valid/loss"].tobytes() == r["valid/old_loss"].tobytes()
        assert abs(float(r["accum2/loss"]) - loss2) <= 1e-5 * abs(loss2)
    assert abs(loss2 - loss) > 1e-3 * abs(loss)  # the microbatch means weigh otherwise


def params_to_named(tree):
    """The reference's params as the port's named parameters (numpy)."""
    cfg = get_arch("qwen3").reduced()
    from repro_torch.models import params_from_numpy

    model = params_from_numpy(jax_tree_to_numpy(tree), cfg, device="cpu")
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)

