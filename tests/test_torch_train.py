"""The port's training substrate against the reference's
(tests/test_training.py, tests/test_checkpoint_fault.py:238 and
tests/test_system.py:40 ported): AdamW's first step, clipping, the cosine
schedule and the global norm; the two cross-entropies and remat; the
token pipeline, bitwise the reference's; accumulation equal to the full
batch; loss descent; int8 compression and error feedback; restart
determinism; the train command line killed and resumed.  Reduced configs in
float32 on the CPU.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import SyntheticTokenPipeline as RefPipeline
from repro.models import layers as jlayers
from repro.training import compression as jcomp, optimizer as jopt
from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree
from repro_torch.configs import get_arch
from repro_torch.data.tokens import SyntheticTokenPipeline
from repro_torch.models import init_params, layers, train_forward, trainable
from repro_torch.training import (adamw_init, adamw_update, compress_int8, cosine_schedule,
                                  decompress_int8, error_feedback_allreduce, global_norm,
                                  make_train_step, named_parameters)
from repro_torch.training.train_step import accumulate_grads
from torch_train_ref import to_torch

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs


def _np(t):
    return t.detach().numpy()


# -------------------------------------------------------------- optimizer --
def test_adamw_first_step_is_lr_signed():
    """With bias correction, |dp| of step 1 is lr sign(g) (wd = 0); the
    reference's update on the same numbers agrees."""
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, -0.2, 0.3])}
    before = p["w"].clone()
    new_p, st = adamw_update(g, adamw_init(p), p, lr=0.01, weight_decay=0.0, clip_norm=None)
    np.testing.assert_allclose(np.abs(_np(before - new_p["w"])), 0.01, rtol=1e-3)
    want, _ = jopt.adamw_update({"w": jnp.asarray(g["w"].numpy())},
                                jopt.adamw_init({"w": jnp.asarray(before.numpy())}),
                                {"w": jnp.asarray(before.numpy())}, lr=0.01,
                                weight_decay=0.0, clip_norm=None)
    np.testing.assert_allclose(_np(new_p["w"]), np.asarray(want["w"]), rtol=0, atol=1e-7)
    assert int(st.step) == 1 and st.step.dtype == torch.int32


def test_adamw_keeps_param_dtype_and_float32_moments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32
    new_p, st2 = adamw_update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, st, p,
                              lr=0.1)
    assert new_p["w"].dtype == torch.bfloat16 and st2.m["w"].dtype == torch.float32
    assert torch.equal(st.m["w"], torch.zeros(4))  # the old state is left as it was


def test_grad_clipping():
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, st2 = adamw_update(g, adamw_init(p), p, lr=0.0, clip_norm=1.0)
    assert float(global_norm(st2.m)) <= 0.11  # (1 - b1) times the clipped norm 1


def test_global_norm_and_cosine_schedule_match_reference():
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in
            (("a", (3, 5)), ("b", (7,)), ("c", (2, 2, 2)))}
    got = float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    assert got == pytest.approx(float(jopt.global_norm(tree)), rel=1e-6)
    lr, ref = cosine_schedule(1e-3, warmup=10, total=110), jopt.cosine_schedule(1e-3, 10, 110)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-5)
    assert float(lr(torch.tensor(110))) == pytest.approx(0.0, abs=1e-9)
    for step in (0, 1, 5, 9, 10, 11, 50, 109, 110, 200):
        assert float(lr(torch.tensor(step, dtype=torch.int32))) == pytest.approx(
            float(ref(jnp.asarray(step, jnp.int32))), rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------- losses --
@pytest.mark.parametrize("chunk", [16, 7])
def test_cross_entropies_and_gradients_match_reference(chunk):
    """Both losses with ignored labels (-1), against the reference's: the
    value to 1e-6 relative, the gradients to 1e-5 of their max; the fused
    one (a chunk that does not divide S) equals the unfused one."""
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 20, 8)).astype(np.float32)
    head = rng.standard_normal((8, 33)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 20)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -1] = -1
    h, w = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(head).requires_grad_()
    lab = torch.from_numpy(labels)
    fused = layers.chunked_cross_entropy(h, w, lab, chunk=chunk)
    plain = layers.cross_entropy_loss(h @ w, lab)
    gf = torch.autograd.grad(fused, (h, w))
    gp = torch.autograd.grad(plain, (h, w))

    def ref(hh, ww):
        return jlayers.chunked_cross_entropy(hh, ww, jnp.asarray(labels), chunk=chunk)
    want, (jh, jw) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(hidden),
                                                             jnp.asarray(head))
    want_plain = jlayers.cross_entropy_loss(jnp.asarray(hidden) @ jnp.asarray(head),
                                            jnp.asarray(labels))
    fused, plain = fused.item(), plain.item()
    assert fused == pytest.approx(float(want), rel=1e-6)
    assert plain == pytest.approx(float(want_plain), rel=1e-6)
    assert fused == pytest.approx(plain, rel=1e-6)
    for got, ref_g in zip(gf, (jh, jw)):
        np.testing.assert_allclose(_np(got), np.asarray(ref_g), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(ref_g)).max()))
    for a, b in zip(gf, gp):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5 * float(b.abs().max()))


def test_remat_policies_give_the_same_gradients():
    """No remat, "full" and "dots" recompute the same operations: the
    gradients are bitwise equal; an unknown policy raises."""
    cfg = get_arch("qwen3").reduced()
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int64))
    grads = {}
    for policy in (None, "full", "dots"):
        model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
        c = cfg if policy is None else dataclasses.replace(cfg, remat_policy=policy)
        logits, _ = train_forward(model, {"tokens": tok}, c, remat=policy is not None)
        loss = layers.cross_entropy_loss(logits[:, :-1], tok[:, 1:])
        grads[policy] = torch.autograd.grad(loss, list(named_parameters(model).values()))
    for policy in ("full", "dots"):
        for a, b in zip(grads[None], grads[policy]):
            assert torch.equal(a, b), policy
    with pytest.raises(ValueError, match="remat policy"):
        layers.remat(lambda x: x, torch.zeros(1), policy="selective")


# -------------------------------------------------------------- pipeline --
@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 16, 4, 7), (512, 40, 3, 1),
                                                  (4096, 64, 2, 0)])
def test_pipeline_determinism_and_reference_tokens(vocab, seq, batch, seed):
    p1 = SyntheticTokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    p2 = SyntheticTokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref = RefPipeline(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    b1, b2 = p1.host_batch(42), p2.host_batch(42)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.host_batch(43)["tokens"], b1["tokens"])
    for step in (0, 42, 1000):
        got, want = p1.host_batch(step), ref.host_batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------- the step --
def test_microbatch_accumulation_matches_full_batch():
    cfg = get_arch("qwen3").reduced()
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)))
    batch = {"tokens": tok, "labels": tok}
    out = {}
    for accum in (1, 2):
        model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
        _, _, m = make_train_step(cfg, lr_fn=1e-3, accum=accum)(
            model, adamw_init(named_parameters(model)), batch)
        out[accum] = (float(m["loss"]), {k: p.detach().clone()
                                         for k, p in named_parameters(model).items()})
    assert out[1][0] == pytest.approx(out[2][0], rel=1e-4)
    assert max(float((a - out[2][1][k]).abs().max()) for k, a in out[1][1].items()) < 1e-4


def test_accumulation_sums_in_float32():
    """bf16 parameters: autograd's gradients are bf16, their accumulation
    buffers float32."""
    cfg = get_arch("qwen3").reduced()
    model = trainable(init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu"))
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (4, 16)))
    _, m1, g1 = accumulate_grads(model, {"tokens": tok, "labels": tok}, cfg, accum=1)
    _, m2, g2 = accumulate_grads(model, {"tokens": tok, "labels": tok}, cfg, accum=2)
    assert all(g.dtype == torch.bfloat16 for g in g1.values())
    assert all(g.dtype == torch.float32 for g in g2.values())
    assert float(m2["lb_loss"]) == 0.0 and float(m2["z_loss"]) == 0.0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-125m"])
def test_loss_decreases(arch):
    cfg = get_arch(arch).reduced()
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1)
    model = trainable(init_params(cfg, seed=2, dtype=torch.float32, device="cpu"))
    opt = adamw_init(named_parameters(model))
    step = make_train_step(cfg, lr_fn=3e-3)
    losses = []
    for i in range(30):
        model, opt, m = step(model, opt, to_torch(pipe.host_batch(i)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_restart_is_bitwise_the_unbroken_run(tmp_path):
    """Four steps on the pipeline's batches; the state after step 1 saved by
    the CheckpointManager, restored into a model of another seed, and steps
    2-3 run again: the losses, parameters, m and v equal the unbroken
    run's bitwise (the pipeline regenerates the batches by step); the
    optimizer's step restored as 0 is caught."""
    cfg = get_arch("qwen3").reduced()
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3)
    step_fn = make_train_step(cfg, lr_fn=cosine_schedule(3e-3, warmup=1, total=10))

    def run(model, opt, steps):
        losses = []
        for s in steps:
            model, opt, m = step_fn(model, opt, to_torch(pipe.host_batch(s)))
            losses.append(float(m["loss"]))
        return opt, losses

    model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    named = named_parameters(model)
    mgr = CheckpointManager(str(tmp_path))
    opt, head = run(model, adamw_init(named), [0, 1])
    mgr.save({"params": {k: p.detach().clone() for k, p in named.items()}, "opt": opt}, 1)
    mgr.close()
    opt, tail = run(model, opt, [2, 3])

    def restored(step_as_zero=False):
        fresh = trainable(init_params(cfg, seed=9, dtype=torch.float32, device="cpu"))
        fn = named_parameters(fresh)
        state = restore_pytree({"params": {k: p.detach() for k, p in fn.items()},
                                "opt": adamw_init(fn)}, str(tmp_path), 1)
        with torch.no_grad():
            for k, p in fn.items():
                p.copy_(state["params"][k])
        o = state["opt"]
        if step_as_zero:
            o = o._replace(step=torch.zeros_like(o.step))
        return fresh, o

    fresh, o = restored()
    o2, tail2 = run(fresh, o, [2, 3])
    assert tail2 == tail
    for k, p in named_parameters(fresh).items():
        assert torch.equal(p, named[k]) and torch.equal(o2.m[k], opt.m[k])
        assert torch.equal(o2.v[k], opt.v[k])
    fresh, o = restored(step_as_zero=True)
    _, bad = run(fresh, o, [2, 3])
    assert bad != tail


def test_train_cli_killed_and_resumed(tmp_path, monkeypatch):
    """launch.train's main() on the CPU: a run that dies after step 24
    resumes from its step-19 checkpoint and ends where an unbroken run
    ends, to the bit; the loss descends."""
    from repro_torch.launch import train

    args = ["--arch", "qwen3", "--reduced", "--steps", "35", "--batch", "4", "--seq", "32",
            "--ckpt-every", "10", "--f32", "--lr", "3e-3", "--device", "cpu"]
    whole = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert np.isfinite(whole)

    real = SyntheticTokenPipeline.host_batch

    def dies_at_25(self, step):
        if step == 25:
            raise KeyboardInterrupt("killed")
        return real(self, step)

    monkeypatch.setattr(SyntheticTokenPipeline, "host_batch", dies_at_25)
    with pytest.raises(KeyboardInterrupt):
        train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.setattr(SyntheticTokenPipeline, "host_batch", real)
    steps = sorted(n for n in os.listdir(tmp_path / "b") if n.startswith("step_"))
    assert steps[-1] == "step_0000000019"
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed == whole


# ------------------------------------------------------------ compression --
def test_int8_roundtrip_error_bound_and_reference_codes():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(1000).astype(np.float32) * 3)
    codes, scale = compress_int8(x)
    back = decompress_int8(codes, scale, x.shape)
    err = (back - x).abs().numpy()
    step = np.repeat(scale.numpy().reshape(-1), 256)[: x.numel()]
    assert (err <= step * 0.5 + 1e-7).all()
    jcodes, jscale = jcomp.compress_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    zero_codes, zero_scale = compress_int8(torch.zeros(300))
    assert torch.equal(zero_scale, torch.ones(2, 1)) and not zero_codes.any()


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rdv"),
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_error_feedback_allreduce_unbiased_over_steps(world1):
    """The compressed mean plus the residual carried tracks the exact sum
    over ten steps (world 1, gloo)."""
    r = {"w": torch.zeros(512)}
    acc_exact, acc_comp = torch.zeros(512), torch.zeros(512)
    for i in range(10):
        g = {"w": torch.from_numpy(np.random.default_rng(10 + i).standard_normal(512)
                                   .astype(np.float32))}
        red, r = error_feedback_allreduce(g, r)
        acc_exact += g["w"]
        acc_comp += red["w"]
    rel = float(torch.linalg.norm(acc_comp + r["w"] - acc_exact) / torch.linalg.norm(acc_exact))
    assert rel < 1e-5  # at world 1 the carry makes the sum exact up to rounding


# ----------------------------------------------------------- launch.steps --
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b", "zamba2-7b", "xlstm-125m",
                                  "whisper-base", "llava-next-34b"])
def test_cells_match_the_reference(arch, monkeypatch):
    """Each kind's inputs (shapes, integer or float) against the
    reference's ``input_specs``, and a decode cache's logical axes against
    its ``_CACHE_RULES`` (its spec resolver replaced by one that returns
    the axes: no mesh here); the sequence-parallel decision; a train cell's
    step runs."""
    from repro.configs import get_arch as jget_arch
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import steps as jsteps
    from repro.models import input_specs as jinput_specs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps

    monkeypatch.setattr(jsteps.shr, "logical_to_spec", lambda axes, shape, mesh: tuple(axes))
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    for name, seq, batch, kind in (("t", 24, 2, "train"), ("p", 24, 2, "prefill"),
                                   ("d", 24, 2, "decode")):
        want = jinput_specs(jcfg, JShape(name, seq, batch, kind))
        cell = steps.build_cell(cfg, ShapeConfig(name, seq, batch, kind))
        got = cell.inputs
        assert sorted(got) == sorted(want)
        for k in got:
            if k == "cache":
                leaves = jax.tree_util.tree_leaves_with_path(want[k])
                flat_got = {jax.tree_util.keystr(p): s for p, s in
                            jax.tree_util.tree_leaves_with_path(
                                got[k], is_leaf=lambda x: hasattr(x, "dtype"))}
                for p, leaf in leaves:
                    assert tuple(flat_got[jax.tree_util.keystr(p)].shape) == leaf.shape
                axes = jsteps._cache_pspecs(want[k], None)
                assert cell.cache_axes == axes
                continue
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert got[k].dtype.is_floating_point == jnp.issubdtype(want[k].dtype, jnp.floating)
        assert cell.sp_mode is False
    assert steps.use_sequence_parallel(ShapeConfig("s", 8, 3, "train"), 2)
    assert steps.use_sequence_parallel(ShapeConfig("s", 8, 1, "decode"), 2)
    with pytest.raises(ValueError, match="skipped"):
        steps.build_cell(get_arch("qwen3"), "long_500k")
    if cfg.family in ("dense", "ssm"):
        cell = steps.build_cell(cfg, ShapeConfig("t", 16, 2, "train"), accum=2)
        model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
        tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
        _, opt, m = cell.fn(model, adamw_init(named_parameters(model)),
                            {"tokens": tok, "labels": tok})
        assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))
