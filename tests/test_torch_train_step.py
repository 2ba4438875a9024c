"""One train step of the port against the reference's ``make_train_step``
and ``jax.value_and_grad``, family by family: dense (qwen3, the fused and
the unfused loss), mixture of experts (llama4), multi-head latent
attention (deepseek-v2), here; the hybrid, the xLSTM, the encoder-decoder
and the VLM in tests/test_torch_train_families.py.

Reduced configs in float32 on the CPU, the reference's params carried
across (``params_from_numpy``), the same seeded batch, accum 1 and 2, a
constant learning rate of 1e-3.  Held: the loss to 1e-5 relative; each
gradient leaf, and the updated ``m`` and ``v``, to 1e-4 of the leaf's max
|x| (float32 products of a few hundred terms in another order land near
1e-6); the parameters' update where |g| exceeds 1e-3 of the leaf's max |g|
to 1e-4 of the leaf's largest update.  AdamW's first step is lr sign(g)
plus decay, so where |g| is near 0 two right implementations can step
opposite ways: those entries are counted, not held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.training import optimizer as jopt, train_step as jts
from repro_torch.models import params_to_numpy
from repro_torch.training import (accumulate_grads, adamw_init, make_train_step,
                                  named_parameters)
from torch_train_ref import (LR, as_ref_tree, batch, configs, flat, leaf_errors, port_model,
                             ref_params, to_jax, to_torch)

LOSS_TOL, LEAF_TOL, G_FLOOR = 1e-5, 1e-4, 1e-3
EPS32 = float(np.finfo(np.float32).eps)


def _ref_grads(jcfg, params, b, accum, fused):
    """The reference's gradients: of the batch's loss, or at accum > 1 the
    float32 mean of each microbatch's (as its step accumulates them)."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, mb: jts.loss_fn(p, mb, jcfg, fused=fused)[0]))
    if accum == 1:
        return vg(params, b)[1]
    per = next(iter(b.values())).shape[0] // accum
    grads = [vg(params, {k: v[i * per:(i + 1) * per] for k, v in b.items()})[1]
             for i in range(accum)]
    return jax.tree.map(lambda *gs: sum(gs[1:], gs[0]) / accum, *grads)


def check_one_step(family, accum, fused=False):
    """Run one step in both packages and hold loss, gradients, moments and
    the update; returns how many entries of the update were not held."""
    jcfg, cfg = configs(family)
    tree = ref_params(jcfg)
    b = batch(cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jts.make_train_step(jcfg, lr_fn=LR, accum=accum, fused_loss=fused))
    jp2, jst, jm = jstep(jp, jopt.adamw_init(jp), to_jax(b))
    jgrads = _ref_grads(jcfg, jp, to_jax(b), accum, fused)

    model = port_model(tree, cfg)
    loss, metrics, grads = accumulate_grads(model, to_torch(b), cfg, accum=accum,
                                            fused_loss=fused)
    step = make_train_step(cfg, lr_fn=LR, accum=accum, fused_loss=fused)
    _, st, m = step(model, adamw_init(named_parameters(model)), to_torch(b))

    want = float(jm["loss"])
    assert abs(float(loss) - want) <= LOSS_TOL * abs(want)
    assert abs(float(m["loss"]) - want) <= LOSS_TOL * abs(want)
    for name in ("ce", "lb_loss", "z_loss"):
        assert abs(float(m[name]) - float(jm[name])) <= LOSS_TOL * max(abs(float(jm[name])), 1)
    assert float(m["lr"]) == pytest.approx(LR, rel=1e-7) and int(st.step) == 1

    for label, got, ref in (("grad", as_ref_tree(model, grads), jgrads),
                            ("m", as_ref_tree(model, st.m), jst.m),
                            ("v", as_ref_tree(model, st.v), jst.v)):
        errs = leaf_errors(got, jax.tree.map(np.asarray, ref))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LEAF_TOL, (label, worst, errs[worst])

    g, p0 = flat(jax.tree.map(np.asarray, jgrads)), flat(tree)
    p_port, p_ref = flat(params_to_numpy(model)), flat(jax.tree.map(np.asarray, jp2))
    unheld, total = 0, 0
    for k in p0:
        held = np.abs(g[k]) > G_FLOOR * np.abs(g[k]).max()
        scale = np.abs(p_ref[k] - p0[k]).max()
        # the update to 1e-4 of the leaf's largest, plus the one rounding of
        # the new parameter (an ulp of 1.0 is 1e-4 of a 1e-3 update)
        tol = LEAF_TOL * scale + EPS32 * np.abs(p_ref[k])
        bad = (np.abs(p_port[k] - p_ref[k]) > tol) & held
        assert not bad.any(), (k, np.abs(p_port[k] - p_ref[k])[bad].max(), scale)
        unheld += int((~held).sum())
        total += held.size
    return unheld, total


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dense_step_matches_reference(accum, fused):
    unheld, total = check_one_step("dense", accum, fused)
    assert unheld < 0.25 * total  # mostly embedding rows the batch never reads


@pytest.mark.parametrize("family", ["moe", "mla"])
@pytest.mark.parametrize("accum", [1, 2])
def test_moe_and_mla_steps_match_reference(family, accum):
    unheld, total = check_one_step(family, accum)
    assert unheld < 0.25 * total
