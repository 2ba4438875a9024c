"""The port's int8 weight serving held against `repro.serving.quant`.

Codes and scales are compared bitwise (both round half to even), on float32
and bfloat16 numpy weights and on a reduced h2o-danube carried across with
``params_from_numpy`` (widened so that some leaves reach the 65,536
elements of the rule, counted on the stacked (L, ...) leaves).  Generation
follows tests/test_torch_lm.py: float32 weights on the CPU, tokens equal
to the reference engine's, logits within 1e-4 of max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit
from repro.serving import quant as jq
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.core.mapreduce import tree_leaves
from repro_torch.models import params_from_numpy, params_from_tree, params_to_numpy, params_to_tree
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

WIDE = dict(d_model=256, d_ff=512, vocab=1024)  # embed 262,144, mlp (2, 256, 512)
PROMPT, NEW = 40, 8


def _torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _weights(shape, dtype, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # a column of zeros: its scale is 1
    return w.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(512, 256), (3, 64, 48), (2, 1, 9), (300, 5)])
def test_codes_and_scales_are_bitwise(shape, dtype):
    w = _weights(shape, dtype, seed=len(shape))
    want = jq.quantize_leaf(jnp.asarray(w))
    got = tq.quantize_leaf(_torch(w))
    assert got.codes.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.nbytes == want.nbytes and tuple(got.shape) == want.shape
    for out in (jnp.float32, jnp.bfloat16):
        back = tq.dequantize_leaf(got, torch.float32 if out == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jq.dequantize_leaf(want, out), np.float32))


def test_round_half_to_even_at_the_ties():
    """Entries at k + 1/2 steps of the scale round to the even code."""
    w = np.zeros((2, 6), np.float32)
    w[0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    w[1] = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    w = np.concatenate([w, np.zeros((1, 6), np.float32)]).T.copy()  # axis -2 carries the max
    got, want = tq.quantize_leaf(torch.from_numpy(w)), jq.quantize_leaf(jnp.asarray(w))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.codes[:, 0].tolist() == [127, 0, 2, 2, 0, -2]


def _cfgs():
    jcfg = dataclasses.replace(jget_arch("danube").reduced(), **WIDE)
    cfg = dataclasses.replace(get_arch("danube").reduced(), **WIDE)
    return jcfg, cfg


@pytest.fixture(scope="module")
def wide_danube():
    jcfg, cfg = _cfgs()
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, model


def _pairs(jtree, ttree):
    """(path, reference leaf, port leaf) over both trees, QuantTensors kept whole."""
    jl = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, jq.QuantTensor))[0]
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(jl, tl)]


def test_model_leaves_quantize_as_the_reference_does(wide_danube):
    _, _, params, model = wide_danube
    want = jq.quantize_tree(params)
    got = tq.quantize_tree(params_to_tree(model))
    quantized = []
    for path, a, b in _pairs(want, got):
        assert isinstance(a, jq.QuantTensor) == isinstance(b, tq.QuantTensor), path
        if isinstance(a, jq.QuantTensor):
            quantized.append(path)
            np.testing.assert_array_equal(b.codes.numpy(), np.asarray(a.codes))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert any("embed" in p for p in quantized) and any("w_gate" in p for p in quantized)
    assert not any("norm" in p for p in quantized)  # (2, 256): below the rule
    assert tq.tree_param_bytes(got) == jq.tree_param_bytes(want)
    assert tq.tree_param_bytes(params_to_tree(model)) == jq.tree_param_bytes(params)


def test_a_stacked_norm_at_the_rule_is_quantized_over_the_layer_axis():
    """(16, 4,096) = 65,536 elements stacked over 16 layers: eligible, its
    scale the max over the layer axis (axis -2), as in the reference; one
    layer's (4,096,) slice alone would stay in full precision."""
    rng = np.random.default_rng(3)
    tree = {"layers": {"attn_norm": (1 + 0.1 * rng.standard_normal((16, 4096))).astype(np.float32),
                       "small": rng.standard_normal((16, 4095)).astype(np.float32)},
            "final_norm": rng.standard_normal(65536).astype(np.float32)}
    want = jq.quantize_tree(jax.tree.map(jnp.asarray, tree))
    got = tq.quantize_tree({"layers": {k: torch.from_numpy(v) for k, v in tree["layers"].items()},
                            "final_norm": torch.from_numpy(tree["final_norm"])})
    q = got["layers"]["attn_norm"]
    assert isinstance(q, tq.QuantTensor) and q.scale.shape == (1, 4096)
    assert not isinstance(got["layers"]["small"], tq.QuantTensor)
    assert not isinstance(got["final_norm"], tq.QuantTensor)  # 1-D
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(want["layers"]["attn_norm"].codes))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(want["layers"]["attn_norm"].scale))
    assert tq.tree_param_bytes(got) == jq.tree_param_bytes(want)
    back = tq.dequantize_tree(got, torch.float32)
    np.testing.assert_array_equal(
        back["layers"]["attn_norm"].numpy(),
        np.asarray(jq.dequantize_tree(want, jnp.float32)["layers"]["attn_norm"]))


def test_params_tree_round_trip(wide_danube):
    _, cfg, params, model = wide_danube
    tree = params_to_tree(model)
    again = params_to_tree(params_from_tree(tree, cfg))
    for a, b in zip(tree_leaves(tree), tree_leaves(again)):
        assert torch.equal(a, b)
    for path, a, b in _pairs(params, params_to_numpy(model)):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_quantized_engine_tokens_equal_the_reference(wide_danube):
    """``ServeEngine(quantize=True)`` on both packages, float32: tokens
    equal, every step's logits (the reference's recomputed on its tokens
    over its dequantized weights) within 1e-4 of max|logit|; the engine
    holds int8 codes, and its model is the plain engine's over
    dequantize_tree(quantize_tree(params))."""
    jcfg, cfg, params, model = wide_danube
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW, quantize=True)
    want = jeng.generate(jnp.asarray(prompts), NEW).tokens
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, quantize=True, device="cpu")
    assert eng.params["embed"].codes.dtype == torch.int8
    got = eng.generate(prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    logits, cache = jeng._prefill(jeng.params, {"tokens": jnp.asarray(prompts)})
    cache = jeng._grow_cache(cache, 2)
    steps = [logits]
    for i in range(1, NEW):
        logits, cache = jeng._decode(jeng.params, cache, jnp.asarray(want[:, i - 1]),
                                     jnp.asarray(PROMPT + i - 1, jnp.int32))
        steps.append(logits)
    jl = np.stack([np.asarray(s) for s in steps], 1)
    assert float(np.abs(got.logits.numpy() - jl).max() / np.abs(jl).max()) <= 1e-4
    deq = params_from_tree(tq.dequantize_tree(tq.quantize_tree(params_to_tree(model)),
                                              torch.float32), cfg)
    plain = ServeEngine(cfg, deq, max_len=PROMPT + NEW, device="cpu").generate(
        prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(plain.tokens, got.tokens)
    assert torch.equal(plain.logits, got.logits)
    assert tq.tree_param_bytes(eng.params) < 0.6 * tq.tree_param_bytes(params_to_tree(model))


def test_bf16_engine_dequantizes_to_its_dtype():
    cfg = dataclasses.replace(get_arch("danube").reduced(), **WIDE)
    from repro_torch.models import init_params

    model = init_params(cfg, seed=2, dtype=torch.bfloat16, device="cpu")
    eng = ServeEngine(cfg, model, max_len=24, dtype=torch.bfloat16, quantize=True, device="cpu")
    m = eng.model()
    assert m.embed.dtype == torch.bfloat16 and m.layers[0].mlp.w_gate.dtype == torch.bfloat16
    out = eng.generate(np.zeros((1, 16), np.int32), 4)
    assert out.tokens.shape == (1, 4)
