"""The port's mixture-of-experts family held against the JAX reference.

Reduced llama4-maverick (`ArchConfig.reduced()`: 2 layers, d_model 64, 4
query heads over 1 KV head of 16, 4 experts of width 64, top-1, one shared
expert, capacity factor 4.0: dropless) and two variants: capacity factor
1.0 (tokens dropped), and top-2 over 4 experts with two shared experts at
capacity factor 1.0.  The reference's float32 params are carried across by
``params_from_numpy`` on the CPU.  Routing is held bitwise: the top-k
experts and gates the reference's ``jax.lax.top_k`` returned, and each
(token, choice)'s bucket place, recounted in numpy by the stable-rank rule
from the reference's choices.  Outputs and aux losses within rtol 1e-4 /
atol 1e-5 (float32 products in another order measure about 1e-6);
generation as tests/test_torch_lm.py holds it: tokens equal, logits within
1e-4 of max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import decode_step as jdecode, forward as jforward, init_params as jinit
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.serving import quant as jq
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.core.mapreduce import tree_leaves
from repro_torch.models import (decode_step, forward, init_params, moe as tmoe, params_from_numpy,
                                params_from_tree, params_to_numpy, params_to_tree, prefill)
from repro_torch.models.layers import expert_init
from repro_torch.models.model_zoo import _moe
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

RTOL, ATOL = 1e-4, 1e-5
PROMPT, NEW = 40, 8
VARIANTS = {  # name: MoEConfig fields replaced on the reduced llama4
    "dropless": {},
    "drops": {"capacity_factor": 1.0},
    "top2_shared2": {"top_k": 2, "num_shared": 2, "capacity_factor": 1.0},
}


def _cfgs(variant="dropless", dispatch="gather", **arch):
    over = dict(VARIANTS[variant], dispatch=dispatch)
    out = []
    for get in (jget_arch, get_arch):
        c = get("llama4").reduced()
        out.append(dataclasses.replace(c, moe=dataclasses.replace(c.moe, **over), **arch))
    return out


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


def _stable_rank(expert_idx: np.ndarray) -> np.ndarray:
    """Each (token, choice)'s place in its expert's bucket: how many earlier
    pairs, token-major, chose the same expert."""
    flat = expert_idx.reshape(-1)
    seen, pos = {}, np.empty_like(flat)
    for i, e in enumerate(flat):
        pos[i] = seen.get(e, 0)
        seen[e] = pos[i] + 1
    return pos.reshape(expert_idx.shape)


def _layer(jcfg, seed=0):
    """A reference MoE layer's float32 params and the port's over the same
    numbers."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(lambda a: np.asarray(a)[None], p)
    return p, _moe(tree, 0, lambda a: torch.from_numpy(np.array(a)))


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("variant", ["dropless", "drops", "top2_shared2"])
def test_moe_apply_matches(variant, dispatch, monkeypatch):
    jcfg, cfg = _cfgs(variant, dispatch)
    jp, tp = _layer(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(np.float32)
    routed = []
    top_k = jax.lax.top_k

    def recording_top_k(operand, k):
        out = top_k(operand, k)
        routed.append(tuple(np.asarray(a) for a in out))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, gaux = tmoe.moe_apply(tp, torch.from_numpy(x), cfg)
    (jgates, jidx), = routed
    _, _, gates, idx, pos = tmoe.moe_route(tp, torch.from_numpy(x).reshape(80, 64), cfg)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), _stable_rank(jidx))
    _close(gates, jgates / np.maximum(jgates.sum(-1, keepdims=True), 1e-9))
    capacity = tmoe.moe_capacity(80, cfg)
    dropped = int((pos >= capacity).sum())
    assert (dropped > 0) == (variant != "dropless"), dropped
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    assert set(gaux) == set(waux) == {"lb_loss", "z_loss"}
    for name in gaux:
        _close(gaux[name], waux[name])
    bare, no_aux = tmoe.moe_apply(tp, torch.from_numpy(x), cfg, aux=False)
    assert no_aux is None and torch.equal(bare, got)


def test_capacity_rule_matches_the_reference_formula():
    """moe.py:58: max(int(t k / e cf), min(t k, 4)); a decode batch of 2
    tokens over 128 experts keeps 2."""
    cfg = get_arch("llama4")
    assert tmoe.moe_capacity(32000, cfg) == 312
    assert tmoe.moe_capacity(4, cfg) == 4 and tmoe.moe_capacity(2, cfg) == 2
    _, drops = _cfgs("drops")
    assert tmoe.moe_capacity(80, drops) == 20


def test_bf16_moe_rounds_where_the_reference_rounds():
    """bf16 activations and experts: the router still runs in float32 and
    routes as the reference does; the outputs agree to bf16 rounding."""
    jcfg, cfg = _cfgs("top2_shared2")
    p = jmoe.moe_init(jax.random.PRNGKey(4), jcfg, dtype=jnp.bfloat16)
    tree = jax.tree.map(lambda a: np.asarray(a)[None], p)
    tp = _moe(tree, 0, lambda a: torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
              if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(a)))
    assert tp.router.dtype == torch.float32 and tp.e_gate.dtype == torch.bfloat16
    x = np.random.default_rng(5).standard_normal((2, 16, 64)).astype(np.float32)
    want, _ = jmoe.moe_apply(p, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, _ = tmoe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert float(np.abs(got.float().numpy() - want).max()) <= 2e-2 * np.abs(want).max()


@pytest.fixture(scope="module", params=["dropless", "drops"])
def llama4(request):
    """(variant, reference cfg, port cfg, JAX params, port model, prompts)."""
    jcfg, cfg = _cfgs(request.param)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    return request.param, jcfg, cfg, params, model, prompts


def test_prefill_and_decode_step_match(llama4):
    variant, jcfg, cfg, params, model, prompts = llama4
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    seen = []
    hook = model.layers[0].mlp_norm.register_forward_hook(lambda m, i, out: seen.append(out))
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    hook.remove()
    pos = tmoe.moe_route(model.layers[0].mlp, seen[0].reshape(-1, cfg.d_model), cfg)[-1]
    assert bool((pos >= tmoe.moe_capacity(pos.shape[0], cfg)).any()) == (variant == "drops")
    assert _rel(logits, jlogits) <= RTOL
    assert set(cache) == set(jcache) == {"k", "v", "pos"}
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        assert _rel(cache[name], jcache[name]) <= RTOL, name
    # no window: the caches grow to a capacity of PROMPT + 1 for the step
    jcache = JServeEngine(jcfg, params, max_len=PROMPT + 1)._grow_cache(jcache, 2)
    cache = ServeEngine(cfg, model, max_len=PROMPT + 1, device="cpu")._grow_cache(cache, 2)
    tok = np.asarray([3, 500], np.int32)
    jlogits, jcache = jdecode(params, jcache, {"tokens": jnp.asarray(tok),
                                               "pos": jnp.asarray(PROMPT, jnp.int32)}, jcfg)
    logits, cache = decode_step(model, cache, {"tokens": torch.from_numpy(tok), "pos": PROMPT},
                                cfg)
    assert _rel(logits, jlogits) <= RTOL
    for name in cache:
        assert _rel(cache[name], jcache[name]) <= RTOL, name


def test_generate_matches_jax_engine(llama4):
    """Tokens equal the reference engine's; every step's logits (the
    reference's recomputed on its tokens) within 1e-4 of max|logit|."""
    _, jcfg, cfg, params, model, prompts = llama4
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW)
    want = jeng.generate(jnp.asarray(prompts), NEW).tokens
    got = ServeEngine(cfg, model, max_len=PROMPT + NEW, device="cpu").generate(
        prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    logits, cache = jeng._prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jeng._grow_cache(cache, prompts.shape[0])
    steps = [logits]
    for i in range(1, NEW):
        logits, cache = jeng._decode(params, cache, jnp.asarray(want[:, i - 1]),
                                     jnp.asarray(PROMPT + i - 1, jnp.int32))
        steps.append(logits)
    jlogits = np.stack([np.asarray(s) for s in steps], 1)
    assert _rel(got.logits, jlogits) <= 1e-4


def test_forward_aux_matches(llama4):
    """``forward(return_aux=True)``: logits and the aux losses summed over
    the layers, as the reference's `lm_forward` returns them; the default
    return stays the logits."""
    _, jcfg, cfg, params, model, prompts = llama4
    want, waux = jforward(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    logits, aux = forward(model, {"tokens": torch.from_numpy(prompts)}, cfg, return_aux=True)
    assert _rel(logits, want) <= RTOL
    for name in ("lb_loss", "z_loss"):
        _close(aux[name], waux[name])
    assert torch.equal(forward(model, {"tokens": torch.from_numpy(prompts)}, cfg), logits)


def test_serving_skips_the_aux_losses(llama4):
    """Prefill and decode dispatch none of the aux losses' operators (the
    first choice's scatter-add, the logsumexp); ``return_aux`` does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    _, _, cfg, _, model, prompts = llama4
    tokens = torch.from_numpy(prompts)
    aux_ops = {"index_add_", "index_add", "logsumexp"}
    with Ops() as serving:
        _, cache = prefill(model, {"tokens": tokens}, cfg)
        cache = ServeEngine(cfg, model, max_len=PROMPT + 1, device="cpu")._grow_cache(cache, 2)
        decode_step(model, cache, {"tokens": tokens[:, -1], "pos": PROMPT}, cfg)
    with Ops() as training:
        forward(model, {"tokens": tokens}, cfg, return_aux=True)
    assert "bmm" in serving.names and not serving.names & aux_ops
    assert "logsumexp" in training.names and training.names & {"index_add_", "index_add"}


def test_dense_forward_aux_is_zero():
    cfg = get_arch("danube").reduced()
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    _, aux = forward(model, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, cfg,
                     return_aux=True)
    assert float(aux["lb_loss"]) == 0.0 and float(aux["z_loss"]) == 0.0


@pytest.mark.parametrize("variant,dtype", [("dropless", jnp.float32), ("dropless", jnp.bfloat16),
                                           ("top2_shared2", jnp.bfloat16)])
def test_params_round_trip_bitwise(variant, dtype):
    """The reference's ``layers["moe"]`` leaves -- router (L, d, E) float32,
    e_gate / e_up (L, E, d, f), e_down (L, E, f, d), shared.{w_gate, w_up,
    w_down} -- carried in and back bit for bit."""
    jcfg, cfg = _cfgs(variant)
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
    assert tree["layers"]["moe"]["router"].dtype == np.float32
    model = params_from_numpy(tree, cfg, device="cpu")
    back = params_to_numpy(model)
    flat, tdef = jax.tree_util.tree_flatten(tree)
    flat2, tdef2 = jax.tree_util.tree_flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = params_to_tree(params_from_tree(params_to_tree(model), cfg))
    for a, b in zip(tree_leaves(params_to_tree(model)), tree_leaves(again)):
        assert torch.equal(a, b)


def test_no_shared_expert_round_trips():
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, num_shared=0))
                 for c in _cfgs())
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(6), jcfg, dtype=jnp.float32))
    assert "shared" not in tree["layers"]["moe"]
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.layers[0].mlp.shared is None
    assert "shared" not in params_to_numpy(model)["layers"]["moe"]
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want, _ = jprefill(tree, {"tokens": jnp.asarray(prompts)}, jcfg)
    got, _ = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert _rel(got, want) <= RTOL


@pytest.fixture(scope="module")
def wide_llama4():
    """Experts of width 256: each stacked (2, 4, 64, 256) expert leaf has
    131,072 elements, above the quantization rule's 65,536."""
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, d_ff_expert=256))
                 for c in _cfgs())
    params = jinit(jax.random.PRNGKey(8), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, model


def test_expert_leaves_quantize_as_the_reference_does(wide_llama4):
    _, _, params, model = wide_llama4
    want = jq.quantize_tree(params)
    got = tq.quantize_tree(params_to_tree(model))
    jl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jq.QuantTensor))[0]
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    quantized = []
    for (path, a), b in zip(jl, tl):
        path = jax.tree_util.keystr(path)
        assert isinstance(a, jq.QuantTensor) == isinstance(b, tq.QuantTensor), path
        if isinstance(a, jq.QuantTensor):
            quantized.append(path)
            np.testing.assert_array_equal(b.codes.numpy(), np.asarray(a.codes))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for name, scale in (("e_gate", (2, 4, 1, 256)), ("e_up", (2, 4, 1, 256)),
                        ("e_down", (2, 4, 1, 64))):
        assert any(name in p for p in quantized), name
        assert tuple(got["layers"]["moe"][name].scale.shape) == scale
    assert not any("router" in p for p in quantized)  # (2, 64, 4): below the rule
    assert tq.tree_param_bytes(got) == jq.tree_param_bytes(want)


def test_quantized_engine_tokens_equal_a_plain_engine_and_the_reference(wide_llama4):
    jcfg, cfg, params, model = wide_llama4
    prompts = np.random.default_rng(9).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, quantize=True, device="cpu")
    assert eng.params["layers"]["moe"]["e_gate"].codes.dtype == torch.int8
    got = eng.generate(prompts, NEW, keep_logits=True)
    deq = params_from_tree(tq.dequantize_tree(tq.quantize_tree(params_to_tree(model)),
                                              torch.float32), cfg)
    plain = ServeEngine(cfg, deq, max_len=PROMPT + NEW, device="cpu").generate(
        prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(plain.tokens, got.tokens)
    assert torch.equal(plain.logits, got.logits)
    want = JServeEngine(jcfg, params, max_len=PROMPT + NEW, quantize=True).generate(
        jnp.asarray(prompts), NEW).tokens
    np.testing.assert_array_equal(got.tokens, want)


def test_expert_init_draws_slab_by_slab_into_its_dtype():
    """Shape and dtype as asked; the slabs are the generator's successive
    float32 draws times the scale, rounded once; the spread is the scale."""
    g = torch.Generator().manual_seed(3)
    w = expert_init(g, (6, 128, 96), 0.125, torch.bfloat16)
    assert w.shape == (6, 128, 96) and w.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(3)
    want = torch.stack([torch.randn((128, 96), generator=g) * 0.125 for _ in range(6)])
    assert torch.equal(w, want.to(torch.bfloat16))
    assert abs(w.float().std().item() / 0.125 - 1) < 0.02
    assert torch.equal(expert_init(torch.Generator().manual_seed(3), (6, 128, 96), 0.125,
                                   torch.float32), want)


def test_moe_init_shapes_dtypes_and_scales():
    cfg = dataclasses.replace(get_arch("llama4").reduced(), d_model=256)
    m = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    e, d, f = 4, 256, 64
    assert m.router.dtype == torch.float32 and m.router.shape == (d, e)
    assert m.e_gate.shape == m.e_up.shape == (e, d, f) and m.e_down.shape == (e, f, d)
    assert m.e_gate.dtype == m.e_down.dtype == torch.bfloat16
    assert m.shared.w_gate.shape == (d, f) and m.shared.w_down.shape == (f, d)
    for w, scale in ((m.router, d ** -0.5), (m.e_gate, d ** -0.5), (m.e_up, d ** -0.5),
                     (m.e_down, f ** -0.5)):
        assert abs(w.float().std().item() / scale - 1) < 0.1
    assert m.router.device.type == "cpu"  # the generator's device


def test_deepseek_v2_still_raises_through_mla():
    """deepseek-v2 no longer raises through MLA: its reduced config builds
    on the CPU with MLA attention over the MoE family, and its cache spec
    is the latent cache, {"lat": (L, B, C, kv_lora + rope), "pos": (L, C)}."""
    from repro_torch.models import cache_spec
    from repro_torch.models.attention import MLAAttention

    cfg = get_arch("deepseek-v2").reduced()
    assert cfg.family == "moe" and cfg.attn == "mla"
    model = init_params(cfg, device="cpu")
    assert isinstance(model.layers[0].attn, MLAAttention)
    assert isinstance(model.layers[0].mlp, tmoe.MoE)
    spec = cache_spec(cfg, 2, 48)
    assert set(spec) == {"lat", "pos"}
    assert spec["lat"].shape == (cfg.n_layers, 2, 48, 32 + 8) and spec["pos"].shape == (2, 48)
    full = cache_spec(get_arch("deepseek-v2"), 4, 8016)
    assert full["lat"].shape == (60, 4, 8016, 576) and full["pos"].dtype == torch.int32


@pytest.mark.parametrize("module,name", [("llama4_maverick_400b", "llama4"),
                                         ("deepseek_v2_236b", "deepseek-v2"),
                                         ("glm4_9b", "glm4"), ("qwen3_0_6b", "qwen3"),
                                         ("phi3_medium_14b", "phi3"),
                                         ("h2o_danube_1_8b", "danube")])
def test_config_shims_equal_the_reference(module, name):
    import importlib

    want = importlib.import_module(f"repro.configs.{module}").CONFIG
    got = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == get_arch(name)
