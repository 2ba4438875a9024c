"""The port's multi-head latent attention (MLA) held against the JAX reference.

Reduced deepseek-v2 (`ArchConfig.reduced()`: 2 layers, d_model 64, 4 heads,
MLA ranks kv 32 and q 0 (one ``wq``), rope 8, nope 16, v 16; 4 experts of
64, top-2, one shared, capacity factor 4.0: dropless) and a variant with
``q_lora_rank = 24``, the full model's low-rank query path (``w_dq``,
``q_norm``, ``w_uq``), which ``.reduced()`` never takes.  The reference's
float32 params are carried across by ``params_from_numpy`` on the CPU,
where kernel 8's wrapper runs its chunked plain version (q/k of nope + rope
= 24, v of 16).  Inputs come from numpy seeds.  Tolerance rtol 1e-4 / atol
1e-5 (float32 products in another order measure about 1e-6); generation as
tests/test_torch_moe.py holds it: tokens equal, logits within 1e-4 of
max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn, cache_spec as jcache_spec
from repro.models import init_params as jinit, prefill as jprefill
from repro.serving import quant as jq
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.core.mapreduce import tree_leaves
from repro_torch.models import (attention as tattn, cache_spec, init_params, params_from_numpy,
                                params_from_tree, params_to_numpy, params_to_tree, prefill)
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

RTOL, ATOL = 1e-4, 1e-5
PROMPT, NEW, STEPS = 40, 8, 3
Q_FORMS = {"wq": 0, "low_rank_q": 24}  # name: q_lora_rank


def _cfgs(q_lora_rank=0, **arch):
    out = []
    for get in (jget_arch, get_arch):
        c = get("deepseek-v2").reduced()
        out.append(dataclasses.replace(
            c, mla=dataclasses.replace(c.mla, q_lora_rank=q_lora_rank), **arch))
    return out


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(Q_FORMS))
def deepseek(request):
    """(q form, reference cfg, port cfg, JAX params, port model, prompts)."""
    jcfg, cfg = _cfgs(Q_FORMS[request.param])
    assert cfg.attn == "mla" and cfg.family == "moe"
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    return request.param, jcfg, cfg, params, model, prompts


def _layer(params, model, i=0):
    """Layer i's attention: the reference's leaves and the port's module."""
    return jax.tree.map(lambda a: a[i], params["layers"]["attn"]), model.layers[i].attn


def _x(cfg, s=PROMPT, seed=2):
    return np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)).astype(np.float32)


def test_layer_leaves_follow_the_q_form(deepseek):
    form, _, cfg, params, model, _ = deepseek
    leaves = set(params["layers"]["attn"])
    attn = model.layers[0].attn
    assert isinstance(attn, tattn.MLAAttention)
    if form == "wq":
        assert "wq" in leaves and "w_dq" not in leaves and attn.w_dq is None
    else:
        assert {"w_dq", "q_norm", "w_uq"} <= leaves and "wq" not in leaves and attn.wq is None
        assert tuple(attn.w_uq.shape) == (24, cfg.n_heads * 24)


def test_mla_prefill_output_and_latent_cache_match(deepseek):
    _, jcfg, cfg, params, model, _ = deepseek
    jp, tp = _layer(params, model)
    x = _x(cfg)
    positions = np.arange(PROMPT, dtype=np.int32)
    want, wcache = jattn.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(positions),
                                   return_cache=True)
    got, gcache = tattn.mla_apply(tp, torch.from_numpy(x), cfg, torch.from_numpy(positions),
                                  return_cache=True)
    assert got.shape == want.shape == (2, PROMPT, cfg.d_model)
    _close(got, want)
    m = cfg.mla
    assert set(gcache) == set(wcache) == {"lat", "pos"}
    assert tuple(gcache["lat"].shape) == (2, PROMPT, m.kv_lora_rank + m.rope_head_dim)
    _close(gcache["lat"], wcache["lat"])
    np.testing.assert_array_equal(gcache["pos"].numpy(), np.asarray(wcache["pos"]))
    # the plain dense attention gives the kernel wrapper's CPU result
    from repro_torch.kernels.swa_attention.ref import swa_attention_ref

    dense, _ = tattn.mla_apply(tp, torch.from_numpy(x), cfg, torch.from_numpy(positions),
                               attention=lambda q, k, v, w, scale: swa_attention_ref(
                                   q, k, v, w, scale))
    _close(dense, want)


def _grown(cache, capacity):
    """A prefill's latent cache in capacity slots: zeros, positions -1."""
    lat = np.zeros(cache["lat"].shape[:1] + (capacity,) + cache["lat"].shape[2:], np.float32)
    lat[:, :cache["lat"].shape[1]] = np.asarray(cache["lat"])
    pos = np.full((capacity,), -1, np.int32)
    pos[:cache["pos"].shape[0]] = np.asarray(cache["pos"])
    return lat, pos


def test_absorbed_decode_steps_match_the_reference(deepseek):
    """Three absorbed steps from a prefill cache grown to capacity: outputs,
    the latent written in place at each position, and the positions."""
    _, jcfg, cfg, params, model, _ = deepseek
    jp, tp = _layer(params, model, 1)
    x = _x(cfg, PROMPT + STEPS, seed=3)
    positions = np.arange(PROMPT, dtype=np.int32)
    _, c0 = jattn.mla_apply(jp, jnp.asarray(x[:, :PROMPT]), jcfg, jnp.asarray(positions),
                            return_cache=True)
    lat, pos = _grown(c0, PROMPT + STEPS)
    jcache = {"lat": jnp.asarray(lat), "pos": jnp.asarray(pos)}
    tcache = {"lat": torch.from_numpy(lat.copy()), "pos": torch.from_numpy(pos.copy())}
    lat_storage = tcache["lat"].data_ptr()
    for i in range(PROMPT, PROMPT + STEPS):
        xi, at = x[:, i:i + 1], np.asarray([i], np.int32)
        want, jcache = jattn.mla_apply(jp, jnp.asarray(xi), jcfg, jnp.asarray(at), cache=jcache,
                                       pos=jnp.asarray(i, jnp.int32))
        got, out_cache = tattn.mla_apply(tp, torch.from_numpy(xi), cfg, torch.from_numpy(at),
                                         cache=tcache, pos=i)
        assert out_cache is tcache and tcache["lat"].data_ptr() == lat_storage  # in place
        _close(got, want)
        _close(tcache["lat"], jcache["lat"])
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_absorbed_decode_equals_the_non_absorbed_forward(deepseek):
    """The port's absorbed decode at positions PROMPT .. PROMPT + 2 against
    its own non-absorbed prefill over the whole sequence at those rows: the
    reference's claim of identical math."""
    _, _, cfg, params, model, _ = deepseek
    tp = model.layers[0].attn
    x = torch.from_numpy(_x(cfg, PROMPT + STEPS, seed=4))
    full, _ = tattn.mla_apply(tp, x, cfg, torch.arange(PROMPT + STEPS, dtype=torch.int32))
    _, cache = tattn.mla_apply(tp, x[:, :PROMPT], cfg, torch.arange(PROMPT, dtype=torch.int32),
                               return_cache=True)
    lat, pos = _grown({k: v.numpy() for k, v in cache.items()}, PROMPT + STEPS)
    cache = {"lat": torch.from_numpy(lat), "pos": torch.from_numpy(pos)}
    for i in range(PROMPT, PROMPT + STEPS):
        got, _ = tattn.mla_apply(tp, x[:, i:i + 1], cfg, torch.tensor([i], dtype=torch.int32),
                                 cache=cache, pos=i)
        _close(got, full[:, i:i + 1].numpy())


def test_prefill_logits_and_stacked_cache_match(deepseek):
    _, jcfg, cfg, params, model, prompts = deepseek
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert _rel(logits, jlogits) <= RTOL
    assert set(cache) == set(jcache) == {"lat", "pos"}
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        assert _rel(cache[name], jcache[name]) <= RTOL, name


def test_generate_matches_jax_engine(deepseek):
    """Tokens equal the reference engine's; every step's logits (the
    reference's recomputed on its tokens) within 1e-4 of max|logit|; the
    engine grows the latent cache with zeros and its positions with -1."""
    _, jcfg, cfg, params, model, prompts = deepseek
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW)
    want = jeng.generate(jnp.asarray(prompts), NEW).tokens
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, device="cpu")
    got = eng.generate(prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    logits, cache = jeng._prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jeng._grow_cache(cache, prompts.shape[0])
    _, tcache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    tcache = eng._grow_cache(tcache, prompts.shape[0])
    assert tuple(tcache["lat"].shape) == cache["lat"].shape == (2, 2, PROMPT + NEW, 40)
    assert not tcache["lat"][:, :, PROMPT:].any() and (tcache["pos"][:, PROMPT:] == -1).all()
    steps = [logits]
    for i in range(1, NEW):
        logits, cache = jeng._decode(params, cache, jnp.asarray(want[:, i - 1]),
                                     jnp.asarray(PROMPT + i - 1, jnp.int32))
        steps.append(logits)
    jlogits = np.stack([np.asarray(s) for s in steps], 1)
    assert _rel(got.logits, jlogits) <= 1e-4


@pytest.mark.parametrize("form", sorted(Q_FORMS))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bitwise(form, dtype):
    """The reference's MLA leaves -- w_dkv, kv_norm, w_uk, w_uv, w_kr, wo and
    wq or w_dq, q_norm, w_uq, each stacked on L -- carried in and back bit
    for bit, and through the tree of tensors."""
    jcfg, cfg = _cfgs(Q_FORMS[form])
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
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


@pytest.mark.parametrize("form", sorted(Q_FORMS))
def test_cache_spec_equals_the_reference(form):
    jcfg, cfg = _cfgs(Q_FORMS[form])
    for batch, seq in ((2, 48), (1, 7)):
        want = jattn.mla_cache_spec(jcfg, batch, seq, jnp.float32)
        got = tattn.mla_cache_spec(cfg, batch, seq, torch.float32)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert got["pos"].dtype == torch.int32 and got["lat"].dtype == torch.float32
        assert tattn.attention_cache_spec(cfg, batch, seq) == tattn.mla_cache_spec(cfg, batch,
                                                                                    seq)
        want = jcache_spec(jcfg, batch, seq)
        got = cache_spec(cfg, batch, seq)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


def test_init_params_builds_deepseek_on_the_cpu():
    """Both q forms build from a seed with the reference's leaves, shapes
    and scales; the same seed gives the same weights."""
    for form, rank in Q_FORMS.items():
        _, cfg = _cfgs(rank)
        model = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
        attn = model.layers[0].attn
        m, h = cfg.mla, cfg.n_heads
        assert tuple(attn.w_dkv.shape) == (cfg.d_model, m.kv_lora_rank)
        assert tuple(attn.w_uk.shape) == (m.kv_lora_rank, h * m.nope_head_dim)
        assert tuple(attn.w_uv.shape) == (m.kv_lora_rank, h * m.v_head_dim)
        assert tuple(attn.w_kr.shape) == (cfg.d_model, m.rope_head_dim)
        assert tuple(attn.wo.shape) == (h * m.v_head_dim, cfg.d_model)
        assert torch.equal(attn.kv_norm, torch.ones(m.kv_lora_rank))
        assert (attn.wq is None) == bool(rank)
        again = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
        for a, b in zip(tree_leaves(params_to_tree(model)), tree_leaves(params_to_tree(again))):
            assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(0)
    wide = dataclasses.replace(cfg, d_model=1024)
    attn = tattn.mla_init(gen, wide, torch.float32)
    assert abs(attn.w_dkv.std().item() * 1024 ** 0.5 - 1) < 0.05
    with pytest.raises(ValueError, match="either wq"):
        tattn.MLAAttention(attn.w_dkv, attn.kv_norm, attn.w_uk, attn.w_uv, attn.w_kr, attn.wo)


@pytest.fixture(scope="module")
def wide_deepseek():
    """Reduced deepseek-v2 widened so that its MLA and expert leaves pass
    the quantization rule's 65,536 elements: d_model 512, 8 heads, kv rank
    128, nope 32, rope 16, v 32 (w_dkv (2, 512, 128), w_uk and w_uv (2,
    128, 256), wo (2, 256, 512), wq (2, 512, 384), experts (2, 4, 512,
    64)); w_kr (2, 512, 16) and the norms stay below it."""
    out = []
    for get in (jget_arch, get_arch):
        c = get("deepseek-v2").reduced()
        mla = dataclasses.replace(c.mla, kv_lora_rank=128, nope_head_dim=32, rope_head_dim=16,
                                  v_head_dim=32)
        out.append(dataclasses.replace(c, d_model=512, n_heads=8, n_kv_heads=8, mla=mla))
    jcfg, cfg = out
    params = jinit(jax.random.PRNGKey(8), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, model


def test_quantized_engine_tokens_equal_the_reference(wide_deepseek):
    jcfg, cfg, params, model = wide_deepseek
    q = tq.quantize_tree(params_to_tree(model))
    attn = q["layers"]["attn"]
    for name in ("w_dkv", "w_uk", "w_uv", "wo", "wq"):
        assert isinstance(attn[name], tq.QuantTensor), name
    assert not isinstance(attn["w_kr"], tq.QuantTensor)
    assert isinstance(q["layers"]["moe"]["e_gate"], tq.QuantTensor)
    want_q = jq.quantize_tree(params)
    for name in ("w_dkv", "w_uk", "w_uv", "wo", "wq"):
        np.testing.assert_array_equal(attn[name].codes.numpy(),
                                      np.asarray(want_q["layers"]["attn"][name].codes))
    assert tq.tree_param_bytes(q) == jq.tree_param_bytes(want_q)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, quantize=True, device="cpu")
    got = eng.generate(prompts, NEW)
    want = JServeEngine(jcfg, params, max_len=PROMPT + NEW, quantize=True).generate(
        jnp.asarray(prompts), NEW).tokens
    np.testing.assert_array_equal(got.tokens, want)


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    tps = serve.main(["--arch", "deepseek-v2", "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "24", "--max-new", "4"])
    out = capsys.readouterr().out
    assert tps > 0 and "[serve] deepseek-v2-236b f32 on cpu: 2×4 tokens" in out
