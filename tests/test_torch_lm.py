"""The port's dense-family LM serving path held against the JAX reference.

Reduced h2o-danube-1.8b (`ArchConfig.reduced()`: 2 layers, d_model 64, 4
query heads over 1 KV head, head_dim 16, window 16, vocab 512) in float32,
with the reference's params carried across by ``params_from_numpy``, on the
CPU, where the attention kernel's wrapper runs its chunked plain version.
One prefill case runs reduced qwen3 (qk_norm, no window).  Prompts are
longer than the window, so the prefill cache is ring-aligned and decode
wraps it.  Tolerances: float32 products over a few hundred terms in another
order, measured at about 1e-6 of each leaf's scale; held to 1e-5 (1e-4 of
max|logit| for generation, as stated for the serving check).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn, layers as jlayers
from repro.models import decode_step as jdecode, forward as jforward, init_params as jinit
from repro.models import prefill as jprefill
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.models import (attention as tattn, decode_step, forward, init_params, layers,
                                params_from_numpy, params_to_numpy, prefill)
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 1e-5
PROMPT = 40  # > the reduced window of 16


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def danube():
    """(reference cfg, port cfg, JAX params, port model, prompts)."""
    jcfg, cfg = jget_arch("danube").reduced(), get_arch("danube").reduced()
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.swa_window) == (4, 1, 16, 16)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    return jcfg, cfg, params, model, prompts


def test_rms_norm_and_swiglu_match():
    x, w = _rand(3, 5, 64, seed=2), _rand(64, seed=3)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert _rel(got, jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)) <= TOL
    wg, wu, wd = _rand(64, 128, seed=4), _rand(64, 128, seed=5), _rand(128, 64, seed=6)
    got = layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    assert _rel(got, jlayers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))) <= TOL


@pytest.mark.parametrize("start", [0, 4000, 8000])
def test_apply_rope_matches_to_position_8192(start):
    """The inverse frequencies agree to the bit, so the angles do; the
    rotated values agree to 1e-6 of |x| ~ 4 at every position up to 8192
    (one float32 ulp of an inverse frequency would move the angle at
    position 8000 by about 5e-4)."""
    pos = np.arange(start, start + 192, dtype=np.int32)
    x = _rand(2, 192, 4, 80, seed=start)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(layers.rope_frequencies(80, 10000.0).numpy(),
                                  np.asarray(jlayers.rope_frequencies(80, 10000.0)))


def test_gqa_apply_prefill_and_decode_match(danube):
    jcfg, cfg, params, model, _ = danube
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    tp = model.layers[0].attn
    x, x1 = _rand(2, 20, 64, seed=7), _rand(2, 1, 64, seed=8)
    pos = np.arange(20, dtype=np.int32)
    want, jcache = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), return_cache=True)
    got, cache = tattn.gqa_apply(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                                 return_cache=True)
    assert _rel(got, want) <= TOL
    for name in ("k", "v", "pos"):
        assert _rel(cache[name], jcache[name]) <= TOL, name
    # one decode step at position 20: ring slot 20 % 16 = 4
    want, jcache = jattn.gqa_apply(jp, jnp.asarray(x1), jcfg, jnp.asarray([20], jnp.int32),
                                   cache=jcache, pos=jnp.asarray(20, jnp.int32))
    got, cache = tattn.gqa_apply(tp, torch.from_numpy(x1), cfg,
                                 torch.tensor([20], dtype=torch.int32), cache=cache, pos=20)
    assert _rel(got, want) <= TOL
    for name in ("k", "v", "pos"):
        assert _rel(cache[name], jcache[name]) <= TOL, name


def test_lm_prefill_and_decode_step_match(danube):
    jcfg, cfg, params, model, prompts = danube
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert _rel(logits, jlogits) <= TOL
    assert set(cache) == set(jcache) == {"k", "v", "pos"}
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        assert _rel(cache[name], jcache[name]) <= TOL, name
    # the ring-aligned positions: slot j holds the position congruent to j
    np.testing.assert_array_equal(cache["pos"][0].numpy() % 16, np.arange(16))
    tok = np.asarray([3, 500], np.int32)
    jlogits, jcache = jdecode(params, jcache, {"tokens": jnp.asarray(tok),
                                               "pos": jnp.asarray(PROMPT, jnp.int32)}, jcfg)
    logits, cache = decode_step(model, cache, {"tokens": torch.from_numpy(tok), "pos": PROMPT},
                                cfg)
    assert _rel(logits, jlogits) <= TOL
    for name in cache:
        assert _rel(cache[name], jcache[name]) <= TOL, name


def test_generate_matches_jax_engine(danube):
    """Prompt 40 > window 16: tokens equal the reference engine's, and every
    step's logits (the reference's recomputed on its tokens with its own
    prefill / decode) within 1e-4 of max|logit|."""
    jcfg, cfg, params, model, prompts = danube
    max_new = 12
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + max_new)
    want = jeng.generate(jnp.asarray(prompts), max_new).tokens
    got = ServeEngine(cfg, model, max_len=PROMPT + max_new, device="cpu").generate(
        prompts, max_new, keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    logits, cache = jeng._prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jeng._grow_cache(cache, prompts.shape[0])
    steps = [logits]
    for i in range(1, max_new):
        logits, cache = jeng._decode(params, cache, jnp.asarray(want[:, i - 1]),
                                     jnp.asarray(PROMPT + i - 1, jnp.int32))
        steps.append(logits)
    jlogits = np.stack([np.asarray(s) for s in steps], 1)
    assert got.logits.shape == jlogits.shape
    assert _rel(got.logits, jlogits) <= 1e-4


def test_generate_equals_full_forward(danube):
    """Greedy generation equals step-by-step argmax of the full forward
    (the reference's tests/test_serving.py check, on the port alone)."""
    _, cfg, _, model, prompts = danube
    toks = torch.from_numpy(prompts).long()
    want = []
    for _ in range(6):
        nxt = forward(model, {"tokens": toks}, cfg)[:, -1].argmax(-1)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    got = ServeEngine(cfg, model, max_len=PROMPT + 6, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got.tokens, torch.stack(want, 1).numpy())


def test_forward_matches_reference(danube):
    jcfg, cfg, params, model, prompts = danube
    want, _ = jforward(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    assert _rel(forward(model, {"tokens": torch.from_numpy(prompts)}, cfg), want) <= TOL


def test_qwen3_prefill_matches():
    """The rest of the dense family: qk_norm and plain causal attention."""
    jcfg, cfg = jget_arch("qwen3").reduced(), get_arch("qwen3").reduced()
    assert cfg.qk_norm and cfg.swa_window is None
    params = jinit(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert _rel(logits, jlogits) <= TOL
    for name in cache:
        assert _rel(cache[name], jcache[name]) <= TOL, name


@pytest.mark.parametrize("arch,dtype", [("danube", jnp.float32), ("danube", jnp.bfloat16),
                                        ("qwen3", jnp.bfloat16)])
def test_params_round_trip_bitwise(arch, dtype):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.embed.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    back = params_to_numpy(model)
    flat, tdef = jax.tree_util.tree_flatten(tree)
    flat2, tdef2 = jax.tree_util.tree_flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bf16_engine_runs_and_other_families_raise():
    cfg = get_arch("danube").reduced()
    model = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    out = ServeEngine(cfg, model, max_len=24, dtype=torch.bfloat16, device="cpu").generate(
        np.zeros((1, 20), np.int32), 4)
    assert out.tokens.shape == (1, 4)
    with pytest.raises(TypeError, match="cache holds"):  # float32 cache, bf16 model
        ServeEngine(cfg, model, max_len=24, device="cpu").generate(np.zeros((1, 20)), 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        ServeEngine(cfg, model, max_len=16, device="cpu").generate(np.zeros((1, 14)), 4)
    # int8 weights (serving/quant.py): the reduced model's leaves are all
    # below 65,536 elements, so the engine serves them as given
    quant = ServeEngine(cfg, model, max_len=24, dtype=torch.bfloat16, quantize=True,
                        device="cpu")
    assert np.array_equal(quant.generate(np.zeros((1, 20), np.int32), 4).tokens, out.tokens)
    with pytest.raises(ValueError, match="exceeds max_len"):
        ServeEngine(cfg, model, max_len=16, quantize=True, device="cpu").generate(
            np.zeros((1, 14)), 4)
    whisper = init_params(get_arch("whisper").reduced(), device="cpu")  # ported: encdec
    assert len(whisper.enc_layers) == len(whisper.dec_layers) == 2
    llava = init_params(get_arch("llava").reduced(), device="cpu")  # ported: the VLM
    assert len(llava.layers) == 2 and llava.patch_proj.shape == (64, 64)
    hybrid = init_params(get_arch("zamba2").reduced(), device="cpu")  # ported: the hybrid
    assert len(hybrid.mamba_layers) == 4
    xlstm = init_params(get_arch("xlstm").reduced(), device="cpu")  # ported: the xLSTM
    assert len(xlstm.pairs) == 1 and xlstm.pairs[0].slstm is not None


def test_capacity_below_the_window_keeps_every_valid_slot(danube):
    """max_len below the window with a shorter prompt: the prefill's ring
    cache (window slots) does not fit the capacity.  The engine drops no
    slot: it raises, as the reference's `_grow_cache` does on its negative
    pad."""
    jcfg, cfg, params, model, _ = danube
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    with pytest.raises(ValueError):
        JServeEngine(jcfg, params, max_len=12).generate(jnp.asarray(prompts), 4)
    with pytest.raises(ValueError, match="does not fit capacity"):
        ServeEngine(cfg, model, max_len=12, device="cpu").generate(prompts, 4)
    full = ServeEngine(cfg, model, max_len=24, device="cpu").generate(prompts, 4)
    want = JServeEngine(jcfg, params, max_len=24).generate(jnp.asarray(prompts), 4).tokens
    np.testing.assert_array_equal(full.tokens, want)
