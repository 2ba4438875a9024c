"""The port's VLM (llava-next-34b, its vision tower a stub) held against
the JAX reference.

Reduced llava-next-34b (`ArchConfig.reduced()`: d_model 64, 4 query heads
and 1 KV head of 16, 2 layers, vocab 512, 8 patches) in float32, the
reference's weights carried across with ``params_from_numpy``, patch
embeddings and tokens from numpy seeds, on the CPU.  Tolerances as
tests/test_torch_encdec.py's: TOL = 2e-5 normwise in float32 (logits and
every cache leaf; measured at 4e-7 to 9e-7), generation tokens equal and
logits within 1e-4 of max|logit|, bf16 logits within BF16_TOL = 6e-2 of
each row's max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import decode_step as jdecode
from repro.models import forward as jforward, init_params as jinit, prefill as jprefill
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.kernels.swa_attention.ops import swa_attention
from repro_torch.models import (decode_step, fake_patch_embeds, forward, params_from_numpy,
                                params_from_tree, params_to_numpy, params_to_tree, prefill)
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 2e-5
GEN_TOL = 1e-4
BF16_TOL = 6e-2
PROMPT, NEW = 12, 8
N_PATCHES = 8
MAX_LEN = N_PATCHES + PROMPT + NEW  # the cache must hold the patches too


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def _cfgs(**kw):
    return tuple(dataclasses.replace(c, **kw) for c in (jget_arch("llava").reduced(),
                                                         get_arch("llava").reduced()))


def _inputs(cfg, seed=1, b=2, s=PROMPT):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _jbatch(patches, tokens):
    return {"patch_embeds": jnp.asarray(patches), "tokens": jnp.asarray(tokens)}


def _batch(patches, tokens):
    return {"patch_embeds": torch.from_numpy(patches), "tokens": torch.from_numpy(tokens)}


@pytest.fixture(scope="module")
def vlm():
    """(reference cfg, port cfg, JAX float32 params, port model, patch
    embeddings, tokens)."""
    jcfg, cfg = _cfgs()
    assert (cfg.family, cfg.n_patches, cfg.n_heads, cfg.n_kv_heads) == ("vlm", N_PATCHES, 4, 1)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return (jcfg, cfg, params, model) + _inputs(cfg)


def test_forward_matches_reference(vlm):
    """Logits over n_patches + S_text positions, the patches first."""
    jcfg, cfg, params, model, patches, tokens = vlm
    want, jaux = jforward(params, _jbatch(patches, tokens), jcfg)
    got, aux = forward(model, _batch(patches, tokens), cfg, return_aux=True)
    assert got.shape == want.shape == (2, N_PATCHES + PROMPT, cfg.vocab)
    assert _rel(got, want) <= TOL
    assert set(aux) == set(jaux) and all(float(v) == 0 for v in aux.values())


def test_prefill_matches_reference_leaf_by_leaf(vlm):
    jcfg, cfg, params, model, patches, tokens = vlm
    jlogits, jcache = jprefill(params, _jbatch(patches, tokens), jcfg)
    logits, cache = prefill(model, _batch(patches, tokens), cfg)
    assert _rel(logits, jlogits) <= TOL
    assert set(cache) == set(jcache) == {"k", "v", "pos"}
    for name, t in cache.items():
        assert tuple(t.shape) == jcache[name].shape
    assert cache["k"].shape == (2, 2, N_PATCHES + PROMPT, 1, 16)
    assert _rel(cache["k"], jcache["k"]) <= TOL and _rel(cache["v"], jcache["v"]) <= TOL
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_decode_steps_from_patches_and_text(vlm):
    """Three decode steps at pos0 = S_text + n_patches against the
    reference's, logits and cache leaves after each; decoding from pos0 =
    S_text (the patches forgotten) leaves the reference's logits."""
    jcfg, cfg, params, model, patches, tokens = vlm
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu")
    jlogits, jcache = jprefill(params, _jbatch(patches, tokens), jcfg)
    jcache = jeng._grow_cache(jcache, 2)
    _, cache = prefill(model, _batch(patches, tokens), cfg)
    cache = eng._grow_cache(cache, 2)
    _, forgot = prefill(model, _batch(patches, tokens), cfg)
    forgot = eng._grow_cache(forgot, 2)
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jdecode(p, c, {"tokens": t, "pos": pos}, jcfg))
    for i in range(3):
        pos = PROMPT + N_PATCHES + i
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        logits, _ = decode_step(model, cache, {"tokens": torch.from_numpy(tok), "pos": pos}, cfg)
        assert _rel(logits, jlogits) <= TOL
        for name in ("k", "v"):
            assert _rel(cache[name], jcache[name]) <= TOL, (i, name)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        wrong, _ = decode_step(model, forgot, {"tokens": torch.from_numpy(tok),
                                               "pos": PROMPT + i}, cfg)
        assert _rel(wrong, jlogits) > 100 * TOL
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)


def _reference_steps(jeng, params, patches, prompts, tokens):
    logits, cache = jeng._prefill(params, _jbatch(patches, prompts))
    cache = jeng._grow_cache(cache, prompts.shape[0])
    steps = [logits]
    pos0 = prompts.shape[1] + patches.shape[1]
    for i in range(1, tokens.shape[1]):
        logits, cache = jeng._decode(params, cache, jnp.asarray(tokens[:, i - 1]),
                                     jnp.asarray(pos0 + i - 1, jnp.int32))
        steps.append(logits)
    return np.stack([np.asarray(s, np.float32) for s in steps], 1)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_generate_matches_jax_engine(quantize):
    """Tokens equal the reference engine's and every step's logits within
    GEN_TOL, float32 and with int8 weights (at vocab 1,024 the embedding and
    lm_head are the leaves of 65,536 elements)."""
    jcfg, cfg = _cfgs(vocab=1024)
    params = jinit(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    patches, prompts = _inputs(cfg, seed=4)
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN, quantize=quantize)
    want = jeng.generate(jnp.asarray(prompts), NEW,
                         extra={"patch_embeds": jnp.asarray(patches)}).tokens
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, quantize=quantize, device="cpu")
    got = eng.generate(prompts, NEW, extra={"patch_embeds": torch.from_numpy(patches)},
                       keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    jl = _reference_steps(jeng, jeng.params, patches, prompts, want)
    assert _rel(got.logits, jl) <= GEN_TOL
    if quantize:
        assert sorted(k for k, v in eng.params.items()
                      if isinstance(v, tq.QuantTensor)) == ["embed", "lm_head"]


def test_bf16_generate_holds_the_reference_logits():
    jcfg, cfg = _cfgs()
    params = jinit(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    patches, prompts = _inputs(cfg, seed=3)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, dtype=torch.bfloat16, device="cpu")
    got = eng.generate(prompts, NEW, extra={"patch_embeds": torch.from_numpy(patches)},
                       keep_logits=True)
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN, dtype=jnp.bfloat16)
    jl = _reference_steps(jeng, params, patches, prompts, got.tokens)
    assert (_row_rel(got.logits, jl) <= BF16_TOL).all()
    top2 = np.sort(jl, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > BF16_TOL * np.abs(jl).max(-1)
    assert decided.any()
    np.testing.assert_array_equal(got.tokens[decided], jl.argmax(-1)[decided])


def test_generate_equals_full_forward(vlm):
    """Greedy generation equals step-by-step argmax of the full forward over
    the patches and the text so far."""
    _, cfg, _, model, patches, prompts = vlm
    toks = torch.from_numpy(prompts).long()
    pe = torch.from_numpy(patches)
    want = []
    for _ in range(NEW):
        nxt = forward(model, {"patch_embeds": pe, "tokens": toks}, cfg)[:, -1].argmax(-1)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    got = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu").generate(
        prompts, NEW, extra={"patch_embeds": pe})
    np.testing.assert_array_equal(got.tokens, torch.stack(want, 1).numpy())


def test_max_len_that_ignores_the_patches_raises_in_both(vlm):
    """max_len = S_text + max_new passes both engines' prompt check, but the
    prefill's cache (n_patches + S_text positions) does not fit it: both
    raise."""
    jcfg, cfg, params, model, patches, prompts = vlm
    short = PROMPT + 4
    with pytest.raises(ValueError):
        JServeEngine(jcfg, params, max_len=short).generate(
            jnp.asarray(prompts), 4, extra={"patch_embeds": jnp.asarray(patches)})
    with pytest.raises(ValueError, match="does not fit capacity"):
        ServeEngine(cfg, model, max_len=short, device="cpu").generate(
            prompts, 4, extra={"patch_embeds": torch.from_numpy(patches)})


def test_prefill_attention_runs_once_a_layer_over_patches_and_text(vlm):
    """``prefill(attention=...)`` calls the hook once a layer on q (B,
    n_patches + S_text, H, hd) at window n_patches + S_text (causal over
    the patches too); without patch embeddings the VLM raises."""
    _, cfg, _, model, patches, prompts = vlm
    calls = []

    def counting(q, k, v, window, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), window))
        return swa_attention(q, k, v, window, scale=scale)

    s = N_PATCHES + PROMPT
    logits, _ = prefill(model, _batch(patches, prompts), cfg, attention=counting)
    assert calls == [((2, s, 4, 16), (2, s, 1, 16), s)] * cfg.n_layers
    assert torch.equal(logits, prefill(model, _batch(patches, prompts), cfg)[0])
    for call in (prefill, forward):
        with pytest.raises(ValueError, match="needs patch_embeds"):
            call(model, {"tokens": torch.from_numpy(prompts)}, cfg)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bitwise(dtype):
    """Reference tree -> port -> tree bitwise, patch_proj included, and the
    port's tree of tensors back into a model that computes the same
    logits."""
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
    assert tree["patch_proj"].shape == (64, 64)
    model = params_from_numpy(tree, cfg, device="cpu")
    back = params_to_numpy(model)
    flat, tdef = jax.tree_util.tree_flatten(tree)
    flat2, tdef2 = jax.tree_util.tree_flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = params_from_tree(params_to_tree(model), cfg)
    patches, prompts = _inputs(cfg, s=5)
    assert torch.equal(forward(again, _batch(patches, prompts), cfg),
                       forward(model, _batch(patches, prompts), cfg))


def test_stub_patches_and_the_cli():
    """``fake_patch_embeds`` draws unit normals from the generator, cast to
    the dtype; the serve CLI, like the reference's, supplies no patch
    embeddings and raises naming them."""
    from repro_torch.launch import serve

    gen = torch.Generator().manual_seed(7)
    x = fake_patch_embeds(gen, 2, 8, 64, device="cpu")
    assert x.shape == (2, 8, 64) and x.dtype == torch.bfloat16
    gen.manual_seed(7)
    assert torch.equal(x, torch.randn((2, 8, 64), generator=gen).to(torch.bfloat16))
    with pytest.raises(ValueError, match="'patch_embeds'"):
        serve.main(["--arch", "llava", "--reduced", "--device", "cpu"])
