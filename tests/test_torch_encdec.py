"""The port's encoder-decoder (whisper-base) held against the JAX reference.

Reduced whisper-base (`ArchConfig.reduced()`: d_model 64, 4 heads of 16,
2 encoder and 2 decoder layers, vocab 512) in float32, the reference's
weights carried across with ``params_from_numpy``, frames and tokens from
numpy seeds, on the CPU.  Tolerances, normwise relative: TOL = 2e-5 in
float32 (the encoder's states, logits and every cache leaf; measured at
3e-7 to 9e-7); generation: tokens equal and every step's logits within
1e-4 of max|logit| (tests/test_torch_lm.py's limits); bf16 logits within
BF16_TOL = 6e-2 of each row's max|logit| and the tokens equal wherever the
reference's top-2 gap exceeds that (tests/test_torch_xlstm_lm.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import cache_spec as jcache_spec, decode_step as jdecode
from repro.models import forward as jforward, init_params as jinit, prefill as jprefill
from repro.models.encdec import encode as jencode
from repro.serving import quant as jq
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.kernels.swa_attention.ops import swa_attention
from repro_torch.models import (cache_spec, decode_step, encdec, encode, fake_frame_embeds,
                                forward, init_params, params_from_numpy, params_from_tree,
                                params_to_numpy, params_to_tree, prefill)
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 2e-5
GEN_TOL = 1e-4
BF16_TOL = 6e-2
PROMPT, NEW, MAX_LEN = 12, 8, 24
FRAMES_BELOW, FRAMES_ABOVE = 16, 40  # encoder lengths below and above MAX_LEN
GROUPS = ("self", "cross")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def _cfgs(**kw):
    return tuple(dataclasses.replace(c, **kw) for c in (jget_arch("whisper").reduced(),
                                                         get_arch("whisper").reduced()))


def _inputs(cfg, seed=1, b=2, frames=FRAMES_BELOW, s=PROMPT):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _jbatch(frames, tokens):
    return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}


def _batch(frames, tokens):
    return {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}


@pytest.fixture(scope="module")
def wd():
    """(reference cfg, port cfg, JAX float32 params, port model, frames,
    tokens)."""
    jcfg, cfg = _cfgs()
    assert (cfg.family, cfg.enc_layers, cfg.n_layers, cfg.n_heads) == ("encdec", 2, 2, 4)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return (jcfg, cfg, params, model) + _inputs(cfg)


def test_encode_matches_reference(wd):
    jcfg, cfg, params, model, frames, _ = wd
    want = jencode(params, jnp.asarray(frames), jcfg)
    got = encode(model, torch.from_numpy(frames), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32 and _rel(got, want) <= TOL


def test_encoder_is_bidirectional(wd):
    """A frame's state depends on later frames: changing the last frame moves
    the first frame's state (a causal encoder would leave it)."""
    _, cfg, _, model, frames, _ = wd
    moved = frames.copy()
    moved[:, -1] += 1.0
    a = encode(model, torch.from_numpy(frames), cfg)
    b = encode(model, torch.from_numpy(moved), cfg)
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3


def test_forward_matches_reference(wd):
    jcfg, cfg, params, model, frames, tokens = wd
    want, jaux = jforward(params, _jbatch(frames, tokens), jcfg)
    got, aux = forward(model, _batch(frames, tokens), cfg, return_aux=True)
    assert got.shape == want.shape == (2, PROMPT, cfg.vocab) and _rel(got, want) <= TOL
    assert set(aux) == set(jaux) and all(float(v) == 0 for v in aux.values())
    assert torch.equal(forward(model, _batch(frames, tokens), cfg), got)


def test_prefill_matches_reference_leaf_by_leaf(wd):
    """The last logits and the self and cross caches leaf by leaf, shapes
    (L, B, S, KVH, hd) the reference's: the self cache over the tokens, the
    cross cache over the frames."""
    jcfg, cfg, params, model, frames, tokens = wd
    jlogits, jcache = jprefill(params, _jbatch(frames, tokens), jcfg)
    logits, cache = prefill(model, _batch(frames, tokens), cfg)
    assert _rel(logits, jlogits) <= TOL
    assert set(cache) == set(jcache) == set(GROUPS)
    for g in GROUPS:
        assert set(cache[g]) == set(jcache[g]) == {"k", "v"}
        for name, t in cache[g].items():
            assert tuple(t.shape) == jcache[g][name].shape and _rel(t, jcache[g][name]) <= TOL
    assert cache["self"]["k"].shape == (2, 2, PROMPT, 4, 16)
    assert cache["cross"]["k"].shape == (2, 2, FRAMES_BELOW, 4, 16)


@pytest.mark.parametrize("n_frames", [FRAMES_BELOW, FRAMES_ABOVE])
def test_decode_steps_match_reference(wd, n_frames):
    """Three decode steps from the grown prefill caches, logits and every
    leaf after each; the self cache written in place, the cross cache the
    prefill's own length and never written."""
    jcfg, cfg, params, model, _, _ = wd
    frames, tokens = _inputs(cfg, seed=2, frames=n_frames)
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu")
    jlogits, jcache = jprefill(params, _jbatch(frames, tokens), jcfg)
    jcache = jeng._grow_cache(jcache, 2)
    _, cache = prefill(model, _batch(frames, tokens), cfg)
    cache = eng._grow_cache(cache, 2)
    assert cache["self"]["k"].shape[2] == MAX_LEN and cache["cross"]["k"].shape[2] == n_frames
    cross = cache["cross"]["k"].clone()
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jdecode(p, c, {"tokens": t, "pos": pos}, jcfg))
    for i in range(3):
        pos = PROMPT + i
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        big = cache["self"]["k"]
        logits, out = decode_step(model, cache, {"tokens": torch.from_numpy(tok), "pos": pos},
                                  cfg)
        assert out is cache and out["self"]["k"] is big
        assert _rel(logits, jlogits) <= TOL
        for g in GROUPS:
            for name in ("k", "v"):
                assert _rel(cache[g][name], jcache[g][name]) <= TOL, (i, g, name)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    assert torch.equal(cache["cross"]["k"], cross)


def _reference_steps(jeng, params, frames, prompts, tokens):
    """The reference engine's logits (B, T, V) at every step, teacher-forced
    on ``tokens``."""
    logits, cache = jeng._prefill(params, _jbatch(frames, prompts))
    cache = jeng._grow_cache(cache, prompts.shape[0])
    steps = [logits]
    for i in range(1, tokens.shape[1]):
        logits, cache = jeng._decode(params, cache, jnp.asarray(tokens[:, i - 1]),
                                     jnp.asarray(prompts.shape[1] + i - 1, jnp.int32))
        steps.append(logits)
    return np.stack([np.asarray(s, np.float32) for s in steps], 1)


@pytest.mark.parametrize("n_frames", [FRAMES_BELOW, FRAMES_ABOVE], ids=["below", "above"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_generate_matches_jax_engine(quantize, n_frames):
    """Tokens equal the reference engine's and every step's logits within
    GEN_TOL, at an encoder length below MAX_LEN and above it (the cross
    cache keeps its length either way), float32 and with int8 weights (at
    vocab 1,024 the embedding and lm_head, (1,024, 64) and (64, 1,024),
    are the leaves of 65,536 elements: their codes and scales bitwise the
    reference's)."""
    jcfg, cfg = _cfgs(vocab=1024)
    params = jinit(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    frames, prompts = _inputs(cfg, seed=4, frames=n_frames)
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN, quantize=quantize)
    want = jeng.generate(jnp.asarray(prompts), NEW, extra={"frames": jnp.asarray(frames)}).tokens
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, quantize=quantize, device="cpu")
    got = eng.generate(prompts, NEW, extra={"frames": torch.from_numpy(frames)},
                       keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    assert _rel(got.logits, _reference_steps(jeng, jeng.params, frames, prompts, want)) <= GEN_TOL
    if quantize:
        quantized = sorted(k for k, v in eng.params.items() if isinstance(v, tq.QuantTensor))
        assert quantized == ["embed", "lm_head"]
        for name in quantized:
            leaf, jleaf = eng.params[name], jeng.params[name]
            assert isinstance(jleaf, jq.QuantTensor)
            np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaf.scale))


def test_padded_cross_cache_fails_the_reference(wd, monkeypatch):
    """The planted fault: an engine that pads the cross K/V to max_len with
    zero rows (the encoder 16 frames, max_len 24) puts probability mass on 8
    phantom positions; its logits leave the reference's by far more than
    GEN_TOL.  The engine as shipped holds the reference."""
    jcfg, cfg, params, model, frames, prompts = wd
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN)
    want = jeng.generate(jnp.asarray(prompts), NEW, extra={"frames": jnp.asarray(frames)}).tokens
    jl = _reference_steps(jeng, params, frames, prompts, want)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu")
    run = lambda: eng.generate(prompts, NEW, extra={"frames": torch.from_numpy(frames)},  # noqa
                               keep_logits=True)
    assert _rel(run().logits, jl) <= GEN_TOL

    def padded(cache, batch):
        return eng._fit(cache, cache_spec(cfg, batch, MAX_LEN, dtype=eng.dtype))

    monkeypatch.setattr(eng, "_grow_cache", padded)
    bad = run()
    assert bad.logits.shape == (2, NEW, cfg.vocab)
    assert _rel(bad.logits[:, 1:], jl[:, 1:]) > 100 * GEN_TOL


def test_bf16_generate_holds_the_reference_logits():
    """bf16 weights and caches in both engines, the encoder longer than
    max_len: every step's logits, the reference's teacher-forced on the
    port's tokens, within BF16_TOL of each row's max|logit|; the tokens
    equal wherever the reference's top-2 gap exceeds BF16_TOL of that row's
    max|logit|."""
    jcfg, cfg = _cfgs()
    params = jinit(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    frames, prompts = _inputs(cfg, seed=3, frames=FRAMES_ABOVE)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, dtype=torch.bfloat16, device="cpu")
    got = eng.generate(prompts, NEW, extra={"frames": torch.from_numpy(frames)},
                       keep_logits=True)
    jeng = JServeEngine(jcfg, params, max_len=MAX_LEN, dtype=jnp.bfloat16)
    jl = _reference_steps(jeng, params, frames, prompts, got.tokens)
    assert (_row_rel(got.logits, jl) <= BF16_TOL).all()
    top2 = np.sort(jl, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > BF16_TOL * np.abs(jl).max(-1)
    assert decided.any()
    np.testing.assert_array_equal(got.tokens[decided], jl.argmax(-1)[decided])


def test_generate_equals_full_forward(wd):
    """Greedy generation equals step-by-step argmax of the full forward over
    the same frames (tests/test_serving.py's check, on the port alone)."""
    _, cfg, _, model, frames, prompts = wd
    toks = torch.from_numpy(prompts).long()
    fr = torch.from_numpy(frames)
    want = []
    for _ in range(NEW):
        nxt = forward(model, {"frames": fr, "tokens": toks}, cfg)[:, -1].argmax(-1)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    got = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu").generate(
        prompts, NEW, extra={"frames": fr})
    np.testing.assert_array_equal(got.tokens, torch.stack(want, 1).numpy())


def test_prefill_attention_runs_once_a_decoder_layer(wd):
    """``prefill(attention=...)`` calls the hook once per decoder layer, on
    the decoder's (B, S_dec, H, hd) q, k, v at window S_dec, never for the
    encoder's self-attention or cross-attention; a decode step never; the
    result is the default's (the kernel wrapper's plain version here)."""
    _, cfg, _, model, frames, prompts = wd
    calls = []

    def counting(q, k, v, window, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), window))
        return swa_attention(q, k, v, window, scale=scale)

    logits, cache = prefill(model, _batch(frames, prompts), cfg, attention=counting)
    assert calls == [((2, PROMPT, 4, 16), (2, PROMPT, 4, 16), PROMPT)] * cfg.n_layers
    assert torch.equal(logits, prefill(model, _batch(frames, prompts), cfg)[0])
    with pytest.raises(ValueError, match="needs frames"):
        prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bitwise(dtype):
    """Reference tree -> port -> tree, bitwise (enc_layers, dec_layers with
    xattn, embed, enc_norm, final_norm, lm_head), and the port's tree of
    tensors back into a model that computes the same logits."""
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
    model = params_from_numpy(tree, cfg, device="cpu")
    assert isinstance(model, encdec.EncDec)
    assert model.dec_layers[0].xattn.wk.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                                                  else torch.float32)
    back = params_to_numpy(model)
    flat, tdef = jax.tree_util.tree_flatten(tree)
    flat2, tdef2 = jax.tree_util.tree_flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = params_from_tree(params_to_tree(model), cfg)
    frames, prompts = _inputs(cfg, frames=6, s=5)
    batch = _batch(frames, prompts)
    assert torch.equal(forward(again, batch, cfg), forward(model, batch, cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_spec_and_the_grown_cache(wd, dtype):
    """cache_spec is the reference's (the cross cache at enc_len = seq_len);
    the engine grows the self cache to max_len and keeps the cross cache's
    own length, both at the engine's dtype."""
    jcfg, cfg, _, model, _, _ = wd
    spec = cache_spec(cfg, 2, MAX_LEN, dtype=dtype)
    jspec = jcache_spec(jcfg, 2, MAX_LEN, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                        else jnp.float32)
    for g in GROUPS:
        for name in ("k", "v"):
            assert tuple(spec[g][name].shape) == jspec[g][name].shape == (2, 2, MAX_LEN, 4, 16)
            assert spec[g][name].dtype == dtype
    if dtype == torch.bfloat16:
        model = init_params(cfg, seed=0, dtype=dtype, device="cpu")
    frames, prompts = _inputs(cfg, frames=FRAMES_ABOVE)
    _, cache = prefill(model, _batch(frames, prompts), cfg)
    grown = ServeEngine(cfg, model, max_len=MAX_LEN, dtype=dtype, device="cpu")._grow_cache(
        cache, 2)
    assert grown["self"]["k"].shape == (2, 2, MAX_LEN, 4, 16)
    assert grown["cross"]["v"].shape == (2, 2, FRAMES_ABOVE, 4, 16)
    assert all(t.dtype == dtype for g in GROUPS for t in grown[g].values())
    assert torch.equal(grown["self"]["k"][:, :, PROMPT:], torch.zeros_like(
        grown["self"]["k"][:, :, PROMPT:]))


def test_stub_frames_and_the_cli():
    """``fake_frame_embeds`` draws unit normals from the generator, cast to
    the dtype; the serve CLI, like the reference's, supplies no frames and
    raises naming them."""
    from repro_torch.launch import serve

    gen = torch.Generator().manual_seed(0)
    x = fake_frame_embeds(gen, 2, 30, 64, dtype=torch.bfloat16, device="cpu")
    assert x.shape == (2, 30, 64) and x.dtype == torch.bfloat16
    gen.manual_seed(0)
    assert torch.equal(x, torch.randn((2, 30, 64), generator=gen).to(torch.bfloat16))
    assert 0.9 < x.float().std().item() < 1.1
    with pytest.raises(ValueError, match="'frames'"):
        serve.main(["--arch", "whisper", "--reduced", "--device", "cpu"])
