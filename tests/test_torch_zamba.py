"""The port's zamba2 hybrid (Mamba2 trunk, one shared attention block) held
against the JAX reference.

Reduced zamba2 (`ArchConfig.reduced()`: 4 Mamba2 layers, the shared block
every 3 -- so 2 applications, at layers 0 and 3 --, d_model 64, 4 heads of
16, d_ff 128, SSD heads of 16, state 16, chunk 32, vocab 512) in float32,
the reference's weights carried across with ``params_from_numpy``, prompts
of 40 tokens (two chunks, the second padded) from numpy seeds, on the CPU,
where kernel 8's wrapper runs its chunked plain version.  Tolerances,
normwise relative: TOL = 1e-5 in float32 (measured at about 1e-6);
generation as tests/test_torch_lm.py holds it (tokens equal, logits within
1e-4 of max|logit|); bf16 logits within BF16_TOL = 6e-2 of each row's
max|logit|, tokens equal wherever the reference's top-2 gap exceeds that:
each package's bf16 logits lie 4.0-4.5e-2 of the row's max from the
float32 model on the same weights (a random model of width 64 rounding
its activations at every layer), and 2.5-4.7e-2 from each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import cache_spec as jcache_spec, decode_step as jdecode
from repro.models import forward as jforward, init_params as jinit, prefill as jprefill
from repro.serving import quant as jq
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.models import (cache_spec, decode_step, forward, params_from_numpy,
                                params_from_tree, params_to_numpy, params_to_tree, prefill,
                                zamba)
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 1e-5
BF16_TOL = 6e-2
PROMPT, NEW = 40, 6
LEAVES = (("ssm", "conv"), ("ssm", "ssd"), ("attn", "k"), ("attn", "v"), ("attn", "pos"))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> np.ndarray:
    """Each row's max|got - want| over its max|want| (last axis)."""
    got, want = _np(got), _np(want)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


@pytest.fixture(scope="module")
def hybrid():
    """(reference cfg, port cfg, JAX float32 params, port model, prompts,
    the reference's jitted prefill)."""
    jcfg, cfg = jget_arch("zamba2").reduced(), get_arch("zamba2").reduced()
    assert (cfg.family, cfg.n_layers, cfg.shared_attn_every, zamba._n_apps(cfg)) == (
        "hybrid", 4, 3, 2)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    jpre = jax.jit(lambda p, t: jprefill(p, {"tokens": t}, jcfg))
    return jcfg, cfg, params, model, prompts, jpre


def test_forward_matches_reference(hybrid):
    jcfg, cfg, params, model, prompts, _ = hybrid
    want, jaux = jax.jit(lambda p, t: jforward(p, {"tokens": t}, jcfg))(params,
                                                                         jnp.asarray(prompts))
    got, aux = forward(model, {"tokens": torch.from_numpy(prompts)}, cfg, return_aux=True)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    assert set(aux) == set(jaux) and all(float(v) == 0 for v in aux.values())
    assert torch.equal(forward(model, {"tokens": torch.from_numpy(prompts)}, cfg), got)


def test_prefill_matches_reference_leaf_by_leaf(hybrid):
    """The last logits and every cache leaf: the L layers' conv and SSD
    states, the A applications' K, V and positions."""
    jcfg, cfg, params, model, prompts, jpre = hybrid
    jlogits, jcache = jpre(params, jnp.asarray(prompts))
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert _rel(logits, jlogits) <= TOL
    assert set(cache) == set(jcache) and all(set(cache[g]) == set(jcache[g]) for g in cache)
    for g, name in LEAVES:
        t, w = cache[g][name], jcache[g][name]
        assert tuple(t.shape) == w.shape and str(t.dtype).split(".")[-1] == str(w.dtype)
        assert _rel(t, w) <= TOL, (g, name)
    np.testing.assert_array_equal(cache["attn"]["pos"].numpy(), np.asarray(jcache["attn"]["pos"]))


def test_decode_steps_match_reference(hybrid):
    """Three decode steps from the grown prefill caches, logits and every
    leaf after each, the port's cache written in place."""
    jcfg, cfg, params, model, prompts, jpre = hybrid
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + 4)
    eng = ServeEngine(cfg, model, max_len=PROMPT + 4, device="cpu")
    jlogits, jcache = jpre(params, jnp.asarray(prompts))
    jcache = jeng._grow_cache(jcache, 2)
    _, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    cache = eng._grow_cache(cache, 2)
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    jstep = jax.jit(lambda p, c, t, pos: jdecode(p, c, {"tokens": t, "pos": pos}, jcfg))
    for i in range(3):
        pos = PROMPT + i
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        ssd = cache["ssm"]["ssd"]
        logits, out = decode_step(model, cache, {"tokens": torch.from_numpy(tok), "pos": pos}, cfg)
        assert out is cache and out["ssm"]["ssd"] is ssd
        assert _rel(logits, jlogits) <= TOL
        for g, name in LEAVES:
            assert _rel(cache[g][name], jcache[g][name]) <= TOL, (i, g, name)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)


def test_shared_block_fires_before_layers_0_and_3_with_a_cache_each(hybrid, monkeypatch):
    """The prefill's attention hook is called once per application, before
    the Mamba2 layers 0 and 3 (i % 3 == 0), at window = S; each application
    keeps its own cache slot (its input differs, so its K does), and a
    decode step writes position ``pos`` in both slots."""
    _, cfg, _, model, prompts, _ = hybrid
    from repro_torch.kernels.swa_attention.ref import swa_attention_chunked

    events = []
    apply = zamba.mamba2_apply

    def mixer(*a, **kw):
        events.append("mamba")
        return apply(*a, **kw)

    def attention(q, k, v, window, scale=None):
        events.append(("attn", window))
        return swa_attention_chunked(q, k, v, window, scale=scale)

    monkeypatch.setattr(zamba, "mamba2_apply", mixer)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg,
                            attention=attention)
    assert events == [("attn", PROMPT), "mamba", "mamba", "mamba", ("attn", PROMPT), "mamba"]
    want, _ = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert torch.equal(logits, want)
    k = cache["attn"]["k"]
    assert k.shape[0] == 2 and not torch.equal(k[0], k[1])
    cache = ServeEngine(cfg, model, max_len=PROMPT + 2, device="cpu")._grow_cache(cache, 2)
    events.clear()
    decode_step(model, cache, {"tokens": torch.tensor([1, 2]), "pos": PROMPT}, cfg)
    assert events == ["mamba"] * 4  # decode attention is plain PyTorch, not the hook
    np.testing.assert_array_equal(cache["attn"]["pos"][:, PROMPT].numpy(), [PROMPT, PROMPT])
    assert (cache["attn"]["pos"][:, PROMPT + 1] == -1).all()
    assert not torch.equal(cache["attn"]["k"][0, :, PROMPT], cache["attn"]["k"][1, :, PROMPT])


def _reference_steps(jeng, params, prompts, tokens):
    """The reference engine's logits (B, T, V) at every step, teacher-forced
    on ``tokens``."""
    logits, cache = jeng._prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jeng._grow_cache(cache, prompts.shape[0])
    steps = [logits]
    for i in range(1, tokens.shape[1]):
        logits, cache = jeng._decode(params, cache, jnp.asarray(tokens[:, i - 1]),
                                     jnp.asarray(PROMPT + i - 1, jnp.int32))
        steps.append(logits)
    return np.stack([np.asarray(s, np.float32) for s in steps], 1)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_generate_matches_jax_engine(hybrid, quantize):
    """Tokens equal the reference engine's, float32 and with int8 weights
    (the stacked in_proj (4, 64, 296) is the one leaf of 65,536 elements or
    more: its codes and scales bitwise the reference's); every step's
    logits within 1e-4 of max|logit|."""
    jcfg, cfg, params, model, prompts, _ = hybrid
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW, quantize=quantize)
    want = jeng.generate(jnp.asarray(prompts), NEW).tokens
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, quantize=quantize, device="cpu")
    got = eng.generate(prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    jl = _reference_steps(jeng, jeng.params, prompts, want)
    assert _rel(got.logits, jl) <= 1e-4
    if quantize:
        quantized = [k for k, v in eng.params["mamba_layers"]["mixer"].items()
                     if isinstance(v, tq.QuantTensor)]
        assert quantized == ["in_proj"] and eng.params["mamba_layers"]["mixer"]["in_proj"].shape \
            == (4, 64, 296)
        jleaf = jeng.params["mamba_layers"]["mixer"]["in_proj"]
        assert isinstance(jleaf, jq.QuantTensor)
        leaf = eng.params["mamba_layers"]["mixer"]["in_proj"]
        np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes))
        np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaf.scale))


def test_bf16_generate_holds_the_reference_logits():
    """bf16 weights and caches in both engines: every step's logits, the
    reference's teacher-forced on the port's tokens, within BF16_TOL of
    each row's max|logit|; the tokens equal wherever the reference's top-2
    gap exceeds BF16_TOL of that row's max|logit|."""
    jcfg, cfg = jget_arch("zamba2").reduced(), get_arch("zamba2").reduced()
    params = jinit(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, dtype=torch.bfloat16, device="cpu")
    got = eng.generate(prompts, NEW, keep_logits=True)
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW, dtype=jnp.bfloat16)
    jl = _reference_steps(jeng, params, prompts, got.tokens)
    assert (_row_rel(got.logits, jl) <= BF16_TOL).all()
    top2 = np.sort(jl, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > BF16_TOL * np.abs(jl).max(-1)
    assert decided.any()
    np.testing.assert_array_equal(got.tokens[decided], jl.argmax(-1)[decided])


def test_generate_equals_full_forward(hybrid):
    """Greedy generation equals step-by-step argmax of the full forward
    (tests/test_serving.py's check, on the port alone)."""
    _, cfg, _, model, prompts, _ = hybrid
    toks = torch.from_numpy(prompts).long()
    want = []
    for _ in range(NEW):
        nxt = forward(model, {"tokens": toks}, cfg)[:, -1].argmax(-1)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    got = ServeEngine(cfg, model, max_len=PROMPT + NEW, device="cpu").generate(prompts, NEW)
    np.testing.assert_array_equal(got.tokens, torch.stack(want, 1).numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bitwise(dtype):
    """Reference tree -> port -> tree, bitwise, and the port's tree of
    tensors back into a model that computes the same logits; bf16 through
    the int16 view."""
    jcfg, cfg = jget_arch("zamba2").reduced(), get_arch("zamba2").reduced()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
    model = params_from_numpy(tree, cfg, device="cpu")
    mixer = model.mamba_layers[0].mixer
    assert mixer.A_log.dtype == torch.float32
    assert mixer.in_proj.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    back = params_to_numpy(model)
    flat, tdef = jax.tree_util.tree_flatten(tree)
    flat2, tdef2 = jax.tree_util.tree_flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = params_from_tree(params_to_tree(model), cfg)
    tok = torch.zeros((1, 8), dtype=torch.long)
    assert torch.equal(forward(again, {"tokens": tok}, cfg), forward(model, {"tokens": tok}, cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_spec_matches_the_grown_cache(hybrid, dtype):
    """The grown cache's leaves have cache_spec's shapes and dtypes (the
    SSD state float32, the conv state the engine's dtype), the reference's
    spec too; K/V and positions are padded with 0 and -1."""
    jcfg, cfg, params, model, prompts, _ = hybrid
    if dtype == torch.bfloat16:
        model = params_from_numpy(jax.tree.map(np.asarray, jinit(
            jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)), cfg, device="cpu")
    eng = ServeEngine(cfg, model, max_len=PROMPT + 8, dtype=dtype, device="cpu")
    _, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    grown = eng._grow_cache(cache, 2)
    spec = cache_spec(cfg, 2, PROMPT + 8, dtype=dtype)
    jspec = jcache_spec(jcfg, 2, PROMPT + 8, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                        else jnp.float32)
    for g, name in LEAVES:
        t = grown[g][name]
        assert tuple(t.shape) == tuple(spec[g][name].shape) == jspec[g][name].shape
        assert t.dtype == spec[g][name].dtype
        assert str(t.dtype).split(".")[-1] == str(jspec[g][name].dtype)
    assert grown["ssm"]["ssd"].dtype == torch.float32 and grown["ssm"]["conv"].dtype == dtype
    assert (grown["attn"]["pos"][:, PROMPT:] == -1).all()
    assert not grown["attn"]["k"][:, :, PROMPT:].any()
    np.testing.assert_array_equal(grown["attn"]["pos"][:, :PROMPT].numpy(),
                                  cache["attn"]["pos"].numpy())
    with pytest.raises(ValueError, match="attn.k .* does not fit capacity"):
        ServeEngine(cfg, model, max_len=PROMPT - 1, dtype=dtype, device="cpu")._grow_cache(
            cache, 2)


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    tps = serve.main(["--arch", "zamba2", "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "40", "--max-new", "4"])
    out = capsys.readouterr().out
    assert tps > 0 and "[serve] zamba2-7b f32 on cpu: 2×4 tokens" in out
