"""The port's xLSTM language model held against the JAX reference.

Reduced xlstm-125m (`ArchConfig.reduced()`: d_model 64, 4 heads, vocab
512) with n_layers = 4, so two (mLSTM -> sLSTM) pairs' states stack, in
float32, the reference's weights carried across with ``params_from_numpy``,
prompts of 70 tokens (one chunk of 64 and a padded second) from numpy
seeds, on the CPU.  Tolerances, normwise relative: TOL = 2e-5 in float32
(logits and every state leaf; measured at 3e-7 to 7.9e-6); generation as
tests/test_torch_lm.py holds it (tokens equal, logits within 1e-4 of
max|logit|); bf16 logits within BF16_TOL = 6e-2 of each row's max|logit|
and the tokens equal wherever the reference's top-2 gap exceeds that (each
package's bf16 rounds its projections and mixer outputs at every block, at
other points of their sums; measured at 3.5e-2 at most).
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
from repro.serving import quant as jq
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.models import (cache_spec, decode_step, forward, params_from_numpy,
                                params_from_tree, params_to_numpy, params_to_tree, prefill,
                                xlstm_lm)
from repro_torch.serving import ServeEngine
from repro_torch.serving import quant as tq

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 2e-5
BF16_TOL = 6e-2
PROMPT, NEW = 70, 6
LEAVES = (("m", "C"), ("m", "n"), ("m", "m"), ("s", "h"), ("s", "c"), ("s", "n"), ("s", "m"))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> np.ndarray:
    """Each row's max|got - want| over its max|want| (last axis)."""
    got, want = _np(got), _np(want)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def _cfgs(n_layers=4, slstm_every=2):
    return tuple(dataclasses.replace(c, n_layers=n_layers, slstm_every=slstm_every)
                 for c in (jget_arch("xlstm").reduced(), get_arch("xlstm").reduced()))


def _prompts(cfg, seed=1, b=2, s=PROMPT):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def lm():
    """(reference cfg, port cfg, JAX float32 params, port model, prompts,
    the reference's jitted prefill)."""
    jcfg, cfg = _cfgs()
    assert (cfg.family, cfg.n_layers, xlstm_lm._n_pairs(cfg)) == ("ssm", 4, 2)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    jpre = jax.jit(lambda p, t: jprefill(p, {"tokens": t}, jcfg))
    return jcfg, cfg, params, model, _prompts(cfg), jpre


def test_forward_matches_reference(lm):
    jcfg, cfg, params, model, prompts, _ = lm
    want, jaux = jax.jit(lambda p, t: jforward(p, {"tokens": t}, jcfg))(params,
                                                                         jnp.asarray(prompts))
    got, aux = forward(model, {"tokens": torch.from_numpy(prompts)}, cfg, return_aux=True)
    assert got.shape == want.shape and _rel(got, want) <= TOL
    assert set(aux) == set(jaux) and all(float(v) == 0 for v in aux.values())
    assert torch.equal(forward(model, {"tokens": torch.from_numpy(prompts)}, cfg), got)
    hidden = xlstm_lm.xlstm_forward(model, torch.from_numpy(prompts).long(), cfg,
                                    return_hidden=True)
    assert hidden.shape == (2, PROMPT, cfg.d_model) and torch.equal(hidden @ model.lm_head, got)


def test_prefill_matches_reference_leaf_by_leaf(lm):
    """The last logits and every leaf of both pairs' mLSTM and sLSTM
    states, shapes and dtypes (float32) the reference's."""
    jcfg, cfg, params, model, prompts, jpre = lm
    jlogits, jcache = jpre(params, jnp.asarray(prompts))
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert _rel(logits, jlogits) <= TOL
    assert set(cache) == set(jcache) and all(set(cache[g]) == set(jcache[g]) for g in cache)
    for g, name in LEAVES:
        t, w = cache[g][name], jcache[g][name]
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32 and w.dtype == jnp.float32
        assert t.shape[0] == 2 and _rel(t, w) <= TOL, (g, name)


def test_decode_steps_match_reference(lm):
    """Three decode steps from the grown prefill cache, logits and every
    leaf after each, the port's cache written in place."""
    jcfg, cfg, params, model, prompts, jpre = lm
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
        big = cache["m"]["C"]
        logits, out = decode_step(model, cache, {"tokens": torch.from_numpy(tok), "pos": pos}, cfg)
        assert out is cache and out["m"]["C"] is big
        assert _rel(logits, jlogits) <= TOL
        for g, name in LEAVES:
            assert _rel(cache[g][name], jcache[g][name]) <= TOL, (i, g, name)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)


@pytest.mark.parametrize("s", [1, 20])
def test_mlstm_only_stack_matches_reference(s):
    """slstm_every = 0: every "pair" an mLSTM block alone (two here), its
    tree and cache without sLSTM leaves; forward, a prefill of S tokens
    (one: the recurrence; 20: one chunk of 20) and two decode steps."""
    jcfg, cfg = _cfgs(n_layers=2, slstm_every=0)
    params = jinit(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    assert set(params["pairs"]) == {"m_norm", "mlstm"}
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert len(model.pairs) == 2 and model.pairs[1].slstm is None
    prompts = _prompts(cfg, seed=4, s=s)
    want, _ = jforward(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    assert _rel(forward(model, {"tokens": torch.from_numpy(prompts)}, cfg), want) <= TOL
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(prompts)}, jcfg)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cfg)
    assert set(cache) == {"m"} == set(jcache) and _rel(logits, jlogits) <= TOL
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for i in range(2):
        jlogits, jcache = jdecode(params, jcache, {"tokens": jnp.asarray(tok), "pos": s + i},
                                  jcfg)
        logits, cache = decode_step(model, cache, {"tokens": torch.from_numpy(tok),
                                                   "pos": s + i}, cfg)
        assert _rel(logits, jlogits) <= TOL
        for name in ("C", "n", "m"):
            assert _rel(cache["m"][name], jcache["m"][name]) <= TOL, (i, name)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    assert jax.tree.map(lambda a: a.shape, params_to_numpy(model)) == jax.tree.map(
        lambda a: a.shape, params)


def _reference_steps(jeng, params, prompts, tokens):
    """The reference engine's logits (B, T, V) at every step, teacher-forced
    on ``tokens``."""
    logits, cache = jeng._prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jeng._grow_cache(cache, prompts.shape[0])
    steps = [logits]
    for i in range(1, tokens.shape[1]):
        logits, cache = jeng._decode(params, cache, jnp.asarray(tokens[:, i - 1]),
                                     jnp.asarray(prompts.shape[1] + i - 1, jnp.int32))
        steps.append(logits)
    return np.stack([np.asarray(s, np.float32) for s in steps], 1)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_generate_matches_jax_engine(lm, quantize):
    """Tokens equal the reference engine's, float32 and with int8 weights
    (the stacked w_qkv (2, 128, 384) is the one leaf of 65,536 elements or
    more: its codes and scales bitwise the reference's); every step's
    logits within 1e-4 of max|logit|."""
    jcfg, cfg, params, model, prompts, _ = lm
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW, quantize=quantize)
    want = jeng.generate(jnp.asarray(prompts), NEW).tokens
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, quantize=quantize, device="cpu")
    got = eng.generate(prompts, NEW, keep_logits=True)
    np.testing.assert_array_equal(got.tokens, want)
    jl = _reference_steps(jeng, jeng.params, prompts, want)
    assert _rel(got.logits, jl) <= 1e-4
    if quantize:
        leaves = eng.params["pairs"]
        quantized = sorted(f"{g}.{k}" for g in ("mlstm", "slstm") for k, v in leaves[g].items()
                           if isinstance(v, tq.QuantTensor))
        assert quantized == ["mlstm.w_qkv"] and leaves["mlstm"]["w_qkv"].shape == (2, 128, 384)
        jleaf = jeng.params["pairs"]["mlstm"]["w_qkv"]
        assert isinstance(jleaf, jq.QuantTensor)
        leaf = leaves["mlstm"]["w_qkv"]
        np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jleaf.codes))
        np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jleaf.scale))


def test_generate_equals_full_forward(lm):
    """Greedy generation equals step-by-step argmax of the full forward
    (tests/test_serving.py's check, on the port alone)."""
    _, cfg, _, model, prompts, _ = lm
    toks = torch.from_numpy(prompts).long()
    want = []
    for _ in range(NEW):
        nxt = forward(model, {"tokens": toks}, cfg)[:, -1].argmax(-1)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    got = ServeEngine(cfg, model, max_len=PROMPT + NEW, device="cpu").generate(prompts, NEW)
    np.testing.assert_array_equal(got.tokens, torch.stack(want, 1).numpy())


def test_bf16_generate_holds_the_reference_logits():
    """bf16 weights in both engines (the caches float32 in both): every
    step's logits, the reference's teacher-forced on the port's tokens,
    within BF16_TOL of each row's max|logit|; the tokens equal wherever the
    reference's top-2 gap exceeds BF16_TOL of that row's max|logit|."""
    jcfg, cfg = _cfgs()
    params = jinit(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompts = _prompts(cfg, seed=3)
    eng = ServeEngine(cfg, model, max_len=PROMPT + NEW, dtype=torch.bfloat16, device="cpu")
    got = eng.generate(prompts, NEW, keep_logits=True)
    jeng = JServeEngine(jcfg, params, max_len=PROMPT + NEW, dtype=jnp.bfloat16)
    jl = _reference_steps(jeng, params, prompts, got.tokens)
    assert (_row_rel(got.logits, jl) <= BF16_TOL).all()
    top2 = np.sort(jl, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > BF16_TOL * np.abs(jl).max(-1)
    assert decided.any()
    np.testing.assert_array_equal(got.tokens[decided], jl.argmax(-1)[decided])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bitwise(dtype):
    """Reference tree -> port -> tree, bitwise, and the port's tree of
    tensors back into a model that computes the same logits; bf16 through
    the int16 view."""
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), jcfg, dtype=dtype))
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.pairs[0].slstm.r_gates.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                                                  else torch.float32)
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
def test_cache_spec_matches_the_grown_cache(lm, dtype):
    """The grown cache's leaves have cache_spec's shapes and dtypes, the
    reference's spec's too: all float32 whatever the engine's dtype, and no
    sequence axis, so its bytes at max_len 2,048 and 524,288 are the same
    and the grown cache is the prefill's own tensors."""
    jcfg, cfg, params, model, prompts, _ = lm
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
        assert t.dtype == spec[g][name].dtype == torch.float32
        assert jspec[g][name].dtype == jnp.float32
        assert t is cache[g][name]

    def nbytes(max_len):
        return sum(int(np.prod(s.shape)) * s.dtype.itemsize
                   for group in cache_spec(cfg, 4, max_len, dtype=dtype).values()
                   for s in group.values())

    assert nbytes(2048) == nbytes(524288) > 0
    full = get_arch("xlstm")
    assert cache_spec(full, 4, 2048) == cache_spec(full, 4, 524288)


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    tps = serve.main(["--arch", "xlstm", "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "40", "--max-new", "4"])
    out = capsys.readouterr().out
    assert tps > 0 and "[serve] xlstm-125m f32 on cpu: 2×4 tokens" in out
