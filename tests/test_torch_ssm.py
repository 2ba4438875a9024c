"""The port's Mamba2 (SSD) mixer held against the JAX reference.

Reduced zamba2 (`ArchConfig.reduced()`: d_model 64, d_in 128, 8 SSD heads
of 16, state 16, conv 4, chunk 32) in float32, the reference's weights
carried across with ``params_from_numpy``, inputs from numpy seeds, on the
CPU.  Tolerances, normwise relative (max|port - reference| / max|reference|):
TOL = 1e-5 in float32 (products and cumulative sums in another order,
measured at 1e-7 to 1.5e-6); the port against its own recurrence as
tests/test_mixers.py holds the reference (rtol = atol = 1e-4); bf16 1e-2 (the
projections round to bf16 at other points of the sums).

At zamba2's own chunk of 256 the reference's within-chunk decay overflows
(exp of the whole (l, s) square before the causal mask: inf x 0 = NaN); the
port masks the exponent first.  That case is pinned here: the reference's
output holds NaN, the port's is finite, equal to the reference's where that
is finite and to the reference's own s == 1 recurrence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import init_params as jinit, ssm as jssm
from repro_torch.configs import SSMConfig, get_arch
from repro_torch.models import params_from_numpy, ssm

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 1e-5
BF16_TOL = 1e-2
B = 2


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfgs(chunk=None):
    out = [jget_arch("zamba2").reduced(), get_arch("zamba2").reduced()]
    if chunk is not None:
        out = [dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, chunk=chunk)) for c in out]
    return out


def _layer0(params, model):
    """Layer 0's mixer: the reference's leaves and the port's module."""
    return (jax.tree.map(lambda a: a[0], params["mamba_layers"]["mixer"]),
            model.mamba_layers[0].mixer)


def _x(cfg, s, seed=2, scale=1.0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, s, cfg.d_model)) * scale).astype(np.float32)


def _state(cfg, seed=3):
    """A random incoming state {"conv", "ssd"} of the reference's shapes."""
    d_in, nh, n, cw = jssm._dims(cfg)
    g = np.random.default_rng(seed)
    return {"conv": g.standard_normal((B, cw - 1, d_in + 2 * n)).astype(np.float32),
            "ssd": (g.standard_normal((B, nh, cfg.ssm.head_dim, n)) * 0.5).astype(np.float32)}


def _tstate(st):
    return {k: torch.from_numpy(v.copy()) for k, v in st.items()}


@pytest.fixture(scope="module")
def zamba():
    """(reference cfg, port cfg, JAX float32 params, port model, the
    reference's mamba2_apply jitted for the segment and the stateful
    call)."""
    jcfg, cfg = _cfgs()
    assert (cfg.ssm.chunk, cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.d_model) == (32, 16, 16, 64)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    fresh = jax.jit(lambda p, x: jssm.mamba2_apply(p, x, jcfg, return_state=True))
    carried = jax.jit(lambda p, x, st: jssm.mamba2_apply(p, x, jcfg, state=st))
    return jcfg, cfg, params, model, fresh, carried


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 100])
def test_mamba2_apply_matches_reference(zamba, s, carry):
    """Outputs and both state leaves, from a zero state and from a random
    incoming one, at one step, below, at and above one chunk, and over
    several chunks with a pad."""
    jcfg, cfg, params, model, fresh, carried = zamba
    jp, tp = _layer0(params, model)
    x = _x(cfg, s, seed=s)
    if carry:
        st = _state(cfg, seed=s + 1)
        want, jst = carried(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
        got, tst = ssm.mamba2_apply(tp, torch.from_numpy(x), cfg, state=_tstate(st))
    else:
        want, jst = fresh(jp, jnp.asarray(x))
        got, tst = ssm.mamba2_apply(tp, torch.from_numpy(x), cfg, return_state=True)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    for name in ("conv", "ssd"):
        assert tst[name].shape == jst[name].shape and tst[name].dtype == torch.float32
        assert _rel(tst[name], jst[name]) <= TOL, name


def test_no_state_is_returned_unless_asked(zamba):
    _, cfg, _, model, _, _ = zamba
    out, st = ssm.mamba2_apply(model.mamba_layers[0].mixer, torch.from_numpy(_x(cfg, 5)), cfg)
    assert out.shape == (B, 5, cfg.d_model) and st is None


def _recurrence(tp, x, cfg):
    """The port's own s == 1 recurrence over every step of x (B, S, d)."""
    d_in, nh, n, cw = ssm._dims(cfg)
    st = {"conv": torch.zeros((B, cw - 1, d_in + 2 * n)),
          "ssd": torch.zeros((B, nh, cfg.ssm.head_dim, n))}
    ys = []
    for t in range(x.shape[1]):
        y, st = ssm.mamba2_apply(tp, x[:, t:t + 1], cfg, state=st)
        ys.append(y)
    return torch.cat(ys, 1), st


@pytest.mark.parametrize("s", [32, 64, 100])
def test_chunked_equals_recurrence(zamba, s):
    """The port's twin of tests/test_mixers.py:33: the chunked form against
    S steps of the recurrence, outputs and both final state leaves."""
    _, cfg, _, model, _, _ = zamba
    tp = model.mamba_layers[0].mixer
    x = torch.from_numpy(_x(cfg, s, seed=10 + s, scale=0.5))
    y, st = ssm.mamba2_apply(tp, x, cfg, return_state=True)
    y_step, st_step = _recurrence(tp, x, cfg)
    np.testing.assert_allclose(y.numpy(), y_step.numpy(), rtol=1e-4, atol=1e-4)
    for name in ("conv", "ssd"):
        np.testing.assert_allclose(st[name].numpy(), st_step[name].numpy(), rtol=1e-4, atol=1e-4)


def test_state_carries_across_segments(zamba):
    """The port's twin of tests/test_mixers.py:77: a segment's state handed
    to the next equals one pass (the weak-memory halo in chunk index)."""
    _, cfg, _, model, _, _ = zamba
    tp = model.mamba_layers[0].mixer
    x = torch.from_numpy(_x(cfg, 64, seed=7, scale=0.5))
    y_full, st_full = ssm.mamba2_apply(tp, x, cfg, return_state=True)
    y1, st = ssm.mamba2_apply(tp, x[:, :32], cfg, return_state=True)
    y2, st = ssm.mamba2_apply(tp, x[:, 32:], cfg, state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st["ssd"].numpy(), st_full["ssd"].numpy(), rtol=1e-4, atol=1e-4)


def test_chunk_256_is_finite_where_the_reference_overflows():
    """zamba2's own chunk of 256 at the reduced width, B = 2, S = 300 (two
    chunks, the second padded): the reference's unmasked decay gives NaN;
    the port's output is finite, within TOL of the reference's where that is
    finite, and within TOL of max|y| of the reference's own s == 1
    recurrence, outputs and final SSD state."""
    jcfg, cfg = _cfgs(chunk=256)
    assert isinstance(cfg.ssm, SSMConfig) and isinstance(jcfg.ssm, JSSMConfig)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    jp, tp = _layer0(params, model)
    x = _x(cfg, 300, seed=11)
    want, jst = jax.jit(lambda p, x: jssm.mamba2_apply(p, x, jcfg, return_state=True))(
        jp, jnp.asarray(x))
    want = np.asarray(want)
    finite = np.isfinite(want)
    assert not finite.all(), "the reference no longer overflows at chunk 256"
    got, st = ssm.mamba2_apply(tp, torch.from_numpy(x), cfg, return_state=True)
    got = got.numpy()
    assert np.isfinite(got).all() and np.isfinite(st["ssd"].numpy()).all()
    assert np.abs(got - want)[finite].max() / np.abs(want[finite]).max() <= TOL

    step = jax.jit(lambda p, x, st: jssm.mamba2_apply(p, x, jcfg, state=st))
    d_in, nh, n, cw = jssm._dims(jcfg)
    jst_step = {"conv": jnp.zeros((B, cw - 1, d_in + 2 * n)),
                "ssd": jnp.zeros((B, nh, jcfg.ssm.head_dim, n))}
    ys = []
    for t in range(x.shape[1]):
        y, jst_step = step(jp, jnp.asarray(x[:, t:t + 1]), jst_step)
        ys.append(np.asarray(y))
    rec = np.concatenate(ys, 1)
    assert np.isfinite(rec).all()
    assert np.abs(got - rec).max() <= TOL * np.abs(rec).max()
    ssd = np.asarray(jst_step["ssd"])
    assert np.abs(st["ssd"].numpy() - ssd).max() <= TOL * np.abs(ssd).max()


def test_bf16_mixer_matches_reference():
    """bf16 weights and input over 100 steps (4 chunks, padded): output and
    both state leaves within BF16_TOL normwise of the reference (measured:
    8e-4 for the output)."""
    jcfg, cfg = _cfgs()
    params = jinit(jax.random.PRNGKey(4), jcfg, dtype=jnp.bfloat16)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    jp, tp = _layer0(params, model)
    x = _x(cfg, 100, seed=5)
    want, jst = jax.jit(lambda p, x: jssm.mamba2_apply(p, x, jcfg, return_state=True))(
        jp, jnp.asarray(x, jnp.bfloat16))
    got, st = ssm.mamba2_apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg, return_state=True)
    assert got.dtype == torch.bfloat16 and st["conv"].dtype == torch.bfloat16
    assert st["ssd"].dtype == torch.float32
    assert _rel(got, want) <= BF16_TOL
    assert _rel(st["ssd"], jst["ssd"]) <= BF16_TOL
    assert _rel(st["conv"], jst["conv"]) <= BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_and_state_spec_follow_the_reference(dtype):
    """mamba2_init's shapes and dtypes and the state spec's, against the
    reference's on the same reduced config."""
    jcfg, cfg = _cfgs()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jssm.mamba2_init(jax.random.PRNGKey(0), jcfg, dtype=jdtype)
    got = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, dtype=dtype)
    for name in ssm.NAMES:
        t, w = getattr(got, name), want[name]
        assert tuple(t.shape) == w.shape, name
        assert str(t.dtype).split(".")[-1] == str(w.dtype), name
    np.testing.assert_array_equal(got.A_log.numpy(), 0)
    np.testing.assert_array_equal(got.D.numpy(), 1)
    spec, jspec = ssm.mamba2_state_spec(cfg, 3, dtype), jssm.mamba2_state_spec(jcfg, 3, jdtype)
    for name in ("conv", "ssd"):
        assert tuple(spec[name].shape) == jspec[name].shape
        assert str(spec[name].dtype).split(".")[-1] == str(jspec[name].dtype)
