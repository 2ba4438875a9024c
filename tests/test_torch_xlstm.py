"""The port's xLSTM mixers (mLSTM, sLSTM) held against the JAX reference.

Reduced xlstm-125m (`ArchConfig.reduced()`: d_model 64, 4 heads; the
mLSTM's d_in 128 in heads of 32, the sLSTM's heads of 16) in float32, the
reference's weights carried across with ``params_from_numpy``, inputs from
numpy seeds, on the CPU.  Tolerances, normwise relative (max|port -
reference| / max|reference|): TOL = 1e-5 in float32 (products and
cumulative sums in another order; measured at 4e-8 to 1.4e-6); the
chunked form against the port's own recurrence and a segment carry as
tests/test_mixers.py holds the reference's (rtol = atol = 2e-4, and 1e-5
for the sLSTM's carry, the same steps in the same order); bf16 BF16_TOL =
1e-2 (the projections round to bf16 at other points of their sums;
measured at 1.9e-3 at most; the states are float32 on both sides).  The
pins of the sLSTM's head-major gate columns and of its tanh GELU read
1.1 and 1.9e-3 on the wrong forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit, xlstm as jx
from repro_torch.configs import get_arch
from repro_torch.models import params_from_numpy, xlstm

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = 1e-5
BF16_TOL = 1e-2
B = 2
M_LEAVES, S_LEAVES = ("C", "n", "m"), ("h", "c", "n", "m")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfgs():
    return jget_arch("xlstm").reduced(), get_arch("xlstm").reduced()


def _x(cfg, s, seed=2, scale=1.0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, s, cfg.d_model)) * scale).astype(np.float32)


def _mstate(cfg, seed=3):
    """A random incoming mLSTM state {"C", "n", "m"} of the reference's
    shapes (m finite, of either sign)."""
    nh, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    g = np.random.default_rng(seed)
    return {"C": (g.standard_normal((B, nh, hd, hd)) * 0.5).astype(np.float32),
            "n": g.standard_normal((B, nh, hd)).astype(np.float32),
            "m": g.standard_normal((B, nh)).astype(np.float32)}


def _sstate(cfg, seed=4):
    """A random incoming sLSTM state: h, c of either sign, n >= 1, m."""
    shape = (B, cfg.n_heads, cfg.d_model // cfg.n_heads)
    g = np.random.default_rng(seed)
    return {"h": (g.standard_normal(shape) * 0.3).astype(np.float32),
            "c": g.standard_normal(shape).astype(np.float32),
            "n": (1.0 + g.random(shape)).astype(np.float32),
            "m": g.standard_normal(shape).astype(np.float32)}


def _t(st):
    return {k: torch.from_numpy(v.copy()) for k, v in st.items()}


@pytest.fixture(scope="module")
def mixers():
    """(reference cfg, port cfg, pair 0's reference mLSTM and sLSTM leaves,
    the port's MLSTM and SLSTM modules)."""
    jcfg, cfg = _cfgs()
    assert (cfg.n_layers, cfg.slstm_every, cfg.d_model, cfg.n_heads) == (2, 2, 64, 4)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    pair = jax.tree.map(lambda a: a[0], params["pairs"])
    return jcfg, cfg, pair["mlstm"], pair["slstm"], model.pairs[0].mlstm, model.pairs[0].slstm


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("s", [50, 64, 100])
def test_mlstm_apply_matches_reference(mixers, s, chunk, carry):
    """Output and every state leaf, from the fresh state and from a random
    incoming one; S = 50 and 100 leave a pad at both chunks."""
    jcfg, cfg, jp, _, tp, _ = mixers
    x = _x(cfg, s, seed=s + chunk)
    if carry:
        st = _mstate(cfg, seed=s)
        want, jst = jx.mlstm_apply(jp, jnp.asarray(x), jcfg, chunk=chunk,
                                   state=jax.tree.map(jnp.asarray, st))
        got, tst = xlstm.mlstm_apply(tp, torch.from_numpy(x), cfg, chunk=chunk, state=_t(st))
    else:
        want, jst = jx.mlstm_apply(jp, jnp.asarray(x), jcfg, chunk=chunk, return_state=True)
        got, tst = xlstm.mlstm_apply(tp, torch.from_numpy(x), cfg, chunk=chunk,
                                     return_state=True)
    assert got.shape == want.shape and _rel(got, want) <= TOL
    for name in M_LEAVES:
        assert tst[name].shape == jst[name].shape and tst[name].dtype == torch.float32
        assert _rel(tst[name], jst[name]) <= TOL, name


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
def test_mlstm_step_matches_reference(mixers, carry):
    """S == 1: the O(1) recurrence, from the fresh state (m = -1e30) and a
    random one."""
    jcfg, cfg, jp, _, tp, _ = mixers
    x = _x(cfg, 1, seed=9)
    st = _mstate(cfg, seed=10) if carry else None
    want, jst = jx.mlstm_apply(jp, jnp.asarray(x), jcfg, return_state=True,
                               state=None if st is None else jax.tree.map(jnp.asarray, st))
    got, tst = xlstm.mlstm_apply(tp, torch.from_numpy(x), cfg, return_state=True,
                                 state=None if st is None else _t(st))
    assert _rel(got, want) <= TOL
    for name in M_LEAVES:
        assert _rel(tst[name], jst[name]) <= TOL, name


def _mlstm_recurrence(tp, x, cfg):
    """The port's own s == 1 recurrence over every step of x (B, S, d)."""
    st = {k: torch.zeros(s.shape) for k, s in xlstm.mlstm_state_spec(cfg, B).items()}
    st["m"].fill_(-1e30)
    ys = []
    for t in range(x.shape[1]):
        y, st = xlstm.mlstm_apply(tp, x[:, t:t + 1], cfg, state=st)
        ys.append(y)
    return torch.cat(ys, 1), st


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (32, 32), (100, 32)])
def test_mlstm_chunked_equals_recurrence(mixers, s, chunk):
    """The port's twin of tests/test_mixers.py:48: the chunked form against
    S steps of the recurrence, the output and the final state, its C and n
    compared as C e^m and n e^m (the stabiliser's split of the scale is
    the form's own)."""
    _, cfg, _, _, tp, _ = mixers
    x = torch.from_numpy(_x(cfg, s, seed=20 + s, scale=0.5))
    y, st = xlstm.mlstm_apply(tp, x, cfg, chunk=chunk, return_state=True)
    y_step, st_step = _mlstm_recurrence(tp, x, cfg)
    np.testing.assert_allclose(y.numpy(), y_step.numpy(), rtol=2e-4, atol=2e-4)
    for name, shape in (("C", (..., None, None)), ("n", (..., None))):
        a = st[name] * torch.exp(st["m"])[shape]
        b = st_step[name] * torch.exp(st_step["m"])[shape]
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def test_mlstm_state_carries_across_segments(mixers):
    """The port's twin of tests/test_mixers.py:64: a segment's state handed
    to the next equals one pass."""
    _, cfg, _, _, tp, _ = mixers
    x = torch.from_numpy(_x(cfg, 64, seed=5, scale=0.5))
    y_full, _ = xlstm.mlstm_apply(tp, x, cfg, return_state=True, chunk=16)
    y1, st = xlstm.mlstm_apply(tp, x[:, :32], cfg, return_state=True, chunk=16)
    y2, _ = xlstm.mlstm_apply(tp, x[:, 32:], cfg, state=st, chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_no_state_is_returned_unless_asked(mixers):
    _, cfg, _, _, tm, ts = mixers
    x = torch.from_numpy(_x(cfg, 5))
    for apply, p in ((xlstm.mlstm_apply, tm), (xlstm.slstm_apply, ts)):
        out, st = apply(p, x, cfg)
        assert out.shape == x.shape and st is None
        out, st = apply(p, x[:, :1], cfg)
        assert st is None


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("s", [1, 40])
def test_slstm_apply_matches_reference(mixers, s, carry):
    """Output and the four state leaves, from the fresh state (h = c = 0, n
    = 1, m = 0) and from a random one."""
    jcfg, cfg, _, jp, _, tp = mixers
    x = _x(cfg, s, seed=30 + s)
    st = _sstate(cfg, seed=s) if carry else None
    want, jst = jx.slstm_apply(jp, jnp.asarray(x), jcfg, return_state=True,
                               state=None if st is None else jax.tree.map(jnp.asarray, st))
    got, tst = xlstm.slstm_apply(tp, torch.from_numpy(x), cfg, return_state=True,
                                 state=None if st is None else _t(st))
    assert got.shape == want.shape and _rel(got, want) <= TOL
    for name in S_LEAVES:
        assert tst[name].shape == jst[name].shape and tst[name].dtype == torch.float32
        assert _rel(tst[name], jst[name]) <= TOL, name


def test_slstm_state_carries_across_segments(mixers):
    """The port's twin of tests/test_mixers.py:89: 20 steps, then 20 more
    from their state, against all 40 at once, within 1e-5."""
    _, cfg, _, _, _, tp = mixers
    x = torch.from_numpy(_x(cfg, 40, seed=8, scale=0.5))
    y, st = xlstm.slstm_apply(tp, x, cfg, return_state=True)
    assert torch.isfinite(y).all()
    y1, st1 = xlstm.slstm_apply(tp, x[:, :20], cfg, return_state=True)
    y2, st2 = xlstm.slstm_apply(tp, x[:, 20:], cfg, state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    for name in S_LEAVES:
        np.testing.assert_allclose(st2[name].numpy(), st[name].numpy(), rtol=1e-5, atol=1e-5)


def _four_block(w, nh, hd):
    """w_gates with its columns moved so that the port's head-major reading
    of it is the four-d-wide-block reading of ``w``: gate g of head h is
    block g's columns [h hd, (h + 1) hd)."""
    d = nh * hd
    cols = [g * d + h * hd + j for h in range(nh) for g in range(4) for j in range(hd)]
    return w[:, cols]


def test_slstm_gate_columns_are_head_major(mixers):
    """w_gates column j belongs to head j // (4 hd) and gate (j mod 4 hd) //
    hd.  With the recurrent weights zero and only head 0's z columns set,
    the cell c moves in head 0 alone (a four-block split reads those
    columns as head 2's input gate, and no c moves).  The same weights read
    in four blocks (their columns moved by :func:`_four_block`) lie far
    from the reference, so the parity test tells the layouts apart."""
    jcfg, cfg, _, jp, _, tp = mixers
    nh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    w = torch.zeros_like(tp.w_gates)
    w[:, 2 * hd:3 * hd] = 1.0  # head 0's z gate
    probe = xlstm.SLSTM(w, torch.zeros_like(tp.r_gates), tp.gate_norm, tp.up_proj,
                        tp.down_proj)
    x = torch.from_numpy(_x(cfg, 6, seed=12)).abs()
    _, st = xlstm.slstm_apply(probe, x, cfg, return_state=True)
    assert (st["c"][:, 0] != 0).all() and not st["c"][:, 1:].any()

    want, _ = jx.slstm_apply(jp, jnp.asarray(_x(cfg, 20, seed=13)), jcfg)
    moved = xlstm.SLSTM(_four_block(tp.w_gates, nh, hd), tp.r_gates, tp.gate_norm,
                        tp.up_proj, tp.down_proj)
    wrong, _ = xlstm.slstm_apply(moved, torch.from_numpy(_x(cfg, 20, seed=13)), cfg)
    assert _rel(wrong, want) > 100 * TOL


def test_slstm_ffn_gelu_is_the_tanh_form(mixers, monkeypatch):
    """The FFN's GELU is jax.nn.gelu's default, the tanh approximation:
    the port holds the reference at TOL, and with torch's exact GELU in its
    place it does not."""
    jcfg, cfg, _, jp, _, tp = mixers
    x = _x(cfg, 12, seed=14, scale=3.0)
    want, _ = jx.slstm_apply(jp, jnp.asarray(x), jcfg)
    got, _ = xlstm.slstm_apply(tp, torch.from_numpy(x), cfg)
    assert _rel(got, want) <= TOL
    gelu = xlstm.F.gelu
    monkeypatch.setattr(xlstm.F, "gelu", lambda u, approximate="none": gelu(u))
    exact, _ = xlstm.slstm_apply(tp, torch.from_numpy(x), cfg)
    assert _rel(exact, want) > 10 * TOL


def test_bf16_mixers_match_reference():
    """bf16 weights and input: the mLSTM over 100 steps (chunked, padded)
    and one step, the sLSTM over 40; outputs (bf16) within BF16_TOL and the
    float32 states within BF16_TOL of the reference's bf16 run."""
    jcfg, cfg = _cfgs()
    params = jinit(jax.random.PRNGKey(4), jcfg, dtype=jnp.bfloat16)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    pair = jax.tree.map(lambda a: a[0], params["pairs"])
    for s, japply, apply, jp, tp, names in (
            (100, jx.mlstm_apply, xlstm.mlstm_apply, pair["mlstm"], model.pairs[0].mlstm,
             M_LEAVES),
            (1, jx.mlstm_apply, xlstm.mlstm_apply, pair["mlstm"], model.pairs[0].mlstm,
             M_LEAVES),
            (40, jx.slstm_apply, xlstm.slstm_apply, pair["slstm"], model.pairs[0].slstm,
             S_LEAVES)):
        x = _x(cfg, s, seed=15 + s)
        want, jst = japply(jp, jnp.asarray(x, jnp.bfloat16), jcfg, return_state=True)
        got, st = apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg, return_state=True)
        assert got.dtype == torch.bfloat16 and _rel(got, want) <= BF16_TOL, s
        for name in names:
            assert st[name].dtype == torch.float32 and _rel(st[name], jst[name]) <= BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_and_state_specs_follow_the_reference(dtype):
    """mlstm_init's and slstm_init's shapes and dtypes, and both state
    specs (all float32), against the reference's on the reduced config
    and xlstm-125m's own widths."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for jcfg, cfg in (_cfgs(), (jget_arch("xlstm"), get_arch("xlstm"))):
        for jinit_, init, names in ((jx.mlstm_init, xlstm.mlstm_init, xlstm.MLSTM_NAMES),
                                    (jx.slstm_init, xlstm.slstm_init, xlstm.SLSTM_NAMES)):
            want = jax.eval_shape(lambda k: jinit_(k, jcfg, dtype=jdtype), jax.random.PRNGKey(0))
            got = init(torch.Generator().manual_seed(0), cfg, dtype=dtype)
            for name in names:
                t, w = getattr(got, name), want[name]
                assert tuple(t.shape) == w.shape, name
                assert str(t.dtype).split(".")[-1] == str(w.dtype), name
        for jspec_fn, spec_fn in ((jx.mlstm_state_spec, xlstm.mlstm_state_spec),
                                  (jx.slstm_state_spec, xlstm.slstm_state_spec)):
            spec, jspec = spec_fn(cfg, 3), jspec_fn(jcfg, 3)
            assert set(spec) == set(jspec)
            for name in spec:
                assert tuple(spec[name].shape) == jspec[name].shape
                assert spec[name].dtype == torch.float32 and jspec[name].dtype == jnp.float32
    got = xlstm.slstm_init(torch.Generator().manual_seed(0), _cfgs()[1], dtype=dtype)
    np.testing.assert_array_equal(got.gate_norm.float().numpy(), 1)
    r = got.r_gates.float()
    assert 0.8 < r.std().item() * 4 < 1.2  # hd^-0.5 = 1/4 at hd 16
