"""The port's sliding-window attention held against the JAX reference.

Kernel 8's plain versions -- dense (`swa_attention_ref`) and chunked
(`swa_attention_chunked`, the semantics of the reference model's
`_chunked_attention`) -- and the kernel wrapper on CPU tensors, where it
runs the chunked version.  The JAX side runs the Pallas kernel in interpret
mode in a few cases and its dense oracle `swa_attention_reference` in the
rest, over the grid of `tests/test_kernels.py` (windows 1, 16, 70 and one
at least S; S = 128, 250, 300; GQA groups 1, 2, 4).  Tolerances are those
of the reference's tests: float32 rtol 1e-4 / atol 2e-5, bfloat16 2e-2.
Inputs come from numpy with a seed.  The JAX layout is (B, H, S, D), the
port's (B, S, H, D).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import ops as jswa
from repro.models.attention import _chunked_attention
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.swa_attention import ops as sw, ref as swr

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs

TOL = {"f32": dict(rtol=1e-4, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
NP_DTYPE = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
T_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(s, group, d=16, kvh=2, b=1, seed=0, dtype="f32"):
    """(q (B, H, S, D), k, v (B, KVH, S, D)) numpy in the JAX layout."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, s, d)).astype(np.float32).astype(NP_DTYPE[dtype])
                 for n in (kvh * group, kvh, kvh))


def _port(a, dtype="f32"):
    """JAX layout (B, N, S, D) -> the port's (B, S, N, D) tensor."""
    a = np.ascontiguousarray(np.swapaxes(a, 1, 2))
    if dtype == "bf16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _jax_layout(t):
    return np.swapaxes(t.float().numpy(), 1, 2)


@pytest.mark.parametrize("window", [1, 16, 70, 400])
@pytest.mark.parametrize("s", [128, 250, 300])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_versions_match_reference_f32(window, s, group):
    q, k, v = _qkv(s, group, seed=s + window + group)
    want = np.asarray(jswa.swa_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), window))
    tq, tk, tv = (_port(a) for a in (q, k, v))
    for got in (swr.swa_attention_ref(tq, tk, tv, window),
                swr.swa_attention_chunked(tq, tk, tv, window, chunk=64)):
        np.testing.assert_allclose(_jax_layout(got), want, **TOL["f32"])


@pytest.mark.parametrize("window", [1, 16, 70, 400])
@pytest.mark.parametrize("group", [1, 4])
def test_plain_versions_match_reference_bf16(window, group):
    q, k, v = _qkv(250, group, seed=window + group, dtype="bf16")
    want = np.asarray(jswa.swa_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), window)).astype(np.float32)
    tq, tk, tv = (_port(a, "bf16") for a in (q, k, v))
    for got in (swr.swa_attention_ref(tq, tk, tv, window),
                swr.swa_attention_chunked(tq, tk, tv, window, chunk=64)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_jax_layout(got), want, **TOL["bf16"])


@pytest.mark.parametrize("s,window,group", [(128, 16, 2), (250, 70, 4), (300, 1, 1)])
def test_plain_versions_match_pallas_interpret(s, window, group):
    """The Pallas kernel itself (interpret mode, padded to its 64-row tiles)."""
    q, k, v = _qkv(s, group, seed=7 * s + window)
    want = np.asarray(jswa.swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
                                         block_q=64, block_k=64, interpret=True))
    tq, tk, tv = (_port(a) for a in (q, k, v))
    for got in (swr.swa_attention_ref(tq, tk, tv, window), sw.swa_attention(tq, tk, tv, window)):
        np.testing.assert_allclose(_jax_layout(got), want, **TOL["f32"])


@pytest.mark.parametrize("window", [None, 1, 48, 100])
@pytest.mark.parametrize("chunk", [32, 64, 100])
def test_chunked_matches_reference_chunked_attention(window, chunk):
    """`swa_attention_chunked` against the model's `_chunked_attention` at
    chunk < S, with its clipped key slice of width window + chunk."""
    s, group, d, kvh = 300, 4, 16, 2
    q, k, v = _qkv(s, group, d=d, kvh=kvh, seed=chunk)
    # the model's layout: q (B, S, KVH, G, D), k / v (B, S, KVH, D)
    qm = np.swapaxes(q, 1, 2).reshape(1, s, kvh, group, d)
    km, vm = np.swapaxes(k, 1, 2), np.swapaxes(v, 1, 2)
    want = np.asarray(_chunked_attention(jnp.asarray(qm), jnp.asarray(km), jnp.asarray(vm),
                                         d**-0.5, window=window, chunk=chunk))
    got = swr.swa_attention_chunked(_port(q), _port(k), _port(v), window, chunk=chunk)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, **TOL["f32"])


def test_wrapper_runs_the_chunked_plain_version_on_cpu():
    q, k, v = (_port(a) for a in _qkv(250, 4, seed=3))
    reset_launch_counts()
    got = sw.swa_attention(q, k, v, 70)
    assert launch_counts()["swa_attention"] == 0
    assert torch.equal(got, swr.swa_attention_chunked(q, k, v, 70))
    # a window of at least S is plain causal attention
    assert torch.equal(sw.swa_attention(q, k, v, 250), swr.swa_attention_chunked(q, k, v, None))


def test_wrapper_raises_on_grad_and_bad_shapes():
    q, k, v = (_port(a) for a in _qkv(64, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        sw.swa_attention(q.requires_grad_(True), k, v, 8)
    q.requires_grad_(False)
    with pytest.raises(ValueError, match="H % KVH"):
        sw.swa_attention(q[:, :, :3].contiguous(), k, v, 8)
    with pytest.raises(ValueError, match="window"):
        sw.swa_attention(q, k, v, 0)


def test_valid_pairs_and_row_scale():
    assert swr.valid_pairs(8000, 4096) == 24_381_440
    assert swr.valid_pairs(10, 20) == 55
    v = _port(_qkv(40, 1, kvh=3, seed=4)[2])
    scale = swr.swa_row_scale(v, 5, 6)
    for s in (0, 3, 4, 39):
        for h in range(6):
            assert scale[0, s, h, 0] == v[0, max(0, s - 4): s + 1, h // 2].abs().max()


# ------------------------------------------- q/k and v of different widths --

def _qkv_dv(s, group, dk, dv, kvh=2, seed=0):
    """(q (B, H, S, DK), k (B, KVH, S, DK), v (B, KVH, S, DV)) numpy in the JAX
    layout: multi-head latent attention's shapes (q/k 192, v 128) and a
    small pair."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, n, s, d)).astype(np.float32)
                 for n, d in ((kvh * group, dk), (kvh, dk), (kvh, dv)))


@pytest.mark.parametrize("window", [None, 1, 37, 100])
@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128)])
def test_plain_versions_take_a_v_narrower_than_q(dk, dv, window):
    """Both plain versions against the model's `_chunked_attention` at DK !=
    DV, with and without a window, S below and above the chunk: out (B, S,
    H, DV)."""
    s, group, kvh, chunk = 150, 2, 2, 64
    q, k, v = _qkv_dv(s, group, dk, dv, kvh=kvh, seed=dk + (window or 0))
    qm = np.swapaxes(q, 1, 2).reshape(1, s, kvh, group, dk)
    km, vm = np.swapaxes(k, 1, 2), np.swapaxes(v, 1, 2)
    want = np.asarray(_chunked_attention(jnp.asarray(qm), jnp.asarray(km), jnp.asarray(vm),
                                         dk**-0.5, window=window, chunk=chunk))
    want = want.reshape(1, s, kvh * group, dv)
    tq, tk, tv = (_port(a) for a in (q, k, v))
    chunked = swr.swa_attention_chunked(tq, tk, tv, window, chunk=chunk)
    dense = swr.swa_attention_ref(tq, tk, tv, s if window is None else window)
    wrapper = sw.swa_attention(tq, tk, tv, s if window is None else window)
    for got in (chunked, dense, wrapper):
        assert tuple(got.shape) == (1, s, kvh * group, dv)
        np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


@pytest.mark.parametrize("s,window,group,dk,dv", [(128, 16, 2, 24, 16), (100, 100, 1, 192, 128),
                                                  (130, 40, 4, 192, 128)])
def test_narrow_v_matches_pallas_interpret_on_v_padded_to_dk(s, window, group, dk, dv):
    """The Pallas kernel (interpret mode) takes one D: v padded with zero
    columns to DK gives the same function, sliced back to DV."""
    q, k, v = _qkv_dv(s, group, dk, dv, seed=s + dk)
    vpad = np.concatenate([v, np.zeros(v.shape[:3] + (dk - dv,), np.float32)], -1)
    want = np.asarray(jswa.swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vpad),
                                         window, block_q=64, block_k=64, interpret=True))
    want = np.swapaxes(want[..., :dv], 1, 2)
    tq, tk, tv = (_port(a) for a in (q, k, v))
    for got in (swr.swa_attention_ref(tq, tk, tv, window), sw.swa_attention(tq, tk, tv, window)):
        np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


def test_wrapper_rejects_heads_wider_than_the_kernel():
    """q/k above 192 or v above 128 raise on every device (the kernel has no
    instantiation for them); 192 / 128 itself runs."""
    q, k, v = (_port(a) for a in _qkv_dv(16, 1, 200, 128))
    with pytest.raises(ValueError, match="up to 192"):
        sw.swa_attention(q, k, v, 8)
    q, k, v = (_port(a) for a in _qkv_dv(16, 1, 192, 136))
    with pytest.raises(ValueError, match="up to 128"):
        sw.swa_attention(q, k, v, 8)
    q, k, v = (_port(a) for a in _qkv_dv(16, 1, 192, 128))
    assert tuple(sw.swa_attention(q, k, v, 8).shape) == (1, 16, 2, 128)
    with pytest.raises(ValueError, match="KVH"):  # v's heads must be k's
        sw.swa_attention(q, k, v[:, :, :1].contiguous(), 8)
