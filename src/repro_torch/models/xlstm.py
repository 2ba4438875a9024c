"""xLSTM mixers (port of `repro.models.xlstm`, Beck et al. 2024,
arXiv:2405.04517): the mLSTM (matrix memory, chunkwise-parallel) and the
sLSTM (scalar memory, a true recurrence over time).

mLSTM: C_t = f_t C_{t-1} + i_t v_t k_t^T, h_t = o_t (C_t q_t / max(|n_t .
q_t|, exp(-m_t))), with exponential gating and the max-stabiliser m_t.  A
segment longer than one step runs the exact chunkwise form, a loop over
chunks carrying the (C, n, m) state in float32 (weak memory in chunk
index); one step runs the O(1) recurrence.  The log weights of the
within-chunk sources are masked to -inf above the diagonal before their
exp, as in the reference.

sLSTM: per-head scalar memory (h, c, n, m) with block-diagonal recurrent
weights, run as an eager loop over time steps; the block carries its own
2x FFN (tanh-approximated GELU, as ``jax.nn.gelu``).

Both compute in ``torch`` alone: the reference's mixers are ``jnp`` and
``lax.scan``, outside any Pallas kernel.  Where the reference rounds to
the model's dtype (the gate projections, the decode step's v k^T and
scaled q, the mixer outputs before their norms), the port rounds there
too, so bf16 models agree with it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import TensorSpec
from .layers import DTYPE, dense_init, rms_norm, weight

__all__ = ["MLSTM", "SLSTM", "mlstm_init", "mlstm_apply", "mlstm_state_spec", "slstm_init",
           "slstm_apply", "slstm_state_spec", "MLSTM_NAMES", "SLSTM_NAMES"]

State = Dict[str, torch.Tensor]
MLSTM_NAMES = ("up_proj", "w_qkv", "w_if", "gate_norm", "down_proj")
SLSTM_NAMES = ("w_gates", "r_gates", "gate_norm", "up_proj", "down_proj")
NEG = -1e30  # the reference's "minus infinity" of a fresh stabiliser and a padded input gate
_S_KEYS = ("h", "c", "n", "m")


# ------------------------------------------------------------ mLSTM ----


class MLSTM(nn.Module):
    """The mLSTM block's leaves, d_in = 2 d_model, nh heads of hd = d_in /
    nh: up_proj (d, 2 d_in) [x, z gate], w_qkv (d_in, 3 d_in), w_if (d_in, 2
    nh) [input, forget], gate_norm (d_in,), down_proj (d_in, d)."""

    def __init__(self, up_proj, w_qkv, w_if, gate_norm, down_proj):
        super().__init__()
        self.up_proj, self.w_qkv, self.w_if = weight(up_proj), weight(w_qkv), weight(w_if)
        self.gate_norm, self.down_proj = weight(gate_norm), weight(down_proj)


def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    d_in = 2 * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def mlstm_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> MLSTM:
    """The reference's shapes, dtypes and scales (1 / sqrt(fan-in), the
    gate norm at 1)."""
    d = cfg.d_model
    d_in, nh, _ = _mlstm_dims(cfg)
    return MLSTM(dense_init(gen, d, 2 * d_in, dtype, device),
                 dense_init(gen, d_in, 3 * d_in, dtype, device),
                 dense_init(gen, d_in, 2 * nh, dtype, device),
                 torch.ones((d_in,), dtype=dtype, device=device),
                 dense_init(gen, d_in, d, dtype, device))


def _log_weights(cf: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    """The log weight of source s for target l within a chunk, cf[l] - cf[s]
    + li[s] for s <= l, -inf above the diagonal (set before any exp):
    cf (..., L) the inclusive within-chunk sum of log f, li (..., L) the
    log input gates -> (..., L, L)."""
    chunk = cf.shape[-1]
    upper = torch.ones((chunk, chunk), dtype=torch.bool, device=cf.device).triu_(1)
    return (cf[..., :, None] - cf[..., None, :] + li[..., None, :]).masked_fill_(
        upper, float("-inf"))


def _mlstm_chunk_scan(q, k, v, log_f, log_i, C, n, m, chunk: int):
    """The exact chunkwise mLSTM over a segment whose length is a multiple
    of ``chunk``: q, k, v (B, nh, S, hd) float32, log_f, log_i (B, nh, S),
    the carry C (B, nh, hd, hd), n (B, nh, hd), m (B, nh) -> (h (B, nh, S,
    hd), (C, n, m) after the segment).  Each chunk's outputs read the carry
    that entered it; the carry then takes the chunk's sources."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    s = q.shape[2]
    hs = []
    for c0 in range(0, s, chunk):
        qk, kk, vk = (t[:, :, c0:c0 + chunk] for t in (q, k, v))
        li = log_i[..., c0:c0 + chunk]
        cf = torch.cumsum(log_f[..., c0:c0 + chunk], -1)  # inclusive, within the chunk
        logw = _log_weights(cf, li)
        log_cross = cf + m[..., None]  # the carry's decay to each target
        finite = torch.where(torch.isfinite(logw), logw, float("-inf"))
        m_new = torch.maximum(finite.amax(-1), log_cross)  # (B, nh, L)
        w = torch.exp(logw - m_new[..., None])
        cross_scale = torch.exp(log_cross - m_new)

        sw = (qk @ kk.transpose(-1, -2)) * scale * w  # scores times their weights
        num = sw @ vk + (qk @ C.transpose(-1, -2)) * scale * cross_scale[..., None]
        den = sw.sum(-1) + (qk @ n[..., None])[..., 0] * scale * cross_scale
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])

        # the chunk-end state
        tot_f = cf[..., -1]  # (B, nh)
        src = tot_f[..., None] - cf + li  # each source's log weight at the chunk's end
        m_next = torch.maximum(tot_f + m, src.amax(-1))
        carry_scale = torch.exp(tot_f + m - m_next)
        src_w = torch.exp(src - m_next[..., None])  # (B, nh, L)
        C = C * carry_scale[..., None, None] + (vk * src_w[..., None]).transpose(-1, -2) @ kk
        n = n * carry_scale[..., None] + (src_w[..., None, :] @ kk)[..., 0, :]
        m = m_next
    return torch.cat(hs, 2), (C, n, m)


def _mlstm_step(q, k, v, log_f, log_i, C0, n0, m0) -> Tuple[torch.Tensor, State]:
    """One step of the recurrence: q, k, v (B, nh, hd) in the model's dtype,
    log_f, log_i (B, nh) float32 -> (h (B, nh, hd) float32, the state).
    v k^T and q hd^-0.5 are formed in the model's dtype before they meet the
    float32 state, as in the reference."""
    hd = q.shape[-1]
    lf_m = log_f + m0
    m_new = torch.maximum(lf_m, log_i)
    decay = torch.exp(lf_m - m_new)
    gain = torch.exp(log_i - m_new)
    C = C0 * decay[..., None, None] + gain[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = n0 * decay[..., None] + gain[..., None] * k
    qs = q * torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)
    num = (C @ qs.to(C.dtype)[..., None])[..., 0]
    den = (n * qs).sum(-1).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, {"C": C, "n": n, "m": m_new}


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg, *, state: Optional[State] = None,
                return_state: bool = False, chunk: int = 64
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d) -> (out (B, S, d), the state {"C", "n", "m"} or None).

    S == 1 runs the recurrence, a longer segment the chunked form with
    chunk = min(``chunk``, S), the segment padded to a multiple of it with
    steps that change nothing (log f = 0, log i = -1e30).  ``state`` (from
    an earlier segment or step) is carried in; the new state is returned
    with ``return_state`` or when ``state`` was given."""
    b, s, d = x.shape
    d_in, nh, hd = _mlstm_dims(cfg)

    xm, z = torch.chunk(x @ p.up_proj, 2, dim=-1)
    q, k, v = (t.reshape(b, s, nh, hd) for t in torch.chunk(xm @ p.w_qkv, 3, dim=-1))
    log_i, f_raw = torch.chunk((xm @ p.w_if).float(), 2, dim=-1)  # (B, S, nh) each
    log_f = F.logsigmoid(f_raw)

    if state is None:
        C0 = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        m0 = torch.full((b, nh), NEG, dtype=torch.float32, device=x.device)
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]

    if s == 1:
        h, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0],
                                   C0, n0, m0)
        h = h[:, None]
    else:
        chunk = min(chunk, s)
        pad = (-s) % chunk
        q, k, v = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2).contiguous()
                   for t in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad)).transpose(1, 2)
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG).transpose(1, 2)
        h, (C, n, m) = _mlstm_chunk_scan(q, k, v, log_f, log_i, C0, n0, m0, chunk)
        h = h.transpose(1, 2)[:, :s]
        new_state = {"C": C, "n": n, "m": m}

    h = h.reshape(b, s, d_in).to(x.dtype)
    h = h * F.silu(z.float()).to(x.dtype)
    out = rms_norm(h, p.gate_norm, cfg.norm_eps) @ p.down_proj
    return out, (new_state if (return_state or state is not None) else None)


def mlstm_state_spec(cfg, batch: int) -> Dict[str, TensorSpec]:
    """All float32, whatever the model's dtype."""
    _, nh, hd = _mlstm_dims(cfg)
    return {"C": TensorSpec((batch, nh, hd, hd), torch.float32),
            "n": TensorSpec((batch, nh, hd), torch.float32),
            "m": TensorSpec((batch, nh), torch.float32)}


# ------------------------------------------------------------ sLSTM ----


class SLSTM(nn.Module):
    """The sLSTM block's leaves, nh heads of hd = d / nh: w_gates (d, 4 d),
    whose columns are head-major, each head's 4 hd columns its (i, f, z,
    o) gates; r_gates (nh, hd, 4 hd), block-diagonal per head; gate_norm
    (d,); the FFN's up_proj (d, 2 d) and down_proj (2 d, d)."""

    def __init__(self, w_gates, r_gates, gate_norm, up_proj, down_proj):
        super().__init__()
        self.w_gates, self.r_gates, self.gate_norm = (weight(w_gates), weight(r_gates),
                                                      weight(gate_norm))
        self.up_proj, self.down_proj = weight(up_proj), weight(down_proj)


def slstm_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> SLSTM:
    """The reference's shapes, dtypes and scales (r_gates at hd^-0.5)."""
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    return SLSTM(dense_init(gen, d, 4 * d, dtype, device),
                 (torch.randn((nh, hd, 4 * hd), generator=gen, device=device)
                  * hd ** -0.5).to(dtype),
                 torch.ones((d,), dtype=dtype, device=device),
                 dense_init(gen, d, 2 * d, dtype, device),
                 dense_init(gen, 2 * d, d, dtype, device))


def _slstm_fresh(b: int, nh: int, hd: int, device) -> State:
    """The fresh state: h = c = 0, n = 1, m = 0."""
    return {k: torch.full((b, nh, hd), float(k == "n"), dtype=torch.float32, device=device)
            for k in _S_KEYS}


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg, *, state: Optional[State] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d) -> (out (B, S, d), the state {"h", "c", "n", "m"} or
    None): the recurrence (:func:`_slstm_scan`), then the gate norm and the
    FFN.  ``state`` is carried in; the new state is returned with
    ``return_state`` or when ``state`` was given."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh

    wx = (x @ p.w_gates).reshape(b, s, nh, 4 * hd)  # head-major gate columns
    st = _slstm_fresh(b, nh, hd, x.device) if state is None else state
    hs, state_out = _slstm_scan(wx.float().permute(1, 2, 0, 3).contiguous(),
                                *(st[k].float().transpose(0, 1) for k in _S_KEYS),
                                p.r_gates.float())
    y = hs.permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype)
    out = _slstm_ffn(p, rms_norm(y, p.gate_norm, cfg.norm_eps))
    new_state = {k: t.transpose(0, 1) for k, t in zip(_S_KEYS, state_out)}
    return out, (new_state if (return_state or state is not None) else None)


def _slstm_scan(wx, h, c, n, m, r) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The recurrence, one step at a time, in a (nh, B, hd) layout: wx (S,
    nh, B, 4 hd) float32 input gates, the state h, c, n, m (nh, B, hd), r
    (nh, hd, 4 hd) -> (h of every step (S, nh, B, hd), the final (h, c, n,
    m)).  Each step's recurrent product is one batched matmul added to its
    input gates."""
    hs = []
    for t in range(wx.shape[0]):
        pre = torch.baddbmm(wx[t], h, r)  # (nh, B, 4 hd): i, f, z, o
        i_, f_, z_, o_ = torch.chunk(pre, 4, dim=-1)
        lf_m = F.logsigmoid(f_) + m
        m_new = torch.maximum(lf_m, i_)
        i_g = torch.exp(i_ - m_new)
        f_g = torch.exp(lf_m - m_new)
        c = f_g * c + i_g * torch.tanh(z_)
        n = f_g * n + i_g
        h = torch.sigmoid(o_) * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs), (h, c, n, m)


def _slstm_ffn(p: SLSTM, y: torch.Tensor) -> torch.Tensor:
    """The block's position-wise FFN, its GELU the tanh form in float32."""
    u = F.gelu((y @ p.up_proj).float(), approximate="tanh").to(y.dtype)
    return u @ p.down_proj


def slstm_state_spec(cfg, batch: int) -> Dict[str, TensorSpec]:
    """h, c, n, m (B, nh, hd), all float32."""
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {k: TensorSpec(shape, torch.float32) for k in _S_KEYS}
