"""Mamba2 (SSD) mixer, chunkwise-parallel form (port of `repro.models.ssm`).

The state-space dual form processes the sequence in chunks: interactions
within a chunk are dense products, and an (nh, hd, N) float32 state carries
across chunks.  The chunk-boundary state is the paper's weak-memory halo
in chunk index, order 1 in chunks.  Decode is the O(1) recurrence
h <- dA h + dt x (x) B, y = C h + D x.

One departure from the reference, in how a value is computed, not in the
value: the within-chunk decay is exp(cum_l - cum_s) for s <= l and 0 above
the diagonal.  The reference exponentiates the whole (l, s) square and
multiplies by the causal mask afterwards (`repro/models/ssm.py:140-147`);
above the diagonal the exponent is the sum of |dt A| across the chunk,
which passes float32's exp range (88.7) at zamba2's chunk of 256, and inf
x 0 gives NaN.  The port sets the exponent to -inf above the diagonal
before the exp (:func:`_diag_scores`), so it keeps the reference's contract,
chunked form == recurrence, at every chunk, and equals the reference to
float32 rounding wherever the reference is finite.

The diagonal term is built in a (b, chunk, head, l, s) layout, so its
product with x is one batched matmul; its elementwise factors are those of
the reference, multiplied in the reference's order.  The SSD is plain
PyTorch: the reference computes it in ``jnp``, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import TensorSpec
from .layers import DTYPE, dense_init, rms_norm, weight

__all__ = ["Mamba2", "mamba2_init", "mamba2_apply", "mamba2_state_spec"]

State = Dict[str, torch.Tensor]
NAMES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm", "out_proj")


class Mamba2(nn.Module):
    """The mixer's leaves, with d_in = expand d_model, N the state width,
    nh = d_in / head_dim and C = d_in + 2 N the conv's channels: in_proj (d,
    2 d_in + 2 N + nh), conv_w (conv_width, C), conv_b (C,), A_log / D /
    dt_bias (nh,) float32, gate_norm (d_in,), out_proj (d_in, d)."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias, gate_norm, out_proj):
        super().__init__()
        self.in_proj, self.conv_w, self.conv_b = weight(in_proj), weight(conv_w), weight(conv_b)
        self.A_log, self.D, self.dt_bias = weight(A_log), weight(D), weight(dt_bias)
        self.gate_norm, self.out_proj = weight(gate_norm), weight(out_proj)


def _dims(cfg) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.state_dim, s.conv_width


def mamba2_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> Mamba2:
    """The reference's shapes, dtypes and scales: in_proj and out_proj at 1
    / sqrt(fan-in), the conv taps at 0.2, A_log = dt_bias = 0, D = 1."""
    d_in, nh, n, cw = _dims(cfg)
    conv_ch = d_in + 2 * n  # x, B, C go through the causal conv
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2(
        dense_init(gen, cfg.d_model, 2 * d_in + 2 * n + nh, dtype, device),
        (torch.randn((cw, conv_ch), generator=gen, device=device) * 0.2).to(dtype),
        torch.zeros((conv_ch,), dtype=dtype, device=device),
        torch.zeros((nh,), **f32), torch.ones((nh,), **f32), torch.zeros((nh,), **f32),
        torch.ones((d_in,), dtype=dtype, device=device),
        dense_init(gen, d_in, cfg.d_model, dtype, device))


def _split_proj(cfg, proj: torch.Tensor):
    """(z, x, B, C, dt) views of the input projection."""
    d_in, nh, n, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq (B, S, C): the sum of the cw taps in
    seq's dtype, tap 0 first, plus the bias, then SiLU in float32.
    ``state`` is the (cw - 1) trailing inputs of the previous segment
    (zeros at the sequence's start).  Returns (out float32, new state)."""
    cw, s = w.shape[0], seq.shape[1]
    if state is None:
        state = seq.new_zeros((seq.shape[0], cw - 1, seq.shape[-1]))
    padded = torch.cat([state, seq], 1)
    out = padded[:, 0:s] * w[0]
    for i in range(1, cw):
        out += padded[:, i:i + s] * w[i]
    out = F.silu((out + b).float())
    return out, padded[:, s:].clone()  # the last cw - 1 inputs


def _diag_scores(cum: torch.Tensor, cb: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """The within-chunk scores (b, nc, h, l, s): C_l . B_s exp(cum_l - cum_s)
    dt_s for s <= l, 0 above the diagonal, the exponent set to -inf there
    before the exp.  cum (b, nc, h, l) is the inclusive within-chunk sum of
    log dA, cb (b, nc, l, s) = C_l . B_s, dt (b, nc, h, s)."""
    chunk = cum.shape[-1]
    upper = torch.ones((chunk, chunk), dtype=torch.bool, device=cum.device).triu_(1)
    scores = (cum[..., :, None] - cum[..., None, :]).masked_fill_(upper, float("-inf"))
    if torch.is_grad_enabled():  # autograd keeps exp's output: no in-place product on it
        return scores.exp() * cb[:, :, None] * dt[..., None, :]
    # serving: in place, one (b, nc, h, l, s) buffer (3.76 GB a layer at
    # zamba2's prefill)
    return scores.exp_().mul_(cb[:, :, None]).mul_(dt[..., None, :])


def _ssd_step(xh, bc, cc, dt, log_da, D, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: xh (B, 1, nh, hd), bc / cc (B, 1, N), dt /
    log_da (B, 1, nh), h0 (B, nh, hd, N) -> (y (B, 1, nh, hd), h)."""
    da = torch.exp(log_da[:, 0])  # (B, nh)
    h = h0 * da[..., None, None] + dt[:, 0][..., None, None] * torch.einsum(
        "bhp,bn->bhpn", xh[:, 0], bc[:, 0])
    y = torch.einsum("bhpn,bn->bhp", h, cc[:, 0]) + D[None, :, None] * xh[:, 0]
    return y[:, None], h


def _ssd_chunked(xh, bc, cc, dt, log_da, D, h0, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD over a whole segment, as :func:`_ssd_step` over each step
    (xh (B, S, nh, hd), bc / cc (B, S, N), dt / log_da (B, S, nh)) ->
    (y (B, S, nh, hd), final state).  The sequence is padded to a multiple
    of ``chunk`` with dt = log dA = 0: padded steps are identities of the
    recurrence, so the final state is unaffected, and their outputs are
    sliced away."""
    b, s, nh, hd = xh.shape
    n = bc.shape[-1]
    pad = (-s) % chunk
    if pad:
        xh, bc, cc, dt, log_da = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                                  for t in (xh, bc, cc, dt, log_da))
    nc = (s + pad) // chunk
    cum = torch.cumsum(log_da.reshape(b, nc, chunk, nh), 2)  # inclusive, within each chunk
    xck = xh.reshape(b, nc, chunk, nh, hd)
    bck, cck = bc.reshape(b, nc, chunk, n), cc.reshape(b, nc, chunk, n)
    dtk = dt.reshape(b, nc, chunk, nh)

    # within-chunk (diagonal) term, one (l, s) product per chunk and head
    cb = torch.einsum("bcln,bcsn->bcls", cck, bck)
    scores = _diag_scores(cum.transpose(2, 3), cb, dtk.transpose(2, 3))
    y_diag = torch.matmul(scores, xck.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del scores

    # chunk summary states, then the scan over chunks
    tail = torch.exp(cum[:, :, -1:, :] - cum)  # decay from step s to the chunk's end
    s_local = torch.einsum("bcshp,bcsn->bchpn", xck * (tail * dtk)[..., None], bck)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, nh)
    h, h_prevs = h0, []
    for c in range(nc):
        h_prevs.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + s_local[:, c]
    y_off = torch.einsum("bcln,bchpn->bclhp", cck, torch.stack(h_prevs, 1))
    decay = torch.exp(cum)[..., None]
    y_off = y_off * decay if torch.is_grad_enabled() else y_off.mul_(decay)
    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hd) + D[None, None, :, None] * xh
    return y[:, :s], h


def _ssd(xh, bc, cc, dt, log_da, D, h0, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD of a segment: the recurrence at one step, else chunked."""
    if xh.shape[1] == 1:
        return _ssd_step(xh, bc, cc, dt, log_da, D, h0)
    return _ssd_chunked(xh, bc, cc, dt, log_da, D, h0, chunk)


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg, *, state: Optional[State] = None,
                 return_state: bool = False) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d) -> (out (B, S, d), the state {"conv", "ssd"} or None).

    S == 1 runs the O(1) recurrence, any longer segment the chunked SSD;
    ``state`` (from an earlier segment or step) is carried in.  The new
    state is returned with ``return_state`` or when ``state`` was given."""
    d_in, nh, n, _ = _dims(cfg)
    hd = cfg.ssm.head_dim
    b, s, _ = x.shape

    proj = x @ p.in_proj
    z, _, _, _, dt = _split_proj(cfg, proj)
    conv_in = proj[..., d_in:2 * d_in + 2 * n]  # x, B, C: adjacent columns
    conv_out, conv_state = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                        None if state is None else state["conv"])
    xh = conv_out[..., :d_in].to(x.dtype).reshape(b, s, nh, hd).float()
    bc = conv_out[..., d_in:d_in + n]
    cc = conv_out[..., d_in + n:]
    del conv_out
    dt = F.softplus(dt.float() + p.dt_bias)  # (B, S, nh)
    log_da = dt * -torch.exp(p.A_log)  # log decay
    h0 = (state["ssd"].float() if state is not None
          else torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device))

    y, h = _ssd(xh, bc, cc, dt, log_da, p.D, h0, cfg.ssm.chunk)
    del xh, bc, cc

    y = y.reshape(b, s, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = rms_norm(y, p.gate_norm, cfg.norm_eps) @ p.out_proj
    new_state = {"conv": conv_state, "ssd": h}
    return out, (new_state if (return_state or state is not None) else None)


def mamba2_state_spec(cfg, batch: int, dtype=DTYPE) -> Dict[str, TensorSpec]:
    """The conv state in the model's dtype, the SSD state in float32."""
    d_in, nh, n, cw = _dims(cfg)
    return {"conv": TensorSpec((batch, cw - 1, d_in + 2 * n), dtype),
            "ssd": TensorSpec((batch, nh, cfg.ssm.head_dim, n), torch.float32)}
