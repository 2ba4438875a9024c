"""Plain PyTorch versions of sliding-window causal attention.

Position q attends to keys k in (q - window, q].  Both functions take the
port's layout -- q (B, S, H, D), k and v (B, S_k, KVH, D), query head h
served by KV head h // (H / KVH) -- and return (B, S, H, D):

  * :func:`swa_attention_ref` -- dense, O(S^2) logits: the port of
    `repro.kernels.swa_attention.ref.swa_attention_ref` (with the GQA head
    repeat of ``ops.swa_attention_reference``).  For tests at small sizes.
  * :func:`swa_attention_chunked` -- the semantics of the reference model's
    `_chunked_attention` (`repro.models.attention`): queries in chunks of
    ``chunk``, each against a key slice of width ``window + chunk`` starting
    at the clipped ``q0 - window``, logits in float32, probabilities
    rounded to v's dtype before the product with v.  The kernel wrapper's
    CPU path, and the yardstick of the kernel on the card at full width,
    where the dense version would need (S x S) logits per head.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "swa_attention_ref", "swa_attention_chunked", "valid_pairs",
           "swa_row_scale"]

NEG_INF = -1e30  # the reference kernel's finite mask sentinel


def _group(q: torch.Tensor, k: torch.Tensor) -> int:
    if q.ndim != 4 or k.ndim != 4 or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"need q (B, S, H, D) and k, v (B, S_k, KVH, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over {k.shape[2]} KV heads")
    return q.shape[2] // k.shape[2]


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Dense sliding-window causal attention; logits and the product with v
    in float32, the result in q's dtype."""
    g = _group(q, k)
    s, d = q.shape[1], q.shape[3]
    scale = d**-0.5 if scale is None else scale
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    p = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def swa_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None, *, scale: Optional[float] = None,
                          chunk: int = 512, q_pos0: int = 0,
                          causal: bool = True) -> torch.Tensor:
    """Causal (optionally banded) attention, query-chunked.  ``window=None``
    is plain causal attention over all S_k keys; the result is in v's
    dtype."""
    g = _group(q, k)
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, g, d)
    chunk = min(chunk, s)
    use_window = window is not None and sk > window + chunk
    outs = []
    for qs in range(0, s, chunk):
        qc = qg[:, qs: qs + chunk]
        q_pos = q_pos0 + qs + torch.arange(qc.shape[1], device=q.device)
        if use_window:
            width = window + chunk
            start = min(max(qs + q_pos0 - window, 0), sk - width)
            kc, vc = k[:, start: start + width], v[:, start: start + width]
            k_pos = start + torch.arange(width, device=q.device)
        else:
            kc, vc = k, v
            k_pos = torch.arange(sk, device=q.device)
        logits = torch.einsum("bqngk,bsnk->bngqs", qc, kc).float() * scale
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                              device=q.device)
        if window is not None:
            mask &= k_pos[None, :] > (q_pos[:, None] - window)
        p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        outs.append(torch.einsum("bngqs,bsnv->bqngv", p.to(v.dtype), vc))
    return torch.cat(outs, 1).reshape(b, s, h, v.shape[-1])


def valid_pairs(s: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head: sum over q of min(q + 1, W)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def swa_row_scale(v: torch.Tensor, window: int, heads: int) -> torch.Tensor:
    """(B, S, H, 1) float32: max |v| over the keys in each output row's
    window, (s - window, s], of its KV head.  An output row is a convex
    combination of those rows of v, so this bounds it: the scale its
    rounding is held to."""
    b, s, kvh, _ = v.shape
    w = min(window, s)
    m = v.float().abs().amax(-1).permute(0, 2, 1).reshape(b * kvh, 1, s)
    m = torch.nn.functional.max_pool1d(torch.nn.functional.pad(m, (w - 1, 0)), w, stride=1)
    m = m.reshape(b, kvh, s).permute(0, 2, 1)
    return m.repeat_interleave(heads // kvh, dim=2)[..., None]
