"""Grouped-query attention: prefill and decode paths (port of the GQA half of
`repro.models.attention`).

Prefill runs the sliding-window attention kernel (`kernels/swa_attention`,
the port of the reference's Pallas twin of `_chunked_attention`) over the
full sequence, with ``window = cfg.swa_window``, or ``window = S`` (plain
causal) for an architecture without one.  The kernel wrapper runs the
chunked plain version on CPU tensors.

Decode attends one new token against a static-capacity cache, in plain
PyTorch as the reference computes it outside any Pallas kernel.  SWA
architectures keep a ring cache of capacity min(window, seq) with explicit
positions.  Unlike the reference, decode writes the new token's K/V and
position into the cache in place (no copy of the whole cache per step).

MLA (deepseek-v2) waits for its slice; the reference's ``shard(...)``
annotations and its model-axis K/V repeat are dropped on one device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels.swa_attention.ops import swa_attention
from ..kernels.swa_attention.ref import NEG_INF
from .layers import DTYPE, dense_init, rms_norm, apply_rope, weight

__all__ = ["GQAAttention", "TensorSpec", "gqa_init", "gqa_apply", "gqa_cache_spec",
           "attention_init", "attention_cache_spec", "mla_not_ported"]

Cache = Dict[str, torch.Tensor]
Attention = Callable[..., torch.Tensor]


class TensorSpec(NamedTuple):
    """Shape and dtype of a cache leaf (the reference's ShapeDtypeStruct)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def mla_not_ported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: multi-head latent attention (MLA) is not ported yet "
        "(ROADMAP Queue A item 11)")


class GQAAttention(nn.Module):
    """Projections (in, out): wq (d, H hd), wk / wv (d, KVH hd), wo (H hd, d);
    q_norm / k_norm (hd,) for architectures with ``qk_norm``."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = weight(wq), weight(wk), weight(wv), weight(wo)
        self.q_norm = None if q_norm is None else weight(q_norm)
        self.k_norm = None if k_norm is None else weight(k_norm)


def gqa_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> GQAAttention:
    hd = cfg.resolved_head_dim
    norms = {}
    if cfg.qk_norm:
        norms = {"q_norm": torch.ones((hd,), dtype=dtype, device=device),
                 "k_norm": torch.ones((hd,), dtype=dtype, device=device)}
    return GQAAttention(dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device),
                        dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
                        dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
                        dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device), **norms)


def attention_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> GQAAttention:
    if cfg.attn == "mla":
        raise mla_not_ported(cfg)
    return gqa_init(gen, cfg, dtype, device)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      valid: torch.Tensor) -> torch.Tensor:
    """q (B, 1, KVH, G, hk) against the cache k (B, C, KVH, hk), v (B, C,
    KVH, hv), masked by ``valid`` (C,) or (B, C) -> (B, 1, KVH, G, hv)."""
    logits = torch.einsum("bqngk,bsnk->bngqs", q, k).float() * scale
    if valid.ndim == 1:
        valid = valid[None]
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bngqs,bsnv->bqngv", p.to(v.dtype), v)


def gqa_apply(p: GQAAttention, x: torch.Tensor, cfg, positions: torch.Tensor, *,
              cache: Optional[Cache] = None, pos: Optional[int] = None,
              return_cache: bool = False,
              attention: Optional[Attention] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x (B, S, d) -> (out (B, S, d), cache or None).

    Without ``cache``: prefill over the whole sequence through ``attention``
    (default: the kernel wrapper ``swa_attention``; any function with its
    signature, such as the plain ``swa_attention_chunked``); with
    ``return_cache`` also the fresh decode cache.  With ``cache``: one
    decode step (S = 1) writing position ``pos``, in place.
    """
    hd = cfg.resolved_head_dim
    kvh = cfg.n_kv_heads
    g = cfg.n_heads // kvh
    scale = 1.0 / math.sqrt(hd)
    b, s, _ = x.shape

    q = (x @ p.wq).view(b, s, cfg.n_heads, hd)
    k = (x @ p.wk).view(b, s, kvh, hd)
    v = (x @ p.wv).view(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        window = cfg.swa_window if cfg.swa_window is not None else s
        out = (attention or swa_attention)(q, k, v, window, scale=scale)
        new_cache = _gqa_fresh_cache(cfg, k, v, positions) if return_cache else None
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per step, got {s}")
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        if ck.dtype != k.dtype:
            raise TypeError(f"cache holds {ck.dtype} but the model computes {k.dtype}: give "
                            f"the serving engine the model's dtype")
        capacity = ck.shape[1]
        slot = pos % capacity if (cfg.swa_window is not None
                                  and capacity <= cfg.swa_window) else pos
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        cpos[slot] = pos
        valid = (cpos <= pos) & (cpos >= 0)
        if cfg.swa_window is not None:
            valid &= cpos > pos - cfg.swa_window
        out = _decode_attention(q.view(b, s, kvh, g, hd), ck, cv, scale, valid)
        new_cache = cache

    out = out.reshape(b, s, cfg.n_heads * hd)
    return out @ p.wo, new_cache


def _gqa_fresh_cache(cfg, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor) -> Cache:
    """Cache built by prefill.

    SWA architectures keep only the trailing window, stored RING-ALIGNED so
    decode's ``slot = pos % window`` continues it; a prefill shorter than
    the window is padded to full window capacity with invalid slots
    (pos = -1).
    """
    pos = positions.expand(k.shape[1]).to(torch.int32)
    if cfg.swa_window is not None:
        w = cfg.swa_window
        s = k.shape[1]
        if s > w:
            k, v, pos = k[:, -w:], v[:, -w:], pos[-w:]
            shift = (s - w) % w  # p0 = s - w is the global position of the first kept entry
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
            pos = torch.roll(pos, shift, dims=0)
        elif s < w:
            pad = w - s
            k = torch.cat([k, k.new_zeros((k.shape[0], pad) + tuple(k.shape[2:]))], 1)
            v = torch.cat([v, v.new_zeros((v.shape[0], pad) + tuple(v.shape[2:]))], 1)
            pos = torch.cat([pos, pos.new_full((pad,), -1)])
    return {"k": k, "v": v, "pos": pos}


def gqa_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of the decode cache of one layer."""
    hd = cfg.resolved_head_dim
    c = min(cfg.swa_window, seq_len) if cfg.swa_window is not None else seq_len
    return {"k": TensorSpec((batch, c, cfg.n_kv_heads, hd), dtype),
            "v": TensorSpec((batch, c, cfg.n_kv_heads, hd), dtype),
            "pos": TensorSpec((c,), torch.int32)}


def attention_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE) -> Dict[str, TensorSpec]:
    if cfg.attn == "mla":
        raise mla_not_ported(cfg)
    return gqa_cache_spec(cfg, batch, seq_len, dtype)
