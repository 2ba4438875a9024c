"""Attention: grouped-query (GQA) and multi-head latent (MLA), prefill and
decode paths (port of `repro.models.attention`).

Prefill runs the sliding-window attention kernel (`kernels/swa_attention`,
the port of the reference's Pallas twin of `_chunked_attention`) over the
full sequence, with ``window = cfg.swa_window``, or ``window = S`` (plain
causal) for an architecture without one.  The kernel wrapper runs the
chunked plain version on CPU tensors.

Decode attends one new token against a static-capacity cache, in plain
PyTorch as the reference computes it outside any Pallas kernel.  SWA
architectures keep a ring cache of capacity min(window, seq) with explicit
positions.  Unlike the reference, decode writes the new token's K/V (MLA:
its latent) and position into the cache in place (no copy of the whole
cache per step).

MLA (deepseek-v2) has the reference's two forms of one computation: the
prefill is non-absorbed (per-head keys and values from the latent, q/k of
nope + rope = 192 and v of 128 through the kernel), and decode is absorbed
(q folded through ``w_uk`` against the compact latent cache (B, C, kv_lora
+ rope)).  The reference's ``shard(...)`` annotations and its model-axis
K/V repeat are dropped on one device.

On a ``("data", "model")`` mesh (``mesh=``, `parallel.tensor`), GQA runs on
the rank's local heads, read off its weights' widths: q/k/v are
column-parallel, kernel 8 (or the decode attention) runs on the local
heads, and ``wo`` is row-parallel, so the output is whole on every model
rank; the decode cache holds the local KV heads (``gqa_cache_spec(...,
mesh=)``), as the reference's cache rule ``("batch", "seq", "kv", None)``
places them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels.swa_attention.ops import swa_attention
from ..kernels.swa_attention.ref import NEG_INF
from ..parallel import tensor as tp
from .layers import DTYPE, column_parallel, dense_init, rms_norm, apply_rope, row_parallel, weight

__all__ = ["GQAAttention", "MLAAttention", "TensorSpec", "gqa_init", "gqa_apply",
           "gqa_cache_spec", "mla_init", "mla_apply", "mla_cache_spec", "attention_init",
           "attention_apply", "attention_cache_spec"]

Cache = Dict[str, torch.Tensor]
Attention = Callable[..., torch.Tensor]


class TensorSpec(NamedTuple):
    """Shape and dtype of a cache leaf (the reference's ShapeDtypeStruct)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


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


class MLAAttention(nn.Module):
    """Projections (in, out), with r = kv_lora_rank, n / rp / hv the nope,
    rope and v head dims: w_dkv (d, r), kv_norm (r,), w_uk (r, H n), w_uv
    (r, H hv), w_kr (d, rp), wo (H hv, d); the query either through a
    low-rank path, w_dq (d, q_lora_rank), q_norm (q_lora_rank,), w_uq
    (q_lora_rank, H (n + rp)), or with q_lora_rank = 0 as one wq (d, H (n +
    rp))."""

    def __init__(self, w_dkv, kv_norm, w_uk, w_uv, w_kr, wo, *, wq=None, w_dq=None,
                 q_norm=None, w_uq=None):
        super().__init__()
        if (wq is None) == (w_dq is None) or (w_dq is None) != (w_uq is None):
            raise ValueError("MLA takes either wq or w_dq, q_norm and w_uq")
        self.w_dkv, self.kv_norm, self.w_kr = weight(w_dkv), weight(kv_norm), weight(w_kr)
        self.w_uk, self.w_uv, self.wo = weight(w_uk), weight(w_uv), weight(wo)
        self.wq = None if wq is None else weight(wq)
        self.w_dq = None if w_dq is None else weight(w_dq)
        self.q_norm = None if q_norm is None else weight(q_norm)
        self.w_uq = None if w_uq is None else weight(w_uq)


def mla_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> MLAAttention:
    """The reference's leaves and scales (1 / sqrt(fan-in), norms at one)."""
    m, h = cfg.mla, cfg.n_heads
    qdim = h * (m.nope_head_dim + m.rope_head_dim)
    dense = lambda i, o: dense_init(gen, i, o, dtype, device)  # noqa: E731
    w = dict(w_dkv=dense(cfg.d_model, m.kv_lora_rank),
             kv_norm=torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
             w_uk=dense(m.kv_lora_rank, h * m.nope_head_dim),
             w_uv=dense(m.kv_lora_rank, h * m.v_head_dim),
             w_kr=dense(cfg.d_model, m.rope_head_dim),
             wo=dense(h * m.v_head_dim, cfg.d_model))
    if m.q_lora_rank:
        w.update(w_dq=dense(cfg.d_model, m.q_lora_rank),
                 q_norm=torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
                 w_uq=dense(m.q_lora_rank, qdim))
    else:
        w["wq"] = dense(cfg.d_model, qdim)
    return MLAAttention(**w)


def attention_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None):
    if cfg.attn == "mla":
        return mla_init(gen, cfg, dtype, device)
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
              return_cache: bool = False, attention: Optional[Attention] = None,
              mesh=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x (B, S, d) -> (out (B, S, d), cache or None).

    Without ``cache``: prefill over the whole sequence through ``attention``
    (default: the kernel wrapper ``swa_attention``; any function with its
    signature, such as the plain ``swa_attention_chunked``); with
    ``return_cache`` also the fresh decode cache.  With ``cache``: one
    decode step (S = 1) writing position ``pos``, in place.  The heads are
    those of ``p``'s weights: all of them, or on ``mesh`` the rank's.
    """
    hd = cfg.resolved_head_dim
    h = p.wq.shape[1] // hd
    kvh = p.wk.shape[1] // hd
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    b, s, _ = x.shape

    q, k, v = column_parallel(x, (p.wq, p.wk, p.wv), mesh)
    q = q.view(b, s, h, hd)
    k = k.view(b, s, kvh, hd)
    v = v.view(b, s, kvh, hd)
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

    return row_parallel(out.reshape(b, s, h * hd), p.wo, mesh), new_cache


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


def gqa_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE,
                   mesh=None) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of the decode cache of one layer (on ``mesh``, of
    the rank's KV heads)."""
    hd = cfg.resolved_head_dim
    kvh = cfg.n_kv_heads if mesh is None else tp.head_layout(cfg, tp.model_size(mesh))[1]
    c = min(cfg.swa_window, seq_len) if cfg.swa_window is not None else seq_len
    return {"k": TensorSpec((batch, c, kvh, hd), dtype),
            "v": TensorSpec((batch, c, kvh, hd), dtype),
            "pos": TensorSpec((c,), torch.int32)}


def mla_apply(p: MLAAttention, x: torch.Tensor, cfg, positions: torch.Tensor, *,
              cache: Optional[Cache] = None, pos: Optional[int] = None,
              return_cache: bool = False,
              attention: Optional[Attention] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Multi-head latent attention (DeepSeek-V2): x (B, S, d) -> (out (B, S,
    d), cache or None), as :func:`gqa_apply`.

    Without ``cache`` (prefill), the non-absorbed form: per-head k_nope =
    c_kv W_uk and v = c_kv W_uv, k_rope broadcast over the heads, q/k of
    nope + rope through ``attention`` (default: the kernel wrapper) with G
    = 1; ``return_cache`` adds the latent cache {"lat": (B, S, r + rp),
    "pos"}.  With ``cache`` (decode, S = 1), the absorbed form: q_nope
    folded through W_uk attends against the latent cache, whose slot
    ``pos`` is written in place, and the context goes out through W_uv.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h, r = cfg.n_heads, m.kv_lora_rank
    nope, rope, hv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(nope + rope)

    if p.wq is None:
        q = rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps) @ p.w_uq
    else:
        q = x @ p.wq
    q = q.view(b, s, h, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    c_kv = rms_norm(x @ p.w_dkv, p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(x @ p.w_kr, positions, cfg.rope_theta)  # (B, S, rp): one head
    kv_lat = torch.cat([c_kv, k_rope], -1)  # (B, S, r + rp)

    if cache is None:
        # q, k and v for the kernel; the pieces are let go as they are joined
        # (each is 1-1.6 GB at deepseek-v2's prefill of 4 x 8,000 tokens)
        q = torch.cat([q_nope, q_rope], -1)
        del q_nope, q_rope
        k = (c_kv @ p.w_uk).view(b, s, h, nope)
        k = torch.cat([k, k_rope[:, :, None, :].expand(b, s, h, rope)], -1)
        v = (c_kv @ p.w_uv).view(b, s, h, hv)
        window = cfg.swa_window if cfg.swa_window is not None else s
        out = (attention or swa_attention)(q, k, v, window, scale=scale)
        del q, k, v
        new_cache = None
        if return_cache:
            new_cache = {"lat": kv_lat, "pos": positions.expand(s).to(torch.int32)}
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per step, got {s}")
        lat, cpos = cache["lat"], cache["pos"]
        if lat.dtype != kv_lat.dtype:
            raise TypeError(f"cache holds {lat.dtype} but the model computes {kv_lat.dtype}: "
                            f"give the serving engine the model's dtype")
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, p.w_uk.view(r, h, nope))
        q_dec = torch.cat([q_abs, q_rope], -1).view(b, 1, 1, h, r + rope)
        lat[:, pos] = kv_lat[:, 0]
        cpos[pos] = pos
        valid = (cpos <= pos) & (cpos >= 0)
        ctx = _decode_attention(q_dec, lat[:, :, None, :], lat[:, :, None, :r], scale, valid)
        out = torch.einsum("bshr,rhv->bshv", ctx.view(b, 1, h, r), p.w_uv.view(r, h, hv))
        new_cache = cache

    return out.reshape(b, s, h * hv) @ p.wo, new_cache


def mla_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of one layer's latent cache."""
    m = cfg.mla
    return {"lat": TensorSpec((batch, seq_len, m.kv_lora_rank + m.rope_head_dim), dtype),
            "pos": TensorSpec((seq_len,), torch.int32)}


def attention_apply(p, x: torch.Tensor, cfg, positions: torch.Tensor, **kw
                    ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """:func:`mla_apply` for an MLA architecture, else :func:`gqa_apply`."""
    return (mla_apply if cfg.attn == "mla" else gqa_apply)(p, x, cfg, positions, **kw)


def attention_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE,
                         mesh=None) -> Dict[str, TensorSpec]:
    if cfg.attn == "mla":
        return mla_cache_spec(cfg, batch, seq_len, dtype)
    return gqa_cache_spec(cfg, batch, seq_len, dtype, mesh)
