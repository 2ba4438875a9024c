"""Encoder-decoder backbone, whisper-base (port of `repro.models.encdec`).

The frontend is a stub (`vlm_stub.fake_frame_embeds`): the encoder takes
precomputed (B, S_enc, d_model) frame embeddings.  The backbone is the
reference's, not OpenAI's Whisper: rotary positions, RMSNorm, SwiGLU and a
separate ``lm_head``.  The encoder is a bidirectional transformer; each
decoder layer is causal self-attention, cross-attention to the encoder's
states (wq, wk, wv, wo; no norms and no rope on either side) and an MLP.

Attention: the decoder's causal self-attention over a whole sequence
(prefill, teacher-forced forward) runs the sliding-window attention
kernel's wrapper at ``window = S``, as `attention.gqa_apply` does (the
prefill's ``attention=`` may replace it); the encoder's self-attention and every
cross-attention are bidirectional, in :func:`full_attention`, plain
PyTorch, as the reference computes them in `jnp` outside any Pallas kernel
(kernel 8 is causal only).  Decode attends one token against the caches in
plain PyTorch.

Serving: prefill runs the encoder once and returns the decoder's self
cache ``{"k", "v": (L, B, S_dec, KVH, hd)}`` and the cross cache of the
same leaves at the encoder's length, computed once from its output; a
decode step writes the new token's self K/V at ``pos`` in place (the self
cache has no ``pos`` leaf: a step masks by ``arange(C) <= pos``) and never
runs the encoder.  The cross cache keeps the true encoder length: it is
unmasked, so a padded row would take probability mass.

:func:`encdec_train_forward` is the forward with gradients: every encoder
layer under :func:`layers.remat` (the reference checkpoints its encoder
layers always), every decoder layer too when ``remat``, and the decoder's
causal self-attention the plain ``swa_attention_chunked``, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..kernels.swa_attention.ops import swa_attention
from ..kernels.swa_attention.ref import swa_attention_chunked
from .attention import Attention, Cache, GQAAttention, TensorSpec, _decode_attention, gqa_init
from .layers import (DTYPE, MLP, RMSNorm, apply_rope, dense_init, embed_init, mlp_init, remat,
                     weight)

__all__ = ["CrossAttention", "EncoderLayer", "DecoderLayer", "EncDec", "full_attention",
           "encdec_init", "encode", "decode_forward", "encdec_forward", "encdec_train_forward",
           "encdec_prefill",
           "encdec_decode_step", "encdec_cache_spec", "XATTN_NAMES"]

XATTN_NAMES = ("wq", "wk", "wv", "wo")
CHUNK = 512  # the reference's query chunk


class CrossAttention(nn.Module):
    """wq (d, H hd), wk / wv (d, KVH hd), wo (H hd, d)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = weight(wq), weight(wk), weight(wv), weight(wo)


class EncoderLayer(nn.Module):
    def __init__(self, attn_norm: RMSNorm, attn: GQAAttention, mlp_norm: RMSNorm, mlp: MLP):
        super().__init__()
        self.attn_norm, self.attn, self.mlp_norm, self.mlp = attn_norm, attn, mlp_norm, mlp


class DecoderLayer(nn.Module):
    def __init__(self, attn_norm: RMSNorm, attn: GQAAttention, x_norm: RMSNorm,
                 xattn: CrossAttention, mlp_norm: RMSNorm, mlp: MLP):
        super().__init__()
        self.attn_norm, self.attn, self.x_norm, self.xattn = attn_norm, attn, x_norm, xattn
        self.mlp_norm, self.mlp = mlp_norm, mlp


class EncDec(nn.Module):
    """Token embedding (V, d), encoder and decoder layers, the encoder's
    and the decoder's final norms, lm_head (d, V)."""

    def __init__(self, cfg, embed: torch.Tensor, enc_layers: List[EncoderLayer],
                 dec_layers: List[DecoderLayer], enc_norm: RMSNorm, final_norm: RMSNorm,
                 lm_head: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.embed = weight(embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm, self.final_norm = enc_norm, final_norm
        self.lm_head = weight(lm_head)


def encdec_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> EncDec:
    """Random weights from ``gen``, the reference's initialisers and scales
    (its numbers differ: another generator)."""
    hd = cfg.resolved_head_dim
    norm = lambda: RMSNorm(torch.ones((cfg.d_model,), dtype=dtype, device=device),  # noqa: E731
                           cfg.norm_eps)
    dense = lambda i, o: dense_init(gen, i, o, dtype, device)  # noqa: E731
    enc = [EncoderLayer(norm(), gqa_init(gen, cfg, dtype, device), norm(),
                        mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device))
           for _ in range(cfg.enc_layers)]
    dec = []
    for _ in range(cfg.n_layers):
        attn = gqa_init(gen, cfg, dtype, device)
        xattn = CrossAttention(dense(cfg.d_model, cfg.n_heads * hd),
                               dense(cfg.d_model, cfg.n_kv_heads * hd),
                               dense(cfg.d_model, cfg.n_kv_heads * hd),
                               dense(cfg.n_heads * hd, cfg.d_model))
        dec.append(DecoderLayer(norm(), attn, norm(), xattn, norm(),
                                mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)))
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    return EncDec(cfg, embed, enc, dec, norm(), norm(), dense(cfg.d_model, cfg.vocab))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Bidirectional attention in query chunks of CHUNK, as the reference's
    ``_chunked_attention(causal=False)``: q (B, S, KVH, G, hk) against every
    key of k (B, Sk, KVH, hk), v (B, Sk, KVH, hv) -> (B, S, KVH, G, hv).
    Logits in float32 times ``scale``, softmax over all keys, P cast to v's
    dtype before P V."""
    outs = []
    for start in range(0, q.shape[1], CHUNK):
        logits = torch.einsum("bqngk,bsnk->bngqs", q[:, start:start + CHUNK], k).float()
        p = torch.softmax(logits * scale, dim=-1)
        outs.append(torch.einsum("bngqs,bsnv->bqngv", p.to(v.dtype), v))
    return torch.cat(outs, 1)


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return (x @ w).view(b, s, n, hd)


def _self_attn(p: GQAAttention, x: torch.Tensor, cfg, positions: torch.Tensor, causal: bool, *,
               cache: Optional[Cache] = None, pos: Optional[int] = None,
               attention: Optional[Attention] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, S, d) -> (out (B, S, d), (k, v) roped at ``positions``).

    Without ``cache``: causal through ``attention`` (default: the kernel
    wrapper, window = S) or bidirectional through :func:`full_attention`.
    With ``cache`` (one decode token): k, v written at ``pos`` in place, the
    query attending to every slot up to ``pos``."""
    hd, kvh, h = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(hd)
    q = apply_rope(_heads(x, p.wq, h, hd), positions, cfg.rope_theta)
    k = apply_rope(_heads(x, p.wk, kvh, hd), positions, cfg.rope_theta)
    v = _heads(x, p.wv, kvh, hd)
    if cache is not None:
        if s != 1:
            raise ValueError(f"decode takes one token per step, got {s}")
        ck, cv = cache["k"], cache["v"]
        if ck.dtype != k.dtype:
            raise TypeError(f"cache holds {ck.dtype} but the model computes {k.dtype}: give "
                            f"the serving engine the model's dtype")
        ck[:, pos] = k[:, 0]
        cv[:, pos] = v[:, 0]
        valid = torch.arange(ck.shape[1], device=ck.device) <= pos
        out = _decode_attention(q.view(b, 1, kvh, h // kvh, hd), ck, cv, scale, valid)
    elif causal:
        out = (attention or swa_attention)(q, k, v, s, scale=scale)
    else:
        out = full_attention(q.view(b, s, kvh, h // kvh, hd), k, v, scale)
    return out.reshape(b, s, h * hd) @ p.wo, (k, v)


def _cross_kv(p: CrossAttention, enc_out: torch.Tensor, cfg) -> Cache:
    """One decoder layer's cross K/V (B, S_enc, KVH, hd) from the encoder's
    output: no rope."""
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": _heads(enc_out, p.wk, kvh, hd), "v": _heads(enc_out, p.wv, kvh, hd)}


def _cross_attn(p: CrossAttention, x: torch.Tensor, cfg, enc_kv: Cache) -> torch.Tensor:
    hd, kvh, h = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads
    b, s, _ = x.shape
    q = (x @ p.wq).view(b, s, kvh, h // kvh, hd)
    out = full_attention(q, enc_kv["k"], enc_kv["v"], 1.0 / math.sqrt(hd))
    return out.reshape(b, s, h * hd) @ p.wo


def _positions(n: int, start: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def _encode(p: EncDec, frames: torch.Tensor, cfg, policy: Optional[str] = None) -> torch.Tensor:
    x = frames.to(p.enc_norm.weight.dtype)
    positions = _positions(x.shape[1], 0, x.device)

    def body(layer, x):
        x = x + _self_attn(layer.attn, layer.attn_norm(x), cfg, positions, causal=False)[0]
        return x + layer.mlp(layer.mlp_norm(x))

    for layer in p.enc_layers:
        x = remat(body, layer, x, policy=policy)
    return p.enc_norm(x)


@torch.no_grad()
def encode(p: EncDec, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames (B, S_enc, d_model), the stubbed frontend's output -> the
    encoder's states (B, S_enc, d_model) in the weights' dtype."""
    return _encode(p, frames, cfg)


def _decoder_layer(layer: DecoderLayer, x: torch.Tensor, cfg, positions: torch.Tensor,
                   enc_kv: Cache, **self_kw) -> Tuple[torch.Tensor, Tuple]:
    """-> (x, the self-attention's (k, v))."""
    a, kv = _self_attn(layer.attn, layer.attn_norm(x), cfg, positions, causal=True, **self_kw)
    x = x + a
    x = x + _cross_attn(layer.xattn, layer.x_norm(x), cfg, enc_kv)
    return x + layer.mlp(layer.mlp_norm(x)), kv


def _logits(p: EncDec, x: torch.Tensor) -> torch.Tensor:
    return p.final_norm(x) @ p.lm_head


def _decode(p: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor, cfg, return_hidden: bool,
            attention: Optional[Attention] = None, policy: Optional[str] = None) -> torch.Tensor:
    x = p.embed[tokens]
    positions = _positions(x.shape[1], 0, x.device)

    def body(layer, x, enc_out):
        return _decoder_layer(layer, x, cfg, positions, _cross_kv(layer.xattn, enc_out, cfg),
                              attention=attention)[0]

    for layer in p.dec_layers:
        x = remat(body, layer, x, enc_out, policy=policy)
    return p.final_norm(x) if return_hidden else _logits(p, x)


@torch.no_grad()
def decode_forward(p: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor, cfg, *,
                   return_hidden: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass over the encoder's states -> logits (B,
    S_dec, V), or with ``return_hidden`` the final normed hidden states."""
    return _decode(p, tokens, enc_out, cfg, return_hidden)


def encdec_forward(p: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg, *,
                   return_hidden: bool = False) -> torch.Tensor:
    """The encoder, then the teacher-forced decoder -> logits (B, S_dec,
    V), or with ``return_hidden`` the final normed hidden states."""
    return decode_forward(p, tokens, encode(p, frames, cfg), cfg, return_hidden=return_hidden)


def encdec_train_forward(p: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg, *,
                         remat: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """:func:`encdec_forward` with gradients: the encoder's layers always
    under full remat, the decoder's when ``remat``, the decoder's causal
    self-attention plain."""
    enc_out = _encode(p, frames, cfg, policy="full")
    return _decode(p, tokens, enc_out, cfg, return_hidden, attention=swa_attention_chunked,
                   policy="full" if remat else None)


@torch.no_grad()
def encdec_prefill(p: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg, *,
                   attention: Optional[Attention] = None) -> Tuple[torch.Tensor, Dict[str, Cache]]:
    """Serving prefill -> (logits of the last position (B, V), {"self":
    the decoder's K/V over S_dec, "cross": K/V over S_enc}), each leaf
    stacked (L, B, S, KVH, hd)."""
    enc_out = encode(p, frames, cfg)
    cross = [_cross_kv(layer.xattn, enc_out, cfg) for layer in p.dec_layers]
    del enc_out
    x = p.embed[tokens]
    positions = _positions(x.shape[1], 0, x.device)
    selfs = []
    for layer, enc_kv in zip(p.dec_layers, cross):
        x, kv = _decoder_layer(layer, x, cfg, positions, enc_kv, attention=attention)
        selfs.append(kv)
    logits = _logits(p, x[:, -1:])[:, 0]
    stack = lambda ts: torch.stack(list(ts))  # noqa: E731
    return logits, {"self": {"k": stack(k for k, _ in selfs), "v": stack(v for _, v in selfs)},
                    "cross": {name: stack(c[name] for c in cross) for name in ("k", "v")}}


@torch.no_grad()
def encdec_decode_step(p: EncDec, cache: Dict[str, Cache], tokens: torch.Tensor, pos: int,
                       cfg) -> Tuple[torch.Tensor, Dict[str, Cache]]:
    """One decoder step at write position ``pos`` against the (self, cross)
    caches -> (logits (B, V), the same cache, its self K/V written in
    place)."""
    pos = int(pos)
    x = p.embed[tokens[:, None]]
    positions = _positions(1, pos, x.device)
    for i, layer in enumerate(p.dec_layers):
        x, _ = _decoder_layer(layer, x, cfg, positions,
                              {n: t[i] for n, t in cache["cross"].items()},
                              cache={n: t[i] for n, t in cache["self"].items()}, pos=pos)
    return _logits(p, x)[:, 0], cache


def encdec_cache_spec(cfg, batch: int, seq_len: int, enc_len: int,
                      dtype=DTYPE) -> Dict[str, Dict[str, TensorSpec]]:
    """Stacked shapes and dtypes of the self cache (``seq_len`` slots) and
    the cross cache (``enc_len`` encoder positions)."""
    hd = cfg.resolved_head_dim

    def kv(s):
        spec = TensorSpec((cfg.n_layers, batch, s, cfg.n_kv_heads, hd), dtype)
        return {"k": spec, "v": spec}
    return {"self": kv(seq_len), "cross": kv(enc_len)}
