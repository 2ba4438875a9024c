"""Decoder-only LM backbone, dense family (port of `repro.models.transformer`).

The reference stacks its layers' parameters on a leading L axis and scans
over them; the port keeps one :class:`Block` per layer in an
``nn.ModuleList`` and loops.  The decode cache keeps the reference's
stacked layout, ``{"k", "v": (L, B, C, KVH, hd), "pos": (L, C)}``, so the
two compare leaf by leaf.

Entry points (all under ``torch.no_grad``; training is a later slice):
  lm_forward      -- tokens -> logits (B, S, V)
  lm_prefill      -- tokens -> (last logits (B, V), stacked cache)
  lm_decode_step  -- (cache, tokens (B,), pos) -> (logits (B, V), cache)

``lm_prefill`` takes ``attention=`` (default: the sliding-window attention
kernel's wrapper) for its attention; decode attention is plain PyTorch.
MoE layers wait for their slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .attention import (Attention, Cache, GQAAttention, TensorSpec, attention_cache_spec,
                        attention_init, gqa_apply)
from .layers import DTYPE, MLP, RMSNorm, dense_init, embed_init, mlp_init, weight

__all__ = ["Block", "Transformer", "lm_init", "lm_forward", "lm_prefill", "lm_decode_step",
           "lm_cache_spec", "lm_head_matrix"]


class Block(nn.Module):
    def __init__(self, attn_norm: RMSNorm, attn: GQAAttention, mlp_norm: RMSNorm, mlp: MLP):
        super().__init__()
        self.attn_norm, self.attn, self.mlp_norm, self.mlp = attn_norm, attn, mlp_norm, mlp


class Transformer(nn.Module):
    """Embedding (V, d), blocks, final norm and, unless tied, lm_head (d, V)."""

    def __init__(self, cfg, embed: torch.Tensor, layers: List[Block], final_norm: RMSNorm,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = weight(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else weight(lm_head)


def _check_family(cfg) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts layers are not ported "
                                  "yet (ROADMAP Queue A item 11)")
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: the VLM stub is not ported yet "
                                  "(ROADMAP Queue A item 11)")


def _layer_init(gen: torch.Generator, cfg, dtype, device) -> Block:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    attn = attention_init(gen, cfg, dtype, device)
    return Block(RMSNorm(ones(), cfg.norm_eps), attn, RMSNorm(ones(), cfg.norm_eps),
                 mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device))


def lm_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> Transformer:
    """Random weights from ``gen``, the reference's initialisers and scales
    (its numbers differ: another generator)."""
    _check_family(cfg)
    layers = [_layer_init(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    head = None if cfg.tie_embeddings else dense_init(gen, cfg.d_model, cfg.vocab, dtype, device)
    final = RMSNorm(torch.ones((cfg.d_model,), dtype=dtype, device=device), cfg.norm_eps)
    return Transformer(cfg, embed, layers, final, head)


def _block(p: Block, x: torch.Tensor, cfg, positions: torch.Tensor, cache: Optional[Cache] = None,
           pos: Optional[int] = None, return_cache: bool = False,
           attention: Optional[Attention] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    attn_out, new_cache = gqa_apply(p.attn, p.attn_norm(x), cfg, positions, cache=cache, pos=pos,
                                    return_cache=return_cache, attention=attention)
    x = x + attn_out
    x = x + p.mlp(p.mlp_norm(x))
    return x, new_cache


def _embed_inputs(p: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return p.embed[tokens]


def lm_head_matrix(p: Transformer) -> torch.Tensor:
    return p.embed.T if p.cfg.tie_embeddings else p.lm_head


def _unembed(p: Transformer, x: torch.Tensor) -> torch.Tensor:
    return p.final_norm(x) @ lm_head_matrix(p)


def _positions(n: int, start: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


@torch.no_grad()
def lm_forward(p: Transformer, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    x = _embed_inputs(p, tokens)
    positions = _positions(x.shape[1], 0, x.device)
    for layer in p.layers:
        x, _ = _block(layer, x, cfg, positions)
    return _unembed(p, x)


@torch.no_grad()
def lm_prefill(p: Transformer, tokens: torch.Tensor, cfg, *,
               attention: Optional[Attention] = None) -> Tuple[torch.Tensor, Cache]:
    """Prefill -> (logits of the last position (B, V), stacked cache)."""
    x = _embed_inputs(p, tokens)
    positions = _positions(x.shape[1], 0, x.device)
    caches = []
    for layer in p.layers:
        x, cache = _block(layer, x, cfg, positions, return_cache=True, attention=attention)
        caches.append(cache)
    logits = _unembed(p, x[:, -1:, :])[:, 0]
    return logits, {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


@torch.no_grad()
def lm_decode_step(p: Transformer, cache: Cache, tokens: torch.Tensor, pos: int,
                   cfg) -> Tuple[torch.Tensor, Cache]:
    """One decode step at write position ``pos`` -> (logits (B, V), the same
    cache, updated in place)."""
    pos = int(pos)
    x = _embed_inputs(p, tokens[:, None])
    positions = _positions(1, pos, x.device)
    for i, layer in enumerate(p.layers):
        x, _ = _block(layer, x, cfg, positions, cache={k: t[i] for k, t in cache.items()},
                      pos=pos)
    return _unembed(p, x)[:, 0], cache


def lm_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE) -> Dict[str, TensorSpec]:
    """Stacked (L, ...) shapes and dtypes of the decode cache."""
    per_layer = attention_cache_spec(cfg, batch, seq_len, dtype)
    return {k: TensorSpec((cfg.n_layers,) + s.shape, s.dtype) for k, s in per_layer.items()}
