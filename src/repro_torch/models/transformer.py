"""Decoder-only LM backbone, dense, MoE and VLM families (port of
`repro.models.transformer`).

The reference stacks its layers' parameters on a leading L axis and scans
over them; the port keeps one :class:`Block` per layer in an
``nn.ModuleList`` and loops.  The decode cache keeps the reference's
stacked layout, ``{"k", "v": (L, B, C, KVH, hd), "pos": (L, C)}`` (MLA:
``{"lat": (L, B, C, kv_lora + rope), "pos"}``), so the two compare leaf by
leaf.

Serving entry points (under ``torch.no_grad``):
  lm_forward      -- tokens -> logits (B, S, V) (with ``return_aux``, and
                     the aux losses summed over layers)
  lm_prefill      -- tokens -> (last logits (B, V), stacked cache)
  lm_decode_step  -- (cache, tokens (B,), pos) -> (logits (B, V), cache)
and the training forward, with gradients:
  lm_train_forward -- tokens -> (logits, or the final normed hidden states
                     with ``return_hidden``, aux losses summed over layers)

The training forward runs each block under :func:`layers.remat` with
``cfg.remat_policy`` (the reference's ``jax.checkpoint`` of its scanned
body), and its attention is the plain chunked ``swa_attention_chunked``,
the reference's own training attention (``_chunked_attention``): the
attention kernel has no backward, as the reference's Pallas kernel has
none.

``lm_prefill`` takes ``attention=`` (default: the sliding-window attention
kernel's wrapper) for its attention; decode attention is plain PyTorch.
A block's attention is grouped-query (:class:`GQAAttention`) or, for a
config with ``attn == "mla"``, multi-head latent (:class:`MLAAttention`);
its feed-forward a dense SwiGLU (:class:`MLP`) or, for a config with
``moe``, a mixture of experts (:class:`MoE`, `moe.py`).

On a ``("data", "model")`` mesh (``mesh=``, with the rank's shard of the
model from ``parallel.tensor.shard_params``; the dense family only), each
block makes two rank-ordered model-axis reductions (after the
row-parallel ``wo`` and ``w_down``), the embedding lookup is
vocab-parallel (one more), and the logits are the rank's vocab shard
(B, ..., V / tp): 2L + 1 collectives a prefill or decode step.  The
training backward makes 2L + 1 more: one a replicated input (each block's
attention and MLP inputs, the final hidden states into the loss).

The VLM family (llava-next-34b) takes ``patch_embeds`` (B, n_patches,
d_model), the stubbed vision tower's output (`vlm_stub.py`), through
``patch_proj`` (d, d) and prefixes them to the text: positions run over
n_patches + S_text, causal over the whole sequence, patches included, so
decode continues at ``pos = n_patches + S_text``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels.swa_attention.ref import swa_attention_chunked
from .attention import (Attention, Cache, GQAAttention, MLAAttention, TensorSpec,
                        attention_apply, attention_cache_spec, attention_init)
from .layers import (DTYPE, MLP, RMSNorm, column_parallel, dense_init, embed_init, mlp_init,
                     remat, vocab_parallel_embed, weight)
from .moe import Aux, MoE, moe_apply, moe_init

__all__ = ["Block", "Transformer", "lm_init", "lm_forward", "lm_train_forward", "lm_prefill",
           "lm_decode_step", "lm_cache_spec", "lm_head_matrix"]


class Block(nn.Module):
    """Attention (GQA or MLA) and a feed-forward ``mlp``: a dense
    :class:`MLP`, or an :class:`MoE` (the reference's ``layers["moe"]``)."""

    def __init__(self, attn_norm: RMSNorm, attn: Union[GQAAttention, MLAAttention],
                 mlp_norm: RMSNorm, mlp: Union[MLP, MoE]):
        super().__init__()
        self.attn_norm, self.attn, self.mlp_norm, self.mlp = attn_norm, attn, mlp_norm, mlp


class Transformer(nn.Module):
    """Embedding (V, d), blocks, final norm, unless tied lm_head (d, V),
    and for the VLM family patch_proj (d, d)."""

    def __init__(self, cfg, embed: torch.Tensor, layers: List[Block], final_norm: RMSNorm,
                 lm_head: Optional[torch.Tensor] = None,
                 patch_proj: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = weight(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else weight(lm_head)
        self.patch_proj = None if patch_proj is None else weight(patch_proj)


def _layer_init(gen: torch.Generator, cfg, dtype, device) -> Block:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    attn = attention_init(gen, cfg, dtype, device)
    mlp = (moe_init(gen, cfg, dtype, device) if cfg.moe is not None
           else mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device))
    return Block(RMSNorm(ones(), cfg.norm_eps), attn, RMSNorm(ones(), cfg.norm_eps), mlp)


def lm_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> Transformer:
    """Random weights from ``gen``, the reference's initialisers and scales
    (its numbers differ: another generator)."""
    layers = [_layer_init(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    head = None if cfg.tie_embeddings else dense_init(gen, cfg.d_model, cfg.vocab, dtype, device)
    proj = (dense_init(gen, cfg.d_model, cfg.d_model, dtype, device) if cfg.family == "vlm"
            else None)
    final = RMSNorm(torch.ones((cfg.d_model,), dtype=dtype, device=device), cfg.norm_eps)
    return Transformer(cfg, embed, layers, final, head, proj)


def _block(p: Block, x: torch.Tensor, cfg, positions: torch.Tensor, cache: Optional[Cache] = None,
           pos: Optional[int] = None, return_cache: bool = False,
           attention: Optional[Attention] = None, aux: bool = False, mesh=None
           ) -> Tuple[torch.Tensor, Optional[Cache], Optional[Aux]]:
    """-> (x, cache, the MoE layer's aux losses when ``aux``, else None).
    On ``mesh`` the attention's ``wo`` and the MLP's ``w_down`` are
    row-parallel: each ends in a model-axis reduction."""
    kw = {} if mesh is None else {"mesh": mesh}
    attn_out, new_cache = attention_apply(p.attn, p.attn_norm(x), cfg, positions, cache=cache,
                                          pos=pos, return_cache=return_cache,
                                          attention=attention, **kw)
    x = x + attn_out
    h = p.mlp_norm(x)
    if isinstance(p.mlp, MoE):
        mlp_out, layer_aux = moe_apply(p.mlp, h, cfg, aux=aux)
    else:
        mlp_out, layer_aux = p.mlp(h, mesh), None
    return x + mlp_out, new_cache, layer_aux


def _embed_inputs(p: Transformer, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """The token embeddings (on ``mesh``, vocab-parallel); for the VLM
    family the projected patch embeddings before them (B, n_patches +
    S_text, d)."""
    x = vocab_parallel_embed(p.embed, tokens, mesh)
    if p.cfg.family != "vlm":
        return x
    if patch_embeds is None:
        raise ValueError(f"{p.cfg.name}: the VLM needs patch_embeds, the stubbed vision "
                         f"tower's (B, n_patches, d_model) output "
                         f"(models.vlm_stub.fake_patch_embeds)")
    return torch.cat([patch_embeds.to(x.dtype) @ p.patch_proj, x], 1)


def lm_head_matrix(p: Transformer) -> torch.Tensor:
    """(d, V), or the rank's vocab columns (d, V / tp) of a shard."""
    return p.embed.T if p.cfg.tie_embeddings else p.lm_head


def _unembed(p: Transformer, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The logits (on ``mesh``, the rank's vocab shard)."""
    return column_parallel(p.final_norm(x), (lm_head_matrix(p),), mesh)[0]


def _positions(n: int, start: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def _layers(p: Transformer, tokens: torch.Tensor, cfg, patch_embeds: Optional[torch.Tensor],
            aux: bool, attention: Optional[Attention] = None,
            policy: Optional[str] = None, mesh=None) -> Tuple[torch.Tensor, Aux]:
    """The embedding and every block -> (x before the final norm, the aux
    losses summed over layers, 0 for dense ones or without ``aux``); each
    block under :func:`remat` with ``policy``."""
    x = _embed_inputs(p, tokens, patch_embeds, mesh)
    positions = _positions(x.shape[1], 0, x.device)
    total = {name: torch.zeros((), device=x.device) for name in ("lb_loss", "z_loss")}

    def body(layer, x):
        x, _, layer_aux = _block(layer, x, cfg, positions, attention=attention, aux=aux,
                                 mesh=mesh)
        return x, layer_aux

    for layer in p.layers:
        x, layer_aux = remat(body, layer, x, policy=policy)
        for name, v in (layer_aux or {}).items():
            total[name] = total[name] + v
    return x, total


@torch.no_grad()
def lm_forward(p: Transformer, tokens: torch.Tensor, cfg, *,
               patch_embeds: Optional[torch.Tensor] = None, return_aux: bool = False,
               mesh=None):
    """Full-sequence forward -> logits (B, S, V) (the VLM's S counts its
    patches; on ``mesh`` the rank's vocab shard); with ``return_aux``,
    (logits, {"lb_loss", "z_loss"} summed over layers, 0 for dense
    ones)."""
    x, total = _layers(p, tokens, cfg, patch_embeds, aux=return_aux, mesh=mesh)
    logits = _unembed(p, x, mesh)
    return (logits, total) if return_aux else logits


def lm_train_forward(p: Transformer, tokens: torch.Tensor, cfg, *,
                     patch_embeds: Optional[torch.Tensor] = None, remat: bool = True,
                     return_hidden: bool = False, mesh=None) -> Tuple[torch.Tensor, Aux]:
    """The training forward, with gradients -> (logits (B, S, V), or with
    ``return_hidden`` the final normed hidden states (B, S, d), and the aux
    losses summed over layers).  Each block runs under ``cfg.remat_policy``
    when ``remat``; attention is the plain ``swa_attention_chunked``.  On
    ``mesh`` the logits are the rank's vocab shard."""
    x, total = _layers(p, tokens, cfg, patch_embeds, aux=True, attention=swa_attention_chunked,
                       policy=cfg.remat_policy if remat else None, mesh=mesh)
    return (p.final_norm(x) if return_hidden else _unembed(p, x, mesh)), total


@torch.no_grad()
def lm_prefill(p: Transformer, tokens: torch.Tensor, cfg, *,
               patch_embeds: Optional[torch.Tensor] = None,
               attention: Optional[Attention] = None, mesh=None) -> Tuple[torch.Tensor, Cache]:
    """Prefill -> (logits of the last position (B, V), stacked cache); on
    ``mesh`` the rank's vocab shard (B, V / tp) and its KV heads' cache."""
    x = _embed_inputs(p, tokens, patch_embeds, mesh)
    positions = _positions(x.shape[1], 0, x.device)
    caches = []
    for layer in p.layers:
        x, cache, _ = _block(layer, x, cfg, positions, return_cache=True, attention=attention,
                             mesh=mesh)
        caches.append(cache)
    logits = _unembed(p, x[:, -1:, :], mesh)[:, 0]
    return logits, {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


@torch.no_grad()
def lm_decode_step(p: Transformer, cache: Cache, tokens: torch.Tensor, pos: int,
                   cfg, mesh=None) -> Tuple[torch.Tensor, Cache]:
    """One decode step at write position ``pos`` -> (logits (B, V), or on
    ``mesh`` the rank's vocab shard, and the same cache, updated in
    place)."""
    pos = int(pos)
    x = vocab_parallel_embed(p.embed, tokens[:, None], mesh)
    positions = _positions(1, pos, x.device)
    for i, layer in enumerate(p.layers):
        x, _, _ = _block(layer, x, cfg, positions, cache={k: t[i] for k, t in cache.items()},
                         pos=pos, mesh=mesh)
    return _unembed(p, x, mesh)[:, 0], cache


def lm_cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE,
                  mesh=None) -> Dict[str, TensorSpec]:
    """Stacked (L, ...) shapes and dtypes of the decode cache (on ``mesh``,
    of the rank's KV heads)."""
    per_layer = attention_cache_spec(cfg, batch, seq_len, dtype, mesh)
    return {k: TensorSpec((cfg.n_layers,) + s.shape, s.dtype) for k, s in per_layer.items()}
