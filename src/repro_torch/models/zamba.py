"""Zamba2-style hybrid backbone: a Mamba2 trunk and one SHARED attention
block applied every ``shared_attn_every`` layers (port of
`repro.models.zamba`, arXiv:2411.15242).

The shared block (full attention and a SwiGLU MLP, one set of weights, the
transformer's :class:`~.transformer.Block`) runs before each Mamba2 layer
whose index i has i % every == 0: ceil(81 / 6) = 14 applications for
zamba2-7b, each with its OWN KV cache, in slot i // every (weights shared,
caches not).  The reference scans its stacked layers; the port keeps one
:class:`MambaLayer` per layer and loops.

As in the reference, the concat-with-embedding input and the
per-application LoRA deltas of the released checkpoints are left out.

The decode cache is the reference's tree, ``{"ssm": {"conv": (L, B, cw -
1, C), "ssd": (L, B, nh, hd, N) float32}, "attn": {"k", "v": (A, B, S,
KVH, hd), "pos": (A, S)}}``, and decode updates it in place.  Prefill's
attention goes through ``attention=`` (default: kernel 8's wrapper, at
window = S), once per application.

:func:`zamba_train_forward` is the forward with gradients: each layer (the
shared block where it applies, then the mixer) under :func:`layers.remat`
(the reference checkpoints its scanned body), the shared block's attention
the plain ``swa_attention_chunked``, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..kernels.swa_attention.ref import swa_attention_chunked
from .attention import Attention, TensorSpec, gqa_cache_spec, gqa_init
from .layers import DTYPE, RMSNorm, dense_init, embed_init, mlp_init, remat, weight
from .ssm import Mamba2, mamba2_apply, mamba2_init, mamba2_state_spec
from .transformer import Block, _block, _positions

__all__ = ["MambaLayer", "Zamba", "zamba_init", "zamba_forward", "zamba_train_forward",
           "zamba_prefill",
           "zamba_decode_step", "zamba_cache_spec"]

Cache = Dict[str, Dict[str, torch.Tensor]]


class MambaLayer(nn.Module):
    """A pre-norm Mamba2 layer (the reference's ``mamba_layers`` entry)."""

    def __init__(self, norm: RMSNorm, mixer: Mamba2):
        super().__init__()
        self.norm, self.mixer = norm, mixer


class Zamba(nn.Module):
    """Embedding (V, d), the Mamba2 layers, the shared block, the final norm
    and lm_head (d, V)."""

    def __init__(self, cfg, embed: torch.Tensor, mamba_layers: List[MambaLayer],
                 shared_attn: Block, final_norm: RMSNorm, lm_head: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.embed = weight(embed)
        self.mamba_layers = nn.ModuleList(mamba_layers)
        self.shared_attn = shared_attn
        self.final_norm = final_norm
        self.lm_head = weight(lm_head)


def _n_apps(cfg) -> int:
    return -(-cfg.n_layers // cfg.shared_attn_every)


def zamba_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> Zamba:
    """Random weights from ``gen``, the reference's initialisers and scales
    (its numbers differ: another generator)."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    layers = [MambaLayer(RMSNorm(ones(), cfg.norm_eps), mamba2_init(gen, cfg, dtype, device))
              for _ in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    shared = Block(RMSNorm(ones(), cfg.norm_eps), gqa_init(gen, cfg, dtype, device),
                   RMSNorm(ones(), cfg.norm_eps), mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                                          device))
    head = dense_init(gen, cfg.d_model, cfg.vocab, dtype, device)
    return Zamba(cfg, embed, layers, shared, RMSNorm(ones(), cfg.norm_eps), head)


def _mixer(layer: MambaLayer, x: torch.Tensor, cfg, **kw):
    m, state = mamba2_apply(layer.mixer, layer.norm(x), cfg, **kw)
    return x + m, state


def _run(p: Zamba, tokens: torch.Tensor, cfg, return_hidden: bool,
         attention: Optional[Attention] = None, policy: Optional[str] = None) -> torch.Tensor:
    x = p.embed[tokens]
    positions = _positions(x.shape[1], 0, x.device)

    def body(i, layer, x):
        if i % cfg.shared_attn_every == 0:
            x = _block(p.shared_attn, x, cfg, positions, attention=attention)[0]
        return _mixer(layer, x, cfg)[0]

    for i, layer in enumerate(p.mamba_layers):
        x = remat(body, i, layer, x, policy=policy)
    x = p.final_norm(x)
    return x if return_hidden else x @ p.lm_head


@torch.no_grad()
def zamba_forward(p: Zamba, tokens: torch.Tensor, cfg, *,
                  return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V), or with ``return_hidden``
    the final normed hidden states (B, S, d)."""
    return _run(p, tokens, cfg, return_hidden)


def zamba_train_forward(p: Zamba, tokens: torch.Tensor, cfg, *, remat: bool = True,
                        return_hidden: bool = False) -> torch.Tensor:
    """:func:`zamba_forward` with gradients, each layer under full remat
    when ``remat`` (the reference's plain ``jax.checkpoint``), the shared
    block's attention plain."""
    return _run(p, tokens, cfg, return_hidden, attention=swa_attention_chunked,
                policy="full" if remat else None)


@torch.no_grad()
def zamba_prefill(p: Zamba, tokens: torch.Tensor, cfg, *,
                  attention: Optional[Attention] = None) -> Tuple[torch.Tensor, Cache]:
    """Prefill -> (logits of the last position (B, V), {"ssm": the L layers'
    states, "attn": the A applications' KV caches})."""
    x = p.embed[tokens]
    b, s = tokens.shape
    positions = _positions(s, 0, x.device)
    every = cfg.shared_attn_every
    ssm, attn = ({k: torch.zeros(t.shape, dtype=t.dtype, device=x.device) for k, t in g.items()}
                 for g in zamba_cache_spec(cfg, b, s, x.dtype).values())
    for i, layer in enumerate(p.mamba_layers):
        if i % every == 0:
            x, cache, _ = _block(p.shared_attn, x, cfg, positions, return_cache=True,
                                 attention=attention)
            for k, t in cache.items():
                attn[k][i // every] = t
            del cache
        x, state = _mixer(layer, x, cfg, return_state=True)
        for k, t in state.items():
            ssm[k][i] = t
    logits = (p.final_norm(x[:, -1:]) @ p.lm_head)[:, 0]
    return logits, {"ssm": ssm, "attn": attn}


@torch.no_grad()
def zamba_decode_step(p: Zamba, cache: Cache, tokens: torch.Tensor, pos: int,
                      cfg) -> Tuple[torch.Tensor, Cache]:
    """One decode step at write position ``pos`` -> (logits (B, V), the same
    cache, updated in place)."""
    pos = int(pos)
    x = p.embed[tokens[:, None]]
    positions = _positions(1, pos, x.device)
    every = cfg.shared_attn_every
    for i, layer in enumerate(p.mamba_layers):
        if i % every == 0:
            app = {k: t[i // every] for k, t in cache["attn"].items()}
            x = _block(p.shared_attn, x, cfg, positions, cache=app, pos=pos)[0]
        state = {k: t[i] for k, t in cache["ssm"].items()}
        x, new = _mixer(layer, x, cfg, state=state)
        for k, t in new.items():
            state[k].copy_(t)
    return (p.final_norm(x) @ p.lm_head)[:, 0], cache


def zamba_cache_spec(cfg, batch: int, seq_len: int,
                     dtype=DTYPE) -> Dict[str, Dict[str, TensorSpec]]:
    """Stacked shapes and dtypes of the decode cache: (L, ...) Mamba2
    states, (A, ...) KV caches."""
    def stacked(spec, n):
        return {k: TensorSpec((n,) + tuple(s.shape), s.dtype) for k, s in spec.items()}

    return {"ssm": stacked(mamba2_state_spec(cfg, batch, dtype), cfg.n_layers),
            "attn": stacked(gqa_cache_spec(cfg, batch, seq_len, dtype), _n_apps(cfg))}
