"""xLSTM language model (port of `repro.models.xlstm_lm`): alternating
mLSTM / sLSTM blocks, xlstm-125m.

With ``slstm_every`` set, the n_layers-deep stack is n_layers / 2 pairs of
(mLSTM -> sLSTM), each a pre-norm residual; with ``slstm_every = 0`` every
"pair" is an mLSTM block alone.  The reference scans its stacked pairs; the
port keeps one :class:`XLSTMPair` per pair and loops.

The decode cache is the reference's tree of recurrent states, not a KV
cache: ``{"m": {"C": (P, B, nh, hd, hd), "n": (P, B, nh, hd), "m": (P, B,
nh)}, "s": {"h", "c", "n", "m": (P, B, nh, hd)}}``, all float32 whatever
the model's dtype, and without a sequence axis: its bytes do not grow with
the context.  Decode updates it in place.

:func:`xlstm_train_forward` is the forward with gradients, each pair under
:func:`layers.remat` (the reference checkpoints its scanned body).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .attention import TensorSpec
from .layers import DTYPE, RMSNorm, dense_init, embed_init, remat, weight
from .xlstm import (MLSTM, SLSTM, mlstm_apply, mlstm_init, mlstm_state_spec, slstm_apply,
                    slstm_init, slstm_state_spec)

__all__ = ["XLSTMPair", "XLSTM", "xlstm_lm_init", "xlstm_forward", "xlstm_train_forward",
           "xlstm_prefill",
           "xlstm_decode_step", "xlstm_cache_spec"]

Cache = Dict[str, Dict[str, torch.Tensor]]


class XLSTMPair(nn.Module):
    """One pair: the mLSTM block and its pre-norm, then (unless the stack is
    mLSTM only) the sLSTM block and its pre-norm."""

    def __init__(self, m_norm: RMSNorm, mlstm: MLSTM, s_norm: Optional[RMSNorm] = None,
                 slstm: Optional[SLSTM] = None):
        super().__init__()
        self.m_norm, self.mlstm, self.s_norm, self.slstm = m_norm, mlstm, s_norm, slstm


class XLSTM(nn.Module):
    """Embedding (V, d), the pairs, the final norm and lm_head (d, V)."""

    def __init__(self, cfg, embed: torch.Tensor, pairs: List[XLSTMPair], final_norm: RMSNorm,
                 lm_head: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.embed = weight(embed)
        self.pairs = nn.ModuleList(pairs)
        self.final_norm = final_norm
        self.lm_head = weight(lm_head)


def _n_pairs(cfg) -> int:
    if cfg.slstm_every:
        assert cfg.n_layers % 2 == 0, "alternating stack needs even n_layers"
        return cfg.n_layers // 2
    return cfg.n_layers


def xlstm_lm_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> XLSTM:
    """Random weights from ``gen``, the reference's initialisers and scales
    (its numbers differ: another generator)."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731

    def pair():
        mixer = mlstm_init(gen, cfg, dtype, device)
        if not cfg.slstm_every:
            return XLSTMPair(RMSNorm(ones(), cfg.norm_eps), mixer)
        return XLSTMPair(RMSNorm(ones(), cfg.norm_eps), mixer, RMSNorm(ones(), cfg.norm_eps),
                         slstm_init(gen, cfg, dtype, device))

    pairs = [pair() for _ in range(_n_pairs(cfg))]
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    head = dense_init(gen, cfg.d_model, cfg.vocab, dtype, device)
    return XLSTM(cfg, embed, pairs, RMSNorm(ones(), cfg.norm_eps), head)


def _pair_apply(pair: XLSTMPair, x: torch.Tensor, cfg, states: Optional[Cache] = None,
                return_state: bool = False) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x -> (x after the pair, {"m": the mLSTM state, "s": the sLSTM state}
    with ``return_state`` or when ``states`` were given, else None)."""
    m_out, m_state = mlstm_apply(pair.mlstm, pair.m_norm(x), cfg,
                                 state=None if states is None else states["m"],
                                 return_state=return_state)
    x = x + m_out
    new = {"m": m_state}
    if cfg.slstm_every:
        s_out, new["s"] = slstm_apply(pair.slstm, pair.s_norm(x), cfg,
                                      state=None if states is None else states["s"],
                                      return_state=return_state)
        x = x + s_out
    return x, (new if (return_state or states is not None) else None)


def _run(p: XLSTM, tokens: torch.Tensor, cfg, return_hidden: bool,
         policy: Optional[str] = None) -> torch.Tensor:
    x = p.embed[tokens]
    for pair in p.pairs:
        x = remat(lambda pair, x: _pair_apply(pair, x, cfg)[0], pair, x, policy=policy)
    return p.final_norm(x) if return_hidden else _logits(p, x)


@torch.no_grad()
def xlstm_forward(p: XLSTM, tokens: torch.Tensor, cfg, *,
                  return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V), or with ``return_hidden``
    the final normed hidden states (B, S, d)."""
    return _run(p, tokens, cfg, return_hidden)


def xlstm_train_forward(p: XLSTM, tokens: torch.Tensor, cfg, *, remat: bool = True,
                        return_hidden: bool = False) -> torch.Tensor:
    """:func:`xlstm_forward` with gradients, each pair under
    full remat when ``remat`` (the reference's plain ``jax.checkpoint``)."""
    return _run(p, tokens, cfg, return_hidden, policy="full" if remat else None)


def _logits(p: XLSTM, x: torch.Tensor) -> torch.Tensor:
    """The final norm and lm_head: (B, S, d) -> (B, S, V)."""
    return p.final_norm(x) @ p.lm_head


@torch.no_grad()
def xlstm_prefill(p: XLSTM, tokens: torch.Tensor, cfg) -> Tuple[torch.Tensor, Cache]:
    """Prefill -> (logits of the last position (B, V), every pair's states
    stacked on a leading (P, ...) axis)."""
    x = p.embed[tokens]
    cache = {g: {k: torch.empty(s.shape, dtype=s.dtype, device=x.device)
                 for k, s in spec.items()}
             for g, spec in xlstm_cache_spec(cfg, tokens.shape[0], tokens.shape[1]).items()}
    for i, pair in enumerate(p.pairs):
        x, states = _pair_apply(pair, x, cfg, return_state=True)
        for g, state in states.items():
            for k, t in state.items():
                cache[g][k][i] = t
    return _logits(p, x[:, -1:])[:, 0], cache


@torch.no_grad()
def xlstm_decode_step(p: XLSTM, cache: Cache, tokens: torch.Tensor, pos: int,
                      cfg) -> Tuple[torch.Tensor, Cache]:
    """One decode step -> (logits (B, V), the same cache, updated in place).
    ``pos`` is the write position of the engine's convention; a recurrent
    state has no use for it."""
    x = p.embed[tokens[:, None]]
    for i, pair in enumerate(p.pairs):
        states = {g: {k: t[i] for k, t in group.items()} for g, group in cache.items()}
        x, new = _pair_apply(pair, x, cfg, states=states)
        for g, state in new.items():
            for k, t in state.items():
                states[g][k].copy_(t)
    return _logits(p, x)[:, 0], cache


def xlstm_cache_spec(cfg, batch: int, seq_len: int,
                     dtype=DTYPE) -> Dict[str, Dict[str, TensorSpec]]:
    """Stacked shapes of the decode cache, (P, ...) per pair: float32 and
    independent of ``seq_len`` and ``dtype``, as the reference's."""
    per = {"m": mlstm_state_spec(cfg, batch)}
    if cfg.slstm_every:
        per["s"] = slstm_state_spec(cfg, batch)
    n = _n_pairs(cfg)
    return {g: {k: TensorSpec((n,) + tuple(s.shape), s.dtype) for k, s in spec.items()}
            for g, spec in per.items()}
