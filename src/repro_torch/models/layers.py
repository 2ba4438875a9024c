"""Shared model primitives (port of `repro.models.layers`).

Weights keep the reference's (in, out) layout and are applied as ``x @ w``;
initialisers draw from an explicit ``torch.Generator``.  Norms, rotary
embedding and the SwiGLU activation compute in float32 and cast back, as
the reference does, so bf16 models round where the reference rounds.

The reference's ``scan_layers`` is a loop over an ``nn.ModuleList`` in
`transformer.py`.  Training adds the reference's two cross-entropy
functions and :func:`remat`, the port of its ``jax.checkpoint`` of a layer
body under ``cfg.remat_policy``.

On a ``("data", "model")`` mesh (``mesh=``, `parallel.tensor`) the
projections are column-parallel (:func:`column_parallel`: the replicated
input, marked once for all the products that read it, times the rank's
columns) or row-parallel (:func:`row_parallel`: the rank's rows, then the
rank-ordered reduction), the embedding lookup is vocab-parallel
(:func:`vocab_parallel_embed`) and the cross-entropies read the rank's
vocab shard of the logits, their max, sum of exps and gold logit each
reduced over the model axis.  The backward mirrors each collective
(`parallel.tensor`): a replicated input's gradient is summed over the
model axis, a reduction's passes through, the max's is zero.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..parallel import tensor as tp
from ..parallel.sharding import collective_stage

__all__ = ["DTYPE", "dense_init", "expert_init", "embed_init", "rms_norm", "rope_frequencies",
           "apply_rope", "swiglu", "mlp_init", "RMSNorm", "MLP", "weight",
           "column_parallel", "row_parallel", "vocab_parallel_embed", "cross_entropy_loss",
           "chunked_cross_entropy", "remat", "REMAT_POLICIES"]

DTYPE = torch.bfloat16  # activation / parameter dtype of the full-size configs


def weight(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter: serving only, no gradient."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype=DTYPE,
               device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn((in_dim, out_dim), generator=gen, device=device) * scale).to(dtype)


def expert_init(gen: torch.Generator, shape, scale: float, dtype=DTYPE,
                device=None) -> torch.Tensor:
    """A stacked (E, a, b) leaf of standard normals times ``scale``, drawn
    one (a, b) slab at a time into a preallocated ``dtype`` tensor: the only
    float32 temporary is one slab (an expert of llama4-maverick is 168 MB in
    float32; its whole (128, 5120, 8192) leaf would be 21.5 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    slab = torch.empty(shape[1:], dtype=torch.float32, device=device)
    for i in range(shape[0]):
        torch.randn(shape[1:], generator=gen, device=device, out=slab)
        out[i].copy_(slab.mul_(scale))
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=DTYPE,
               device=None) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=device) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               head_axis: Optional[bool] = None) -> torch.Tensor:
    """Rotary embedding over split halves (not interleaved pairs).

    x: (..., S, H, D) when ``head_axis`` (default for 4-D and more), else
    (..., S, D); positions: (S,) absolute positions.
    """
    d = x.shape[-1]
    if head_axis is None:
        head_axis = x.ndim >= 4
    inv = rope_frequencies(d, theta, x.device)
    ang = positions[:, None].float() * inv  # (S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if head_axis:  # align with (..., S, H, D)
        cos, sin = cos[:, None, :], sin[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def column_parallel(x: torch.Tensor, ws, mesh=None) -> Tuple[torch.Tensor, ...]:
    """``x @ w`` for each ``w`` of ``ws``, the rank's columns, with ``x``
    replicated on the model axis: the rank's columns of each output.
    ``x`` is marked replicated once (:func:`parallel.tensor.replicated`),
    so the backward makes one model-axis reduction for all the products."""
    x = tp.replicated(x, mesh)
    return tuple(x @ w for w in ws)


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x @ w`` with ``x`` the rank's columns and ``w`` its rows, summed
    over the model axis in rank order: the whole output on every rank."""
    return tp.reduce_model(x @ w, mesh)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The embedding rows of ``tokens`` from the rank's vocab rows
    ``embed`` (V / tp, d): rows outside its range read as zero, then the
    model axis's sum (exactly one rank holds each row)."""
    if mesh is None:
        return embed[tokens]
    local = tokens - tp.vocab_start(mesh, embed.shape[0])
    inside = (local >= 0) & (local < embed.shape[0])
    x = torch.where(inside[..., None], embed[local.clamp(0, embed.shape[0] - 1)],
                    embed.new_zeros(()))
    return tp.reduce_model(x, mesh)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, mesh=None) -> torch.Tensor:
    """SwiGLU; on a mesh ``w_gate`` / ``w_up`` are column-parallel and
    ``w_down`` row-parallel by ``ff``."""
    g, u = column_parallel(x, (w_gate, w_up), mesh)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return row_parallel(h, w_down, mesh)


class RMSNorm(nn.Module):
    def __init__(self, w: torch.Tensor, eps: float):
        super().__init__()
        self.weight = weight(w)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class MLP(nn.Module):
    """SwiGLU feed-forward with (in, out) weights."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = weight(w_gate), weight(w_up), weight(w_down)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down, mesh)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=DTYPE, device=None) -> MLP:
    return MLP(dense_init(gen, d_model, d_ff, dtype, device),
               dense_init(gen, d_model, d_ff, dtype, device),
               dense_init(gen, d_ff, d_model, dtype, device))


# ------------------------------------------------------------ training --


def _vocab_parallel_lse_gold(logits: torch.Tensor, gold: torch.Tensor,
                             mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, gold logit) over the whole vocabulary from the rank's
    float32 shard (..., V / tp) and its share of the gold logit (0 where
    the label lies in another shard): the max, then the sum of exps and
    the gold logit, each reduced over the model axis."""
    top = tp.max_model(logits.amax(-1), mesh)
    sums = torch.exp(logits - top[..., None]).sum(-1)
    sums, gold = tp.reduce_model(torch.stack([sums, gold]), mesh).unbind(0)
    return top + torch.log(sums), gold


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1, mesh=None) -> torch.Tensor:
    """Mean token cross-entropy over the labels that are not ``ignore_id``;
    logits (..., V) reduced in float32.  On a mesh ``logits`` is the rank's
    vocab shard (..., V / tp) and the loss is the rank's rows' mean."""
    logits = logits.float()
    mask = labels != ignore_id
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    else:
        local = labels - tp.vocab_start(mesh, logits.shape[-1])
        inside = (local >= 0) & (local < logits.shape[-1])
        gold = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        lse, gold = _vocab_parallel_lse_gold(logits, torch.where(inside, gold, 0.0), mesh)
    return (lse - gold).mul(mask).sum() / mask.sum().clamp_min(1)


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, lab: torch.Tensor,
               ignore_id: int, mesh=None) -> torch.Tensor:
    """The summed NLL of one chunk's (B, c) labels; its (B, c, V) logits live
    only here.  The gold logit is picked by an index compare and a masked
    sum, as the reference picks it (its backward is elementwise: no
    scatter).  On a mesh ``head`` is the rank's vocab columns and ``h``
    the replicated hidden states."""
    logits = (h @ head).float()
    iota = torch.arange(logits.shape[-1], device=logits.device)
    if mesh is not None:
        iota = iota + tp.vocab_start(mesh, logits.shape[-1])
    gold = torch.where(iota == lab[..., None], logits, 0.0).sum(-1)
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        lse, gold = _vocab_parallel_lse_gold(logits, gold, mesh)
    return ((lse - gold) * (lab != ignore_id)).sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          ignore_id: int = -1, chunk: int = 256, mesh=None) -> torch.Tensor:
    """Fused next-token cross-entropy that never holds the (B, S, V) logits:
    hidden (B, S, d) final normed states, head (d, V), labels (B, S) with
    position t the target of hidden[t].  The sequence is walked in chunks of
    ``chunk`` positions; each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, the reference's per-chunk
    ``jax.checkpoint``), so its residuals are O(B c d).  On a mesh ``head``
    is the rank's vocab columns (d, V / tp), and ``hidden`` is marked
    replicated once for every chunk."""
    hidden = tp.replicated(hidden, mesh)
    s = hidden.shape[1]
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        part = checkpoint(_recomputed(_chunk_nll), hidden[:, c0:c0 + chunk], head,
                          labels[:, c0:c0 + chunk], ignore_id, mesh, use_reentrant=False)
        nll = nll + part
    count = (labels != ignore_id).sum()
    return nll / count.clamp_min(1)


# the matmul outputs a "dots" block keeps (the reference's
# dots_with_no_batch_dims_saveable: products without batch dims)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
REMAT_POLICIES = ("full", "dots")


def _recomputed(fn: Callable) -> Callable:
    """``fn`` for one ``torch.utils.checkpoint`` call: its first run is the
    forward, and each later run (the backward's recompute) counts its
    collectives as the train step's ``"recompute"`` stage."""
    runs = []

    def run(*args):
        runs.append(None)
        if len(runs) == 1:
            return fn(*args)
        with collective_stage("recompute"):
            return fn(*args)

    return run


def remat(fn: Callable, *args, policy: Optional[str] = "full"):
    """``fn(*args)`` under activation checkpointing, the reference's
    ``jax.checkpoint`` of a layer body: ``"full"`` keeps only the inputs
    and recomputes the body in the backward; ``"dots"`` also keeps the
    outputs of the products without batch dims (``torch.mm``, what ``x @
    w`` lowers to) and recomputes the rest; None runs ``fn`` plainly."""
    if policy is None:
        return fn(*args)
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} is not one of {REMAT_POLICIES}")
    if policy == "dots":
        return checkpoint(_recomputed(fn), *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _DOTS))
    return checkpoint(_recomputed(fn), *args, use_reentrant=False)
