"""Mixture-of-Experts layer: top-k routing, static-capacity dispatch (port
of `repro.models.moe`).

The router runs in float32: softmax, top-k, gates renormalised with a
1e-9 floor.  Each expert's bucket holds ``capacity = max(int(t k / e
capacity_factor), min(t k, 4))`` (token, choice) pairs; a pair's place in
its bucket is its rank in a stable sort of the token-major flattened
choices, so the first-come pairs are kept and the same ones dropped as in
the reference.  Dispatch is by gather and scatter (``"gather"``, the
default) or by one-hot products (``"einsum"``, the reference's iteration-0
formulation, O(T E C d)); both combine in float32 and cast back.  The
experts are batched matrix products (``torch.bmm``: the reference computes
them outside any Pallas kernel) with SwiGLU's activation in float32; the
shared expert(s) are one dense SwiGLU of width ``num_shared d_ff_expert``.
The reference's ``shard(...)`` annotations (expert parallelism) are
dropped on one device.

Aux outputs: the load-balance loss (the first choice's dispatch fraction
by a scatter-add, times the mean router probability, times e) and the
router z-loss (mean logsumexp^2).  Serving does not use them, so
``moe_apply(..., aux=False)`` skips their work (the reference's jit drops
it as dead code).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .layers import DTYPE, MLP, expert_init, mlp_init, weight

__all__ = ["MoE", "moe_init", "moe_apply", "moe_capacity", "moe_route", "bucket_positions"]

Aux = Dict[str, torch.Tensor]


class MoE(nn.Module):
    """router (d, E) float32; e_gate, e_up (E, d, f) and e_down (E, f, d) in
    the model's dtype; ``shared`` a SwiGLU of width num_shared f, or None."""

    def __init__(self, router, e_gate, e_up, e_down, shared: Optional[MLP] = None):
        super().__init__()
        self.router = weight(router)
        self.e_gate, self.e_up, self.e_down = weight(e_gate), weight(e_up), weight(e_down)
        self.shared = shared


def moe_init(gen: torch.Generator, cfg, dtype=DTYPE, device=None) -> MoE:
    """The reference's scales: 1/sqrt(d) for the router, e_gate and e_up,
    1/sqrt(f) for e_down.  The expert leaves are drawn one expert slab at a
    time into the model's dtype (:func:`layers.expert_init`), on ``device``
    (default: the generator's)."""
    device = gen.device if device is None else device
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    scale = 1.0 / math.sqrt(d)
    router = torch.randn((d, e), generator=gen, device=device) * scale
    return MoE(router, expert_init(gen, (e, d, f), scale, dtype, device),
               expert_init(gen, (e, d, f), scale, dtype, device),
               expert_init(gen, (e, f, d), 1.0 / math.sqrt(f), dtype, device),
               mlp_init(gen, d, m.num_shared * f, dtype, device) if m.num_shared else None)


def moe_capacity(t: int, cfg) -> int:
    """Static bucket size of each expert for ``t`` tokens.  The floor of
    min(t k, 4) keeps a small decode batch dropless."""
    m = cfg.moe
    k = m.top_k
    return max(int(t * k / m.num_experts * m.capacity_factor), min(t * k, 4))


def bucket_positions(expert_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's bucket, (T, k) int64: how
    many earlier pairs, token-major, chose the same expert (a stable-sort
    rank)."""
    flat_e = expert_idx.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    seg_start = torch.searchsorted(sorted_e, torch.arange(num_experts, device=flat_e.device))
    pos_sorted = torch.arange(flat_e.numel(), device=flat_e.device) - seg_start[sorted_e]
    return torch.empty_like(flat_e).index_put_((sort_idx,), pos_sorted).reshape(expert_idx.shape)


def moe_route(p: MoE, xt: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    """Routing of the tokens xt (T, d): (logits (T, E) float32, probs,
    gates (T, k), expert_idx (T, k) int64, pos (T, k) int64, the place of
    each (token, choice) in its expert's bucket by stable-sort rank)."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = xt.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gate_vals, expert_idx, bucket_positions(expert_idx, e)


def moe_apply(p: MoE, x: torch.Tensor, cfg, *,
              aux: bool = True) -> Tuple[torch.Tensor, Optional[Aux]]:
    """x (B, S, d) -> (out (B, S, d), {"lb_loss", "z_loss"}, or None
    without ``aux``)."""
    m = cfg.moe
    b, s, d = x.shape
    e = m.num_experts
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    dev = x.device
    logits, probs, gate_vals, expert_idx, pos = moe_route(p, xt, cfg)
    capacity = moe_capacity(t, cfg)
    keep = pos < capacity

    if m.dispatch == "einsum":
        onehot = torch.nn.functional.one_hot(expert_idx, e).float()  # (T, k, E)
        pos_oh = (pos[..., None] == torch.arange(capacity, device=dev)).float()
        pos_oh = pos_oh * keep[..., None]  # a dropped pair's row is zero
        dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)
        combine = torch.einsum("tke,tkc->tec", onehot * gate_vals[..., None], pos_oh)
        ein = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    else:
        # slot e * capacity collects the dropped pairs and is cut off
        flat_slot = torch.where(keep, expert_idx * capacity + pos, e * capacity)
        token_ids = torch.arange(t, device=dev)[:, None].expand_as(expert_idx)
        src = torch.full((e * capacity + 1,), t, dtype=torch.long, device=dev)  # t: none
        src[flat_slot.reshape(-1)] = token_ids.reshape(-1)
        x_pad = torch.cat([xt, xt.new_zeros((1, d))])
        ein = x_pad[src[:-1]].reshape(e, capacity, d)

    # each buffer is let go once read: at deepseek-v2's prefill (E x C =
    # 160 x 1,500 slots of 5,120) they are 0.7-2.5 GB each
    g = torch.bmm(ein, p.e_gate)
    u = torch.bmm(ein, p.e_up)
    del ein
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    del g, u
    eout = torch.bmm(h, p.e_down)  # (E, C, d)
    del h

    if m.dispatch == "einsum":
        out = torch.einsum("tec,ecd->td", combine, eout.float()).to(x.dtype)
    else:
        slot = torch.where(keep, expert_idx * capacity + pos, 0)
        picked = eout.reshape(e * capacity, d)[slot.reshape(-1)].reshape(*slot.shape, d)
        picked = torch.where(keep[..., None], picked, 0)
        out = torch.einsum("tkd,tk->td", picked.float(), gate_vals).to(x.dtype)
    if p.shared is not None:
        out = out + p.shared(xt)
    out = out.reshape(b, s, d)
    if not aux:
        return out, None

    density = torch.zeros(e, device=dev).index_add_(
        0, expert_idx[:, 0], torch.ones(t, device=dev)) / t
    lb_loss = e * torch.sum(density * probs.mean(0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, {"lb_loss": lb_loss, "z_loss": z_loss}
