"""AdamW over named tensors (port of `repro.training.optimizer`).

The state mirrors the parameters by name: float32 first and second moments
``m`` and ``v`` whatever the parameters' dtype, and the int32 ``step``.
The update clips by the global norm, ``min(1, clip / (gn + 1e-9))``, takes
the bias-corrected ``(m / bc1) / (sqrt(v / bc2) + eps)``, adds the
decoupled ``weight_decay * p``, computes in float32 and casts back to each
parameter's dtype, in the reference's order of operations.  Not
``torch.optim.AdamW``: with bfloat16 parameters it keeps ``m`` and ``v``
in bfloat16.

The learning rate of :func:`cosine_schedule` is a float32 tensor of the
step: linear warmup from 0 at step 0, then a cosine to 0 at ``total``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["AdamWState", "adamw_init", "global_norm", "cosine_schedule", "adamw_update",
           "Zero1Plan", "zero1_plan", "zero1_init", "zero1_update"]

Named = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Named
    v: Named
    step: torch.Tensor  # int32, 0-d
    plan: Optional["Zero1Plan"] = None  # ZeRO-1 moments' (zero1_init)


def adamw_init(params: Named) -> AdamWState:
    """Zero float32 moments of each parameter's shape, on its device; step 0."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    device = next(iter(params.values())).device
    return AdamWState(m=zeros(), v=zeros(), step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: Named) -> torch.Tensor:
    """sqrt of the sum over every leaf of its float32 sum of squares."""
    squares = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.stack(squares).sum())


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """step -> float32 learning rate: ``base_lr * step / warmup`` below
    ``warmup`` (0 at step 0), then ``base_lr / 2 (1 + cos(pi frac))`` with
    frac the share of the steps after the warmup, clipped to [0, 1]."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def _clip_scale(norm: torch.Tensor, clip_norm: Optional[float]) -> Optional[torch.Tensor]:
    if clip_norm is None:
        return None
    return torch.clamp(clip_norm / (norm + 1e-9), max=1.0)


def _bias_corrections(step: torch.Tensor, b1: float, b2: float):
    stepf = step.float()
    return 1 - b1 ** stepf, 1 - b2 ** stepf


def _leaf_update(g, m, v, p, scale, lr, b1, b2, eps, weight_decay, bc1, bc2):
    """One leaf's (or slice's) AdamW arithmetic -> (new p in its dtype, m,
    v): elementwise, so a slice's result is the whole leaf's, sliced."""
    g = g.float()
    if scale is not None:
        g = g * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    update = update + weight_decay * p.float()
    return (p.float() - lr * update).to(p.dtype), m, v


@torch.no_grad()
def adamw_update(grads: Named, state: AdamWState, params: Named, *,
                 lr: Union[torch.Tensor, float], b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0,
                 norm: Optional[torch.Tensor] = None) -> Tuple[Named, AdamWState]:
    """One AdamW step -> (params, the new state).  The parameters are
    written in place (each ``params[k]`` keeps its storage, dtype and
    ``requires_grad``); ``m``, ``v`` and ``step`` are new tensors, and
    ``state`` is left as it was.  ``norm``: the gradients' global norm for
    the clip where the caller has it (a tensor-parallel rank's is the whole
    model's, `parallel.tensor.global_norm`); by default
    :func:`global_norm` of ``grads``."""
    step = state.step + 1
    scale = _clip_scale(global_norm(grads) if norm is None else norm, clip_norm)
    bc1, bc2 = _bias_corrections(step, b1, b2)
    m_new, v_new = {}, {}
    for k, p in params.items():
        new, m_new[k], v_new[k] = _leaf_update(grads[k], state.m[k], state.v[k], p, scale, lr,
                                               b1, b2, eps, weight_decay, bc1, bc2)
        p.copy_(new)
        del new
    return params, AdamWState(m=m_new, v=v_new, step=step)


# ------------------------------------------------------------- ZeRO-1 --


class Zero1Plan(NamedTuple):
    """Which part of each leaf's moments a data rank holds (ZeRO-1 over the
    data axis, the rule of ``parallel.sharding.zero1_pspecs``): by name,
    ``("whole",)`` (every data rank holds and updates the whole leaf: a
    data axis of 1, or no dimension the rule may split), ``("slice", dim)``
    (its 1/data of ``dim``) or ``("layer", owner)`` (the rule splits the
    stacked layer axis: the whole leaf of a layer, held by data rank
    ``owner`` only).  ``rank`` of ``size`` data ranks."""

    parts: Dict[str, Tuple]
    rank: int
    size: int

    def held(self, name: str) -> bool:
        part = self.parts[name]
        return part[0] != "layer" or part[1] == self.rank

    def take(self, name: str, t: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """Data rank ``rank``'s (default this one's) part of ``t``, the
        rank's whole leaf ``name`` (a view)."""
        part, rank = self.parts[name], self.rank if rank is None else rank
        if part[0] != "slice":
            return t
        n = t.shape[part[1]] // self.size
        return t.narrow(part[1], rank * n, n)


def _tree_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference tree's path of the port's parameter ``name`` (a name
    of ``named_parameters``) and its layer (None outside the layers): the
    stacked leaf ``layers/attn/wq`` for ``layers.3.attn.wq``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]  # an RMSNorm's weight is its leaf
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def zero1_plan(named: Named, cfg, mesh) -> Zero1Plan:
    """The ZeRO-1 plan of a (dense) model rank's ``named`` parameters on
    ``mesh``: the rule tables' ``zero1_pspecs`` on the whole model's
    stacked tree (`models.params_to_tree`'s layout) put the data axes on
    the first divisible dimension that the parameter specs leave whole
    (drawing the whole model on the ``meta`` device)."""
    from ..models import init_params
    from ..parallel import sharding
    from ..parallel import tensor as tp

    dp, rank = tp.data_size(mesh), tp.data_rank(mesh)
    if dp == 1:
        return Zero1Plan({k: ("whole",) for k in named}, rank, dp)
    whole = init_params(cfg, generator=torch.Generator(), dtype=torch.float32, device="meta")
    tree = sharding.param_tree(whole)
    pspecs, zspecs = sharding.param_pspecs(tree, mesh), sharding.zero1_pspecs(tree, mesh)
    parts = {}
    for k in named:
        path, layer = _tree_path(k)
        ps, zs = pspecs, zspecs
        for key in path:
            ps, zs = ps[key], zs[key]
        ps = tuple(ps) + (None,) * (len(zs) - len(ps))
        dims = [i for i, (a, b) in enumerate(zip(ps, zs)) if a != b]
        if not dims:
            parts[k] = ("whole",)
        elif layer is not None and dims[0] == 0:
            parts[k] = ("layer", layer // (cfg.n_layers // dp))
        else:
            parts[k] = ("slice", dims[0] - (layer is not None))
    return Zero1Plan(parts, rank, dp)


def zero1_init(named: Named, plan: Zero1Plan) -> AdamWState:
    """Zero float32 moments of the parts of ``named`` the rank holds, and
    ``plan``, which :func:`zero1_update` reads."""
    def zeros():
        return {k: torch.zeros(plan.take(k, p).shape, dtype=torch.float32, device=p.device)
                for k, p in named.items() if plan.held(k)}

    device = next(iter(named.values())).device
    return AdamWState(m=zeros(), v=zeros(), step=torch.zeros((), dtype=torch.int32, device=device),
                      plan=plan)


@torch.no_grad()
def zero1_update(grads: Named, state: AdamWState, params: Named, mesh, *,
                 lr: Union[torch.Tensor, float], norm: torch.Tensor, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0) -> Tuple[Named, AdamWState]:
    """:func:`adamw_update` with ZeRO-1 moments: the rank updates the part
    of each leaf whose moments it holds (``state`` from
    :func:`zero1_init`, with its plan), then every updated part is
    all-gathered over the data axis in rank order (in
    ``parallel.sharding.buckets``, counted as the
    step's ``"zero1"``) and written into each rank's parameters: a concatenation,
    so the result is bitwise ``adamw_update``'s with whole moments on the
    same gradients and norm, on every data rank."""
    from ..parallel import sharding
    from ..parallel import tensor as tp

    plan = state.plan
    if plan is None or set(state.m) != {k for k in params if plan.held(k)}:
        raise ValueError("the optimizer state does not hold this rank's ZeRO-1 moments: "
                         "make it with training.zero1_init (or the train step's init_state)")
    step = state.step + 1
    scale = _clip_scale(norm, clip_norm)
    bc1, bc2 = _bias_corrections(step, b1, b2)
    m_new, v_new, sent = {}, {}, {}
    for k, p in params.items():
        if not plan.held(k):
            continue
        part = plan.take(k, p)
        new, m_new[k], v_new[k] = _leaf_update(plan.take(k, grads[k]), state.m[k], state.v[k],
                                               part, scale, lr, b1, b2, eps, weight_decay,
                                               bc1, bc2)
        if plan.parts[k][0] == "whole":
            p.copy_(new)
        else:
            sent[k] = new
    # rank r sends, in the order of ``params``, its slice of every sliced
    # leaf and the whole leaves of its layers: the same shapes in the same
    # order on every rank, gathered in buckets of one dtype
    def sends(r):
        return [k for k, p in params.items() if plan.parts[k][0] == "slice"
                or plan.parts[k] == ("layer", r)]

    units = [sends(r) for r in range(plan.size)]
    for group in sharding.buckets(units[plan.rank], {k: sent[k] for k in units[plan.rank]}):
        stacked = tp._gather(torch.cat([sent[units[plan.rank][i]].reshape(-1) for i in group]),
                             mesh, "data", stage="zero1")
        for r in range(plan.size):
            start = 0
            for i in group:
                k = units[r][i]
                dst = plan.take(k, params[k], r)
                dst.copy_(stacked[r, start:start + dst.numel()].view(dst.shape))
                start += dst.numel()
    return params, AdamWState(m=m_new, v=v_new, step=step, plan=plan)
