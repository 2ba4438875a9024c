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

__all__ = ["AdamWState", "adamw_init", "global_norm", "cosine_schedule", "adamw_update"]

Named = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Named
    v: Named
    step: torch.Tensor  # int32, 0-d


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


@torch.no_grad()
def adamw_update(grads: Named, state: AdamWState, params: Named, *,
                 lr: Union[torch.Tensor, float], b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0) -> Tuple[Named, AdamWState]:
    """One AdamW step -> (params, the new state).  The parameters are
    written in place (each ``params[k]`` keeps its storage, dtype and
    ``requires_grad``); ``m``, ``v`` and ``step`` are new tensors, and
    ``state`` is left as it was."""
    step = state.step + 1
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / (global_norm(grads) + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    m_new, v_new = {}, {}
    for k, p in params.items():
        g = grads[k].float()
        if scale is not None:
            g = g * scale
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        update = update + weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
        m_new[k], v_new[k] = m, v
    return params, AdamWState(m=m_new, v=v_new, step=step)
