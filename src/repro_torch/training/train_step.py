"""The train step: loss -> gradients -> AdamW, with microbatch accumulation
and, on a mesh, a data-parallel gradient mean (port of
`repro.training.train_step`).

``make_train_step(cfg, ...)`` returns ``step(model, opt_state, batch) ->
(model, opt_state, metrics)``: the model's parameters are updated in place
(:func:`optimizer.adamw_update`), the optimizer state is returned anew, and
the metrics ``ce``, ``lb_loss``, ``z_loss``, ``loss`` and ``lr`` (the
reference's) and ``grad_norm`` (the global norm before clipping) are 0-d
float32 tensors.  The loss is the cross-entropy plus 0.01 ``lb_loss`` plus
1e-3 ``z_loss``; ``fused_loss`` takes the chunked cross-entropy over the
final hidden states (the (B, S, V) logits never exist).

With ``accum > 1`` the batch is split into ``accum`` microbatches along
its leading axis, run one after another; each microbatch's gradients (in
the parameters' dtype, as autograd gives them) are added into float32
buffers, and their sum divided by ``accum``; the loss is the mean of the
microbatch losses.  As in the reference, ``lb_loss`` and ``z_loss`` are
then reported as 0.

With ``mesh`` (a 1-D ``"data"`` mesh of `repro_torch.parallel`), each rank
steps on its own slice of the global batch and the gradients and loss are
averaged over the ranks before the update: every rank's tensors are
gathered and summed in rank order (``parallel.psum_tree``), so every rank
applies the same update, bitwise, whatever the backend's reduction order.

On a ``("data", "model")`` mesh with a model axis (`parallel.tensor`),
:func:`loss_fn` runs forward only: the rank's model shard on its rows, the
vocab-parallel cross-entropy, and the loss averaged over the data axis in
rank order (each rank's mean weighted by its count of labels: the global
mean).  The backward through the model-axis collectives and a train step
on a model axis come with the next slice: ``make_train_step`` raises for
one until then.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..models.layers import chunked_cross_entropy, cross_entropy_loss
from ..models.model_zoo import forward_hidden, train_forward
from .optimizer import AdamWState, adamw_update, global_norm

__all__ = ["loss_fn", "named_parameters", "accumulate_grads", "grad_buffers",
           "make_train_step"]

Named = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def named_parameters(model) -> Named:
    """{name: parameter} of the parameters that require grad, in the
    model's registration order: the tree that gradients and the optimizer
    state mirror (`models.trainable` makes a model's parameters require
    grad)."""
    named = {k: p for k, p in model.named_parameters() if p.requires_grad}
    if not named:
        raise ValueError("the model has no parameter that requires grad: make it trainable "
                         "first (repro_torch.models.trainable)")
    return named


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg, *, lb_coef: float = 0.01,
            z_coef: float = 1e-3, fused: bool = False, loss_chunk: int = 256,
            mesh: Any = None) -> Tuple[torch.Tensor, Metrics]:
    """(loss, {"ce", "lb_loss", "z_loss"}): the next-token cross-entropy
    (hidden or logits at t against labels at t + 1) plus the MoE aux
    losses.  On a ``("data", "model")`` ``mesh``: ``params`` the rank's
    shard, ``batch`` its rows, the loss the whole batch's (forward only)."""
    labels = batch["labels"]
    if fused:
        hidden, head, aux = forward_hidden(params, batch, cfg, mesh=mesh)
        shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], 1)
        ce = chunked_cross_entropy(hidden, head, shifted, chunk=loss_chunk, mesh=mesh)
    else:
        logits, aux = train_forward(params, batch, cfg, mesh=mesh)
        ce = cross_entropy_loss(logits[:, :-1], labels[:, 1:], mesh=mesh)
    if mesh is not None:
        ce, aux = _data_mean(ce, (labels[:, 1:] != -1).sum(), aux, mesh)
    loss = ce + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
    return loss, {"ce": ce, "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}


def _data_mean(ce: torch.Tensor, count: torch.Tensor, aux: Metrics,
               mesh) -> Tuple[torch.Tensor, Metrics]:
    """The data ranks' cross-entropies weighted by their label counts, and
    their aux losses averaged: one rank-ordered reduction over the data
    axis."""
    from ..parallel import tensor as tp

    if tp.data_size(mesh) == 1:
        return ce, aux
    names = sorted(aux)
    mine = torch.stack([ce * count, count.to(ce.dtype)] + [aux[k].float() for k in names])
    total = tp.reduce_data(mine, mesh)
    world = tp.data_size(mesh)
    return total[0] / total[1], {k: total[2 + i] / world for i, k in enumerate(names)}


def grad_buffers(named: Named) -> Named:
    """Zero float32 buffers that microbatch gradients are added into."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}


def _microbatches(batch: Dict[str, torch.Tensor], accum: int):
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"a batch of {b} rows does not split into {accum} microbatches")
    per = b // accum
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()} for i in range(accum)]


def accumulate_grads(params, batch: Dict[str, torch.Tensor], cfg, *, accum: int = 1,
                     fused_loss: bool = False) -> Tuple[torch.Tensor, Metrics, Named]:
    """(loss, metrics, gradients by name) over ``accum`` microbatches: at 1
    the loss's own gradients in the parameters' dtype; above 1 the float32
    mean of the microbatches' gradients (:func:`grad_buffers`) and the mean
    loss, with ``lb_loss`` and ``z_loss`` reported as 0."""
    named = named_parameters(params)

    def grad_fn(mb):
        loss, metrics = loss_fn(params, mb, cfg, fused=fused_loss)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(named, grads))

    if accum == 1:
        return grad_fn(batch)
    acc = grad_buffers(named)
    loss_sum = None
    for mb in _microbatches(batch, accum):
        loss, _, grads = grad_fn(mb)
        for k, g in grads.items():
            acc[k] += g
        del grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = {k: g / accum for k, g in acc.items()}
    loss = loss_sum / accum
    zero = torch.zeros((), device=loss.device)
    return loss, {"ce": loss, "lb_loss": zero, "z_loss": zero}, grads


def _mesh_mean(tree: Any, mesh) -> Any:
    """Every rank's tensors summed in rank order (one gather per dtype)
    and divided by the world."""
    from ..core.mapreduce import tree_map
    from ..parallel import psum_tree

    world = mesh.size()
    return tree_map(lambda t: t / world, psum_tree(tree, mesh))


def make_train_step(cfg, *, lr_fn: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4,
                    accum: int = 1, weight_decay: float = 0.1,
                    clip_norm: Optional[float] = 1.0, fused_loss: bool = False,
                    mesh: Any = None) -> Callable:
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``;
    ``lr_fn`` maps the optimizer's step (before the update) to the learning
    rate, or is a constant.  ``mesh``: a data mesh (a model axis of 1)."""
    if mesh is not None:
        from ..parallel import tensor as tp

        if tp.model_size(mesh) > 1:
            raise NotImplementedError(
                f"a train step on a model axis of {tp.model_size(mesh)}: {tp.NEXT_SLICE}")

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = accumulate_grads(params, batch, cfg, accum=accum,
                                                fused_loss=fused_loss)
        if mesh is not None:
            mean = _mesh_mean({"grads": grads, "loss": loss, "metrics": metrics}, mesh)
            grads, loss, metrics = mean["grads"], mean["loss"], mean["metrics"]
        lr = lr_fn(opt_state.step) if callable(lr_fn) else lr_fn
        _, opt_state = adamw_update(grads, opt_state, named_parameters(params), lr=lr,
                                    weight_decay=weight_decay, clip_norm=clip_norm)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=loss.device)
        metrics = dict(metrics, loss=loss, lr=lr, grad_norm=global_norm(grads))
        return params, opt_state, metrics

    return train_step
