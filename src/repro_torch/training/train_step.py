"""The train step: loss -> gradients -> AdamW, with microbatch accumulation
and, on a mesh, data and tensor parallelism (port of
`repro.training.train_step` and of the reference's pjit placement of it).

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

On a mesh each rank steps on its own rows, and :func:`loss_fn` makes the
loss the whole (micro)batch's: one gather of the data axis a microbatch
brings every rank's cross-entropy and count of labels that are not -1,
and each rank's is weighted by its share of the labels (the aux losses by
1 / data), in rank order -- the reference's ``sum(nll mask) / sum(mask)``
over the whole batch.  Its backward gives each rank the gradient of that
global loss with respect to its own rows' terms, so the data-axis combine
of the gradients is a sum (rank-ordered, ``parallel.psum_tree``; every
rank applies the same update, bitwise).  A microbatch is each data
rank's i-th slice of its rows; it lies inside one of the reference's
microbatches (the global batch's i-th slice, its rows in rank-major
order), and its cross-entropy is weighted by its share of that global
microbatch's labels, so the step's loss is the reference's mean of the
microbatch means.

A 1-D ``"data"`` mesh (`repro_torch.parallel.data_mesh`) is data
parallelism for any family.  A ``("data", "model")`` mesh
(`parallel.tensor.model_mesh`) with a model axis above 1 is the dense
family's tensor-parallel step: the model is the rank's shard
(``parallel.tensor.shard_params``), its backward runs through the
collectives' own (2L + 1 model-axis reductions a microbatch); then the
``q_norm`` / ``k_norm`` gradients are summed over the model axis and a
replicated KV head's over the ranks that share it
(``tensor.combine_model_grads``), the gradients summed over the data
axis, the clip takes the whole model's norm across shards
(``tensor.global_norm``), and the AdamW moments are ZeRO-1 over the data
axis (``optimizer.zero1_update``: each data rank holds and updates its
1/data of each leaf, then the parameters are gathered).  Its state comes
from :func:`init_state`.  Every collective is counted by the stage it
belongs to (``parallel.collective_stages``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..models.layers import chunked_cross_entropy, cross_entropy_loss
from ..models.model_zoo import forward_hidden, train_forward
from ..parallel.sharding import collective_stage, psum_tree, sum_ranks
from .optimizer import (AdamWState, adamw_init, adamw_update, global_norm, zero1_init,
                        zero1_plan, zero1_update)

__all__ = ["loss_fn", "named_parameters", "accumulate_grads", "grad_buffers",
           "make_train_step", "init_state"]

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


def _tensor_parallel(mesh) -> bool:
    from ..parallel import tensor as tp

    return mesh is not None and tp.has_model_axis(mesh)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg, *, lb_coef: float = 0.01,
            z_coef: float = 1e-3, fused: bool = False, loss_chunk: int = 256,
            mesh: Any = None,
            microbatch: Optional[Tuple[int, torch.Tensor]] = None) -> Tuple[torch.Tensor, Metrics]:
    """(loss, {"ce", "lb_loss", "z_loss"}): the next-token cross-entropy
    (hidden or logits at t against labels at t + 1) plus the MoE aux
    losses.  On a ``mesh`` ``batch`` is the rank's rows and the loss the
    whole batch's (see the module's docstring); on a ``("data", "model")``
    mesh ``params`` is the rank's shard.  ``microbatch``: (its index i, the
    rank's label counts of every microbatch of the step), where ``batch``
    is the rank's i-th of them (the loss is then its terms' share of the
    step's; :func:`accumulate_grads` passes it)."""
    labels = batch["labels"]
    model_mesh = mesh if _tensor_parallel(mesh) else None
    if fused:
        hidden, head, aux = forward_hidden(params, batch, cfg, mesh=model_mesh)
        shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], 1)
        ce = chunked_cross_entropy(hidden, head, shifted, chunk=loss_chunk, mesh=model_mesh)
    else:
        logits, aux = train_forward(params, batch, cfg, mesh=model_mesh)
        ce = cross_entropy_loss(logits[:, :-1], labels[:, 1:], mesh=model_mesh)
    if mesh is not None:
        index, counts = microbatch or (0, _label_count(labels)[None])
        ce, aux = _data_mean(ce, counts, index, aux, mesh)
    loss = ce + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
    return loss, {"ce": ce, "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}


def _label_count(labels: torch.Tensor) -> torch.Tensor:
    """The count of next-token labels that are not -1."""
    return (labels[:, 1:] != -1).sum()


def _data_mean(ce: torch.Tensor, counts: torch.Tensor, index: int, aux: Metrics,
               mesh) -> Tuple[torch.Tensor, Metrics]:
    """The data ranks' cross-entropies of their ``index``-th microbatch,
    each weighted by its share of the label count of the reference's
    microbatch it lies in, summed in rank order, and their aux losses
    averaged: one gather of the data axis (``tensor.gather_data``, whose
    backward keeps the rank's own row) of the cross-entropy, the rank's
    ``counts`` of every microbatch and the aux losses.  Rank r's
    microbatch i is the global batch's (r accum + i)-th slice of rows, in
    the reference's microbatch (r accum + i) // data.  At one microbatch
    each weight is ``count_r / total``, exactly 1 / data where the counts
    are equal."""
    from ..parallel import tensor as tp

    if tp.data_size(mesh) == 1:
        return ce, aux
    names, accum, world = sorted(aux), counts.numel(), tp.data_size(mesh)
    mine = torch.cat([ce[None], counts.to(ce.dtype), torch.stack([aux[k].float() for k in names])])
    every = tp.gather_data(mine, mesh)
    slices = every[:, 1:1 + accum].detach()
    # the label count of each of the reference's microbatches: its data
    # consecutive slices of the global batch, summed in rank order
    totals = sum_ranks(slices.reshape(accum, world).T, slices.dtype)
    group = [(r * accum + index) // world for r in range(world)]
    weights = slices[:, index] / totals[group].clamp_min(1)
    total = sum_ranks(every[:, 0] * weights, ce.dtype)
    return total, {k: sum_ranks(every[:, 1 + accum + i], torch.float32) / world
                   for i, k in enumerate(names)}


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
                     fused_loss: bool = False,
                     mesh: Any = None) -> Tuple[torch.Tensor, Metrics, Named]:
    """(loss, metrics, gradients by name) over ``accum`` microbatches: at 1
    the loss's own gradients in the parameters' dtype; above 1 the float32
    mean of the microbatches' gradients (:func:`grad_buffers`) and the mean
    loss, with ``lb_loss`` and ``z_loss`` reported as 0.  On a ``mesh``
    the loss is the whole batch's and the gradients the rank's terms of
    it (:func:`loss_fn`), before any combine."""
    named = named_parameters(params)

    def grad_fn(mb, microbatch=None):
        loss, metrics = loss_fn(params, mb, cfg, fused=fused_loss, mesh=mesh,
                                microbatch=microbatch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(named, grads))

    if accum == 1:
        return grad_fn(batch)
    acc = grad_buffers(named)
    loss_sum = None
    mbs = _microbatches(batch, accum)
    counts = torch.stack([_label_count(mb["labels"]) for mb in mbs])
    for i, mb in enumerate(mbs):
        loss, _, grads = grad_fn(mb, (i, counts))
        for k, g in grads.items():
            acc[k] += g
        del grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = {k: g / accum for k, g in acc.items()}
    loss = loss_sum / accum
    zero = torch.zeros((), device=loss.device)
    return loss, {"ce": loss, "lb_loss": zero, "z_loss": zero}, grads


def init_state(params, cfg, mesh: Any = None) -> AdamWState:
    """The optimizer state a step of :func:`make_train_step` takes: whole
    moments (``adamw_init``), or on a ``("data", "model")`` mesh the rank's
    ZeRO-1 moments and their plan (``zero1_init``)."""
    named = named_parameters(params)
    if not _tensor_parallel(mesh):
        return adamw_init(named)
    return zero1_init(named, zero1_plan(named, cfg, mesh))


def make_train_step(cfg, *, lr_fn: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4,
                    accum: int = 1, weight_decay: float = 0.1,
                    clip_norm: Optional[float] = 1.0, fused_loss: bool = False,
                    mesh: Any = None) -> Callable:
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``;
    ``lr_fn`` maps the optimizer's step (before the update) to the learning
    rate, or is a constant.  ``mesh``: a 1-D data mesh (any family), or a
    ``("data", "model")`` mesh (the dense family on a model axis above 1:
    ``model`` the rank's shard, ``opt_state`` from :func:`init_state`)."""
    from ..parallel import tensor as tp

    tensor_parallel = _tensor_parallel(mesh)
    if tensor_parallel:
        tp.check_family(cfg)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        with collective_stage("forward"):
            loss, metrics, grads = accumulate_grads(params, batch, cfg, accum=accum,
                                                    fused_loss=fused_loss, mesh=mesh)
        named = named_parameters(params)
        lr = lr_fn(opt_state.step) if callable(lr_fn) else lr_fn
        kw = dict(lr=lr, weight_decay=weight_decay, clip_norm=clip_norm)
        with collective_stage("combine"):
            if tensor_parallel:
                grads = tp.combine_model_grads(grads, cfg, mesh)
            if mesh is not None and tp.data_size(mesh) > 1:
                grads = psum_tree(grads, mesh)
        if tensor_parallel:
            norm = tp.global_norm(grads, cfg, mesh)
            _, opt_state = zero1_update(grads, opt_state, named, mesh, norm=norm, **kw)
        else:
            _, opt_state = adamw_update(grads, opt_state, named, **kw)
            norm = global_norm(grads)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=loss.device)
        metrics = dict(metrics, loss=loss, lr=lr, grad_norm=norm)
        return params, opt_state, metrics

    return train_step
