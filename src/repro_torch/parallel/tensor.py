"""Tensor parallelism over the ``"model"`` mesh axis for the dense family's
serving path and train step (the port of the reference's GSPMD placement:
``shard`` for the activations and ``param_pspecs`` for the weights).

The reference runs one program on any ``("data", "model")`` mesh and lets
XLA insert the collectives.  The port is SPMD with the collectives
written out, Megatron-style: each process is one (data, model) rank
(:func:`model_mesh`, a 2-D ``DeviceMesh``), holds its slice of every
weight (:func:`shard_params`) and its slice of the batch, and runs the
model code with ``mesh=``.  The layout follows ``param_pspecs``' rules
wherever the split is head-aligned:

  * ``wq`` (d, H hd): columns by query heads; rank r holds heads
    [r H/tp, (r + 1) H/tp);
  * ``wk``, ``wv`` (d, KVH hd): by KV heads when tp divides KVH; when KVH
    divides tp, each rank holds the one KV head its query heads read,
    replicated over tp / KVH ranks (any other pair raises).  GSPMD may cut
    a head in the middle (qwen3-0.6b's 1,024 ``wk`` columns over 16
    ranks: 64 each); an explicit step cannot, so its weight and cache
    bytes per device can exceed the rule table's (the dry run writes
    both);
  * ``wo`` (H hd, d): rows by query heads, followed by a model-axis
    reduction; the MLP's ``w_gate`` / ``w_up`` by ``ff`` columns and
    ``w_down`` by ``ff`` rows, followed by a reduction;
  * ``embed`` (V, d) by vocab rows, its lookup masked to the rank's range
    and reduced; ``lm_head`` (d, V) (or ``embed.T`` when tied) by vocab
    columns: prefill and decode return the rank's vocab shard of the
    logits, as the reference's out spec ``("batch", "vocab")`` does, and
    :func:`greedy_pick` gathers only each shard's best;
  * ``q_norm`` / ``k_norm``, every RMSNorm and the residual stream are
    replicated on every model rank.

Every model-axis reduction is rank-ordered: an all-gather, then a sum in
rank order (in float32 for bf16 partials), as ``psum_tree`` does, so every
model rank holds a bitwise-equal residual, run after run.  A transformer
block makes two (after ``wo`` and after ``w_down``) and the embedding one:
2L + 1 a prefill or decode step.

The collectives are ``torch.autograd.Function`` s with their backward,
Megatron's f/g pair, so every model rank ends with bitwise-equal
gradients wherever the forward was replicated: a reduction's backward is
the identity (the incoming gradient is already replicated), a replicated
input's (:func:`replicated`, marked once for each column-parallel input:
the attention's and the MLP's normed inputs and the final hidden states)
is the rank-ordered reduction of its partial gradient, the max of the
vocab-parallel log-sum-exp has none, and the vocab gather's keeps the
rank's slice.  A train step's backward thus makes 2L + 1 reductions, as
its forward does.  :func:`grad_role`, :func:`combine_model_grads` and
:func:`global_norm` are what the train step (`training.train_step`)
needs past the backward: the gradients of the leaves the model axis does
not split and the norm across shards (the data-axis sum is
``sharding.psum_tree``).  Every collective
is counted twice (``sharding.collective_counts`` / ``collective_bytes``):
as executed, an all-gather of world x its input, and as the function needs
it, ``function=True``: a reduction is an all-reduce of the one partial,
which is what the dry run's bound reads (an all-reduce at 16 ranks moves
about an eighth of the rank-ordered gather's bytes); and by the train
step's stage (``sharding.collective_stages``; `models.layers` marks
remat's recompute).  On an ``AbstractMesh``
(the counting mesh of the dry run) nothing is exchanged: the collectives
return tensors of the right shape (on ``meta``) and only count, and
:func:`shard_params` slices rank 0's shard (every rank's has its shape).

The transport is the caller's: ``"nccl"`` (the default on the card, one
rank a card: NCCL refuses two ranks on one device, so that raises) or
``"gloo"`` (the CPU, and ranks that share one card).  Nothing falls back
to another.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core.backend import resolve_device
from .sharding import (AbstractMesh, axis_world, buckets, mesh_axis_size, record_collective,
                       sum_ranks)
from .sharding import _mesh_names as _axis_names

__all__ = ["TRANSPORTS", "ModelShard", "model_mesh", "mesh_transport", "model_size",
           "model_rank", "data_size", "head_layout", "layout_reason", "check_family",
           "check_layout", "shard_params", "reduce_model", "max_model", "gather_data",
           "replicated", "gather_vocab", "greedy_pick", "vocab_start", "data_rank",
           "has_model_axis", "grad_role", "combine_model_grads", "global_norm"]

TRANSPORTS = ("nccl", "gloo")


def model_mesh(data: int, model: int, rank: int, init_method: str, device="cuda",
               transport: Optional[str] = None):
    """Join the process group and build the 2-D ``("data", "model")`` mesh
    of ``data`` x ``model`` ranks (rank = data index x model + model index).

    ``transport``: ``"nccl"`` (the default on the card) puts rank r on card
    r and raises ``RuntimeError`` when the ranks outnumber the cards;
    ``"gloo"`` (the default on the CPU) runs on the CPU or on ranks that
    share a card (each process's card is ``cuda:<rank mod cards>``).
    ``init_method`` is the rendezvous (``file://<path>`` or
    ``tcp://host:port``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)  # raises on "cuda" without a GPU
    transport = transport or ("nccl" if dev.type == "cuda" else "gloo")
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} is not one of {TRANSPORTS}")
    world = data * model
    if transport == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl transport runs on the card; the CPU takes 'gloo'")
        if not dist.is_nccl_available():
            raise RuntimeError("the nccl transport needs NCCL, and this PyTorch has none")
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"nccl puts one rank on one card: {world} ranks over {cards} card(s), and "
                f"NCCL refuses two ranks on one device; ranks that share a card take "
                f"transport='gloo'")
        torch.cuda.set_device(rank)
    elif dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(transport, init_method=init_method, world_size=world,
                                rank=rank)
    elif dist.get_backend() != transport:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not {transport}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def mesh_transport(mesh) -> str:
    """The transport of ``mesh``'s model axis; ``"count"`` for an
    ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return "count"
    return dist.get_backend(mesh.get_group("model"))


def model_size(mesh) -> int:
    return mesh_axis_size(mesh, ("model",))


def data_size(mesh) -> int:
    return mesh_axis_size(mesh, ("pod", "data"))


def model_rank(mesh) -> int:
    """This process's index on the model axis (0 on an ``AbstractMesh``)."""
    if isinstance(mesh, AbstractMesh) or model_size(mesh) == 1:
        return 0
    return mesh.get_local_rank("model")


def data_rank(mesh) -> int:
    """This process's index on the data axis (0 on an ``AbstractMesh``)."""
    if isinstance(mesh, AbstractMesh) or data_size(mesh) == 1:
        return 0
    return mesh.get_local_rank("data")


def has_model_axis(mesh) -> bool:
    """Whether ``mesh`` names a ``"model"`` axis (a 1-D data mesh does
    not)."""
    return "model" in _axis_names(mesh)


# ------------------------------------------------------------- the layout --


def check_family(cfg) -> None:
    """Tensor parallelism covers the dense family; any other raises."""
    if cfg.family != "dense" or cfg.attn != "gqa":
        raise NotImplementedError(f"tensor parallelism: {cfg.family} waits for a later slice")


def head_layout(cfg, tp: int) -> Tuple[int, int]:
    """(query heads, KV heads) a model rank holds at model axis ``tp``."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    if h % tp:
        raise ValueError(f"{cfg.name}: {h} query heads do not split over a model axis of {tp}")
    if kvh % tp == 0:
        return h // tp, kvh // tp
    if tp % kvh == 0:
        return h // tp, 1
    raise ValueError(f"{cfg.name}: {kvh} KV heads neither split over a model axis of {tp} "
                     f"nor divide it")


def check_layout(cfg, tp: int) -> None:
    """Raise unless ``cfg`` splits over a model axis of ``tp`` by the
    layout above: the family (``NotImplementedError``), then the heads,
    ``d_ff`` and the vocabulary (``ValueError``)."""
    check_family(cfg)
    head_layout(cfg, tp)
    for name, n in (("d_ff", cfg.d_ff), ("vocab", cfg.vocab)):
        if n % tp:
            raise ValueError(f"{cfg.name}: {name} {n} does not split over a model axis of {tp}")


def layout_reason(cfg, tp: int) -> Optional[str]:
    """Why ``cfg`` does not split over a model axis of ``tp``, or None."""
    try:
        check_layout(cfg, tp)
    except (NotImplementedError, ValueError) as err:
        return str(err)
    return None


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Which shard a model holds: model rank ``rank`` of ``size``."""

    rank: int
    size: int


def _heads(cfg, tp: int, rank: int) -> Tuple[slice, slice]:
    """The rank's query-head and KV-head ranges."""
    hq, hkv = head_layout(cfg, tp)
    q0 = rank * hq
    kv0 = q0 // (cfg.n_heads // cfg.n_kv_heads)  # the KV head its first query head reads
    return slice(q0, q0 + hq), slice(kv0, kv0 + hkv)


def _cols(w: torch.Tensor, sl: slice, width: int = 1) -> torch.Tensor:
    return w[:, sl.start * width:sl.stop * width].contiguous().clone()


def _rows(w: torch.Tensor, sl: slice, width: int = 1) -> torch.Tensor:
    return w[sl.start * width:sl.stop * width].contiguous().clone()


@torch.no_grad()
def shard_params(model, mesh, *, rank: Optional[int] = None):
    """The rank's shard of a whole dense model (a ``Transformer``), each
    leaf a copy of its slice by the layout above; ``rank`` overrides the
    mesh's model rank (the counting mesh's is 0).  The shard records
    itself as ``model.shard`` (:class:`ModelShard`); the model functions
    refuse it without ``mesh=``."""
    from ..models.attention import GQAAttention
    from ..models.layers import MLP, RMSNorm
    from ..models.transformer import Block, Transformer

    cfg = model.cfg
    tp = model_size(mesh)
    check_layout(cfg, tp)
    r = model_rank(mesh) if rank is None else rank
    if not 0 <= r < tp:
        raise ValueError(f"model rank {r} outside a model axis of {tp}")
    hd = cfg.resolved_head_dim
    qs, kvs = _heads(cfg, tp, r)
    ff = slice(r * cfg.d_ff // tp, (r + 1) * cfg.d_ff // tp)
    voc = slice(r * cfg.vocab // tp, (r + 1) * cfg.vocab // tp)
    norm = lambda n: RMSNorm(n.weight.clone(), n.eps)  # noqa: E731
    blocks = []
    for b in model.layers:
        a = b.attn
        norms = (a.q_norm.clone(), a.k_norm.clone()) if a.q_norm is not None else ()
        attn = GQAAttention(_cols(a.wq, qs, hd), _cols(a.wk, kvs, hd), _cols(a.wv, kvs, hd),
                            _rows(a.wo, qs, hd), *norms)
        mlp = MLP(_cols(b.mlp.w_gate, ff), _cols(b.mlp.w_up, ff), _rows(b.mlp.w_down, ff))
        blocks.append(Block(norm(b.attn_norm), attn, norm(b.mlp_norm), mlp))
    head = None if model.lm_head is None else _cols(model.lm_head, voc)
    out = Transformer(cfg, _rows(model.embed, voc), blocks, norm(model.final_norm), head)
    out.shard = ModelShard(r, tp)
    return out


def vocab_start(mesh, local: int) -> int:
    """The first vocabulary row of the rank's shard of ``local`` rows."""
    return model_rank(mesh) * local


# ------------------------------------------------------ the collectives --


def _gather(x: torch.Tensor, mesh, axis: str, reduce: bool = False,
            stage: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` of the mesh, stacked in rank order
    (world, ...): one all-gather, counted (``reduce``: its function is an
    all-reduce of ``x``) under ``stage`` (default the current one,
    ``sharding.collective_stage``'s); on a counting mesh an empty tensor
    of that shape."""
    world = axis_world(mesh, axis)
    nbytes = x.numel() * x.element_size()
    record_collective("all-gather", world * nbytes,
                      function=("all-reduce", nbytes) if reduce else None, stage=stage)
    out = x.new_empty((world,) + tuple(x.shape))
    if isinstance(mesh, AbstractMesh):
        return out
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=mesh.get_group(axis))
    return out


def _reduce(x: torch.Tensor, mesh, axis: str, stage: Optional[str] = None) -> torch.Tensor:
    """The rank-ordered sum of every rank's ``x`` along ``axis``."""
    return sum_ranks(_gather(x, mesh, axis, reduce=True, stage=stage), x.dtype)


class _ReduceModel(torch.autograd.Function):
    """g: the sum of the partials; its backward is the identity (the
    incoming gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _MaxModel(torch.autograd.Function):
    """The max over the model axis: the shift of a log-sum-exp, whose
    gradient is zero (it cancels; the reference's ``logsumexp`` stops it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _gather(x, mesh, "model", reduce=True).amax(0)

    @staticmethod
    def backward(ctx, grad):
        return None, None


class _Replicated(torch.autograd.Function):
    """f: the identity forward; the backward sums the rank's partial
    gradient over the model axis in rank order (in float32 for bf16)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.mesh, "model", stage="backward"), None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(list(_gather(x, mesh, "model").unbind(0)), -1)

    @staticmethod
    def backward(ctx, grad):
        local = grad.shape[-1] // model_size(ctx.mesh)
        return grad.narrow(-1, vocab_start(ctx.mesh, local), local), None


class _GatherData(torch.autograd.Function):
    """Every data rank's ``x`` stacked in rank order; the backward keeps
    the rank's own row (every rank computes the same function of the
    stack)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh, "data", reduce=True)

    @staticmethod
    def backward(ctx, grad):
        return grad[data_rank(ctx.mesh)], None


def reduce_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every model rank's partial ``x``, in rank order; the
    same bits on every rank.  Identity on a model axis of 1 (no
    collective)."""
    if mesh is None or model_size(mesh) == 1:
        return x
    return _ReduceModel.apply(x, mesh, "model")


def max_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of every model rank's ``x`` (no gradient)."""
    if mesh is None or model_size(mesh) == 1:
        return x
    return _MaxModel.apply(x, mesh)


def gather_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``x``, stacked in rank order (data, ...); the
    gradient flows to the rank's own row.  (1, ...) on a data axis of 1."""
    if mesh is None or data_size(mesh) == 1:
        return x[None]
    return _GatherData.apply(x, mesh)


def replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the replicated input of the column-parallel products that
    read it: the identity, whose backward is the model-axis sum of the
    products' partial gradients (mark each input once, not each product)."""
    if mesh is None or model_size(mesh) == 1:
        return x
    return _Replicated.apply(x, mesh)


def gather_vocab(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every model rank's vocab shard (..., V / tp) joined in rank order:
    the whole (..., V)."""
    if mesh is None or model_size(mesh) == 1:
        return x
    return _GatherVocab.apply(x, mesh)


def greedy_pick(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The greedy token of each row from the rank's vocab shard (B, V /
    tp): each shard's max and its first index, gathered ((tp, B, 2)
    float32: one all-gather), and the first rank holding the overall max
    wins -- the first index of the max over the whole vocabulary, as
    ``argmax`` picks it.  (B,) int64, the same on every model rank."""
    if mesh is None or model_size(mesh) == 1:
        return logits.argmax(-1)
    v = logits.float()
    best, idx = v.max(-1)
    idx = idx + vocab_start(mesh, v.shape[-1])
    both = _gather(torch.stack([best, idx.float()], -1), mesh, "model")  # (tp, B, 2)
    winner = both[..., 0].argmax(0)  # the first rank with the max
    return both[..., 1].gather(0, winner[None])[0].long()


# ------------------------------------------------ the train step's gradients --


def grad_role(name: str, cfg, tp: int) -> str:
    """How a model rank's gradient of the leaf ``name`` (a name of
    ``named_parameters``) relates to the whole model's:

      * ``"replicated"``: a norm on the replicated residual (``attn_norm``,
        ``mlp_norm``, ``final_norm``): the whole gradient, the same bits on
        every model rank, with no collective;
      * ``"partial"``: ``q_norm`` / ``k_norm``, which act on the rank's heads
        only: the sum over the model axis is the whole gradient;
      * ``"shared"``: ``wk`` / ``wv`` of a KV head replicated over tp / KVH
        ranks: each holds the part its own query heads give, summed over
        the ranks that share the head;
      * ``"split"``: the rank's slice of a split leaf, whole as it is."""
    leaf = name.split(".")
    if leaf[-1] == "weight" and leaf[-2] in ("attn_norm", "mlp_norm", "final_norm"):
        return "replicated"
    if leaf[-1] in ("q_norm", "k_norm"):
        return "partial"
    if leaf[-1] in ("wk", "wv") and cfg.n_kv_heads % tp:
        return "shared"
    return "split"


def _kv_group(cfg, mesh) -> slice:
    """The model ranks that hold the same KV head as this one (the
    replicated layout: tp / KVH consecutive ranks)."""
    size = model_size(mesh) // cfg.n_kv_heads
    first = model_rank(mesh) // size * size
    return slice(first, first + size)


def combine_model_grads(grads, cfg, mesh):
    """The rank's gradients with each ``"partial"`` leaf summed over the
    model axis and each ``"shared"`` one over its KV group, in rank order:
    gathers of the model axis in :func:`buckets` (none without such a
    leaf), counted as the step's ``"combine"``."""
    tp = model_size(mesh)
    if tp == 1:
        return grads
    out = dict(grads)
    roles = {k: grad_role(k, cfg, tp) for k in grads}
    todo = [k for k in grads if roles[k] in ("partial", "shared")]
    group = _kv_group(cfg, mesh) if "shared" in roles.values() else None
    for run in buckets(todo, grads):
        names = [todo[i] for i in run]
        stacked = _gather(torch.cat([grads[k].reshape(-1) for k in names]), mesh, "model",
                          reduce=True, stage="combine")
        start = 0
        for k in names:
            n = grads[k].numel()
            rows = stacked[:, start:start + n]
            if roles[k] == "shared":
                rows = rows[group]
            out[k] = sum_ranks(rows, grads[k].dtype).view_as(grads[k])
            start += n
    return out


def global_norm(grads, cfg, mesh) -> torch.Tensor:
    """The whole model's gradient norm from the rank's combined gradients:
    the float32 sums of squares of its split leaves (a shared KV leaf on
    the first rank of its group only) reduced over the model axis in rank
    order (one gather, counted as ``"norm"``), plus those of the leaves
    every rank holds whole, counted once.  The same bits on every rank."""
    tp = model_size(mesh)
    first = model_rank(mesh) % max(tp // cfg.n_kv_heads, 1) == 0
    split, whole = [], []
    for k, g in grads.items():
        role = grad_role(k, cfg, tp)
        sq = torch.sum(torch.square(g.float()))
        if role in ("replicated", "partial"):
            whole.append(sq)
        elif role == "split" or first:
            split.append(sq)
    total = torch.stack(split).sum()
    if tp > 1:
        total = _reduce(total, mesh, "model", stage="norm")
    if whole:
        total = total + torch.stack(whole).sum()
    return torch.sqrt(total)

