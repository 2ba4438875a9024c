"""Model zoo dispatcher over every family of the registry (port of
`repro.models.model_zoo`).

  init_params(cfg, seed=...)              -> Transformer (Zamba for the hybrid,
                                             XLSTM for the "ssm" family, EncDec
                                             for the encoder-decoder)
  forward(params, batch, cfg)             -> logits (B, S, V) (``return_aux``:
                                             and the MoE aux losses)
  prefill(params, batch, cfg)             -> (last logits, cache)
  decode_step(params, cache, batch, cfg)  -> (logits, cache)
  cache_spec(cfg, batch, seq)             -> {name: TensorSpec}
  train_forward(params, batch, cfg)       -> (logits, aux): the training
                                             forward, with gradients
  forward_hidden(params, batch, cfg)      -> (hidden, head, aux): the same,
                                             stopped at the final normed
                                             hidden states (the fused loss)
  input_specs(cfg, shape)                 -> {name: TensorSpec} of a cell's
                                             inputs (train, prefill, decode)
  trainable(params)                       -> the model, every parameter
                                             requiring grad
  params_from_numpy / params_to_numpy     -- the reference's weights carried
                                             across, and back
  params_to_tree / params_from_tree       -- the same layout as tensors (layer
                                             leaves stacked on a leading L axis)

``batch`` is a dict: ``tokens`` (and ``pos`` for decode); the
encoder-decoder (whisper-base, `encdec.py`) also takes ``frames`` (B,
S_enc, d_model) and the VLM (llava-next-34b) ``patch_embeds`` (B,
n_patches, d_model) for prefill and forward, the stubbed frontends'
outputs (`vlm_stub.py`); without them they raise ``ValueError``.  The
dense and MoE families, with GQA or MLA attention (deepseek-v2), the VLM,
the Mamba2 / shared-attention hybrid (zamba2, `zamba.py`), the xLSTM
family (xlstm-125m, `xlstm_lm.py`) and the encoder-decoder are ported.
``init_params`` and ``params_from_numpy`` put the model on the card unless
the caller asks for the CPU.

On a ``("data", "model")`` mesh (``mesh=``: `parallel.tensor`), ``forward``,
``prefill``, ``decode_step``, ``train_forward`` and ``forward_hidden`` run
the rank's shard (``parallel.tensor.shard_params``) on the rank's slice of
the batch, tensor-parallel over the model axis; the logits are the rank's
vocab shard.  The dense family only: any other family raises
``NotImplementedError``, and a shard without its mesh (or a mesh without
a shard) raises ``ValueError`` -- nothing is replicated silently.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.mapreduce import tree_map
from ..parallel import tensor as tp
from . import encdec, transformer, xlstm_lm, zamba
from .attention import Attention, GQAAttention, MLAAttention, TensorSpec
from .encdec import XATTN_NAMES, CrossAttention, DecoderLayer, EncDec, EncoderLayer
from .layers import DTYPE, MLP, RMSNorm
from .moe import MoE
from .ssm import NAMES as _MAMBA_NAMES, Mamba2
from .transformer import Block, Transformer
from .xlstm import MLSTM, MLSTM_NAMES, SLSTM, SLSTM_NAMES
from .xlstm_lm import XLSTM, XLSTMPair
from .zamba import MambaLayer, Zamba

__all__ = ["init_params", "forward", "prefill", "decode_step", "cache_spec", "train_forward",
           "forward_hidden", "input_specs", "trainable", "params_from_numpy",
           "params_to_numpy", "params_from_tree", "params_to_tree"]

Model = Union[Transformer, Zamba, XLSTM, EncDec]


def _frames(batch: Dict[str, Any], cfg) -> torch.Tensor:
    if batch.get("frames") is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder needs frames, the stubbed audio "
                         f"frontend's (B, S_enc, d_model) output "
                         f"(models.vlm_stub.fake_frame_embeds)")
    return batch["frames"]


def init_params(cfg, *, seed: int = 0, generator: Optional[torch.Generator] = None,
                dtype=DTYPE, device="cuda") -> Model:
    """Random weights from ``seed`` (or an explicit ``generator`` on
    ``device``), made on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    if cfg.family == "encdec":
        return encdec.encdec_init(generator, cfg, dtype, dev)
    if cfg.family == "hybrid":
        return zamba.zamba_init(generator, cfg, dtype, dev)
    if cfg.family == "ssm":
        return xlstm_lm.xlstm_lm_init(generator, cfg, dtype, dev)
    return transformer.lm_init(generator, cfg, dtype, dev)


def _mesh_kw(params: Model, cfg, mesh) -> Dict[str, Any]:
    """``{"mesh": mesh}`` for a tensor-parallel call, ``{}`` for a whole
    model; raises for another family on a mesh, or a shard and a mesh that
    do not match."""
    shard = getattr(params, "shard", None)
    if mesh is None:
        if shard is not None:
            raise ValueError(f"{cfg.name}: this model is model rank {shard.rank} of "
                             f"{shard.size}'s shard: call it with mesh=")
        return {}
    tp.check_family(cfg)
    want = (tp.model_rank(mesh), tp.model_size(mesh))
    if shard is None or (shard.rank, shard.size) != want:
        raise ValueError(f"{cfg.name}: the mesh wants model rank {want[0]} of {want[1]}'s "
                         f"shard (parallel.tensor.shard_params), the model is "
                         f"{'whole' if shard is None else (shard.rank, shard.size)}")
    return {"mesh": mesh}


def forward(params: Model, batch: Dict[str, Any], cfg, *, return_aux: bool = False,
            mesh=None):
    """Full-sequence forward -> logits (B, S, V); with ``return_aux``,
    (logits, aux losses summed over layers) as the reference returns (zero
    for the hybrid, the xLSTM and the encoder-decoder)."""
    kw = _mesh_kw(params, cfg, mesh)
    if cfg.family in ("hybrid", "ssm", "encdec"):
        if cfg.family == "encdec":
            logits = encdec.encdec_forward(params, _frames(batch, cfg), batch["tokens"], cfg)
        else:
            run = zamba.zamba_forward if cfg.family == "hybrid" else xlstm_lm.xlstm_forward
            logits = run(params, batch["tokens"], cfg)
        if not return_aux:
            return logits
        return logits, {name: torch.zeros((), device=logits.device)
                        for name in ("lb_loss", "z_loss")}
    return transformer.lm_forward(params, batch["tokens"], cfg,
                                  patch_embeds=batch.get("patch_embeds"), return_aux=return_aux,
                                  **kw)


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros((), device=device) for name in ("lb_loss", "z_loss")}


def _train_out(params: Model, batch: Dict[str, Any], cfg, remat: bool, return_hidden: bool,
               mesh=None):
    """(logits or hidden, aux) of the training forward of any family."""
    kw = _mesh_kw(params, cfg, mesh)
    tokens = batch["tokens"]
    if cfg.family == "encdec":
        out = encdec.encdec_train_forward(params, _frames(batch, cfg), tokens, cfg, remat=remat,
                                          return_hidden=return_hidden)
    elif cfg.family in ("hybrid", "ssm"):
        run = zamba.zamba_train_forward if cfg.family == "hybrid" else xlstm_lm.xlstm_train_forward
        out = run(params, tokens, cfg, remat=remat, return_hidden=return_hidden)
    else:
        return transformer.lm_train_forward(params, tokens, cfg,
                                            patch_embeds=batch.get("patch_embeds"), remat=remat,
                                            return_hidden=return_hidden, **kw)
    return out, _zero_aux(out.device)


def train_forward(params: Model, batch: Dict[str, Any], cfg, *, remat: bool = True,
                  mesh=None):
    """The training forward (the reference's ``forward``), with gradients
    -> (logits over the full target sequence, aux losses summed over layers,
    zero outside the MoE family).  Attention is the plain chunked version
    (the attention kernel has no backward); layers run under remat.  On
    ``mesh``, the rank's shard and rows, the logits its vocab shard."""
    return _train_out(params, batch, cfg, remat, return_hidden=False, mesh=mesh)


def forward_hidden(params: Model, batch: Dict[str, Any], cfg, *, remat: bool = True,
                   mesh=None):
    """The training forward stopped at the final normed hidden states (the
    fused-loss path) -> (hidden (B, S, d), head (d, V), or on ``mesh`` the
    rank's vocab columns, aux)."""
    hidden, aux = _train_out(params, batch, cfg, remat, return_hidden=True, mesh=mesh)
    head = (transformer.lm_head_matrix(params) if isinstance(params, Transformer)
            else params.lm_head)
    return hidden, head, aux


def trainable(params: Model) -> Model:
    """The model with every parameter requiring grad, in place (serving
    models are built frozen, ``layers.weight``); returns it.  The served
    entry points keep running under ``torch.no_grad()``."""
    return params.requires_grad_(True)


def input_specs(cfg, shape, mesh=None) -> Dict[str, Any]:
    """{name: TensorSpec} of every model input of a cell (``shape`` a
    ``ShapeConfig``): train takes ``tokens`` and ``labels`` (the VLM's
    labels over n_patches + S_text, its tokens over S_text, with
    ``patch_embeds``; the encoder-decoder ``frames`` beside them),
    prefill ``tokens`` (and the stubs' inputs), decode one token a row,
    ``pos`` and the ``cache``.  On ``mesh``, a rank's: its share of the
    batch over the data axes and its KV heads' cache."""
    b, s = shape.global_batch, shape.seq_len
    if mesh is not None:
        b //= tp.data_size(mesh)
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {}
        text = s
        if cfg.family == "encdec":
            specs["frames"] = TensorSpec((b, s, cfg.d_model), DTYPE)
        elif cfg.family == "vlm":
            text = s - cfg.n_patches
            specs["patch_embeds"] = TensorSpec((b, cfg.n_patches, cfg.d_model), DTYPE)
        specs["tokens"] = TensorSpec((b, text), i32)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, s), i32)
        return specs
    return {"tokens": TensorSpec((b,), i32), "pos": TensorSpec((), i32),
            "cache": cache_spec(cfg, b, s, mesh=mesh)}


def prefill(params: Model, batch: Dict[str, Any], cfg, *,
            attention: Optional[Attention] = None, mesh=None):
    """(last logits (B, V), cache); ``attention`` is the prefill's attention
    (the xLSTM has none; the encoder-decoder's is its decoder's causal
    self-attention).  On ``mesh``: the rank's vocab shard of the logits and
    its KV heads' cache."""
    kw = _mesh_kw(params, cfg, mesh)
    if cfg.family == "encdec":
        return encdec.encdec_prefill(params, _frames(batch, cfg), batch["tokens"], cfg,
                                     attention=attention)
    if cfg.family == "hybrid":
        return zamba.zamba_prefill(params, batch["tokens"], cfg, attention=attention)
    if cfg.family == "ssm":
        return xlstm_lm.xlstm_prefill(params, batch["tokens"], cfg)
    return transformer.lm_prefill(params, batch["tokens"], cfg,
                                  patch_embeds=batch.get("patch_embeds"), attention=attention,
                                  **kw)


def decode_step(params: Model, cache, batch: Dict[str, Any], cfg, *, mesh=None):
    """(logits (B, V), or on ``mesh`` the rank's vocab shard, and the cache
    updated in place)."""
    kw = _mesh_kw(params, cfg, mesh)
    if cfg.family == "encdec":
        return encdec.encdec_decode_step(params, cache, batch["tokens"], batch["pos"], cfg)
    if cfg.family == "hybrid":
        return zamba.zamba_decode_step(params, cache, batch["tokens"], batch["pos"], cfg)
    if cfg.family == "ssm":
        return xlstm_lm.xlstm_decode_step(params, cache, batch["tokens"], batch["pos"], cfg)
    return transformer.lm_decode_step(params, cache, batch["tokens"], batch["pos"], cfg, **kw)


def cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE, mesh=None) -> Dict[str, Any]:
    """{name: TensorSpec}; the hybrid's is nested, {"ssm": ..., "attn": ...},
    and so is the xLSTM's, {"m": ..., "s": ...} (float32 states, no
    sequence axis), and the encoder-decoder's, {"self": ..., "cross": ...}
    (the cross cache at ``enc_len = seq_len``, as the reference's).  On
    ``mesh`` (the dense family), the rank's KV heads'."""
    if mesh is not None:
        tp.check_family(cfg)
        return transformer.lm_cache_spec(cfg, batch, seq_len, dtype, mesh)
    if cfg.family == "encdec":
        return encdec.encdec_cache_spec(cfg, batch, seq_len, enc_len=seq_len, dtype=dtype)
    if cfg.family == "hybrid":
        return zamba.zamba_cache_spec(cfg, batch, seq_len, dtype)
    if cfg.family == "ssm":
        return xlstm_lm.xlstm_cache_spec(cfg, batch, seq_len, dtype)
    return transformer.lm_cache_spec(cfg, batch, seq_len, dtype)


# ------------------------------------------------- weights carried across --


_MLP_NAMES = ("w_gate", "w_up", "w_down")
_MOE_NAMES = ("router", "e_gate", "e_up", "e_down")
_MLA_NAMES = ("w_dkv", "kv_norm", "w_uk", "w_uv", "w_kr", "wo")
_MLA_Q_NAMES = {True: ("w_dq", "q_norm", "w_uq"), False: ("wq",)}  # by q_lora_rank > 0


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bit for bit.  bfloat16
    arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) go
    through an int16 view, never through float32."""
    a = np.array(a)  # a private, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's bfloat16 numpy type; needed only here

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _mlp(tree: Dict[str, Any], i: int, t) -> MLP:
    return MLP(*(t(tree[k][i]) for k in _MLP_NAMES))


def _moe(tree: Dict[str, Any], i: int, t) -> MoE:
    shared = _mlp(tree["shared"], i, t) if "shared" in tree else None
    return MoE(*(t(tree[k][i]) for k in _MOE_NAMES), shared)


def _attention(at: Dict[str, Any], cfg, t):
    """One layer's attention from its leaves ``at`` (``t`` makes each a
    tensor)."""
    if cfg.attn == "mla":
        return MLAAttention(*(t(at[k]) for k in _MLA_NAMES),
                            **{k: t(at[k]) for k in _MLA_Q_NAMES[bool(cfg.mla.q_lora_rank)]})
    return GQAAttention(t(at["wq"]), t(at["wk"]), t(at["wv"]), t(at["wo"]),
                        *((t(at["q_norm"]), t(at["k_norm"])) if cfg.qk_norm else ()))


def _assemble(tree: Dict[str, Any], cfg, t) -> Transformer:
    """The model from a params tree in the reference's layout, ``t`` making
    each leaf (a layer leaf indexed first) a tensor."""
    lay = tree["layers"]
    blocks = []
    for i in range(cfg.n_layers):
        attn = _attention({k: a[i] for k, a in lay["attn"].items()}, cfg, t)
        mlp = _moe(lay["moe"], i, t) if cfg.moe is not None else _mlp(lay["mlp"], i, t)
        blocks.append(Block(RMSNorm(t(lay["attn_norm"][i]), cfg.norm_eps), attn,
                            RMSNorm(t(lay["mlp_norm"][i]), cfg.norm_eps), mlp))
    head = None if cfg.tie_embeddings else t(tree["lm_head"])
    proj = t(tree["patch_proj"]) if cfg.family == "vlm" else None
    return Transformer(cfg, t(tree["embed"]), blocks,
                       RMSNorm(t(tree["final_norm"]), cfg.norm_eps), head, proj)


def _assemble_hybrid(tree: Dict[str, Any], cfg, t) -> Zamba:
    """The hybrid from the reference's tree: ``mamba_layers`` ({"norm",
    "mixer": {...}} stacked on L), ``shared_attn`` (one block's leaves),
    ``embed``, ``final_norm``, ``lm_head``."""
    lay, sh = tree["mamba_layers"], tree["shared_attn"]
    norm = lambda w: RMSNorm(t(w), cfg.norm_eps)  # noqa: E731
    layers = [MambaLayer(norm(lay["norm"][i]),
                         Mamba2(*(t(lay["mixer"][k][i]) for k in _MAMBA_NAMES)))
              for i in range(cfg.n_layers)]
    shared = Block(norm(sh["attn_norm"]), _attention(sh["attn"], cfg, t), norm(sh["mlp_norm"]),
                   MLP(*(t(sh["mlp"][k]) for k in _MLP_NAMES)))
    return Zamba(cfg, t(tree["embed"]), layers, shared, norm(tree["final_norm"]),
                 t(tree["lm_head"]))


def _assemble_xlstm(tree: Dict[str, Any], cfg, t) -> XLSTM:
    """The xLSTM from the reference's tree: ``pairs`` ({"m_norm", "mlstm":
    {...}} and, with ``slstm_every``, {"s_norm", "slstm": {...}}, stacked
    on P), ``embed``, ``final_norm``, ``lm_head``."""
    pr = tree["pairs"]
    norm = lambda w: RMSNorm(t(w), cfg.norm_eps)  # noqa: E731

    def pair(i):
        mixer = MLSTM(*(t(pr["mlstm"][k][i]) for k in MLSTM_NAMES))
        if not cfg.slstm_every:
            return XLSTMPair(norm(pr["m_norm"][i]), mixer)
        return XLSTMPair(norm(pr["m_norm"][i]), mixer, norm(pr["s_norm"][i]),
                         SLSTM(*(t(pr["slstm"][k][i]) for k in SLSTM_NAMES)))

    return XLSTM(cfg, t(tree["embed"]), [pair(i) for i in range(xlstm_lm._n_pairs(cfg))],
                 norm(tree["final_norm"]), t(tree["lm_head"]))


def _assemble_encdec(tree: Dict[str, Any], cfg, t) -> EncDec:
    """The encoder-decoder from the reference's tree: ``enc_layers``
    ({"attn_norm", "attn", "mlp_norm", "mlp"} stacked on the encoder's L),
    ``dec_layers`` (the same and {"x_norm", "xattn"}, stacked on the
    decoder's L), ``embed``, ``enc_norm``, ``final_norm``, ``lm_head``."""
    enc, dec = tree["enc_layers"], tree["dec_layers"]
    norm = lambda w: RMSNorm(t(w), cfg.norm_eps)  # noqa: E731
    attn = lambda lay, i: _attention({k: a[i] for k, a in lay["attn"].items()}, cfg, t)  # noqa: E731
    enc_layers = [EncoderLayer(norm(enc["attn_norm"][i]), attn(enc, i), norm(enc["mlp_norm"][i]),
                               _mlp(enc["mlp"], i, t)) for i in range(cfg.enc_layers)]
    dec_layers = [DecoderLayer(norm(dec["attn_norm"][i]), attn(dec, i), norm(dec["x_norm"][i]),
                               CrossAttention(*(t(dec["xattn"][k][i]) for k in XATTN_NAMES)),
                               norm(dec["mlp_norm"][i]), _mlp(dec["mlp"], i, t))
                  for i in range(cfg.n_layers)]
    return EncDec(cfg, t(tree["embed"]), enc_layers, dec_layers, norm(tree["enc_norm"]),
                  norm(tree["final_norm"]), t(tree["lm_head"]))


def _assembler(cfg):
    return {"hybrid": _assemble_hybrid, "ssm": _assemble_xlstm,
            "encdec": _assemble_encdec}.get(cfg.family, _assemble)


def params_from_numpy(tree: Dict[str, Any], cfg, device="cuda") -> Model:
    """The reference's params of any family -- a nest of dicts of numpy
    arrays, layer leaves stacked on a leading (L, ...) axis, as
    ``jax.tree.map(np.asarray, params)`` gives them -- as the port's model
    on ``device``."""
    dev = resolve_device(device)
    return _assembler(cfg)(tree, cfg, lambda a: _tensor(a, dev))


def params_from_tree(tree: Dict[str, Any], cfg) -> Model:
    """The model over a tree of tensors in :func:`params_to_tree`'s layout:
    each layer's weights are views of the stacked leaves, never copies."""
    return _assembler(cfg)(tree, cfg, lambda a: a)


def _stacked(mods, names) -> Dict[str, torch.Tensor]:
    """{name: the modules' leaves stacked on a new leading axis}."""
    return {k: torch.stack([getattr(m, k).detach() for m in mods]) for k in names}


def _gqa_names(attn: GQAAttention) -> tuple:
    return ("wq", "wk", "wv", "wo") + (("q_norm", "k_norm") if attn.q_norm is not None else ())


def _hybrid_tree(params: Zamba) -> Dict[str, Any]:
    layers, sh = list(params.mamba_layers), params.shared_attn
    own = lambda m, names: {k: getattr(m, k).detach() for k in names}  # noqa: E731
    return {
        "embed": params.embed.detach(),
        "mamba_layers": {"norm": torch.stack([la.norm.weight.detach() for la in layers]),
                         "mixer": _stacked([la.mixer for la in layers], _MAMBA_NAMES)},
        "shared_attn": {"attn_norm": sh.attn_norm.weight.detach(),
                        "attn": own(sh.attn, _gqa_names(sh.attn)),
                        "mlp_norm": sh.mlp_norm.weight.detach(), "mlp": own(sh.mlp, _MLP_NAMES)},
        "final_norm": params.final_norm.weight.detach(),
        "lm_head": params.lm_head.detach(),
    }


def _xlstm_tree(params: XLSTM) -> Dict[str, Any]:
    pairs = list(params.pairs)
    tree = {"m_norm": torch.stack([p.m_norm.weight.detach() for p in pairs]),
            "mlstm": _stacked([p.mlstm for p in pairs], MLSTM_NAMES)}
    if pairs[0].slstm is not None:
        tree.update(s_norm=torch.stack([p.s_norm.weight.detach() for p in pairs]),
                    slstm=_stacked([p.slstm for p in pairs], SLSTM_NAMES))
    return {"embed": params.embed.detach(), "pairs": tree,
            "final_norm": params.final_norm.weight.detach(), "lm_head": params.lm_head.detach()}


def _encdec_tree(params: EncDec) -> Dict[str, Any]:
    def stacked(layers, *parts):
        out = {}
        for norm in parts:
            out[norm] = torch.stack([getattr(la, norm).weight.detach() for la in layers])
        out["attn"] = _stacked([la.attn for la in layers], _gqa_names(layers[0].attn))
        out["mlp"] = _stacked([la.mlp for la in layers], _MLP_NAMES)
        return out

    dec = list(params.dec_layers)
    return {"enc_layers": stacked(list(params.enc_layers), "attn_norm", "mlp_norm"),
            "dec_layers": {**stacked(dec, "attn_norm", "x_norm", "mlp_norm"),
                           "xattn": _stacked([la.xattn for la in dec], XATTN_NAMES)},
            "embed": params.embed.detach(), "enc_norm": params.enc_norm.weight.detach(),
            "final_norm": params.final_norm.weight.detach(), "lm_head": params.lm_head.detach()}


def params_to_tree(params: Model) -> Dict[str, Any]:
    """The port's model as the reference's params tree of tensors on the
    model's device: layer leaves stacked on a leading (L, ...) axis (new
    tensors), the others the model's own."""
    if isinstance(params, Zamba):
        return _hybrid_tree(params)
    if isinstance(params, XLSTM):
        return _xlstm_tree(params)
    if isinstance(params, EncDec):
        return _encdec_tree(params)
    stack = lambda ts: torch.stack([x.detach() for x in ts])  # noqa: E731
    blocks = list(params.layers)

    ffns = [b.mlp for b in blocks]
    if isinstance(ffns[0], MoE):
        ffn = {"moe": _stacked(ffns, _MOE_NAMES)}
        if ffns[0].shared is not None:
            ffn["moe"]["shared"] = _stacked([m.shared for m in ffns], _MLP_NAMES)
    else:
        ffn = {"mlp": _stacked(ffns, _MLP_NAMES)}
    attn = blocks[0].attn
    if isinstance(attn, MLAAttention):
        names = _MLA_NAMES + _MLA_Q_NAMES[attn.wq is None]
    else:
        names = _gqa_names(attn)
    tree = {
        "embed": params.embed.detach(),
        "layers": {"attn_norm": stack([b.attn_norm.weight for b in blocks]),
                   "attn": _stacked([b.attn for b in blocks], names),
                   "mlp_norm": stack([b.mlp_norm.weight for b in blocks]), **ffn},
        "final_norm": params.final_norm.weight.detach(),
    }
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head.detach()
    if params.patch_proj is not None:
        tree["patch_proj"] = params.patch_proj.detach()
    return tree


def params_to_numpy(params: Model) -> Dict[str, Any]:
    """The port's model as the reference's params tree of numpy arrays."""
    return tree_map(_array, params_to_tree(params))
