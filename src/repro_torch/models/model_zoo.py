"""Model zoo dispatcher, dense family (port of `repro.models.model_zoo`).

  init_params(cfg, seed=...)              -> Transformer
  forward(params, batch, cfg)             -> logits (B, S, V)
  prefill(params, batch, cfg)             -> (last logits, cache)
  decode_step(params, cache, batch, cfg)  -> (logits, cache)
  cache_spec(cfg, batch, seq)             -> {name: TensorSpec}
  params_from_numpy / params_to_numpy     -- the reference's weights carried
                                             across, and back

``batch`` is a dict: ``tokens`` (and ``pos`` for decode).  Only the dense
family is ported; every other family raises ``NotImplementedError`` naming
its ROADMAP item.  ``init_params`` and ``params_from_numpy`` put the model on
the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.backend import resolve_device
from . import transformer
from .attention import Attention, GQAAttention, TensorSpec, mla_not_ported
from .layers import DTYPE, MLP, RMSNorm
from .transformer import Block, Transformer

__all__ = ["init_params", "forward", "prefill", "decode_step", "cache_spec",
           "params_from_numpy", "params_to_numpy"]

_OPEN_FAMILIES = {
    "moe": "mixture-of-experts (models/moe.py), ROADMAP Queue A item 11",
    "ssm": "xLSTM (models/xlstm.py, xlstm_lm.py), ROADMAP Queue A item 11",
    "hybrid": "the SSM hybrid (models/ssm.py, zamba.py), ROADMAP Queue A item 11",
    "encdec": "the encoder-decoder (models/encdec.py), ROADMAP Queue A item 11",
    "vlm": "the VLM stub (models/vlm_stub.py), ROADMAP Queue A item 11",
}


def _dense_only(cfg) -> None:
    if cfg.family in _OPEN_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet: "
                                  f"{_OPEN_FAMILIES[cfg.family]}")
    if cfg.attn == "mla":
        raise mla_not_ported(cfg)


def init_params(cfg, *, seed: int = 0, generator: Optional[torch.Generator] = None,
                dtype=DTYPE, device="cuda") -> Transformer:
    """Random weights from ``seed`` (or an explicit ``generator`` on
    ``device``), made on ``device``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return transformer.lm_init(generator, cfg, dtype, dev)


def forward(params: Transformer, batch: Dict[str, Any], cfg) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    _dense_only(cfg)
    return transformer.lm_forward(params, batch["tokens"], cfg)


def prefill(params: Transformer, batch: Dict[str, Any], cfg, *,
            attention: Optional[Attention] = None):
    _dense_only(cfg)
    return transformer.lm_prefill(params, batch["tokens"], cfg, attention=attention)


def decode_step(params: Transformer, cache, batch: Dict[str, Any], cfg):
    _dense_only(cfg)
    return transformer.lm_decode_step(params, cache, batch["tokens"], batch["pos"], cfg)


def cache_spec(cfg, batch: int, seq_len: int, dtype=DTYPE) -> Dict[str, TensorSpec]:
    _dense_only(cfg)
    return transformer.lm_cache_spec(cfg, batch, seq_len, dtype)


# ------------------------------------------------- weights carried across --


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


def params_from_numpy(tree: Dict[str, Any], cfg, device="cuda") -> Transformer:
    """The reference's dense-family params -- a nest of dicts of numpy
    arrays, layer leaves stacked on a leading (L, ...) axis, as
    ``jax.tree.map(np.asarray, params)`` gives them -- as the port's model
    on ``device``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    t = lambda a: _tensor(a, dev)  # noqa: E731
    lay = tree["layers"]
    blocks = []
    for i in range(cfg.n_layers):
        at = {k: a[i] for k, a in lay["attn"].items()}
        attn = GQAAttention(t(at["wq"]), t(at["wk"]), t(at["wv"]), t(at["wo"]),
                            *((t(at["q_norm"]), t(at["k_norm"])) if cfg.qk_norm else ()))
        mlp = MLP(*(t(lay["mlp"][k][i]) for k in ("w_gate", "w_up", "w_down")))
        blocks.append(Block(RMSNorm(t(lay["attn_norm"][i]), cfg.norm_eps), attn,
                            RMSNorm(t(lay["mlp_norm"][i]), cfg.norm_eps), mlp))
    head = None if cfg.tie_embeddings else t(tree["lm_head"])
    return Transformer(cfg, t(tree["embed"]), blocks, RMSNorm(t(tree["final_norm"]),
                                                              cfg.norm_eps), head)


def params_to_numpy(params: Transformer) -> Dict[str, Any]:
    """The port's model as the reference's params tree of numpy arrays."""
    stack = lambda ts: np.stack([_array(x) for x in ts])  # noqa: E731
    blocks = list(params.layers)
    attn = {k: stack([getattr(b.attn, k) for b in blocks]) for k in ("wq", "wk", "wv", "wo")}
    if blocks[0].attn.q_norm is not None:
        attn.update({k: stack([getattr(b.attn, k) for b in blocks]) for k in ("q_norm", "k_norm")})
    tree = {
        "embed": _array(params.embed),
        "layers": {"attn_norm": stack([b.attn_norm.weight for b in blocks]), "attn": attn,
                   "mlp_norm": stack([b.mlp_norm.weight for b in blocks]),
                   "mlp": {k: stack([getattr(b.mlp, k) for b in blocks])
                           for k in ("w_gate", "w_up", "w_down")}},
        "final_norm": _array(params.final_norm.weight),
    }
    if params.lm_head is not None:
        tree["lm_head"] = _array(params.lm_head)
    return tree
