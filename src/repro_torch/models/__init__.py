"""LM serving path of the dense and mixture-of-experts families, with GQA or
multi-head latent attention (port of `repro.models`, those two families)."""
from . import attention, layers, model_zoo, moe, transformer  # noqa: F401
from .model_zoo import (cache_spec, decode_step, forward, init_params, params_from_numpy,
                        params_from_tree, params_to_numpy, params_to_tree, prefill)
from .moe import MoE, moe_apply, moe_init

__all__ = ["init_params", "forward", "prefill", "decode_step", "cache_spec",
           "params_from_numpy", "params_to_numpy", "params_from_tree", "params_to_tree",
           "MoE", "moe_init", "moe_apply"]
