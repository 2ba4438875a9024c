"""LM serving path of the dense and mixture-of-experts families, with GQA or
multi-head latent attention, of the Mamba2 / shared-attention hybrid and of
the xLSTM (port of `repro.models`, those four families)."""
from . import (attention, layers, model_zoo, moe, ssm, transformer, xlstm,  # noqa: F401
               xlstm_lm, zamba)
from .model_zoo import (cache_spec, decode_step, forward, init_params, params_from_numpy,
                        params_from_tree, params_to_numpy, params_to_tree, prefill)
from .moe import MoE, moe_apply, moe_init
from .ssm import Mamba2, mamba2_apply, mamba2_init
from .xlstm import mlstm_apply, slstm_apply
from .xlstm_lm import XLSTM
from .zamba import Zamba

__all__ = ["init_params", "forward", "prefill", "decode_step", "cache_spec",
           "params_from_numpy", "params_to_numpy", "params_from_tree", "params_to_tree",
           "MoE", "moe_init", "moe_apply", "Mamba2", "mamba2_init", "mamba2_apply", "Zamba",
           "mlstm_apply", "slstm_apply", "XLSTM"]
