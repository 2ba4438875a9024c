"""Dense-family LM serving path (port of `repro.models`, dense family)."""
from . import attention, layers, model_zoo, transformer  # noqa: F401
from .model_zoo import (cache_spec, decode_step, forward, init_params, params_from_numpy,
                        params_from_tree, params_to_numpy, params_to_tree, prefill)

__all__ = ["init_params", "forward", "prefill", "decode_step", "cache_spec",
           "params_from_numpy", "params_to_numpy", "params_from_tree", "params_to_tree"]
