"""LM serving and training forwards of every family of the registry (port
of `repro.models`): the dense and mixture-of-experts families with GQA or
multi-head latent attention, the VLM (its vision tower a stub), the Mamba2
/ shared-attention hybrid, the xLSTM and the encoder-decoder (its audio
frontend a stub)."""
from . import (attention, encdec, layers, model_zoo, moe, ssm, transformer,  # noqa: F401
               vlm_stub, xlstm, xlstm_lm, zamba)
from .encdec import EncDec, encode
from .model_zoo import (cache_spec, decode_step, forward, forward_hidden, init_params,
                        input_specs, params_from_numpy, params_from_tree, params_to_numpy,
                        params_to_tree, prefill, train_forward, trainable)
from .moe import MoE, moe_apply, moe_init
from .ssm import Mamba2, mamba2_apply, mamba2_init
from .vlm_stub import fake_frame_embeds, fake_patch_embeds
from .xlstm import mlstm_apply, slstm_apply
from .xlstm_lm import XLSTM
from .zamba import Zamba

__all__ = ["init_params", "forward", "prefill", "decode_step", "cache_spec", "train_forward",
           "forward_hidden", "input_specs", "trainable",
           "params_from_numpy", "params_to_numpy", "params_from_tree", "params_to_tree",
           "MoE", "moe_init", "moe_apply", "Mamba2", "mamba2_init", "mamba2_apply", "Zamba",
           "mlstm_apply", "slstm_apply", "XLSTM", "EncDec", "encode", "fake_frame_embeds",
           "fake_patch_embeds"]
