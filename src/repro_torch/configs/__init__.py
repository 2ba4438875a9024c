"""Configs of the port (copies of `repro.configs`): architectures, the
shape suites, the paper's VAR workloads, and the config shims of the ported
architectures (``configs.<id>.CONFIG``)."""
from . import (glm4_9b, h2o_danube_1_8b, llama4_maverick_400b, llava_next_34b,  # noqa: F401
               phi3_medium_14b, qwen3_0_6b, whisper_base, xlstm_125m, zamba2_7b)
from .base import (SHAPES, SHAPES_BY_NAME, ArchConfig, MLAConfig, MoEConfig, ShapeConfig,
                   SSMConfig, cell_is_runnable)
from .paper_var import PAPER_VAR_CONFIGS, VARWorkload
from .registry import ALIASES, ARCHS, get_arch, list_archs

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "SHAPES_BY_NAME", "cell_is_runnable", "ARCHS", "ALIASES", "get_arch", "list_archs",
           "PAPER_VAR_CONFIGS", "VARWorkload"]
