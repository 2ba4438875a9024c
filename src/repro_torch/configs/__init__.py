"""Configs of the port (copies of `repro.configs`): architectures, the
shape suites, the paper's VAR workloads."""
from .base import (SHAPES, SHAPES_BY_NAME, ArchConfig, MLAConfig, MoEConfig, ShapeConfig,
                   SSMConfig, cell_is_runnable)
from .paper_var import PAPER_VAR_CONFIGS, VARWorkload
from .registry import ALIASES, ARCHS, get_arch, list_archs

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "SHAPES_BY_NAME", "cell_is_runnable", "ARCHS", "ALIASES", "get_arch", "list_archs",
           "PAPER_VAR_CONFIGS", "VARWorkload"]
