"""Architecture configs of the port (copies of `repro.configs`)."""
from .base import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from .registry import ALIASES, ARCHS, get_arch, list_archs

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ARCHS", "ALIASES",
           "get_arch", "list_archs"]
