"""Serving (port of `repro.serving.engine` and `repro.serving.rolling`)."""
from .engine import GenerationResult, ServeEngine
from .rolling import RollingStatsService

__all__ = ["ServeEngine", "GenerationResult", "RollingStatsService"]
