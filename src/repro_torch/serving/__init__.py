"""Batched serving (port of `repro.serving.engine`)."""
from .engine import GenerationResult, ServeEngine

__all__ = ["ServeEngine", "GenerationResult"]
