"""Serving (port of `repro.serving.engine`, `repro.serving.rolling` and
`repro.serving.gateway`)."""
from .engine import GenerationResult, ServeEngine
from .gateway import (Degraded, GatewayConfig, GatewayRejected, PoisonedChunk, QueueFull,
                      RateClass, RateLimited, StatsGateway)
from .rolling import RollingStatsService

__all__ = ["ServeEngine", "GenerationResult", "RollingStatsService", "StatsGateway",
           "GatewayConfig", "RateClass", "GatewayRejected", "QueueFull", "RateLimited",
           "Degraded", "PoisonedChunk"]
