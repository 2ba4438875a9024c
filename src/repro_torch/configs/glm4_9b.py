"""glm4-9b (see registry.py for the numbers)."""
from .registry import GLM4_9B

CONFIG = GLM4_9B
