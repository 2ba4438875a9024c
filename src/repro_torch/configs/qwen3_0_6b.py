"""qwen3-0.6b (see registry.py for the numbers)."""
from .registry import QWEN3_0_6B

CONFIG = QWEN3_0_6B
