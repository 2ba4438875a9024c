"""zamba2-7b (see registry.py for the numbers)."""
from .registry import ZAMBA2_7B

CONFIG = ZAMBA2_7B
