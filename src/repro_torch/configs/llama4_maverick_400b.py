"""llama4-maverick-400b-a17b (see registry.py for the numbers)."""
from .registry import LLAMA4_MAVERICK

CONFIG = LLAMA4_MAVERICK
