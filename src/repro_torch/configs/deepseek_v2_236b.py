"""deepseek-v2-236b (see registry.py for the numbers)."""
from .registry import DEEPSEEK_V2

CONFIG = DEEPSEEK_V2
