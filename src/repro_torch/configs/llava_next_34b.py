"""llava-next-34b (see registry.py for the numbers)."""
from .registry import LLAVA_NEXT_34B

CONFIG = LLAVA_NEXT_34B
