"""whisper-base (see registry.py for the numbers)."""
from .registry import WHISPER_BASE

CONFIG = WHISPER_BASE
