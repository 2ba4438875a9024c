"""phi3-medium-14b (see registry.py for the numbers)."""
from .registry import PHI3_MEDIUM

CONFIG = PHI3_MEDIUM
