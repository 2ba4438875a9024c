"""xlstm-125m (see registry.py for the numbers)."""
from .registry import XLSTM_125M

CONFIG = XLSTM_125M
