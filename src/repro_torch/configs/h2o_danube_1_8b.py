"""h2o-danube-1.8b (see registry.py for the numbers)."""
from .registry import H2O_DANUBE

CONFIG = H2O_DANUBE
