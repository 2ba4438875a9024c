"""Data (port of `repro.data`): the synthetic token pipeline."""
from .tokens import SyntheticTokenPipeline  # noqa: F401
