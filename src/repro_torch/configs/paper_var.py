"""The paper's own workload configs: large-scale VAR / VARMA estimation
(a copy of `repro.configs.paper_var`).

The paper has no named model sizes; these are the regimes its scaling
arguments address: dense moderate d, high-d banded spatial, and VARMA.
"""
from __future__ import annotations

import dataclasses

__all__ = ["VARWorkload", "PAPER_VAR_CONFIGS"]


@dataclasses.dataclass(frozen=True)
class VARWorkload:
    name: str
    n: int  # time steps
    d: int  # spatial dimensions
    p: int  # AR order
    q: int = 0  # MA order
    bandwidth: int = 0  # 0 -> dense coefficient matrices
    block_size: int = 4096


PAPER_VAR_CONFIGS = {
    "var-dense-small": VARWorkload("var-dense-small", n=100_000, d=8, p=3),
    "var-dense-wide": VARWorkload("var-dense-wide", n=1_000_000, d=64, p=2),
    "varma": VARWorkload("varma", n=500_000, d=8, p=2, q=1),
    "var-banded-highd": VARWorkload(
        "var-banded-highd", n=200_000, d=16_384, p=1, bandwidth=4
    ),
}
