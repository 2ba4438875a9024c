"""Banded spatial AR models -- very-high-d weak memory in SPACE (paper §6;
port of `repro.core.estimators.spatial`).

When the AR(1) transition A is b-banded (numerical-differentiation stencils,
road networks, sensor lattices), the state row-partitions into P pieces P_i
with spatial halos P_i+ = P_i plus its b neighbours, and:

  * one-step prediction x_{t+1} = A x_t is embarrassingly parallel across
    row partitions, O(d (2b+1)) work instead of O(d^2)  (§6.1);
  * with a block-diagonal noise precision aligned to the partition, the
    conditional likelihood and its gradient separate per partition (§6.2);
  * first-order methods with the §6.3 step size converge exponentially.

A is stored as stacked diagonals, (d, 2b+1): ``diags[i, b+o] = A[i, i+o]``
for offsets o in [-b, b] (zero where i+o falls off the matrix).  The
predictor goes through the backend's ``banded_matvec`` (the banded kernel on
"cuda"); its gradient with respect to the diagonals is banded-local, so a
fit step launches the kernel once.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..backend import BackendSpec, get_backend, resolve_device

__all__ = [
    "BandedARModel",
    "banded_to_dense",
    "dense_to_banded",
    "banded_predict",
    "SpatialPartition",
    "banded_predict_partitioned",
    "banded_nll",
    "BandedFitResult",
    "fit_banded_ar",
]


def _band_index(d: int, b: int, device=None) -> tuple:
    """(cols (d, 2b+1), valid) with cols[i, b+o] = i + o."""
    rows = torch.arange(d, device=device)[:, None]
    cols = rows + torch.arange(-b, b + 1, device=device)[None, :]
    return cols, (cols >= 0) & (cols < d)


@dataclasses.dataclass(frozen=True)
class BandedARModel:
    """x_{t+1} = A x_t + eps_t with b-banded A stored as diagonals."""

    diags: torch.Tensor  # (d, 2b+1)

    @property
    def d(self) -> int:
        return self.diags.shape[0]

    @property
    def bandwidth(self) -> int:
        return (self.diags.shape[1] - 1) // 2

    @classmethod
    def from_numpy(cls, diags, device="cuda") -> "BandedARModel":
        """A model from (d, 2b+1) diagonals held as a numpy array (for
        example the reference's fitted ``diags``), as float32 on
        ``device`` (the card unless the CPU is asked for)."""
        return cls(torch.as_tensor(np.array(diags, np.float32), device=resolve_device(device)))

    def to_numpy(self) -> np.ndarray:
        """The (d, 2b+1) float32 diagonals as a numpy array."""
        return self.diags.detach().cpu().numpy()


def banded_to_dense(diags: torch.Tensor) -> torch.Tensor:
    """(d, 2b+1) diagonals -> dense (d, d) banded matrix."""
    d, w = diags.shape
    cols, valid = _band_index(d, (w - 1) // 2, diags.device)
    dense = diags.new_zeros((d, d))
    rows = torch.arange(d, device=diags.device)[:, None].expand_as(cols)
    return dense.index_put((rows[valid], cols[valid]), diags[valid], accumulate=True)


def dense_to_banded(A: torch.Tensor, b: int) -> torch.Tensor:
    """The (d, 2b+1) diagonals of a dense matrix (drops what lies off-band)."""
    d = A.shape[0]
    cols, valid = _band_index(d, b, A.device)
    rows = torch.arange(d, device=A.device)[:, None]
    return torch.where(valid, A[rows, cols.clamp(0, d - 1)], 0.0)


def banded_predict(diags: torch.Tensor, x: torch.Tensor,
                   backend: BackendSpec = None) -> torch.Tensor:
    """x_hat = A x from the diagonal form, O(d (2b+1)) (paper §6.1).

    Args:
      diags: (d, 2b+1);  x: (..., d).
    Returns (..., d) float32.  Differentiable in both arguments.
    """
    return get_backend(backend, x.device).banded_matvec(diags, x)


@dataclasses.dataclass(frozen=True)
class SpatialPartition:
    """Row partitioning of a d-dim state with b-halos (paper §6.1, P_i / P_i+)."""

    d: int
    num_parts: int
    bandwidth: int

    def __post_init__(self):
        if self.d % self.num_parts != 0:
            raise ValueError(f"d={self.d} must divide into {self.num_parts} parts")

    @property
    def part_size(self) -> int:
        return self.d // self.num_parts

    def padded_indices(self) -> np.ndarray:
        """(P, part_size + 2b) global row index of every padded slot."""
        starts = np.arange(self.num_parts) * self.part_size - self.bandwidth
        return starts[:, None] + np.arange(self.part_size + 2 * self.bandwidth)[None, :]

    def padded_mask(self) -> np.ndarray:
        idx = self.padded_indices()
        return (idx >= 0) & (idx < self.d)


def banded_predict_partitioned(diags: torch.Tensor, x: torch.Tensor,
                               part: SpatialPartition) -> torch.Tensor:
    """Partitioned predictor: each part computes its rows from x^{P_i+} only
    (an explicit batch gather over the P parts).  Equal to
    :func:`banded_predict`; x (..., d) -> (..., d)."""
    b, ps, P = part.bandwidth, part.part_size, part.num_parts
    idx = torch.as_tensor(part.padded_indices(), device=x.device)
    mask = torch.as_tensor(part.padded_mask(), device=x.device)
    x_parts = torch.where(mask, x[..., idx.clamp(0, part.d - 1)], 0.0)  # (..., P, ps+2b)
    # row r of a part sees its padded slots [r, r + 2b]
    cols = torch.arange(ps, device=x.device)[:, None] + torch.arange(2 * b + 1,
                                                                     device=x.device)
    xn = x_parts[..., cols]  # (..., P, ps, 2b+1)
    out = torch.einsum("...prw,prw->...pr", xn, diags.reshape(P, ps, -1).to(xn.dtype))
    return out.reshape(*x.shape[:-1], part.d)


def banded_nll(diags: torch.Tensor, x: torch.Tensor,
               block_precisions: Optional[torch.Tensor] = None,
               part: Optional[SpatialPartition] = None,
               backend: BackendSpec = None) -> torch.Tensor:
    """Mean conditional NLL with block-diagonal precision (paper §6.2).

    Args:
      diags: (d, 2b+1) banded transition.
      x: (T, d) observations.
      block_precisions: (P, ps, ps) diagonal blocks of the precision
        (defaults to I).
      part: spatial partitioning (defaults to one part).
      backend: compute backend of the predictor; differentiable on both.
    """
    d = diags.shape[0]
    if part is None:
        part = SpatialPartition(d=d, num_parts=1, bandwidth=(diags.shape[1] - 1) // 2)
    pred = banded_predict(diags, x[:-1], backend=backend)  # (T-1, d)
    resid = x[1:] - pred
    r = resid.reshape(resid.shape[0], part.num_parts, part.part_size)
    if block_precisions is None:
        quad = torch.sum(r * r)
        logdet = 0.0
    else:
        quad = torch.einsum("tpi,pij,tpj->", r, block_precisions, r)
        logdet = torch.sum(torch.linalg.slogdet(block_precisions)[1])
    return 0.5 * quad / resid.shape[0] - 0.5 * logdet


class BandedFitResult(NamedTuple):
    diags: torch.Tensor     # (d, 2b+1)
    nll_trace: torch.Tensor  # (n_steps,): the loss before each step


def fit_banded_ar(x: torch.Tensor, bandwidth: int, *, n_steps: int = 300,
                  step_size: Optional[float] = None, num_parts: int = 1,
                  block_precisions: Optional[torch.Tensor] = None,
                  backend: BackendSpec = None) -> BandedFitResult:
    """First-order conditional MLE of the banded model (paper §6.2-6.3),
    stepped eagerly: each step evaluates :func:`banded_nll` and its gradient
    with respect to the diagonals (autograd through the banded matvec's
    banded-local backward) and moves by ``step_size``.

    ``step_size=None`` takes 2 / (lambda_min + lambda_max) of the dense
    sample covariance, as the reference does -- a (d, d) eigendecomposition,
    so pass a step size at large d.
    """
    d = x.shape[1]
    part = SpatialPartition(d=d, num_parts=num_parts, bandwidth=bandwidth)
    be = get_backend(backend, x.device)
    if step_size is None:
        ev = torch.linalg.eigvalsh(torch.cov(x.float().T).reshape(d, d))
        step_size = float(2.0 / (ev[0] + ev[-1]))
    diags = torch.zeros((d, 2 * bandwidth + 1), device=x.device)
    trace = []
    for _ in range(n_steps):
        diags.requires_grad_(True)
        v = banded_nll(diags, x, block_precisions, part, backend=be)
        (g,) = torch.autograd.grad(v, diags)
        diags = diags.detach() - step_size * g
        trace.append(v.detach())
    return BandedFitResult(diags, torch.stack(trace))
