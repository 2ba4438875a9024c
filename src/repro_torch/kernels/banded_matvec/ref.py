"""Plain PyTorch version of the banded matvec kernel (port of
`repro.kernels.banded_matvec.ref` and of ``JnpBackend.banded_matvec``).

y[..., r] = sum_{o=-b..b} diags[r, b+o] * x[..., r+o], with x read as 0 off
the matrix.  The 2b+1 shifted products are summed in order o = -b..b; the
(..., d, 2b+1) neighbourhood gather of the reference is never built, so the
plain version stays within a few copies of x at any size.  Differentiable by
autograd.  On CPU tensors the kernel wrappers (``ops.py``) run these helpers;
on the card the kernels are held to them.
"""
from __future__ import annotations

import torch

__all__ = ["bandwidth", "band_slices", "banded_matvec_ref", "band_transpose",
           "band_gradient"]


def bandwidth(diags: torch.Tensor) -> int:
    """b of a (d, 2b+1) diagonal stack; raises for an even width."""
    if diags.ndim != 2 or diags.shape[1] % 2 == 0:
        raise ValueError(f"diags must be (d, 2b+1), got {tuple(diags.shape)}")
    return (diags.shape[1] - 1) // 2


def band_slices(d: int, b: int):
    """(o, lo, hi) for every offset o in [-b, b] that meets the matrix: rows
    r in [lo, hi) have their neighbour r + o inside [0, d)."""
    for o in range(-b, b + 1):
        if abs(o) < d:
            yield o, max(0, -o), min(d, d - o)


def banded_matvec_ref(diags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """diags (d, 2b+1), x (..., d) -> A x (..., d), in the promoted dtype."""
    d = diags.shape[0]
    b = bandwidth(diags)
    if x.shape[-1] != d:
        raise ValueError(f"x must end in d={d}, got {tuple(x.shape)}")
    y = x.new_zeros(x.shape, dtype=torch.promote_types(diags.dtype, x.dtype))
    for o, lo, hi in band_slices(d, b):
        y[..., lo:hi] += diags[lo:hi, b + o] * x[..., lo + o: hi + o]
    return y


def band_transpose(diags: torch.Tensor) -> torch.Tensor:
    """Diagonal storage of A^T from that of A: out[r, b+o] = diags[r+o, b-o],
    0 where r+o falls off the matrix (port of the reference's
    ``band_transpose``)."""
    d = diags.shape[0]
    b = bandwidth(diags)
    out = torch.zeros_like(diags)
    for o, lo, hi in band_slices(d, b):
        out[lo:hi, b + o] = diags[lo + o: hi + o, b - o]
    return out


def band_gradient(g: torch.Tensor, x: torch.Tensor, b: int) -> torch.Tensor:
    """d loss / d diags for y = A x, from g = d loss / d y and x, both (m, d):
    out[r, b+o] = sum_n g[n, r] x[n, r+o], 0 where r+o falls off the matrix.
    One shifted product and column sum per offset."""
    d = g.shape[1]
    out = g.new_zeros((d, 2 * b + 1))
    for o, lo, hi in band_slices(d, b):
        out[lo:hi, b + o] = (g[:, lo:hi] * x[:, lo + o: hi + o]).sum(0)
    return out
