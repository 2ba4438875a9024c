"""Wrapper of the banded matvec CUDA kernel and its gradient (port of
`repro.kernels.banded_matvec.ops`).

The product is differentiable through :class:`BandedMatvec`, the port of the
reference's custom VJP.  Both cotangents stay banded-local:

  * d loss / d x = A^T g -- the SAME CUDA kernel, run on the transposed band
    (:func:`~.ref.band_transpose`), only when x needs a gradient;
  * d loss / d diags[r, b+o] = sum_n g[n, r] x[n, r+o] -- one shifted
    product and column sum per offset in PyTorch (:func:`~.ref.band_gradient`;
    the reference also computes it outside its Pallas kernel).

So a fit that differentiates only the diagonals launches the kernel once per
step.  CUDA tensors run ``csrc/banded_matvec.cu``; CPU tensors run the
plain version (``ref.py``).  A CUDA tensor never falls back to the plain
version.
"""
from __future__ import annotations

import torch

from .._build import BAND_COLS, BAND_PASS, BAND_VCOLS, BandParams
from .._launch import Kernel, Prepared, on_cuda, register, require, sm_count
from .ref import band_gradient, band_transpose, banded_matvec_ref, bandwidth

__all__ = ["BANDED_MATVEC", "BandedMatvec", "banded_matvec", "banded_matvec_rows",
           "band_transpose", "prepare_banded_matvec"]

BANDED_MATVEC = register(Kernel("banded_matvec", "rt_banded_matvec"))

_SMEM_DEFAULT = 48 * 1024  # bytes of shared memory a launch gets without opting in
_SMEM_MAX = 232448         # bytes a CTA may opt in to on the H100


def prepare_banded_matvec(coef: torch.Tensor, x: torch.Tensor) -> Prepared:
    """y = A x for every row of ``x`` (m, d); ``coef`` (2b+1, d) holds the
    diagonals band-major, coef[b+o, r] = A[r, r+o].  Both contiguous float32
    on one device; ``.launch()`` returns y (m, d)."""
    w, d = coef.shape
    m = x.shape[0]
    require(coef, "coef", (w, d))
    require(x, "x", (m, d))
    if w % 2 == 0 or m == 0 or d == 0:
        raise ValueError(f"need coef (2b+1, d) and x (m >= 1, d >= 1), got "
                         f"{tuple(coef.shape)} and {tuple(x.shape)}")
    p = BandParams()
    p.coef, p.x = coef.data_ptr(), x.data_ptr()
    p.m, p.d, p.b = m, d, (w - 1) // 2
    p.halo = min(p.b, d - 1)
    # the float4 path: whole float4 rows (d % 4 == 0, 16-byte aligned) and a
    # halo of at most two float4 a side; else the shared-memory path
    aligned = d % 4 == 0 and coef.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    p.vec = (1 if p.halo <= 4 else 2) if aligned and p.halo <= 8 else 0
    if p.vec:
        p.col_tiles = -(-d // BAND_VCOLS)
        p.rows_per_pass = 1
    else:
        width = BAND_COLS + 2 * p.halo
        p.rows_per_pass = max(1, min(BAND_PASS, _SMEM_DEFAULT // (4 * width)))
        p.smem_bytes = 4 * width * p.rows_per_pass
        if p.smem_bytes > _SMEM_MAX:
            raise ValueError(f"bandwidth {p.b} needs {p.smem_bytes} bytes of shared memory "
                             f"per CTA; the kernel stages at most {_SMEM_MAX}")
        p.col_tiles = -(-d // BAND_COLS)
    # slabs of rows so the grid holds about four waves of CTAs
    want_slabs = max(1, -(-4 * 8 * sm_count(x.device) // p.col_tiles))
    p.rows_per_cta = max(p.rows_per_pass, -(-m // want_slabs))
    p.row_slabs = -(-m // p.rows_per_cta)
    y = torch.empty((m, d), device=x.device)
    p.y = y.data_ptr()
    return Prepared(BANDED_MATVEC, p, x.device, y, (coef, x))


def _matvec(diags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x for every row of x (m, d): the kernel on CUDA, the plain version
    on the CPU."""
    if not on_cuda(diags, x):
        return banded_matvec_ref(diags, x)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    return prepare_banded_matvec(diags.t().contiguous(), x.contiguous()).launch()


class BandedMatvec(torch.autograd.Function):
    """y = A x over the rows of x (m, d), with the banded-local backward."""

    @staticmethod
    def forward(ctx, diags, x):
        ctx.save_for_backward(diags, x)
        return _matvec(diags, x)

    @staticmethod
    def backward(ctx, g):
        diags, x = ctx.saved_tensors
        d_diags = d_x = None
        if ctx.needs_input_grad[1]:
            d_x = _matvec(band_transpose(diags), g)
        if ctx.needs_input_grad[0]:
            d_diags = band_gradient(g, x, bandwidth(diags))
        return d_diags, d_x


def banded_matvec_rows(diags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x over the last axis: diags (d, 2b+1), x (..., d) -> (..., d)
    float32 (bf16 or other float inputs are cast to float32 first).
    Differentiable in both arguments."""
    d = diags.shape[0]
    bandwidth(diags)
    if x.shape[-1] != d:
        raise ValueError(f"x must end in d={d}, got {tuple(x.shape)}")
    y = BandedMatvec.apply(diags.float(), x.float().reshape(-1, d))
    return y.reshape(x.shape)


def banded_matvec(diags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x with b-banded A in diagonal storage, in the reference's
    contract: diags (d, 2b+1), x (d,) or (d, nrhs) -> y of x's shape,
    float32.  Differentiable (see the module docstring)."""
    if x.ndim == 1:
        return banded_matvec_rows(diags, x)
    if x.ndim != 2:
        raise ValueError(f"x must be (d,) or (d, nrhs), got {tuple(x.shape)}")
    return banded_matvec_rows(diags, x.T).T
