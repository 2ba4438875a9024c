"""Wrappers of the banded matvec CUDA kernels: the product and the gradient
of its diagonals (port of `repro.kernels.banded_matvec.ops`).

The product is differentiable through :class:`BandedMatvec`, the port of the
reference's custom VJP.  Both cotangents stay banded-local, and both run on
the card as kernels of ``csrc/banded_matvec.cu``:

  * d loss / d x = A^T g -- the product kernel with its ``transposed`` flag,
    which reads A's diagonals where they lie (no transposed copy), only when
    x needs a gradient;
  * d loss / d diags[r, b+o] = sum_n g[n, r] x[n, r+o] -- the gradient
    kernel (:func:`band_gradient`), one pass over g and x (the reference
    computes it as one jnp einsum inside its VJP).

So a fit step, which differentiates only the diagonals, launches the product
once and the gradient once.  CUDA tensors run ``csrc/banded_matvec.cu``; CPU
tensors run the plain versions (``ref.py``: ``banded_matvec_ref`` on
``band_transpose(diags)`` for A^T, ``band_gradient``).  A CUDA tensor never
falls back to a plain version.
"""
from __future__ import annotations

import torch

from .._build import BAND_COLS, BAND_MAX_SLABS, BAND_OFFSETS, BAND_PASS, BandGradParams, BandParams
from .._launch import Kernel, Prepared, on_cuda, register, require, sm_count
from .ref import band_gradient as band_gradient_ref
from .ref import band_transpose, banded_matvec_ref, bandwidth

__all__ = ["BANDED_MATVEC", "BAND_GRADIENT", "BandedMatvec", "banded_matvec",
           "banded_matvec_rows", "band_gradient", "band_transpose", "forward_shape",
           "gradient_shape", "prepare_banded_matvec", "prepare_band_gradient"]

BANDED_MATVEC = register(Kernel("banded_matvec", "rt_banded_matvec"))
BAND_GRADIENT = register(Kernel("band_gradient", "rt_band_gradient"))

_SMEM_DEFAULT = 48 * 1024  # bytes of shared memory a launch gets without opting in
_SMEM_MAX = 232448         # bytes a CTA may opt in to on the H100
_VEC_MAX_B = 8             # the vector paths take b <= 8 (two float4 of halo a side)

# Launch shapes, chosen by timing their variants on the H100
# (tools/kernel_variants/variants_bench.py banded): threads per CTA of the
# vector product over many rows and at one right-hand side (4 columns a
# thread), the vector product's grid of about WAVES x 2,048 threads per SM
# (the generic path's 4), and the vector gradient's threads per CTA and row
# slabs (CTAs per cluster).
ROWS_THREADS = 256
ONE_ROW_THREADS = 64
WAVES = 1
GRAD_THREADS = 128
GRAD_SLABS = 8


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _vector_hq(d: int, b: int, aligned: bool) -> int:
    """HQ, the float4 of halo a side, of the vector paths; 0 for the generic
    ones (d % 4 != 0, rows not 16-byte aligned, or b > 8)."""
    if not aligned or d % 4 or b > _VEC_MAX_B:
        return 0
    return 1 if min(b, d - 1) <= 4 else 2


def forward_shape(m: int, d: int, b: int, aligned: bool, transposed: bool, sms: int) -> dict:
    """The launch shape of the product (the integer fields of
    :class:`~.._build.BandParams`): x (m, d), b-banded A, ``aligned`` when
    the diagonals and x start on 16 bytes, ``sms`` SMs on the card."""
    w, halo = 2 * b + 1, min(b, d - 1)
    vec = _vector_hq(d, b, aligned)
    if vec:
        threads = ONE_ROW_THREADS if m == 1 else ROWS_THREADS
        cols, rows_per_pass = 4 * threads, 1
        smem = 4 * w * (cols + (8 * vec if transposed else 0))  # A^T: 4 HQ halo rows a side
    else:
        threads = cols = BAND_COLS
        width = BAND_COLS + 2 * halo
        rows_per_pass = max(1, min(BAND_PASS, _SMEM_DEFAULT // (4 * width)))
        smem = 4 * width * rows_per_pass
    if smem > _SMEM_MAX:
        raise ValueError(f"bandwidth {b} needs {smem} bytes of shared memory per CTA; "
                         f"the kernel stages at most {_SMEM_MAX}")
    col_tiles = _ceil_div(d, cols)
    # slabs of rows so the grid holds about WAVES waves of CTAs
    waves = WAVES if vec else 4
    want_slabs = max(1, _ceil_div(waves * sms * (2048 // threads), col_tiles))
    rows_per_cta = max(rows_per_pass, _ceil_div(m, want_slabs))
    if vec and rows_per_cta == 1 and not transposed:
        smem = 0  # banded_matvec_row: the diagonals go straight to registers
    return dict(halo=halo, vec=vec, transposed=int(transposed), threads=threads,
                rows_per_cta=rows_per_cta, rows_per_pass=rows_per_pass, col_tiles=col_tiles,
                row_slabs=_ceil_div(m, rows_per_cta), smem_bytes=smem)


def gradient_shape(m: int, d: int, b: int, aligned: bool, sms: int) -> dict:
    """The launch shape of the gradient (the integer fields of
    :class:`~.._build.BandGradParams`).  The vector path splits the rows
    into a power of two of slabs, at most GRAD_SLABS and m, one cluster of
    CTAs per column tile; the generic path gives a thread every row of one
    column and BAND_OFFSETS offsets."""
    w, halo = 2 * b + 1, min(b, d - 1)
    vec = _vector_hq(d, b, aligned)
    if vec:
        cols = 4 * GRAD_THREADS
        slabs = 1 << (min(GRAD_SLABS, BAND_MAX_SLABS, m).bit_length() - 1)
        return dict(halo=halo, vec=vec, threads=GRAD_THREADS,
                    rows_per_cta=_ceil_div(m, slabs), col_tiles=_ceil_div(d, cols),
                    row_slabs=slabs, offset_chunks=1, smem_bytes=4 * w * cols)
    return dict(halo=halo, vec=0, threads=BAND_COLS, rows_per_cta=m,
                col_tiles=_ceil_div(d, BAND_COLS), row_slabs=1,
                offset_chunks=_ceil_div(w, BAND_OFFSETS), smem_bytes=0)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def prepare_banded_matvec(diags: torch.Tensor, x: torch.Tensor,
                          transposed: bool = False) -> Prepared:
    """y = A x (A^T x with ``transposed``) for every row of ``x`` (m, d);
    ``diags`` (d, 2b+1) holds the diagonals where the reference keeps them,
    diags[r, b+o] = A[r, r+o].  Both contiguous float32 on one device;
    ``.launch()`` returns y (m, d)."""
    d, w = diags.shape
    m = x.shape[0]
    require(diags, "diags", (d, w))
    require(x, "x", (m, d))
    if w % 2 == 0 or m == 0 or d == 0:
        raise ValueError(f"need diags (d, 2b+1) and x (m >= 1, d >= 1), got "
                         f"{tuple(diags.shape)} and {tuple(x.shape)}")
    shape = forward_shape(m, d, (w - 1) // 2, _aligned(diags, x), transposed,
                          sm_count(x.device))
    p = BandParams(diags=diags.data_ptr(), x=x.data_ptr(), m=m, d=d, b=(w - 1) // 2, **shape)
    y = torch.empty((m, d), device=x.device)
    p.y = y.data_ptr()
    return Prepared(BANDED_MATVEC, p, x.device, y, (diags, x))


def prepare_band_gradient(g: torch.Tensor, x: torch.Tensor, b: int) -> Prepared:
    """d loss / d diags of y = A x for a b-banded A, from g = d loss / d y
    and x, both (m, d) contiguous float32 on one device: out[r, b+o] =
    sum_n g[n, r] x[n, r+o], 0 where r+o falls off the matrix.
    ``.launch()`` returns out (d, 2b+1)."""
    m, d = x.shape
    require(x, "x", (m, d))
    require(g, "g", (m, d))
    if b < 0 or m == 0 or d == 0:
        raise ValueError(f"need b >= 0 and g, x (m >= 1, d >= 1), got b={b} and "
                         f"{tuple(x.shape)}")
    shape = gradient_shape(m, d, b, _aligned(g, x), sm_count(x.device))
    p = BandGradParams(g=g.data_ptr(), x=x.data_ptr(), m=m, d=d, b=b, **shape)
    out = torch.empty((d, 2 * b + 1), device=x.device)
    p.out = out.data_ptr()
    return Prepared(BAND_GRADIENT, p, x.device, out, (g, x))


def _matvec(diags: torch.Tensor, x: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """A x (A^T x with ``transposed``) for every row of x (m, d): the kernel
    on CUDA, the plain version on the CPU."""
    if not on_cuda(diags, x):
        return banded_matvec_ref(band_transpose(diags) if transposed else diags, x)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    return prepare_banded_matvec(diags.contiguous(), x.contiguous(), transposed).launch()


def band_gradient(g: torch.Tensor, x: torch.Tensor, b: int) -> torch.Tensor:
    """d loss / d diags (d, 2b+1) of y = A x from g = d loss / d y and x,
    both (m, d) float32: the gradient kernel on CUDA, the plain version
    (nine shifted products at b = 4) on the CPU."""
    if not on_cuda(g, x):
        return band_gradient_ref(g, x, b)
    if x.shape[0] == 0:
        return x.new_zeros((x.shape[1], 2 * b + 1))
    return prepare_band_gradient(g.contiguous(), x.contiguous(), b).launch()


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
            d_x = _matvec(diags, g, True)
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
