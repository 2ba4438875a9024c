// Banded matrix times vectors for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/banded_matvec/kernel.py: banded_matvec_pallas
// (body _kernel): y = A x for a b-banded A stored as its 2b+1 diagonals,
// y[r] = sum_{o=-b..b} A[r, r+o] x[r+o], x read as 0 off the matrix.
//
// Contract (the port's own, not the TPU kernel's): the m right-hand sides
// are the ROWS of a row-major x (m, d), so the 2b+1 neighbours of an entry
// lie along the contiguous axis and the (..., d) arrays of the spatial
// estimators go in and out without a transpose.  The diagonals come
// band-major, coef (2b+1, d) with coef[b+o][r] = A[r, r+o], so the threads
// of a warp read neighbouring coefficients.
//
// Bound on the H100: bytes.  Each output costs 2b+1 FMAs against one read
// of x and one write of y (at d = 131,072, m = 2,047, b = 4: 2.15 GB moved,
// 4.8 GFLOP).  Rows that meet the matrix only within [0, d) mask the rest
// against the true d: off-matrix coefficients (whatever they hold) meet a 0
// or are skipped, so neither padding nor a limit b <= tile is needed.
//
// Two paths, chosen per launch by the wrapper:
//  * banded_matvec_vec4<HQ> (d % 4 == 0, 16-byte aligned rows, halo
//    h = min(b, d - 1) <= 4 HQ): a thread owns 4 adjacent columns for a slab
//    of rows.  It keeps its 4 (2h+1) coefficients in registers and per row
//    reads 2 HQ + 1 float4 of x (its own 4 columns and HQ float4 of halo on
//    each side, through L1, where the neighbouring threads' reads land) and
//    writes one float4 of y.  A float4 lies wholly on or off the matrix.
//  * banded_matvec_kernel (any d, b, alignment): one CTA takes 256
//    consecutive columns (one per thread) and a slab of rows; per pass it
//    stages up to BM_PASS rows of x with the halo through shared memory,
//    zero off the matrix, and applies each coefficient to every staged row.
// Every output is written once: no reduction, no atomics.
#include <cuda_runtime.h>

#define BM_COLS 256  // generic path: columns per CTA, one per thread
#define BM_PASS 8    // generic path: most rows staged per pass
#define BM_VCOLS 1024  // vector path: columns per CTA, 4 per thread

struct BandParams {
  const float* coef;  // (2b+1, d) band-major diagonals
  const float* x;     // (m, d)
  float* y;           // (m, d)
  int m, d, b;
  int halo;           // min(b, d - 1): offsets beyond it never meet the matrix
  int vec;            // 0: generic path; HQ in {1, 2}: vector path
  int rows_per_cta, rows_per_pass;
  int col_tiles, row_slabs;
  int smem_bytes;     // generic path: rows_per_pass * (BM_COLS + 2 * halo) floats
};

template <int HQ>
static __global__ void __launch_bounds__(256) banded_matvec_vec4(BandParams p) {
  constexpr int H = 4 * HQ;  // largest halo of this instance
  const float* __restrict__ x = p.x;
  float* __restrict__ y = p.y;
  const int c = (blockIdx.x % p.col_tiles) * BM_VCOLS + threadIdx.x * 4;
  const int n0 = (blockIdx.x / p.col_tiles) * p.rows_per_cta;
  const int n1 = min(n0 + p.rows_per_cta, p.m);
  if (c >= p.d) return;
  const int h = p.halo;

  float a[2 * H + 1][4];
#pragma unroll
  for (int o = -H; o <= H; ++o) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (o >= -h && o <= h)
      v = __ldg(reinterpret_cast<const float4*>(p.coef + (size_t)(p.b + o) * p.d + c));
    a[o + H][0] = v.x;
    a[o + H][1] = v.y;
    a[o + H][2] = v.z;
    a[o + H][3] = v.w;
  }

  for (int n = n0; n < n1; ++n) {
    const float* xr = x + (size_t)n * p.d;
    float w[4 + 2 * H];  // columns c - H .. c + 3 + H
#pragma unroll
    for (int q = -HQ; q <= HQ; ++q) {
      const int col = c + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col >= 0 && col < p.d) v = __ldg(reinterpret_cast<const float4*>(xr + col));
      w[H + 4 * q] = v.x;
      w[H + 4 * q + 1] = v.y;
      w[H + 4 * q + 2] = v.z;
      w[H + 4 * q + 3] = v.w;
    }
    float out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int o = -H; o <= H; ++o)
        if (o >= -h && o <= h) acc = fmaf(a[o + H][k], w[H + k + o], acc);
      out[k] = acc;
    }
    *reinterpret_cast<float4*>(y + (size_t)n * p.d + c) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

static __global__ void __launch_bounds__(BM_COLS) banded_matvec_kernel(BandParams p) {
  extern __shared__ float xs[];  // [rows_per_pass][BM_COLS + 2 * halo]
  const int h = p.halo;
  const int width = BM_COLS + 2 * h;
  const int c0 = (blockIdx.x % p.col_tiles) * BM_COLS;
  const int n0 = (blockIdx.x / p.col_tiles) * p.rows_per_cta;
  const int n1 = min(n0 + p.rows_per_cta, p.m);
  const int r = c0 + threadIdx.x;

  for (int n = n0; n < n1; n += p.rows_per_pass) {
    const int rows = min(p.rows_per_pass, n1 - n);
    for (int k = 0; k < rows; ++k) {
      const float* xrow = p.x + (size_t)(n + k) * p.d;
      for (int j = threadIdx.x; j < width; j += BM_COLS) {
        const int col = c0 - h + j;
        xs[k * width + j] = (col >= 0 && col < p.d) ? __ldg(xrow + col) : 0.f;
      }
    }
    __syncthreads();
    if (r < p.d) {
      float acc[BM_PASS];
#pragma unroll
      for (int k = 0; k < BM_PASS; ++k) acc[k] = 0.f;
      for (int o = -h; o <= h; ++o) {
        const float a = __ldg(p.coef + (size_t)(p.b + o) * p.d + r);
        const float* xo = xs + threadIdx.x + h + o;
#pragma unroll
        for (int k = 0; k < BM_PASS; ++k)
          if (k < rows) acc[k] = fmaf(a, xo[k * width], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < BM_PASS; ++k)
        if (k < rows) p.y[(size_t)(n + k) * p.d + r] = acc[k];
    }
    __syncthreads();
  }
}

extern "C" int rt_banded_matvec(const BandParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ctas = p->col_tiles * p->row_slabs;
  if (p->vec == 1 || p->vec == 2) {
    if (p->vec == 1) {
      banded_matvec_vec4<1><<<ctas, 256, 0, st>>>(*p);
    } else {
      banded_matvec_vec4<2><<<ctas, 256, 0, st>>>(*p);
    }
    return (int)cudaGetLastError();
  }
  if (p->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  banded_matvec_kernel<<<ctas, BM_COLS, p->smem_bytes, st>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int rt_band_params_size() { return (int)sizeof(BandParams); }
