// Banded matrix times vectors, and the gradient of its diagonals, for
// Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/banded_matvec/kernel.py: banded_matvec_pallas
// (body _kernel): y = A x for a b-banded A stored as its 2b+1 diagonals,
// y[r] = sum_{o=-b..b} A[r, r+o] x[r+o], x read as 0 off the matrix; and
// the other half of its VJP, src/repro/kernels/banded_matvec/ops.py:69
// (_banded_matvec_bwd), which the reference computes as one jnp einsum:
// d diags[r, b+o] = sum_n g[n, r] x[n, r+o], 0 where r+o falls off the
// matrix.
//
// Contract (the port's own, not the TPU kernel's): the m right-hand sides
// are the ROWS of a row-major x (m, d), so the 2b+1 neighbours of an entry
// lie along the contiguous axis and the (..., d) arrays of the spatial
// estimators go in and out without a transpose.  The diagonals are read
// where they lie, in the reference's row-major (d, 2b+1) storage,
// diags[r (2b+1) + b+o] = A[r, r+o].  With `transposed` the product kernel
// computes A^T x, y[r] = sum_o diags[r+o, b-o] x[r+o]: the product of
// band_transpose(diags) without building it, the same products summed in
// the same order (o = -b..b), so bitwise equal to it.
//
// Bound on the H100: bytes.  The product costs 2b+1 FMAs an output against
// one read of x and one write of y (d = 131,072, m = 2,047, b = 4: 2.15 GB,
// 4.8 GFLOP); at one right-hand side the diagonals (4.7 MB) are most of the
// bytes.  The gradient reads g and x once (2.15 GB) and writes d (2b+1)
// floats.  Rows that meet the matrix only within [0, d) mask the rest
// against the true d: off-matrix coefficients (whatever they hold) meet a 0
// or are skipped, so neither padding nor a limit b <= tile is needed.
//
// Paths, chosen per launch by the wrapper:
//  * banded_matvec_vec4<HQ, T> (d % 4 == 0, 16-byte aligned rows, b <= 8;
//    HQ float4 of halo a side, 4 HQ >= min(b, d - 1)): a thread owns 4
//    adjacent columns for a slab of rows.  The CTA first stages the
//    diagonals of its columns (with 4 HQ halo rows a side for A^T, zero off
//    the matrix) into shared memory with coalesced float4 loads, all of a
//    thread's in flight at once; each thread takes its 4 (2h+1)
//    coefficients into registers, then reads BM_ROWS rows at a time, per
//    row 2 HQ + 1 float4 of x (its own 4 columns and HQ float4 of halo on
//    each side, through L1, where the neighbouring threads' reads land), and
//    writes one float4 of y.  A float4 lies wholly on or off the matrix.
//  * banded_matvec_row<B> (the same shapes, y = A x, slabs of one row: one
//    right-hand side): b a template parameter, each thread reads its 4
//    (2b+1) coefficients straight from device memory as whole float4, in
//    flight with its row of x (staging them cost more than it saved there).
//  * banded_matvec_kernel (any d, b, alignment): one CTA takes 256
//    consecutive columns (one per thread) and a slab of rows; per pass it
//    stages up to BM_PASS rows of x with the halo through shared memory,
//    zero off the matrix, and applies each coefficient to every staged row.
//  * band_gradient_vec4<HQ> (the same shapes): one pass over g and x with
//    the product's access pattern, g in y's place: a thread owns 4 columns
//    and keeps 4 (2h+1) sums over its slab of rows, reading BG_ROWS rows at
//    a time, per row one float4 of g and the float4 window of x.
//    The row slabs of one column tile form a thread-block cluster; each CTA
//    leaves its partial sums in shared memory, and after a cluster barrier
//    CTA q sums the q-th share of the tile's outputs over the slabs in rank
//    order through distributed shared memory.  No atomics, no global
//    scratch, one launch: two launches are bitwise equal.
//  * band_gradient_kernel (any d, b, alignment): a thread per column and
//    chunk of BG_OFFSETS offsets sums over every row itself.
// Every output is written once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define BM_COLS 256     // generic paths: columns per CTA, one per thread
#define BM_PASS 8       // generic product: most rows staged per pass
#define BM_ROWS 2       // vector product: rows of x a thread loads before it computes
#define BM_STAGE 9      // vector product: float4 of the diagonals a thread loads at once
#define BG_ROWS 2       // vector gradient: rows of g and x a thread loads before it computes
#define BG_MAX_SLABS 8  // vector gradient: most CTAs in a cluster (the portable limit)
#define BG_OFFSETS 17   // generic gradient: offsets per thread

struct BandParams {
  const float* diags;  // (d, 2b+1) row-major diagonals
  const float* x;      // (m, d)
  float* y;            // (m, d)
  int m, d, b;
  int halo;            // min(b, d - 1): offsets beyond it never meet the matrix
  int vec;             // 0: generic path; HQ in {1, 2}: vector path
  int transposed;      // 1: y = A^T x
  int threads;         // threads per CTA (vector path: 4 columns each)
  int rows_per_cta, rows_per_pass;
  int col_tiles, row_slabs;
  int smem_bytes;      // vector: the staged diagonals (0 for one row); generic: staged rows of x
};

struct BandGradParams {
  const float* g;      // (m, d) cotangent of y
  const float* x;      // (m, d)
  float* out;          // (d, 2b+1) d loss / d diags
  int m, d, b;
  int halo;            // min(b, d - 1)
  int vec;             // 0: generic path; HQ in {1, 2}: vector path
  int threads;         // threads per CTA (vector path: 4 columns each)
  int rows_per_cta;    // vector path: rows of a slab
  int col_tiles;
  int row_slabs;       // vector path: slabs, the CTAs of a cluster
  int offset_chunks;   // generic path: chunks of BG_OFFSETS offsets
  int smem_bytes;      // vector path: one CTA's partial sums, 4 threads (2b+1) floats
};

// x[c - 4 HQ .. c + 3 + 4 HQ] of one row into w, 0 off the matrix.
template <int HQ>
__device__ __forceinline__ void load_window(const float* __restrict__ row, int c, int d,
                                            float (&w)[4 + 8 * HQ]) {
  constexpr int H = 4 * HQ;
#pragma unroll
  for (int q = -HQ; q <= HQ; ++q) {
    const int col = c + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col >= 0 && col < d) v = __ldg(reinterpret_cast<const float4*>(row + col));
    w[H + 4 * q] = v.x;
    w[H + 4 * q + 1] = v.y;
    w[H + 4 * q + 2] = v.z;
    w[H + 4 * q + 3] = v.w;
  }
}

template <int HQ, bool T>
static __global__ void __launch_bounds__(256) banded_matvec_vec4(BandParams p) {
  constexpr int H = 4 * HQ;  // largest halo of this instance
  extern __shared__ __align__(16) float cs[];  // the staged diagonals, row-major
  const int W = 2 * p.b + 1, h = p.halo;
  const int cols = 4 * blockDim.x;
  const int c0 = (blockIdx.x % p.col_tiles) * cols;
  const int n0 = (blockIdx.x / p.col_tiles) * p.rows_per_cta;
  const int n1 = min(n0 + p.rows_per_cta, p.m);
  const int t4 = 4 * threadIdx.x, c = c0 + t4;
  const float* __restrict__ x = p.x;
  float* __restrict__ y = p.y;
  // Stage rows r0 .. r0 + rows - 1 of diags: the CTA's columns, and for A^T
  // H more on each side.  r0 and d are multiples of 4, so the run starts on
  // 16 bytes and each float4 lies wholly on or off the matrix (0 off it).
  // Each thread issues BM_STAGE float4 loads before its first store.
  const int r0 = T ? c0 - H : c0;
  const int count4 = (T ? cols + 2 * H : min(cols, p.d - c0)) * W / 4;
  const long long first4 = (long long)r0 * W / 4, end4 = (long long)p.d * W / 4;
  const float4* src = reinterpret_cast<const float4*>(p.diags);
  float4* dst = reinterpret_cast<float4*>(cs);
  for (int i0 = threadIdx.x; i0 < count4; i0 += BM_STAGE * blockDim.x) {
    float4 v[BM_STAGE];
#pragma unroll
    for (int j = 0; j < BM_STAGE; ++j) {
      const long long f = first4 + i0 + j * blockDim.x;
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + j * (int)blockDim.x < count4 && f >= 0 && f < end4) v[j] = __ldg(src + f);
    }
#pragma unroll
    for (int j = 0; j < BM_STAGE; ++j)
      if (i0 + j * (int)blockDim.x < count4) dst[i0 + j * blockDim.x] = v[j];
  }
  __syncthreads();
  if (c >= p.d) return;

  float a[2 * H + 1][4];
#pragma unroll
  for (int o = -H; o <= H; ++o)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[o + H][k] = (o >= -h && o <= h)
                        ? cs[T ? (t4 + k + o + H) * W + p.b - o : (t4 + k) * W + p.b + o]
                        : 0.f;

  for (int n = n0; n < n1; n += BM_ROWS) {
    float w[BM_ROWS][4 + 2 * H];  // columns c - H .. c + 3 + H of rows n ..
#pragma unroll
    for (int u = 0; u < BM_ROWS; ++u)
      load_window<HQ>(x + (size_t)min(n + u, n1 - 1) * p.d, c, p.d, w[u]);
#pragma unroll
    for (int u = 0; u < BM_ROWS; ++u) {
      if (n + u >= n1) break;
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int o = -H; o <= H; ++o)
          if (o >= -h && o <= h) acc = fmaf(a[o + H][k], w[u][H + k + o], acc);
        out[k] = acc;
      }
      *reinterpret_cast<float4*>(y + (size_t)(n + u) * p.d + c) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

// One row of y = A x (a slab of one right-hand side), b a template
// parameter: each thread reads its 4 (2b+1) coefficients where they lie, as
// 2b+1 float4 from a 16-byte boundary, in flight with its row of x; no
// shared memory and no barrier between the loads and the products.
template <int B>
static __global__ void __launch_bounds__(256) banded_matvec_row(BandParams p) {
  constexpr int W = 2 * B + 1, HQ = B <= 4 ? 1 : 2, H = 4 * HQ;
  const int h = p.halo;
  const int c = (blockIdx.x % p.col_tiles) * 4 * blockDim.x + 4 * threadIdx.x;
  const int n = blockIdx.x / p.col_tiles;
  if (c >= p.d) return;
  float w[4 + 2 * H];  // columns c - H .. c + 3 + H of row n
  load_window<HQ>(p.x + (size_t)n * p.d, c, p.d, w);
  const float4* mine = reinterpret_cast<const float4*>(p.diags) + (size_t)c * W / 4;
  float run[4 * W];  // rows c .. c + 3 of diags
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float4 q = __ldg(mine + j);
    run[4 * j] = q.x;
    run[4 * j + 1] = q.y;
    run[4 * j + 2] = q.z;
    run[4 * j + 3] = q.w;
  }
  float out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int o = -B; o <= B; ++o)
      if (o >= -h && o <= h) acc = fmaf(run[k * W + B + o], w[H + k + o], acc);
    out[k] = acc;
  }
  *reinterpret_cast<float4*>(p.y + (size_t)n * p.d + c) =
      make_float4(out[0], out[1], out[2], out[3]);
}

static __global__ void __launch_bounds__(BM_COLS) banded_matvec_kernel(BandParams p) {
  extern __shared__ float xs[];  // [rows_per_pass][BM_COLS + 2 * halo]
  const int h = p.halo, W = 2 * p.b + 1;
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
        float a;
        if (p.transposed) {  // diags[r+o, b-o], 0 off the matrix
          const int rr = r + o;
          a = (rr >= 0 && rr < p.d) ? __ldg(p.diags + (size_t)rr * W + p.b - o) : 0.f;
        } else {
          a = __ldg(p.diags + (size_t)r * W + p.b + o);
        }
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

template <int HQ>
static __global__ void __launch_bounds__(256) band_gradient_vec4(BandGradParams p) {
  constexpr int H = 4 * HQ;
  extern __shared__ __align__(16) float part[];  // [4 blockDim.x][2b+1] this slab's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int slabs = p.row_slabs;  // the cluster's size
  const int rank = (int)cluster.block_rank();
  const int W = 2 * p.b + 1, h = p.halo;
  const int cols = 4 * blockDim.x;
  const int c0 = (blockIdx.x / slabs) * cols;
  const int t4 = 4 * threadIdx.x, c = c0 + t4;
  const int n0 = rank * p.rows_per_cta;
  const int n1 = min(n0 + p.rows_per_cta, p.m);

  float acc[4][2 * H + 1];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int o = 0; o <= 2 * H; ++o) acc[k][o] = 0.f;
  if (c < p.d) {
    const float* __restrict__ g = p.g;
    const float* __restrict__ x = p.x;
    for (int n = n0; n < n1; n += BG_ROWS) {
      float4 gv[BG_ROWS];
      float w[BG_ROWS][4 + 2 * H];  // columns c - H .. c + 3 + H of rows n ..
#pragma unroll
      for (int u = 0; u < BG_ROWS; ++u) {
        const size_t row = (size_t)min(n + u, n1 - 1) * p.d;
        gv[u] = __ldg(reinterpret_cast<const float4*>(g + row + c));
        load_window<HQ>(x + row, c, p.d, w[u]);
      }
#pragma unroll
      for (int u = 0; u < BG_ROWS; ++u) {
        if (n + u >= n1) break;
        const float gk[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int o = -H; o <= H; ++o)
            if (o >= -h && o <= h) acc[k][o + H] = fmaf(gk[k], w[u][H + k + o], acc[k][o + H]);
      }
    }
    // this slab's sums, laid out as the tile's rows of the output
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* dst = part + (t4 + k) * W;
      for (int s = 0; s < W; ++s) dst[s] = 0.f;
#pragma unroll
      for (int o = -H; o <= H; ++o)
        if (o >= -h && o <= h) dst[p.b + o] = acc[k][o + H];
    }
  }
  cluster.sync();
  // CTA `rank` sums its share of the tile's outputs over the slabs, in rank order
  const int total = min(cols, p.d - c0) * W;
  const int share = (total + slabs - 1) / slabs;
  const int e0 = rank * share, e1 = min(e0 + share, total);
  const float* src[BG_MAX_SLABS];
#pragma unroll
  for (int q = 0; q < BG_MAX_SLABS; ++q)
    src[q] = q < slabs ? cluster.map_shared_rank(part, q) : part;
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < BG_MAX_SLABS; ++q)
      if (q < slabs) v += src[q][e];
    p.out[(size_t)c0 * W + e] = v;
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

static __global__ void __launch_bounds__(BM_COLS) band_gradient_kernel(BandGradParams p) {
  const int W = 2 * p.b + 1;
  const int r = blockIdx.x * BM_COLS + threadIdx.x;
  const int o0 = -p.b + (int)blockIdx.y * BG_OFFSETS;  // this thread's offsets o0 ..
  if (r >= p.d) return;
  float acc[BG_OFFSETS];
#pragma unroll
  for (int i = 0; i < BG_OFFSETS; ++i) acc[i] = 0.f;
  for (int n = 0; n < p.m; ++n) {
    const float* xr = p.x + (size_t)n * p.d;
    const float gv = __ldg(p.g + (size_t)n * p.d + r);
#pragma unroll
    for (int i = 0; i < BG_OFFSETS; ++i) {
      const int col = r + o0 + i;
      if (o0 + i <= p.b && col >= 0 && col < p.d) acc[i] = fmaf(gv, __ldg(xr + col), acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < BG_OFFSETS; ++i)
    if (o0 + i <= p.b) p.out[(size_t)r * W + p.b + o0 + i] = acc[i];
}

static int allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" int rt_banded_matvec(const BandParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ctas = p->col_tiles * p->row_slabs;
  if (p->vec == 1 || p->vec == 2) {
    static void (*const rows[2][2])(BandParams) = {
        {banded_matvec_vec4<1, false>, banded_matvec_vec4<1, true>},
        {banded_matvec_vec4<2, false>, banded_matvec_vec4<2, true>}};
    static void (*const one_row[9])(BandParams) = {
        banded_matvec_row<0>, banded_matvec_row<1>, banded_matvec_row<2>,
        banded_matvec_row<3>, banded_matvec_row<4>, banded_matvec_row<5>,
        banded_matvec_row<6>, banded_matvec_row<7>, banded_matvec_row<8>};
    void (*kernel)(BandParams) = (p->rows_per_cta == 1 && !p->transposed)
                                     ? one_row[p->b]
                                     : rows[p->vec - 1][p->transposed];
    const int err = allow_smem((const void*)kernel, p->smem_bytes);
    if (err) return err;
    kernel<<<ctas, p->threads, p->smem_bytes, st>>>(*p);
    return (int)cudaGetLastError();
  }
  const int err = allow_smem((const void*)banded_matvec_kernel, p->smem_bytes);
  if (err) return err;
  banded_matvec_kernel<<<ctas, BM_COLS, p->smem_bytes, st>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int rt_band_gradient(const BandGradParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p->vec == 1 || p->vec == 2) {
    void (*kernel)(BandGradParams) = p->vec == 1 ? band_gradient_vec4<1> : band_gradient_vec4<2>;
    const int err = allow_smem((const void*)kernel, p->smem_bytes);
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p->col_tiles * p->row_slabs);
    cfg.blockDim = dim3(p->threads);
    cfg.dynamicSmemBytes = p->smem_bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p->row_slabs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, *p);
    if (launched != cudaSuccess) return (int)launched;
    return (int)cudaGetLastError();
  }
  band_gradient_kernel<<<dim3(p->col_tiles, p->offset_chunks), BM_COLS, 0, st>>>(*p);
  return (int)cudaGetLastError();
}

// The launch alone: an empty kernel on the grid, block and dynamic shared
// memory of a product launch, to show how much of a short launch's time is
// the launch itself (timed beside the product, never on the path).
static __global__ void band_empty_kernel() {}

extern "C" int rt_band_empty(const BandParams* p, void* stream) {
  const int err = allow_smem((const void*)band_empty_kernel, p->smem_bytes);
  if (err) return err;
  band_empty_kernel<<<p->col_tiles * p->row_slabs, p->vec ? p->threads : BM_COLS, p->smem_bytes,
                      (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int rt_band_params_size() { return (int)sizeof(BandParams); }
extern "C" int rt_band_grad_params_size() { return (int)sizeof(BandGradParams); }

// The constants _build.BAND_CONSTANTS mirrors, in its order (checked at load).
extern "C" void rt_band_constants(int* out) {
  const int v[] = {BM_COLS, BM_PASS, BG_MAX_SLABS, BG_OFFSETS};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
}
