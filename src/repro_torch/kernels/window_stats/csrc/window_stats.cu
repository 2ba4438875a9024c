// Lagged sums, fused lag + window moments and rolling window moments for
// Hopper (sm_90a), fp32 in, fp32 or fp64 accumulation.
//
// cross_lag_kernel replaces src/repro/kernels/window_stats/kernel.py:
// cross_window_stats_pallas (body _lag_kernel): S(h) = sum_k a_k b_{k+h}^T,
// h = 0..H.  fused_lag_moments_kernel replaces kernel.py:
// fused_lag_moments_pallas (body _fused_kernel): the masked lag sums plus the
// masked K-window moment sums, from one launch.
//
// Bound on the H100: operations.  At the full-width chunk (65,536 starts,
// d = 64, H = 16) the lag sums are (H+1) * n * d^2 * 2 = 9.1 GFLOP of fp32
// FMAs against 17 MB of input, far above the card's fp32 ridge point.  The
// (H+1, d, d) accumulator (278 KB at that width) does not fit in one CTA's
// shared memory, so the work is split over (64 x 64 channel tile, group of
// up to three consecutive lags, slab of starts).  A CTA stages each step's
// rows once for its whole lag group through a cp.async ring and keeps a
// 4 x 4 register tile per lag, with a sliding window of the shifted rows,
// so FMAs, not shared-memory loads, set its pace (lag_role in
// stats_tiles.cuh).  Per-slab partials are summed in a fixed order by
// reduce_parts_kernel (no float atomics: runs are bit-identical).
// The moment sums cost O(K) per row through exact window counts (see
// stats_tiles.cuh) and are bound by the one read of the rows.
//
// window_moments_kernel replaces kernel.py: window_moments_pallas (body
// _moments_kernel): for every start s of a full window, [sum_{j<w} x_{s+j},
// sum_{j<w} x_{s+j}^2], written directly as (n - w + 1, 2, d).
//
// Bound on the H100: bytes.  At n = 2^22 rows, d = 64 the kernel reads
// 1.07 GB and writes 2.15 GB; the reference's O(w) sum per start would be
// about 1.1 TFLOP at w = 1024.  Here each thread owns one channel and a
// chain of consecutive starts: it sums its first window once, then slides,
// adding the row that enters and subtracting the row that leaves, so a
// start costs O(1) whatever w is.  The running sums are float64 (exact
// products of float32 squares, about 1e-16 rounding per step) and restart
// with every chain, so no partial sum spans more than one chain -- unlike a
// global float32 cumulative sum, which loses digits over millions of rows.
// Each output is rounded once to float32.  Consecutive threads take
// consecutive channels, so loads and stores are coalesced; each thread
// keeps WM_UNROLL loads of each edge in flight.
#include "stats_tiles.cuh"

#define WM_UNROLL 8

struct MomentParams {
  const float* x;  // (n, d) series
  float* out;      // (n_out, 2, d), n_out = n - w + 1
  int n, d, w, n_out;
  int chain;       // starts per thread
  int ctas;        // ceil(ceil(n_out / chain) * d / RT_THREADS)
};

static __global__ void __launch_bounds__(RT_THREADS, RT_MIN_CTAS) cross_lag_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  lag_role(p, blockIdx.x, smem);
}

static __global__ void __launch_bounds__(RT_THREADS, RT_MIN_CTAS) fused_lag_moments_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < p.lag_ctas) {
    lag_role(p, blockIdx.x, smem);
  } else {
    moment_role(p, blockIdx.x - p.lag_ctas, smem);
  }
}

extern "C" int rt_cross_lag_sums(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = plan_smem_bytes(*p, true, false, false);
  cudaError_t err = allow_smem(cross_lag_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cross_lag_kernel<<<p->lag_ctas, RT_THREADS, smem, st>>>(*p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(*p, true, false, st);
}

extern "C" int rt_fused_lag_moments(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = plan_smem_bytes(*p, true, true, false);
  cudaError_t err = allow_smem(fused_lag_moments_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_lag_moments_kernel<<<p->lag_ctas + p->mom_ctas, RT_THREADS, smem, st>>>(*p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(*p, true, true, st);
}

static __global__ void __launch_bounds__(RT_THREADS)
window_moments_kernel(MomentParams p) {
  const long long g = (long long)blockIdx.x * RT_THREADS + threadIdx.x;
  const int c = (int)(g % p.d);
  const long long s_begin = (g / p.d) * p.chain;
  if (s_begin >= p.n_out) return;
  const int s0 = (int)s_begin;
  const int s_end = min(s0 + p.chain, p.n_out);
  const float* __restrict__ xc = p.x + c;
  float* __restrict__ out = p.out + c;
  const size_t d = (size_t)p.d;

  double a1 = 0.0, a2 = 0.0;
  for (int t = s0; t < s0 + p.w; t += WM_UNROLL) {  // the chain's first window
    float v[WM_UNROLL];
#pragma unroll
    for (int u = 0; u < WM_UNROLL; ++u)
      v[u] = (t + u < s0 + p.w) ? __ldg(xc + (size_t)(t + u) * d) : 0.f;
#pragma unroll
    for (int u = 0; u < WM_UNROLL; ++u) {
      const double x = v[u];
      a1 += x;
      a2 += x * x;
    }
  }
  out[(size_t)s0 * 2 * d] = (float)a1;
  out[(size_t)s0 * 2 * d + d] = (float)a2;

  for (int s = s0 + 1; s < s_end; s += WM_UNROLL) {  // slide
    float vin[WM_UNROLL], vout[WM_UNROLL];
#pragma unroll
    for (int u = 0; u < WM_UNROLL; ++u) {
      const bool ok = s + u < s_end;
      vin[u] = ok ? __ldg(xc + (size_t)(s + u + p.w - 1) * d) : 0.f;
      vout[u] = ok ? __ldg(xc + (size_t)(s + u - 1) * d) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < WM_UNROLL; ++u) {
      if (s + u < s_end) {
        const double xi = vin[u], xo = vout[u];
        a1 += xi - xo;
        a2 += xi * xi - xo * xo;
        out[(size_t)(s + u) * 2 * d] = (float)a1;
        out[(size_t)(s + u) * 2 * d + d] = (float)a2;
      }
    }
  }
}

extern "C" int rt_window_moments(const MomentParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  window_moments_kernel<<<p->ctas, RT_THREADS, 0, st>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int rt_moment_params_size() { return (int)sizeof(MomentParams); }
