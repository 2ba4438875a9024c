// Lagged sums and fused lag + window moments for Hopper (sm_90a), fp32.
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
// shared memory, so the work is split over (lag, 64 x 64 channel tile, slab
// of starts); each CTA stages 32-row tiles through shared memory and keeps a
// 4 x 4 register tile per thread.  Per-slab partials are summed in a fixed
// order by reduce_parts_kernel (no float atomics: runs are bit-identical).
// The moment sums cost O(K) per row through exact window counts (see
// stats_tiles.cuh) and are bound by the one read of the rows.
#include "stats_tiles.cuh"

static __global__ void __launch_bounds__(RT_THREADS) cross_lag_kernel(PlanParams p) {
  __shared__ __align__(16) float smem[RT_SMEM_FLOATS];
  lag_role(p, blockIdx.x, smem);
}

static __global__ void __launch_bounds__(RT_THREADS) fused_lag_moments_kernel(PlanParams p) {
  __shared__ __align__(16) float smem[RT_SMEM_FLOATS];
  if ((int)blockIdx.x < p.lag_ctas) {
    lag_role(p, blockIdx.x, smem);
  } else {
    moment_role(p, blockIdx.x - p.lag_ctas, smem);
  }
}

extern "C" int rt_cross_lag_sums(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cross_lag_kernel<<<p->lag_ctas, RT_THREADS, 0, st>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(*p, true, false, st);
}

extern "C" int rt_fused_lag_moments(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  fused_lag_moments_kernel<<<p->lag_ctas + p->mom_ctas, RT_THREADS, 0, st>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(*p, true, true, st);
}
