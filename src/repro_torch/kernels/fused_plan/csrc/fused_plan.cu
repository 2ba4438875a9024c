// The fused-plan megakernel for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/fused_plan/kernel.py:
// fused_plan_megakernel_pallas (body _megakernel): one launch serves every
// member family of a fused statistics plan from the same chunk -- masked lag
// sums (H+1, d, d), K moment windows (K, 2, d), and per Welch member the sum
// of detrended, tapered |DFT|^2 over its stride-aligned candidate starts.
//
// Bound on the H100: operations.  At the full-width chunk (65,536 rows,
// d = 64, H = 16, Welch 256/128) the lag part is 9.1 GFLOP and the Welch
// part 4.3 GFLOP of fp32 FMAs against a 16.8 MB chunk.  The TPU kernel walks
// the chunk once on a sequential grid; here the grid holds CTAs of three
// roles side by side (lag tiles, moment slabs, Welch candidate groups; see
// stats_tiles.cuh), so the families overlap on the SMs and every role reads
// the chunk through L2.  Each CTA writes a partial; one reduce launch sums
// them in a fixed order, so repeated runs are bit-identical.
#include "stats_tiles.cuh"

static __global__ void __launch_bounds__(RT_THREADS) fused_plan_kernel(PlanParams p) {
  __shared__ __align__(16) float smem[RT_SMEM_FLOATS];
  int b = blockIdx.x;
  if (b < p.lag_ctas) {
    lag_role(p, b, smem);
    return;
  }
  b -= p.lag_ctas;
  if (b < p.mom_ctas) {
    moment_role(p, b, smem);
    return;
  }
  b -= p.mom_ctas;
  for (int j = 0; j < p.n_welch; ++j) {
    if (b < p.welch[j].ctas) {
      welch_role(p, p.welch[j], b, smem);
      return;
    }
    b -= p.welch[j].ctas;
  }
}

extern "C" int rt_fused_plan(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int ctas = p->lag_ctas + p->mom_ctas;
  for (int j = 0; j < p->n_welch; ++j) ctas += p->welch[j].ctas;
  fused_plan_kernel<<<ctas, RT_THREADS, 0, st>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(*p, true, true, st);
}

// Struct sizes, checked against the ctypes mirrors when the library loads.
extern "C" int rt_plan_params_size() { return (int)sizeof(PlanParams); }
extern "C" int rt_welch_member_size() { return (int)sizeof(WelchMember); }
