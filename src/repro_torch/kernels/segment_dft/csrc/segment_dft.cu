// Per-segment one-sided DFT power for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/segment_dft/kernel.py: segment_dft_power_pallas
// (body _dft_power_kernel): |rfft((y - mean) * taper)|^2 per segment, as two
// contractions against the taper-folded twiddle matrices (L, F = L/2 + 1).
//
// Bound on the H100: operations.  Each segment costs 2 * L * F * d * 2 fp32
// FLOPs against L * d * 4 bytes read (about 129 FLOP per byte at L = 256),
// so the twiddle contractions dominate.  One CTA computes one segment's
// (32 frequencies x 64 channels) output tile: it takes the per-channel mean
// first (the detrend happens in the kernel), then stages 32-row tiles of the
// centred segment and of both twiddle matrices through shared memory and
// keeps 2 x 4 re/im register tiles per thread.  Each output element is
// written by exactly one CTA, so no reduction pass is needed.
#include "stats_tiles.cuh"

static __global__ void __launch_bounds__(RT_THREADS) segment_power_kernel(PlanParams p) {
  __shared__ __align__(16) float smem[RT_SMEM_FLOATS];
  welch_role(p, p.welch[0], blockIdx.x, smem);
}

extern "C" int rt_segment_power(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  segment_power_kernel<<<p->welch[0].ctas, RT_THREADS, 0, st>>>(*p);
  return (int)cudaGetLastError();
}
