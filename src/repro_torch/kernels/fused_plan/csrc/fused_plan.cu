// The fused-plan megakernel for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/fused_plan/kernel.py:
// fused_plan_megakernel_pallas (body _megakernel): one launch serves every
// member family of a fused statistics plan from the same chunk -- masked lag
// sums (H+1, d, d), K moment windows (K, 2, d), and per Welch member the sum
// of detrended, tapered |DFT|^2 over its stride-aligned candidate starts.
//
// Bound on the H100: operations.  At the full-width chunk (65,536 rows,
// d = 64, H = 16, Welch 256/128) the lag sums are 9.1 GFLOP of fp32 FMAs
// against a 16.8 MB chunk, and set the pace; the Welch power is an FFT
// (about 0.2 GFLOP).  The TPU kernel walks the chunk once on a sequential
// grid; here the grid holds CTAs of three roles side by side (lag groups,
// moment slabs, Welch candidate groups; see stats_tiles.cuh), so the
// families overlap on the SMs and every role reads the chunk through L2.
// A lag CTA stages each slab's rows once for a group of up to three lags,
// through a cp.async ring, and keeps 4 x 4 outputs per lag in registers
// (0.67 byte of shared memory per FMA); at d <= 32, see below.  A Welch member whose segment length
// is a power of two up to RT_FFT_MAX_L takes the shared-memory FFT, any
// other the twiddle contraction.  The roles share one dynamic shared-memory
// size, the most any role of the launch needs (67 KB at the full-width
// chunk, the FFT role's), and a register cap of 128 (two CTAs per SM).
// Each CTA writes a partial; one reduce launch sums them in a fixed order,
// so repeated runs are bit-identical.
//
// Batched (the multi-tenant session's ingest): one launch serves every
// tenant of an arrival batch, as the reference's vmap gives its pallas_call
// a leading grid axis.  The grid is tenant-major (stats_tiles.cuh): CTA b
// serves tenant b / tenant_ctas in the role b % tenant_ctas, with pointers
// offset by 64-bit per-tenant strides, and the reduce launch sums each
// tenant's partials in the same fixed order.  At a session's widths (d =
// 16, a 256-row chunk) each tenant's lag sums run on one slab.  The 64 x 64
// lag tile would be 15/16 padding there, so the lag role takes a tile sized
// by d (small_lag_role, chosen by d at the entry: TW = 16 up to 16 channels,
// 32 up to 32): a tenant costs one lag CTA for H = 16 (writing its sums
// directly, no partial), one moment CTA and its Welch groups.
#include "stats_tiles.cuh"

template <bool BATCHED, int TW>
static __global__ void __launch_bounds__(RT_THREADS, RT_MIN_CTAS) fused_plan_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tn = BATCHED ? blockIdx.x / p.tenant_ctas : 0;
  int b = blockIdx.x - tn * p.tenant_ctas;
  if (b < p.lag_ctas) {
    lag_tile_role<TW, BATCHED>(p, b, tn, smem);
    return;
  }
  b -= p.lag_ctas;
  if (b < p.mom_ctas) {
    moment_role<BATCHED>(p, b, tn, smem);
    return;
  }
  b -= p.mom_ctas;
  for (int j = 0; j < p.n_welch; ++j) {
    if (b < p.welch[j].ctas) {
      welch_member_role<BATCHED>(p, p.welch[j], b, tn, smem);
      return;
    }
    b -= p.welch[j].ctas;
  }
}

extern "C" int rt_fused_plan(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PlanParams q = *p;
  q.tenant_ctas = q.lag_ctas + q.mom_ctas;
  for (int j = 0; j < q.n_welch; ++j) q.tenant_ctas += q.welch[j].ctas;
  const unsigned grid = plan_grid(q, q.tenant_ctas);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = plan_smem_bytes(q, lag_tile(q.d), true, true, true);
  auto kernel = RT_PICK_KERNEL(fused_plan_kernel, q);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, RT_THREADS, smem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(q, true, true, st);
}

// Struct sizes, checked against the ctypes mirrors when the library loads.
extern "C" int rt_plan_params_size() { return (int)sizeof(PlanParams); }
extern "C" int rt_welch_member_size() { return (int)sizeof(WelchMember); }

// Compile-time constants that _build.py mirrors (STATS_CONSTANTS, in this
// order), checked when the library loads.
extern "C" void rt_stats_constants(int* out) {
  const int c[] = {RT_MAX_WINDOWS, RT_MAX_WELCH, RT_TILE, RT_FT, RT_KC,
                   RT_LAG_GROUP, RT_FFT_MAX_L, RT_FFT_FLOATS, RT_FFT_MAX_CHAN, RT_THREADS,
                   RT_SMALL_TILE, RT_MID_TILE, RT_SMALL_LAGS};
  for (int i = 0; i < (int)(sizeof(c) / sizeof(c[0])); ++i) out[i] = c[i];
}
