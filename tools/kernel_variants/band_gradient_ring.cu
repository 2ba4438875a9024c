// A design variant of kernel 7b, the gradient of kernel 7's diagonals (not
// part of the library): band_gradient_vec4 of src/repro_torch/kernels/
// banded_matvec/csrc/banded_matvec.cu with its rows of g and x staged
// through a ring of shared-memory stages instead of read by each thread
// with float4 loads.  One producer warp issues 1-D bulk copies
// (cp.async.bulk, completing on a full mbarrier per stage) of RING_ROWS rows
// of g and of x with its halo; the compute warps read their float4 from
// shared memory and release the stage on its empty mbarrier.  The halo
// slots off the matrix are zeroed once (no copy writes them).  Slabs,
// cluster and the rank-order reduction through distributed shared memory
// are the shipped kernel's.  Same BandGradParams (its size is exported for
// variants_bench.py to check) and entry point, vector path only (d % 4 ==
// 0, aligned, b <= 8).  It lost to the float4 loads in every run on the
// H100 (PERF.md); variants_bench.py banded times it beside them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define RING_STAGES 4
#define RING_ROWS 2
#define BG_MAX_SLABS 8

struct BandGradParams {
  const float* g;
  const float* x;
  float* out;
  int m, d, b;
  int halo;
  int vec;
  int threads;
  int rows_per_cta;
  int col_tiles;
  int row_slabs;
  int offset_chunks;
  int smem_bytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int HQ>
static __global__ void __launch_bounds__(256 + 32) band_gradient_ring(BandGradParams p) {
  constexpr int H = 4 * HQ;
  extern __shared__ __align__(16) float smem[];
  const int threads = p.threads, cols = 4 * threads, cwarps = threads / 32;
  const int W = 2 * p.b + 1, h = p.halo, slabs = p.row_slabs;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = (blockIdx.x / slabs) * cols;
  const int n0 = rank * p.rows_per_cta, n1 = min(n0 + p.rows_per_cta, p.m);
  const int xw = cols + 2 * H, gfl = RING_ROWS * cols, stage_fl = gfl + RING_ROWS * xw;
  float* part = smem;              // [cols][W]
  float* ring = part + cols * W;   // per stage: g [RING_ROWS][cols], x [RING_ROWS][xw]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING_STAGES * stage_fl);
  uint64_t* empty = full + RING_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < RING_STAGES * RING_ROWS * xw; i += blockDim.x) {
    const int col = c0 - H + i % xw;
    if (col < 0 || col >= p.d)
      ring[(i / (RING_ROWS * xw)) * stage_fl + gfl + i % (RING_ROWS * xw)] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int fills = max(n1 - n0, 0) / RING_ROWS + (max(n1 - n0, 0) % RING_ROWS != 0);
  const int gcols = min(cols, p.d - c0);
  const int xlo = max(c0 - H, 0), xhi = min(c0 + cols + H, p.d);

  if (warp == cwarps) {  // the producer warp
    if (lane == 0) {
      for (int it = 0; it < fills; ++it) {
        const int s = it % RING_STAGES;
        mbar_wait(&empty[s], ((it / RING_STAGES) & 1) ^ 1);
        const int r0 = n0 + it * RING_ROWS, rows = min(RING_ROWS, n1 - r0);
        mbar_expect_tx(&full[s], rows * (gcols + xhi - xlo) * 4);
        float* gs = ring + s * stage_fl;
        float* xs = gs + gfl;
        for (int r = 0; r < rows; ++r) {
          const size_t row = (size_t)(r0 + r) * p.d;
          bulk_load(gs + r * cols, p.g + row + c0, gcols * 4, &full[s]);
          bulk_load(xs + r * xw + (xlo - (c0 - H)), p.x + row + xlo, (xhi - xlo) * 4, &full[s]);
        }
      }
    }
    __syncwarp();
  } else {
    const int t4 = 4 * threadIdx.x, c = c0 + t4;
    float acc[4][2 * H + 1];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int o = 0; o <= 2 * H; ++o) acc[k][o] = 0.f;
    for (int it = 0; it < fills; ++it) {
      const int s = it % RING_STAGES;
      mbar_wait(&full[s], (it / RING_STAGES) & 1);
      const int rows = min(RING_ROWS, n1 - (n0 + it * RING_ROWS));
      const float* gs = ring + s * stage_fl;
      const float* xs = gs + gfl;
      if (c < p.d) {
#pragma unroll
        for (int r = 0; r < RING_ROWS; ++r) {
          if (r >= rows) break;
          const float4 gv = *reinterpret_cast<const float4*>(gs + r * cols + t4);
          const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
          float w[4 + 2 * H];
#pragma unroll
          for (int q = 0; q <= 2 * HQ; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(xs + r * xw + t4 + 4 * q);
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int o = -H; o <= H; ++o)
              if (o >= -h && o <= h) acc[k][o + H] = fmaf(gk[k], w[H + k + o], acc[k][o + H]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (c < p.d) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float* dst = part + (t4 + k) * W;
        for (int sl = 0; sl < W; ++sl) dst[sl] = 0.f;
#pragma unroll
        for (int o = -H; o <= H; ++o)
          if (o >= -h && o <= h) dst[p.b + o] = acc[k][o + H];
      }
    }
  }
  cluster.sync();
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
  cluster.sync();
}

extern "C" int rt_band_gradient(const BandGradParams* p, void* stream) {
  if (p->vec != 1 && p->vec != 2) return (int)cudaErrorInvalidValue;
  void (*kernel)(BandGradParams) = p->vec == 1 ? band_gradient_ring<1> : band_gradient_ring<2>;
  const int H = 4 * p->vec, cols = 4 * p->threads;
  const int smem = 4 * (cols * (2 * p->b + 1) + RING_STAGES * RING_ROWS * (2 * cols + 2 * H)) +
                   2 * RING_STAGES * 8;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->col_tiles * p->row_slabs);
  cfg.blockDim = dim3(p->threads + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->row_slabs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, *p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int rt_band_grad_params_size() { return (int)sizeof(BandGradParams); }
