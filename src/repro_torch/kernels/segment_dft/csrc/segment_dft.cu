// Per-segment one-sided DFT power and cross-spectra for Hopper (sm_90a), fp32.
//
// segment_power_kernel replaces src/repro/kernels/segment_dft/kernel.py:
// segment_dft_power_pallas (body _dft_power_kernel): |rfft((y - mean) *
// taper)|^2 per segment, (S, F = L/2 + 1, d).
//
// Bound on the H100: bytes.  An FFT costs about 2.5 L log2 L operations per
// segment and channel against 4 L bytes read and 2 L bytes written (at
// 511 segments of (256, 64): 0.2 GFLOP against 50 MB).  The TPU kernel
// contracts against the taper-folded twiddles (4 L F operations, 26 times an
// FFT's at L = 256, and 4.3 times the byte bound even at the fp32 peak), so
// for L a power of two up to RT_FFT_MAX_L this kernel runs welch_fft_role
// (stats_tiles.cuh): one CTA takes four consecutive segments for one channel
// tile (segment_dft/ops.py FFT_GROUP), copies each (L, chan) tile into
// shared memory by cp.async while the previous one is transformed, takes the
// per-channel means in a fixed order, and transforms two channels per
// complex sequence in place (radix-4 Stockham, roots from the host's table),
// so each segment is read once and each output written once, by one CTA.
// Any other L keeps the twiddle contraction (welch_role): one CTA per
// (segment, 32-frequency x 64-channel tile), staging 32-row tiles of the
// centred segment and of both twiddle matrices through shared memory.
//
// segment_csd_kernel replaces kernel.py: segment_csd_pallas (body
// _csd_kernel): per segment, rfft_i * conj(rfft_j) for every channel pair.
//
// Bound on the H100: bytes.  The output is S * F * d * d complex64 values
// (4.32 GB at 1,023 segments, L = 256, d = 64) against 67 MB of segments,
// so the kernel is bound by its writes.  One CTA takes one (segment,
// 32-frequency tile, channel tile i, channel tile j): it runs the same
// detrend and twiddle contraction as the power kernel (seg_dft_tile) for
// tiles i and j (once when i == j), parks both re/im tiles in shared memory
// and streams the (32, 64, 64) outer product out as interleaved complex64
// (re, im float pairs), so torch.view_as_complex reads the result in place.
// Threads walk the tile's valid (f, i, j) entries in output order: for
// d <= 64 a CTA's writes are one contiguous run.  No reduction, no atomics.
#include "stats_tiles.cuh"

static __global__ void __launch_bounds__(RT_THREADS, RT_FFT_MIN_CTAS)
segment_power_fft_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  welch_fft_role<false>(p, p.welch[0], blockIdx.x, 0, smem);
}

static __global__ void __launch_bounds__(RT_THREADS) segment_power_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  welch_role<false>(p, p.welch[0], blockIdx.x, 0, smem);
}

#define CSD_PLANE (RT_FT * RT_TILE)

static __global__ void __launch_bounds__(RT_THREADS) segment_csd_kernel(PlanParams p) {
  // staging of seg_dft_tile, then the re/im planes of tiles i and j
  __shared__ __align__(16) float smem[4 * CSD_PLANE];
  const WelchMember& w = p.welch[0];
  const int tiles2 = p.d_tiles * p.d_tiles;
  const int tile = blockIdx.x % tiles2;
  const int rest = blockIdx.x / tiles2;
  const int ft = rest % w.f_tiles;
  const int s = rest / w.f_tiles;
  const int i0 = (tile / p.d_tiles) * RT_TILE, j0 = (tile % p.d_tiles) * RT_TILE;
  const int f0 = ft * RT_FT;
  const float* seg = p.y + (size_t)s * w.L * p.d;

  float re_i[2][4], im_i[2][4], re_j[2][4], im_j[2][4];
  seg_dft_tile(seg, w.L, p.d, w.cos, w.sin, w.F, f0, i0, p.detrend, re_i, im_i, smem);
  if (j0 != i0) {
    seg_dft_tile(seg, w.L, p.d, w.cos, w.sin, w.F, f0, j0, p.detrend, re_j, im_j, smem);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        re_j[r][c] = re_i[r][c];
        im_j[r][c] = im_i[r][c];
      }
  }

  float* Ri = smem;             // [RT_FT][RT_TILE]
  float* Ii = Ri + CSD_PLANE;
  float* Rj = Ii + CSD_PLANE;
  float* Ij = Rj + CSD_PLANE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = (ty * 2 + r) * RT_TILE + tx * 4 + c;
      Ri[q] = re_i[r][c];
      Ii[q] = im_i[r][c];
      Rj[q] = re_j[r][c];
      Ij[q] = im_j[r][c];
    }
  __syncthreads();

  const int nf = min(RT_FT, w.F - f0);
  const int ni = min(RT_TILE, p.d - i0), nj = min(RT_TILE, p.d - j0);
  float2* out = reinterpret_cast<float2*>(w.out);
  const int count = nf * ni * nj;
  for (int e = threadIdx.x; e < count; e += RT_THREADS) {
    const int j = e % nj;
    const int fi = e / nj;
    const int i = fi % ni, f = fi / ni;
    const float ar = Ri[f * RT_TILE + i], ai = Ii[f * RT_TILE + i];
    const float br = Rj[f * RT_TILE + j], bi = Ij[f * RT_TILE + j];
    // (ar + i ai) * conj(br + i bi)
    out[(((size_t)s * w.F + f0 + f) * p.d + i0 + i) * p.d + j0 + j] =
        make_float2(ar * br + ai * bi, ai * br - ar * bi);
  }
}

extern "C" int rt_segment_power(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = plan_smem_bytes(*p, RT_TILE, false, false, true);
  if (p->welch[0].fft) {
    const cudaError_t err = allow_smem(segment_power_fft_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    segment_power_fft_kernel<<<p->welch[0].ctas, RT_THREADS, smem, st>>>(*p);
  } else {
    segment_power_kernel<<<p->welch[0].ctas, RT_THREADS, smem, st>>>(*p);
  }
  return (int)cudaGetLastError();
}

// welch[0].ctas = S * f_tiles * d_tiles * d_tiles; welch[0].out is the
// (S, F, d, d, 2) float output.
extern "C" int rt_segment_csd(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  segment_csd_kernel<<<p->welch[0].ctas, RT_THREADS, 0, st>>>(*p);
  return (int)cudaGetLastError();
}
