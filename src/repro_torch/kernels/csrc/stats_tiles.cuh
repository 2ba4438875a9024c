// Shared __device__ routines of the port's Hopper kernels (sm_90a, fp32).
//
// Three routines carry every kernel of the fused statistics plan:
//
//   lag_role      one CTA: S(h) tile = sum_{t in slab} a_t y_{t+h}^T for one
//                 lag h, one 64 x 64 channel tile, one slab of window starts
//                 (an fp32 SGEMM-shaped contraction staged through shared
//                 memory, 4 x 4 outputs per thread);
//   moment_role   one CTA: the K-window moment sums of one slab of rows.
//                 sum_s m_s sum_{j<w} y_{s+j} = sum_t c_w(t) y_t, where
//                 c_w(t) counts the valid starts of windows covering row t
//                 (an exact integer, read off the prefix count of the start
//                 mask), so K windows cost O(K) per row, not O(max w);
//   welch_role    one CTA: detrended, tapered |DFT|^2 of a group of
//                 candidate segments for one 32-frequency x 64-channel tile,
//                 as two contractions against the taper-folded twiddles.
//
// A Pallas kernel on the TPU accumulates into an output block that every
// step of a sequential grid revisits.  CTAs here run in parallel and in no
// order, so each CTA writes its own partial and reduce_parts_kernel sums the
// partials in a fixed order: no float atomics, so the same inputs give
// bit-identical outputs from one run to the next.
//
// Limits: rows * d < 2^31, at most RT_MAX_WINDOWS moment windows and
// RT_MAX_WELCH Welch members per launch (the Python wrappers raise past
// them).  Lags, windows and segment lengths have no other bound.
#pragma once

#include <cuda_runtime.h>

#define RT_THREADS 256
#define RT_KC 32      // rows staged into shared memory per step
#define RT_TILE 64    // channel tile (lag outputs: RT_TILE x RT_TILE per CTA)
#define RT_FT 32      // frequency tile of the segment DFT
#define RT_LANES 8    // row lanes of the moment role (RT_THREADS / 32)
#define RT_MAX_WINDOWS 8
#define RT_MAX_WELCH 4
#define RT_MAX_SECTIONS (2 + RT_MAX_WELCH)
#define RT_SMEM_FLOATS 4608

// One Welch member of a launch.  Candidate entry e starts at series row
// (e / n_cand) * tile + offs[e]; offs[e] < 0 marks a masked or misaligned
// candidate, which contributes nothing.  offs == nullptr: entry e is the
// contiguous segment at row e * L (the standalone segment-power kernel).
struct WelchMember {
  const float* cos;  // (L, F) taper-folded twiddles
  const float* sin;  // (L, F)
  const int* offs;   // (n_entries,) local starts, -1 invalid
  float* part;       // (n_groups, F, d) per-CTA-group power sums
  float* out;        // (F, d) reduced power sum
  int L, F;
  int n_entries, n_cand, tile;
  int group;         // candidate entries per CTA
  int n_groups, f_tiles;
  int ctas;          // n_groups * f_tiles * d_tiles
};

struct PlanParams {
  const float* y;  // (rows, d): right lag factor, moment rows, segment source
  const float* a;  // (n, d) left lag factor, or nullptr: y masked by m
  const float* m;  // (n,) start mask as 0/1 floats, or nullptr: all valid
  int n, d, d_tiles;
  // lag family: S(h) = sum_{t<n} a_t y_{t+h}^T for h = 0..H
  int H, lag_slab, lag_slabs, lag_ctas;
  float* lag_part;  // (lag_slabs, H+1, d, d)
  float* lag_out;   // (H+1, d, d)
  // moment family: sums over rows [0, mom_rows) with window counts c_w(t)
  int K;
  int windows[RT_MAX_WINDOWS];
  const int* prefix;  // (n+1,) prefix[i] = number of valid starts below i
  int mom_rows, mom_slab, mom_slabs, c_groups, mom_ctas;
  float* mom_part;  // (mom_slabs, K, 2, d)
  float* mom_out;   // (K, 2, d)
  // Welch family
  int n_welch;
  WelchMember welch[RT_MAX_WELCH];
  int detrend;
};

// ---------------------------------------------------------------- lag sums
static __device__ void lag_role(const PlanParams& p, int cta, float* smem) {
  const int tiles2 = p.d_tiles * p.d_tiles;
  const int tile = cta % tiles2;
  const int rest = cta / tiles2;
  const int h = rest % (p.H + 1);
  const int slab = rest / (p.H + 1);
  const int i0 = (tile / p.d_tiles) * RT_TILE;
  const int j0 = (tile % p.d_tiles) * RT_TILE;
  const int t_begin = slab * p.lag_slab;
  const int t_end = min(t_begin + p.lag_slab, p.n);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* As = smem;                    // [RT_KC][RT_TILE] left factor rows
  float* Bs = smem + RT_KC * RT_TILE;  // [RT_KC][RT_TILE] rows shifted by h

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += RT_KC) {
    for (int e = threadIdx.x; e < RT_KC * RT_TILE; e += RT_THREADS) {
      const int r = e / RT_TILE, c = e % RT_TILE, t = t0 + r;
      float av = 0.f, bv = 0.f;
      if (t < t_end) {
        if (i0 + c < p.d) {
          if (p.a != nullptr) {
            av = p.a[(size_t)t * p.d + i0 + c];
          } else if (p.m == nullptr || p.m[t] != 0.f) {
            av = p.y[(size_t)t * p.d + i0 + c];
          }
        }
        if (j0 + c < p.d) bv = p.y[(size_t)(t + h) * p.d + j0 + c];
      }
      As[e] = av;
      Bs[e] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < RT_KC; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k * RT_TILE + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k * RT_TILE + tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a4[r], b4[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* out = p.lag_part + ((size_t)slab * (p.H + 1) + h) * p.d * p.d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= p.d) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j < p.d) out[(size_t)i * p.d + j] = acc[r][c];
    }
  }
}

// ------------------------------------------------------- windowed moments
static __device__ void moment_role(const PlanParams& p, int cta, float* smem) {
  const int cg = cta % p.c_groups;
  const int slab = cta / p.c_groups;
  const int tx = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c = cg * 32 + tx;
  const int r_begin = slab * p.mom_slab;
  const int r_end = min(r_begin + p.mom_slab, p.mom_rows);

  float s1[RT_MAX_WINDOWS], s2[RT_MAX_WINDOWS];
#pragma unroll
  for (int k = 0; k < RT_MAX_WINDOWS; ++k) s1[k] = s2[k] = 0.f;

  if (c < p.d) {
    for (int t = r_begin + lane; t < r_end; t += RT_LANES) {
      const float v = p.y[(size_t)t * p.d + c];
      const float v2 = v * v;
      const int hi = p.prefix[min(t + 1, p.n)];
#pragma unroll
      for (int k = 0; k < RT_MAX_WINDOWS; ++k) {
        if (k < p.K) {
          const int lo = min(max(t + 1 - p.windows[k], 0), p.n);
          const float wgt = (float)(hi - p.prefix[lo]);  // exact below 2^24
          s1[k] = fmaf(wgt, v, s1[k]);
          s2[k] = fmaf(wgt, v2, s2[k]);
        }
      }
    }
  }

  // fixed-order reduction over the row lanes
  float* red = smem;  // [RT_LANES][2 * RT_MAX_WINDOWS][32]
#pragma unroll
  for (int k = 0; k < RT_MAX_WINDOWS; ++k) {
    red[(lane * 2 * RT_MAX_WINDOWS + 2 * k) * 32 + tx] = s1[k];
    red[(lane * 2 * RT_MAX_WINDOWS + 2 * k + 1) * 32 + tx] = s2[k];
  }
  __syncthreads();
  if (lane == 0 && c < p.d) {
    for (int k = 0; k < p.K; ++k) {
      float a1 = 0.f, a2 = 0.f;
      for (int l = 0; l < RT_LANES; ++l) {
        a1 += red[(l * 2 * RT_MAX_WINDOWS + 2 * k) * 32 + tx];
        a2 += red[(l * 2 * RT_MAX_WINDOWS + 2 * k + 1) * 32 + tx];
      }
      float* out = p.mom_part + ((size_t)slab * p.K + k) * 2 * p.d;
      out[c] = a1;
      out[p.d + c] = a2;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------ segment DFT power
// Adds re^2 + im^2 of one segment to psd for the CTA's (32 f x 64 channel)
// tile: re = C^T (y - mu), im = S^T (y - mu), mu the per-channel mean.
static __device__ void seg_power_tile(const float* seg, int L, int d,
                                      const float* C, const float* S, int F,
                                      int f0, int j0, int detrend,
                                      float psd[2][4], float* smem) {
  float* Ys = smem;                    // [RT_KC][RT_TILE]
  float* Cs = Ys + RT_KC * RT_TILE;    // [RT_KC][RT_FT]
  float* Ss = Cs + RT_KC * RT_FT;      // [RT_KC][RT_FT]
  float* mu = Ss + RT_KC * RT_FT;      // [RT_TILE]
  float* red = mu + RT_TILE;           // [4][RT_TILE]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  {  // per-channel mean: 4 row lanes per channel, summed in lane order
    const int col = threadIdx.x % RT_TILE, lane = threadIdx.x / RT_TILE;
    float s = 0.f;
    if (detrend && j0 + col < d)
      for (int t = lane; t < L; t += 4) s += seg[(size_t)t * d + j0 + col];
    red[lane * RT_TILE + col] = s;
    __syncthreads();
    if (threadIdx.x < RT_TILE) {
      const int q = threadIdx.x;
      mu[q] = detrend ? (red[q] + red[RT_TILE + q] + red[2 * RT_TILE + q] +
                         red[3 * RT_TILE + q]) / (float)L
                      : 0.f;
    }
    __syncthreads();
  }

  float re[2][4], im[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) re[r][c] = im[r][c] = 0.f;

  for (int t0 = 0; t0 < L; t0 += RT_KC) {
    for (int e = threadIdx.x; e < RT_KC * RT_TILE; e += RT_THREADS) {
      const int r = e / RT_TILE, c = e % RT_TILE, t = t0 + r;
      Ys[e] = (t < L && j0 + c < d) ? seg[(size_t)t * d + j0 + c] - mu[c] : 0.f;
    }
    for (int e = threadIdx.x; e < RT_KC * RT_FT; e += RT_THREADS) {
      const int r = e / RT_FT, c = e % RT_FT, t = t0 + r, f = f0 + c;
      const bool ok = t < L && f < F;
      Cs[e] = ok ? C[(size_t)t * F + f] : 0.f;
      Ss[e] = ok ? S[(size_t)t * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < RT_KC; ++k) {
      const float4 yv = *reinterpret_cast<const float4*>(&Ys[k * RT_TILE + tx * 4]);
      const float2 cv = *reinterpret_cast<const float2*>(&Cs[k * RT_FT + ty * 2]);
      const float2 sv = *reinterpret_cast<const float2*>(&Ss[k * RT_FT + ty * 2]);
      const float y4[4] = {yv.x, yv.y, yv.z, yv.w};
      const float c2[2] = {cv.x, cv.y};
      const float s2[2] = {sv.x, sv.y};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          re[r][c] = fmaf(c2[r], y4[c], re[r][c]);
          im[r][c] = fmaf(s2[r], y4[c], im[r][c]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) psd[r][c] += re[r][c] * re[r][c] + im[r][c] * im[r][c];
}

static __device__ void welch_role(const PlanParams& p, const WelchMember& w,
                                  int cta, float* smem) {
  const int dt = cta % p.d_tiles;
  const int rest = cta / p.d_tiles;
  const int ft = rest % w.f_tiles;
  const int g = rest / w.f_tiles;
  const int j0 = dt * RT_TILE, f0 = ft * RT_FT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float psd[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) psd[r][c] = 0.f;

  const int e_end = min((g + 1) * w.group, w.n_entries);
  for (int e = g * w.group; e < e_end; ++e) {
    long long row;
    if (w.offs == nullptr) {
      row = (long long)e * w.L;
    } else {
      const int off = w.offs[e];
      if (off < 0) continue;  // the same entry for every thread: no divergence
      row = (long long)(e / w.n_cand) * w.tile + off;
    }
    seg_power_tile(p.y + row * p.d, w.L, p.d, w.cos, w.sin, w.F, f0, j0,
                   p.detrend, psd, smem);
  }

  float* out = w.part + (size_t)g * w.F * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = f0 + ty * 2 + r;
    if (f >= w.F) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j < p.d) out[(size_t)f * p.d + j] = psd[r][c];
    }
  }
}

// --------------------------------------------------- fixed-order reduction
struct ReduceSection {
  const float* part;  // (n_parts, count)
  float* out;         // (count,)
  int n_parts, count;
};

struct ReduceParams {
  ReduceSection s[RT_MAX_SECTIONS];
  int n;
};

static __global__ void __launch_bounds__(RT_THREADS)
reduce_parts_kernel(ReduceParams r) {
  const ReduceSection s = r.s[blockIdx.y];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < s.count;
       e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < s.n_parts; ++q) acc += s.part[(size_t)q * s.count + e];
    s.out[e] = acc;
  }
}

// Sums each family's partials of a launch in order; one launch for all.
static cudaError_t reduce_families(const PlanParams& p, bool lag, bool mom,
                                   cudaStream_t stream) {
  ReduceParams r;
  r.n = 0;
  int most = 1;
  auto add = [&](const float* part, float* out, int n_parts, int count) {
    r.s[r.n].part = part;
    r.s[r.n].out = out;
    r.s[r.n].n_parts = n_parts;
    r.s[r.n].count = count;
    ++r.n;
    most = count > most ? count : most;
  };
  if (lag) add(p.lag_part, p.lag_out, p.lag_slabs, (p.H + 1) * p.d * p.d);
  if (mom && p.K > 0) add(p.mom_part, p.mom_out, p.mom_slabs, p.K * 2 * p.d);
  for (int j = 0; j < p.n_welch; ++j)
    add(p.welch[j].part, p.welch[j].out, p.welch[j].n_groups, p.welch[j].F * p.d);
  if (r.n == 0) return cudaSuccess;
  int blocks = (most + RT_THREADS - 1) / RT_THREADS;
  blocks = blocks > 1024 ? 1024 : blocks;
  reduce_parts_kernel<<<dim3(blocks, r.n), RT_THREADS, 0, stream>>>(r);
  return cudaGetLastError();
}
