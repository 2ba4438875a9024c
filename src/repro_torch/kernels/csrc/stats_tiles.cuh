// Shared __device__ routines of the port's Hopper kernels (sm_90a, fp32).
//
// Four routines carry every kernel of the fused statistics plan:
//
//   lag_role       one CTA: S(h) tiles = sum_{t in slab} a_t y_{t+h}^T for a
//                  group of up to RT_LAG_GROUP consecutive lags, one 64 x 64
//                  channel tile, one slab of window starts: the role of
//                  kernel 3 at every width and of kernels 1 and 2 above 32
//                  channels.  Bound on the H100: fp32 FMAs.  The rows of a
//                  and y are staged once per step for the whole lag group
//                  (lag h reads the y buffer h rows down), by 16-byte
//                  cp.async copies into a ring of RT_LAG_STAGES steps, so the
//                  copies of step k+1 overlap the FMAs of step k; the row
//                  mask decides the zero-fill of a row's copies.  Each thread
//                  keeps a 4 x 4 tile per lag and a sliding window of the y
//                  fragments its lags need: per row it loads one float4 of a
//                  and one new float4 of y (32 bytes of shared memory) for 16
//                  FMAs per lag, 0.67 byte per FMA with 3 lags, so the FMAs,
//                  not the shared-memory loads, set the pace.  At 3 lags a
//                  thread needs no more than the 128 registers of two CTAs
//                  per SM (4 lags spilled and ran slower on the H100).  Below
//                  33 channels the tile is padding (15/16 of it at d = 16),
//                  so kernels 1 and 2 take small_lag_role there instead;
//   small_lag_role one CTA: the same sums for d <= RT_MID_TILE, with a tile
//                  sized by d (lag_tile: RT_SMALL_TILE = 16 channels up to 16,
//                  RT_MID_TILE = 32 up to 32) for a run of up to RT_SMALL_LAGS
//                  consecutive lags, so H = 16 is one CTA a tenant.  Each
//                  thread owns column j and RB = TW^2 / RT_THREADS rows (1 at
//                  TW = 16, 4 at 32) at every lag of the run: per row one
//                  broadcast load of a_t (RB floats) and one new y_{t+h}[j]
//                  into a sliding window of the run's length, so 2 shared
//                  loads feed RB x NG FMAs and no thread computes a padding
//                  column past TW.  The slab's rows come once for the run
//                  through the same cp.async ring (RT_LAG_STAGES steps);
//   moment_role    one CTA: the K-window moment sums of one slab of rows.
//                  sum_s m_s sum_{j<w} y_{s+j} = sum_t c_w(t) y_t, where
//                  c_w(t) counts the valid starts of windows covering row t
//                  (an exact integer, read off the prefix count of the start
//                  mask), so K windows cost O(K) per row, not O(max w);
//   welch_fft_role one CTA: detrended, tapered |rfft|^2 of a group of
//                  segments for one channel tile, summed over the group (or
//                  written per segment), for L a power of two up to
//                  RT_FFT_MAX_L.  Bound on the H100: bytes (an FFT's 2.5 L
//                  log2 L operations per channel against 4 L bytes read).
//                  A segment's (L, chan) tile comes into shared memory by
//                  cp.async while the previous one is transformed; two real
//                  channels form one complex sequence, transformed in place
//                  by radix-4 Stockham stages (radix 2 last for odd log2 L)
//                  with roots from a host-built (L/2)-entry table, then split
//                  two-for-one.  One CTA covers every frequency, so a segment
//                  is read once and its means taken once;
//   welch_role     one CTA: the same power as a DFT by two contractions
//                  against the taper-folded twiddles, for one 32-frequency x
//                  64-channel tile (seg_dft_tile, which the cross-spectra
//                  kernel shares): the path of L that is not a power of two
//                  or above RT_FFT_MAX_L.
//
// A Pallas kernel on the TPU accumulates into an output block that every
// step of a sequential grid revisits.  CTAs here run in parallel and in no
// order, so each CTA writes its own partial and reduce_parts_kernel sums the
// partials in a fixed order: no float atomics, so the same inputs give
// bit-identical outputs from one run to the next.
//
// Batches: a launch may serve `batch` independent problems of one shape
// (the tenants of a multi-tenant session).  Tenant t's inputs, partials
// and outputs lie t times their `*_stride` elements after tenant 0's (64-bit
// offsets: tenant x rows x d passes 2^31 at a session's shape), and the grid
// is tenant-major: blockIdx.x = t * tenant_ctas + the CTA's index among its
// tenant's role CTAs, so no grid dimension limits the tenant count.  Each
// role offsets its pointers by its tenant and then runs exactly as for one
// problem; reduce_families sums each tenant's partials in the same fixed
// order.  Roles and kernels come in two instantiations: BATCHED true for a
// batch above 1, and false, the one-problem code as it was before batches
// (the offsets fold away), which a launch of batch 1 runs: bit for bit and
// time for time the one-problem launch.
//
// Limits: rows * d < 2^31 per tenant, at most RT_MAX_WINDOWS moment windows
// and RT_MAX_WELCH Welch members per launch (the Python wrappers raise past
// them).  Lags, windows and segment lengths have no other bound.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_THREADS 256
#define RT_KC 32      // rows staged into shared memory per step
#define RT_TILE 64    // channel tile (lag outputs: RT_TILE x RT_TILE per lag and CTA)
#define RT_FT 32      // frequency tile of the twiddle DFT
#define RT_LANES 8    // row lanes of the moment role (RT_THREADS / 32)
#define RT_MAX_WINDOWS 8
#define RT_MAX_WELCH 4
#define RT_MAX_SECTIONS (2 + RT_MAX_WELCH)
#define RT_SMEM_FLOATS 4608  // seg_dft_tile's staging
#define RT_MOM_SMEM_FLOATS (RT_LANES * 2 * RT_MAX_WINDOWS * 32)
// Design constants, chosen by timing their variants on the H100 (PERF.md).
// RT_LAG_GROUP is mirrored by _build.py's LAG_GROUP, checked at load.
#define RT_LAG_GROUP 3     // most lags per CTA (4 spilled at 128 registers)
#define RT_LAG_STAGES 2    // cp.async ring of the lag contraction
#define RT_MIN_CTAS 2      // CTAs per SM the plan kernels are built for (128 registers)
#define RT_FFT_MIN_CTAS 2  // the same, for the standalone FFT power kernel
// The small-width lag role (mirrored by _build.py's SMALL_TILE, MID_TILE
// and SMALL_LAGS, checked at load): its two tiles and most lags a CTA (17:
// H = 16 in one run).  At the 32-channel tile a thread holds 4 rows of each
// lag and the batched instantiations spill a little; runs of at most 9
// there did not spill but ran 7-14% slower on the H100 (PERF.md).
#define RT_SMALL_TILE 16
#define RT_MID_TILE 32
#define RT_SMALL_LAGS 17
#define RT_LAG_A (RT_KC * RT_TILE)
#define RT_LAG_B ((RT_KC + RT_LAG_GROUP - 1) * RT_TILE)
#define RT_LAG_SMEM_FLOATS (RT_LAG_STAGES * (RT_LAG_A + RT_LAG_B))
#define RT_FFT_MAX_L 4096
#define RT_FFT_FLOATS 8192     // most floats of one staged (L, chan) segment tile
#define RT_FFT_MAX_CHAN 64
// (f, sequence) pairs per thread in the two-for-one split: L/2 + 1 rows of
// at most RT_FFT_FLOATS / (2 L) sequences (at most RT_FFT_MAX_CHAN / 2)
#define RT_FFT_OUT ((RT_FFT_FLOATS / 4 + RT_FFT_MAX_CHAN / 2 + RT_THREADS - 1) / RT_THREADS)

// One Welch member of a launch.  Candidate entry e starts at series row
// (e / n_cand) * tile + offs[e]; offs[e] < 0 marks a masked or misaligned
// candidate, which contributes nothing.  offs == nullptr: entry e is the
// contiguous segment at row e * L, and its power is written on its own
// (the standalone segment-power kernel).
struct WelchMember {
  const float* cos;    // twiddle path: (L, F) taper-folded twiddles
  const float* sin;    // twiddle path: (L, F)
  const float* taper;  // FFT path: (L,) window
  const float* roots;  // FFT path: (L/2, 2) exp(-2 pi i k / L), k < L/2
  const int* offs;     // (n_entries,) local starts, -1 invalid
  float* part;         // (n_groups, F, d) per-CTA-group power sums
  float* out;          // (F, d) reduced power sum
  int L, F;
  int n_entries, n_cand, tile;
  int group;           // candidate entries per CTA
  int n_groups, f_tiles;
  int ctas;            // twiddle: n_groups * f_tiles * d_tiles; FFT: n_groups * chan_tiles
  int fft;             // 1: the FFT path
  int chan;            // FFT path: channels per CTA (a power of two, L * chan <= RT_FFT_FLOATS)
  int chan_tiles;
  long long offs_stride, part_stride, out_stride;  // per tenant (elements)
};

struct PlanParams {
  const float* y;  // (rows, d): right lag factor, moment rows, segment source
  const float* a;  // (n, d) left lag factor, or nullptr: y masked by m
  const float* m;  // (n,) start mask as 0/1 floats, or nullptr: all valid
  int n, d, d_tiles;
  // lag family: S(h) = sum_{t<n} a_t y_{t+h}^T for h = 0..H, in lag_groups
  // runs of consecutive lags
  int H, lag_slab, lag_slabs, lag_ctas, lag_groups;
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
  // batch of `batch` tenants, `tenant_ctas` role CTAs each (set by the C
  // entry); per-tenant strides in elements (0 at batch 1)
  int batch, tenant_ctas;
  long long y_stride, a_stride, m_stride, prefix_stride;
  long long lag_part_stride, lag_out_stride, mom_part_stride, mom_out_stride;
};

// Tenant tn's copy of a per-problem pointer: base + tn * stride, in 64 bits.
// The one-problem instantiation reads the base as it lies.  The roles apply
// it where they read a pointer, not once into a local, so that their
// one-problem instantiation is the one-problem code (a local kept the
// pointers in registers and slowed kernels 1 and 2 by 1-2%; PERF.md).
template <bool BATCHED, typename T>
__device__ __forceinline__ T* at_tenant(T* base, long long stride, int tn) {
  return BATCHED ? base + (long long)tn * stride : base;
}

// ------------------------------------------------------------ async copies
// cp.async copies global -> shared; zero-filled when !full (the source
// address is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying rows [0, nrows) of a row-major (.., d) matrix, columns
// [c0, c0 + width), into shared rows of `width` floats.  Shared row r comes
// from source row src_row(r), or is zero when that is negative; columns >= d
// are zero.  `vec`: 16-byte copies (d, c0, width and the base 16-byte
// aligned), else 4-byte copies.  Each copy calls src_row: the lanes that
// copy one row read the same mask word, one broadcast transaction for the
// warp (reading it once per row and shuffling it to the row's lanes was
// 4-6% slower on the H100 and spilled at 128 registers; PERF.md).
template <typename RowOf>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int d, int c0,
                                           int width, int nrows, bool vec, RowOf src_row) {
  if (vec) {
    const int per_row = width / 4;
    for (int e = threadIdx.x; e < nrows * per_row; e += RT_THREADS) {
      const int r = e / per_row, c = (e % per_row) * 4;
      const long long row = src_row(r);
      const bool ok = row >= 0 && c0 + c < d;
      cp_async16(dst + r * width + c, ok ? src + row * d + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * width; e += RT_THREADS) {
      const int r = e / width, c = e % width;
      const long long row = src_row(r);
      const bool ok = row >= 0 && c0 + c < d;
      cp_async4(dst + e, ok ? src + row * d + c0 + c : src, ok);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// ---------------------------------------------------------------- lag sums
// One staged step: acc[g] += sum_k A[k] (x) B[k + g] over the RT_KC rows of
// the step, for the thread's rows ty*4.. and columns tx*4.. .  b holds the
// NG y fragments of rows k .. k+NG-1 (slot (k+g) % NG), so each row loads
// one new fragment.
template <int NG>
__device__ __forceinline__ void lag_step(const float* As, const float* Bs, int tx, int ty,
                                         float acc[NG][4][4]) {
  float4 b[NG];
#pragma unroll
  for (int g = 0; g + 1 < NG; ++g)
    b[g] = *reinterpret_cast<const float4*>(&Bs[g * RT_TILE + tx * 4]);
#pragma unroll
  for (int k = 0; k < RT_KC; ++k) {
    b[(k + NG - 1) % NG] =
        *reinterpret_cast<const float4*>(&Bs[(k + NG - 1) * RT_TILE + tx * 4]);
    const float4 av = *reinterpret_cast<const float4*>(&As[k * RT_TILE + ty * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 bv = b[(k + g) % NG];
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][r][c] = fmaf(a4[r], b4[c], acc[g][r][c]);
    }
  }
}

// Lags h0 .. h0+NG-1 of the tile (i0, j0) over the starts of one slab.
template <int NG, bool BATCHED>
__device__ void lag_group(const PlanParams& p, int h0, int i0, int j0, int slab, int tn,
                          float* smem) {
  const int t_begin = slab * p.lag_slab;
  const int t_end = min(t_begin + p.lag_slab, p.n);
  const int b_end = t_end + h0 + NG - 1;  // this group reads y rows [t_begin + h0, b_end)
  const int steps = (t_end - t_begin + RT_KC - 1) / RT_KC;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* A = p.a != nullptr ? at_tenant<BATCHED>(p.a, p.a_stride, tn)
                                  : at_tenant<BATCHED>(p.y, p.y_stride, tn);
  const bool vec =
      p.d % 4 == 0 && aligned16(A) && aligned16(at_tenant<BATCHED>(p.y, p.y_stride, tn));

  auto issue = [&](int s) {
    float* As = smem + (s % RT_LAG_STAGES) * (RT_LAG_A + RT_LAG_B);
    const int t0 = t_begin + s * RT_KC;
    stage_rows(As, A, p.d, i0, RT_TILE, RT_KC, vec, [&](int r) -> long long {
      const int t = t0 + r;
      const bool live = t < t_end && (p.a != nullptr || p.m == nullptr ||
                                      at_tenant<BATCHED>(p.m, p.m_stride, tn)[t] != 0.f);
      return live ? t : -1;
    });
    stage_rows(As + RT_LAG_A, at_tenant<BATCHED>(p.y, p.y_stride, tn), p.d, j0, RT_TILE,
               RT_KC + NG - 1, vec,
               [&](int r) -> long long {
                 const int t = t0 + h0 + r;
                 return t < b_end ? t : -1;
               });
  };

  float acc[NG][4][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][r][c] = 0.f;

  for (int s = 0; s < RT_LAG_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<RT_LAG_STAGES - 2>();  // step s has landed
    __syncthreads();                     // ... for every thread; step s-1's slot is free
    if (s + RT_LAG_STAGES - 1 < steps) issue(s + RT_LAG_STAGES - 1);
    cp_async_commit();
    const float* As = smem + (s % RT_LAG_STAGES) * (RT_LAG_A + RT_LAG_B);
    lag_step<NG>(As, As + RT_LAG_A, tx, ty, acc);
  }
  cp_async_wait<0>();


#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float* out = at_tenant<BATCHED>(p.lag_part, p.lag_part_stride, tn) +
                 ((size_t)slab * (p.H + 1) + h0 + g) * p.d * p.d;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= p.d) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx * 4 + c;
        if (j < p.d) out[(size_t)i * p.d + j] = acc[g][r][c];
      }
    }
  }
}

// CTA -> (channel tile, lag group, slab), the tile fastest.  The H+1 lags
// split into lag_groups runs of consecutive lags; the first (H+1) %
// lag_groups runs hold one lag more (tests/test_torch_fft_plan.py: lag_cta
// models it).  _launch.add_lag keeps every run at most RT_LAG_GROUP long.
// `tn`: the CTA's tenant.
template <bool BATCHED>
static __device__ void lag_role(const PlanParams& p, int cta, int tn, float* smem) {
  const int tiles2 = p.d_tiles * p.d_tiles;
  const int tile = cta % tiles2;
  const int rest = cta / tiles2;
  const int grp = rest % p.lag_groups;
  const int slab = rest / p.lag_groups;
  const int base = (p.H + 1) / p.lag_groups, extra = (p.H + 1) % p.lag_groups;
  const int ng = base + (grp < extra ? 1 : 0);
  const int h0 = grp * base + min(grp, extra);
  const int i0 = (tile / p.d_tiles) * RT_TILE;
  const int j0 = (tile % p.d_tiles) * RT_TILE;
  static_assert(RT_LAG_GROUP == 3, "lag_role instantiates lag_group<1..3>");
  switch (ng) {
    case 1: lag_group<1, BATCHED>(p, h0, i0, j0, slab, tn, smem); break;
    case 2: lag_group<2, BATCHED>(p, h0, i0, j0, slab, tn, smem); break;
    case 3: lag_group<3, BATCHED>(p, h0, i0, j0, slab, tn, smem); break;
    default: __trap();  // a run longer than RT_LAG_GROUP: the launch fails
  }
}

// ------------------------------------------------- lag sums at small widths
// The channel tile of kernels 1 and 2's lag role at width d: RT_SMALL_TILE
// up to RT_SMALL_TILE channels, RT_MID_TILE up to RT_MID_TILE, else RT_TILE
// (lag_role).  The C entries choose it by d, never by the batch
// (_launch.lag_tile mirrors it).
__host__ __device__ constexpr int lag_tile(int d) {
  return d <= RT_SMALL_TILE ? RT_SMALL_TILE : d <= RT_MID_TILE ? RT_MID_TILE : RT_TILE;
}

// Floats of one ring step of small_lag_role at tile TW: RT_KC rows of a, and
// RT_KC + RT_SMALL_LAGS - 1 rows of y (a run of NG lags reads NG - 1 more).
__host__ __device__ constexpr int small_lag_slot(int tw) {
  return (2 * RT_KC + RT_SMALL_LAGS - 1) * tw;
}

// One staged step: acc[g][r] += sum_k A[k][i0 + r] B[k + g][j] over the
// RT_KC rows of the step, k ascending.  b holds the NG values of column j
// in rows k .. k+NG-1 (slot (k+g) % NG), so each row loads one new value.
template <int TW, int NG>
__device__ __forceinline__ void small_lag_step(const float* As, const float* Bs, int i0, int j,
                                               float acc[NG][TW * TW / RT_THREADS]) {
  constexpr int RB = TW * TW / RT_THREADS;
  static_assert(RB == 1 || RB == 4, "a thread owns 1 or 4 rows of the tile");
  float b[NG];
#pragma unroll
  for (int g = 0; g + 1 < NG; ++g) b[g] = Bs[g * TW + j];
#pragma unroll
  for (int k = 0; k < RT_KC; ++k) {
    b[(k + NG - 1) % NG] = Bs[(k + NG - 1) * TW + j];
    float a[RB];
    if constexpr (RB == 4) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k * TW + i0]);
      a[0] = av.x;
      a[1] = av.y;
      a[2] = av.z;
      a[3] = av.w;
    } else {
      a[0] = As[k * TW + i0];
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[g][r] = fmaf(a[r], b[(k + g) % NG], acc[g][r]);
  }
}

// Lags h0 .. h0+NG-1 of the whole TW x TW tile over the starts of one slab.
// Masked starts still multiply: their a rows are zero-filled, and 0 times a
// non-finite y is NaN, as the reference's where-then-einsum gives.
template <int TW, int NG, bool BATCHED>
__device__ void small_lag_group(const PlanParams& p, int h0, int slab, int tn, float* smem) {
  constexpr int RB = TW * TW / RT_THREADS;
  constexpr int SLOT = small_lag_slot(TW);
  const int t_begin = slab * p.lag_slab;
  const int t_end = min(t_begin + p.lag_slab, p.n);
  const int b_end = t_end + h0 + NG - 1;  // this run reads y rows [t_begin + h0, b_end)
  const int steps = (t_end - t_begin + RT_KC - 1) / RT_KC;
  const int j = threadIdx.x % TW, i0 = (threadIdx.x / TW) * RB;
  const float* A = p.a != nullptr ? at_tenant<BATCHED>(p.a, p.a_stride, tn)
                                  : at_tenant<BATCHED>(p.y, p.y_stride, tn);
  const bool vec =
      p.d % 4 == 0 && aligned16(A) && aligned16(at_tenant<BATCHED>(p.y, p.y_stride, tn));

  auto issue = [&](int s) {
    float* As = smem + (s % RT_LAG_STAGES) * SLOT;
    const int t0 = t_begin + s * RT_KC;
    stage_rows(As, A, p.d, 0, TW, RT_KC, vec, [&](int r) -> long long {
      const int t = t0 + r;
      const bool live = t < t_end && (p.a != nullptr || p.m == nullptr ||
                                      at_tenant<BATCHED>(p.m, p.m_stride, tn)[t] != 0.f);
      return live ? t : -1;
    });
    stage_rows(As + RT_KC * TW, at_tenant<BATCHED>(p.y, p.y_stride, tn), p.d, 0, TW,
               RT_KC + NG - 1, vec, [&](int r) -> long long {
                 const int t = t0 + h0 + r;
                 return t < b_end ? t : -1;
               });
  };

  float acc[NG][RB];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[g][r] = 0.f;

  for (int s = 0; s < RT_LAG_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<RT_LAG_STAGES - 2>();  // step s has landed
    __syncthreads();                     // ... for every thread; step s-1's slot is free
    if (s + RT_LAG_STAGES - 1 < steps) issue(s + RT_LAG_STAGES - 1);
    cp_async_commit();
    const float* As = smem + (s % RT_LAG_STAGES) * SLOT;
    small_lag_step<TW, NG>(As, As + RT_KC * TW, i0, j, acc);
  }
  cp_async_wait<0>();

  if (j >= p.d) return;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float* out = at_tenant<BATCHED>(p.lag_part, p.lag_part_stride, tn) +
                 ((size_t)slab * (p.H + 1) + h0 + g) * p.d * p.d;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (i0 + r < p.d) out[(size_t)(i0 + r) * p.d + j] = acc[g][r];
  }
}

// small_lag_group<TW, ng>: the run length is a template argument (the
// sliding window lives in registers), instantiated for 1 .. RT_SMALL_LAGS.
template <int TW, bool BATCHED, int NG = 1>
__device__ __forceinline__ void small_lag_run(const PlanParams& p, int ng, int h0, int slab,
                                              int tn, float* smem) {
  if constexpr (NG > RT_SMALL_LAGS) {
    __trap();  // a run longer than RT_SMALL_LAGS: the launch fails
  } else if (ng == NG) {
    small_lag_group<TW, NG, BATCHED>(p, h0, slab, tn, smem);
  } else {
    small_lag_run<TW, BATCHED, NG + 1>(p, ng, h0, slab, tn, smem);
  }
}

// CTA -> (lag run, slab), the run fastest: lag_role's decomposition with
// one channel tile.  The H+1 lags split into lag_groups runs, the first
// (H+1) % lag_groups one lag longer; _launch.add_lag keeps every run at most
// RT_SMALL_LAGS long (tests/test_torch_fft_plan.py models it).  Where a
// tenant has one slab, lag_part is lag_out: the CTA writes the sums, and
// reduce_families leaves them be.
template <int TW, bool BATCHED>
static __device__ void small_lag_role(const PlanParams& p, int cta, int tn, float* smem) {
  const int grp = cta % p.lag_groups;
  const int slab = cta / p.lag_groups;
  const int base = (p.H + 1) / p.lag_groups, extra = (p.H + 1) % p.lag_groups;
  const int ng = base + (grp < extra ? 1 : 0);
  const int h0 = grp * base + min(grp, extra);
  small_lag_run<TW, BATCHED>(p, ng, h0, slab, tn, smem);
}

// The lag role of kernels 1 and 2 at tile TW (lag_tile(d)).
template <int TW, bool BATCHED>
static __device__ __forceinline__ void lag_tile_role(const PlanParams& p, int cta, int tn,
                                                     float* smem) {
  if constexpr (TW == RT_TILE) {
    lag_role<BATCHED>(p, cta, tn, smem);
  } else {
    small_lag_role<TW, BATCHED>(p, cta, tn, smem);
  }
}

// ------------------------------------------------------- windowed moments
template <bool BATCHED>
static __device__ void moment_role(const PlanParams& p, int cta, int tn, float* smem) {
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
    // unrolled so that several rows' loads are in flight at once
#pragma unroll 4
    for (int t = r_begin + lane; t < r_end; t += RT_LANES) {
      const float v = at_tenant<BATCHED>(p.y, p.y_stride, tn)[(size_t)t * p.d + c];
      const float v2 = v * v;
      const int hi = at_tenant<BATCHED>(p.prefix, p.prefix_stride, tn)[min(t + 1, p.n)];
#pragma unroll
      for (int k = 0; k < RT_MAX_WINDOWS; ++k) {
        if (k < p.K) {
          const int lo = min(max(t + 1 - p.windows[k], 0), p.n);
          // exact below 2^24
          const float wgt = (float)(hi - at_tenant<BATCHED>(p.prefix, p.prefix_stride, tn)[lo]);
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
      float* out = at_tenant<BATCHED>(p.mom_part, p.mom_part_stride, tn) +
                   ((size_t)slab * p.K + k) * 2 * p.d;
      out[c] = a1;
      out[p.d + c] = a2;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------ segment FFT power
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W^k = exp(-2 pi i k / L) for 0 <= k < L from the table of k < half = L/2
// (W^(k + L/2) = -W^k).
__device__ __forceinline__ float2 fft_root(const float2* roots, int k, int half) {
  const float2 w = __ldg(&roots[k & (half - 1)]);
  return k < half ? w : make_float2(-w.x, -w.y);
}

// In-place DFT of R points: out_r = sum_q a_q W_R^(q r).
template <int R>
__device__ __forceinline__ void butterfly(float2* a);
template <>
__device__ __forceinline__ void butterfly<2>(float2* a) {
  const float2 t = a[1];
  a[1] = csub(a[0], t);
  a[0] = cadd(a[0], t);
}
template <>
__device__ __forceinline__ void butterfly<4>(float2* a) {
  const float2 s02 = cadd(a[0], a[2]), d02 = csub(a[0], a[2]);
  const float2 s13 = cadd(a[1], a[3]), d13 = csub(a[1], a[3]);
  a[0] = cadd(s02, s13);
  a[2] = csub(s02, s13);
  a[1] = make_float2(d02.x + d13.y, d02.y - d13.x);  // d02 - i d13
  a[3] = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
}

// One radix-R Stockham stage over the 2^lp complex sequences of buf, in
// place (z[t][q] at buf[t * 2^lp + q]); sub-DFTs of length Ns are done.
// Butterfly j of a sequence reads rows j + r L/R, twiddles them by
// W^(r (j % Ns) L / (Ns R)), and writes rows (j / Ns) Ns R + j % Ns + r Ns.
// All reads land in registers before the first write.  FIRST (Ns = 1, unit
// twiddles): the rows are the raw series pairs, taken as (y - mu) * taper.
template <int R, bool FIRST>
__device__ void fft_stage(float2* buf, int L, int lp, int Ns, const float2* roots,
                          const float* taper, const float* mu) {
  constexpr int PER = RT_FFT_FLOATS / 2 / RT_THREADS / R;  // butterflies per thread, at most
  const int nb = (L / R) << lp;
  const int stride = L / R;
  const int span = L / (Ns * R);
  const int qmask = (1 << lp) - 1;
  float2 v[PER][R];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int b = threadIdx.x + u * RT_THREADS;
    if (b < nb) {
      const int q = b & qmask, j = b >> lp;
      const int k = j & (Ns - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = j + r * stride;
        float2 x = buf[(t << lp) + q];
        if (FIRST) {
          const float w = __ldg(&taper[t]);
          x = make_float2((x.x - mu[2 * q]) * w, (x.y - mu[2 * q + 1]) * w);
        } else if (r > 0) {
          x = cmul(x, fft_root(roots, r * k * span, L / 2));
        }
        v[u][r] = x;
      }
      butterfly<R>(v[u]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int b = threadIdx.x + u * RT_THREADS;
    if (b < nb) {
      const int q = b & qmask, j = b >> lp;
      const int k = j & (Ns - 1);
      const int d0 = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[((d0 + r * Ns) << lp) + q] = v[u][r];
    }
  }
  __syncthreads();
}

// Forward DFT, natural order, of the 2^lp sequences of buf (L a power of
// two >= 2): radix 4 while 4 divides what is left, radix 2 last.
static __device__ void fft_pairs(float2* buf, int L, int lp, const float2* roots,
                          const float* taper, const float* mu) {
  int Ns = 1;
  if (L >= 4) {
    fft_stage<4, true>(buf, L, lp, Ns, roots, taper, mu);
    Ns = 4;
  } else {
    fft_stage<2, true>(buf, L, lp, Ns, roots, taper, mu);
    Ns = 2;
  }
  while (Ns < L) {
    if (L / Ns >= 4) {
      fft_stage<4, false>(buf, L, lp, Ns, roots, taper, mu);
      Ns *= 4;
    } else {
      fft_stage<2, false>(buf, L, lp, Ns, roots, taper, mu);
      Ns *= 2;
    }
  }
}

// mu[c] = mean of column c of the (L, C) tile x (0 without detrend), each
// summed in a fixed order: RT_THREADS / C row lanes, then the lanes in turn.
static __device__ void channel_means(const float* x, int L, int C, int detrend, float* red,
                              float* mu) {
  const int c = threadIdx.x % C, lane = threadIdx.x / C, lanes = RT_THREADS / C;
  float s = 0.f;
  if (detrend)
    for (int t = lane; t < L; t += lanes) s += x[t * C + c];
  red[threadIdx.x] = s;
  __syncthreads();
  if ((int)threadIdx.x < C) {
    float m = 0.f;
    if (detrend) {
      for (int l = 0; l < lanes; ++l) m += red[l * C + threadIdx.x];
      m /= (float)L;
    }
    mu[threadIdx.x] = m;
  }
  __syncthreads();
}

// Adds |X_a(f)|^2 and |X_b(f)|^2, f = 0..L/2, of each sequence z = x_a + i
// x_b of the transformed tile to acc: X_a = (Z(f) + conj Z(L-f)) / 2, X_b =
// (Z(f) - conj Z(L-f)) / (2i).  Thread pairs (f, q) = e / 2^lp, e % 2^lp for
// e = threadIdx.x + u RT_THREADS.
__device__ __forceinline__ void split_power(const float2* z, int L, int lp,
                                            float acc[RT_FFT_OUT][2]) {
  const int F = L / 2 + 1;
  const int qmask = (1 << lp) - 1;
#pragma unroll
  for (int u = 0; u < RT_FFT_OUT; ++u) {
    const int e = threadIdx.x + u * RT_THREADS;
    if (e < (F << lp)) {
      const int f = e >> lp, q = e & qmask;
      const float2 zf = z[(f << lp) + q];
      const float2 zc = z[(((L - f) & (L - 1)) << lp) + q];
      const float ar = zf.x + zc.x, ai = zf.y - zc.y;
      const float br = zf.x - zc.x, bi = zf.y + zc.y;
      acc[u][0] += 0.25f * (ar * ar + ai * ai);
      acc[u][1] += 0.25f * (br * br + bi * bi);
    }
  }
}

// Writes acc (pairs as in split_power) to the (F, d) slab `out`, channels
// j0 + 2q and j0 + 2q + 1 below d.
__device__ __forceinline__ void store_power(float* out, int L, int lp, int d, int j0,
                                            float acc[RT_FFT_OUT][2]) {
  const int F = L / 2 + 1;
  const int qmask = (1 << lp) - 1;
#pragma unroll
  for (int u = 0; u < RT_FFT_OUT; ++u) {
    const int e = threadIdx.x + u * RT_THREADS;
    if (e < (F << lp)) {
      const int f = e >> lp, c = j0 + 2 * (e & qmask);
      if (c < d) out[(size_t)f * d + c] = acc[u][0];
      if (c + 1 < d) out[(size_t)f * d + c + 1] = acc[u][1];
    }
  }
}

// CTA -> (channel tile, group of entries), the tile fastest.  The group's
// valid segments come through two shared buffers: the next one's copy is in
// flight while this one is transformed.
template <bool BATCHED>
static __device__ void welch_fft_role(const PlanParams& p, const WelchMember& w, int cta,
                                      int tn, float* smem) {
  const int ct = cta % w.chan_tiles;
  const int g = cta / w.chan_tiles;
  const int L = w.L, C = w.chan, lp = __ffs(C / 2) - 1;
  const int j0 = ct * C;
  float* buf[2] = {smem, smem + L * C};
  float* red = smem + 2 * L * C;  // [RT_THREADS]
  float* mu = red + RT_THREADS;   // [RT_FFT_MAX_CHAN]
  const bool vec =
      p.d % 4 == 0 && C % 4 == 0 && aligned16(at_tenant<BATCHED>(p.y, p.y_stride, tn));
  const float2* roots = reinterpret_cast<const float2*>(w.roots);

  float acc[RT_FFT_OUT][2];
#pragma unroll
  for (int u = 0; u < RT_FFT_OUT; ++u) acc[u][0] = acc[u][1] = 0.f;

  const int e_end = min((g + 1) * w.group, w.n_entries);
  auto row_of = [&](int e) -> long long {  // first series row of entry e, -1 if invalid
    if (w.offs == nullptr) return (long long)e * L;
    // the same entry for every thread: no divergence
    const int off = at_tenant<BATCHED>(w.offs, w.offs_stride, tn)[e];
    return off < 0 ? -1 : (long long)(e / w.n_cand) * w.tile + off;
  };
  auto next_valid = [&](int e) {
    while (e < e_end && row_of(e) < 0) ++e;
    return e;
  };
  auto issue = [&](float* dst, long long row0) {
    stage_rows(dst, at_tenant<BATCHED>(p.y, p.y_stride, tn), p.d, j0, C, L, vec,
               [&](int r) -> long long { return row0 + r; });
  };

  int e = next_valid(g * w.group), cur = 0;
  if (e < e_end) issue(buf[0], row_of(e));
  cp_async_commit();
  while (e < e_end) {
    const int e_next = next_valid(e + 1);
    if (e_next < e_end) issue(buf[cur ^ 1], row_of(e_next));
    cp_async_commit();
    cp_async_wait<1>();  // entry e has landed
    __syncthreads();
    channel_means(buf[cur], L, C, p.detrend, red, mu);
    float2* z = reinterpret_cast<float2*>(buf[cur]);
    fft_pairs(z, L, lp, roots, w.taper, mu);
    split_power(z, L, lp, acc);
    if (w.offs == nullptr) {  // one output per segment
      store_power(w.part + (size_t)e * w.F * p.d, L, lp, p.d, j0, acc);
#pragma unroll
      for (int u = 0; u < RT_FFT_OUT; ++u) acc[u][0] = acc[u][1] = 0.f;
    }
    __syncthreads();  // buf[cur] is read out before it takes the next copy
    cur ^= 1;
    e = e_next;
  }
  cp_async_wait<0>();
  if (w.offs != nullptr)
    store_power(at_tenant<BATCHED>(w.part, w.part_stride, tn) + (size_t)g * w.F * p.d, L, lp,
                p.d, j0, acc);
}

// ------------------------------------------------------ segment DFT
// The DFT of one segment for the CTA's (32 f x 64 channel) tile:
// re = C^T (y - mu), im = S^T (y - mu), mu the per-channel mean (0 without
// detrend).  Thread (tx, ty) holds frequencies f0 + 2 ty + r and channels
// j0 + 4 tx + c in re[r][c], im[r][c].  Ends after a __syncthreads(), so
// the caller may reuse smem at once.
static __device__ void seg_dft_tile(const float* seg, int L, int d,
                                    const float* C, const float* S, int F,
                                    int f0, int j0, int detrend,
                                    float re[2][4], float im[2][4], float* smem) {
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
}

// Adds re^2 + im^2 of one segment to psd for the CTA's tile.
static __device__ void seg_power_tile(const float* seg, int L, int d,
                                      const float* C, const float* S, int F,
                                      int f0, int j0, int detrend,
                                      float psd[2][4], float* smem) {
  float re[2][4], im[2][4];
  seg_dft_tile(seg, L, d, C, S, F, f0, j0, detrend, re, im, smem);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) psd[r][c] += re[r][c] * re[r][c] + im[r][c] * im[r][c];
}

template <bool BATCHED>
static __device__ void welch_role(const PlanParams& p, const WelchMember& w,
                                  int cta, int tn, float* smem) {
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
      const int off = at_tenant<BATCHED>(w.offs, w.offs_stride, tn)[e];
      if (off < 0) continue;  // the same entry for every thread: no divergence
      row = (long long)(e / w.n_cand) * w.tile + off;
    }
    seg_power_tile(at_tenant<BATCHED>(p.y, p.y_stride, tn) + row * p.d, w.L, p.d, w.cos, w.sin,
                   w.F, f0, j0,
                   p.detrend, psd, smem);
  }

  float* out = at_tenant<BATCHED>(w.part, w.part_stride, tn) + (size_t)g * w.F * p.d;
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

// One Welch member's CTA, on the member's path.
template <bool BATCHED>
static __device__ void welch_member_role(const PlanParams& p, const WelchMember& w, int cta,
                                         int tn, float* smem) {
  if (w.fft) {
    welch_fft_role<BATCHED>(p, w, cta, tn, smem);
  } else {
    welch_role<BATCHED>(p, w, cta, tn, smem);
  }
}

// ----------------------------------------------------- launch configuration
// Dynamic shared memory of a launch: the most that any of its roles needs.
// `tile`: the lag role's channel tile (RT_TILE: lag_role).
static int plan_smem_bytes(const PlanParams& p, int tile, bool lag, bool mom, bool welch) {
  int floats = 0;
  if (lag && p.lag_ctas > 0)
    floats = max(floats, tile == RT_TILE ? RT_LAG_SMEM_FLOATS
                                         : RT_LAG_STAGES * small_lag_slot(tile));
  if (mom && p.mom_ctas > 0) floats = max(floats, RT_MOM_SMEM_FLOATS);
  if (welch)
    for (int j = 0; j < p.n_welch; ++j) {
      const WelchMember& w = p.welch[j];
      floats = max(floats, w.fft ? 2 * w.L * w.chan + RT_THREADS + RT_FFT_MAX_CHAN
                                 : RT_SMEM_FLOATS);
    }
  return floats * (int)sizeof(float);
}

// The grid of a batched launch: `batch` tenants of `tenant_ctas` role CTAs
// each, tenant-major in blockIdx.x; 0 if it does not fit a grid dimension.
static unsigned plan_grid(const PlanParams& p, int tenant_ctas) {
  const long long ctas = (long long)p.batch * tenant_ctas;
  return (p.batch >= 1 && ctas <= 0x7fffffffLL) ? (unsigned)ctas : 0u;
}

// The instantiation of a kernel template <bool BATCHED, int TW> for a
// launch: batched for a batch above 1, the lag tile by d (lag_tile).
#define RT_PICK_KERNEL(K, q)                                                          \
  ((q).batch > 1                                                                     \
       ? (lag_tile((q).d) == RT_SMALL_TILE ? K<true, RT_SMALL_TILE>                  \
          : lag_tile((q).d) == RT_MID_TILE ? K<true, RT_MID_TILE> : K<true, RT_TILE>) \
       : (lag_tile((q).d) == RT_SMALL_TILE ? K<false, RT_SMALL_TILE>                 \
          : lag_tile((q).d) == RT_MID_TILE ? K<false, RT_MID_TILE> : K<false, RT_TILE>))

// Lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB
// default only on request).
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// --------------------------------------------------- fixed-order reduction
struct ReduceSection {
  const float* part;  // per tenant: (n_parts, count), tenants part_stride apart
  float* out;         // per tenant: (count,), tenants out_stride apart
  int n_parts, count, batch;
  long long part_stride, out_stride;
};

struct ReduceParams {
  ReduceSection s[RT_MAX_SECTIONS];
  int n;
};

// Each output sums its partials in the order q = 0, 1, ...  One problem:
// the 32-bit loop of the one-problem reduction (a 64-bit index made it 2.5-4
// times slower at the main path's shapes; PERF.md).  A batch: entry
// e of the section's batch * count outputs is tenant e / count, entry e %
// count, in 64 bits.
template <bool BATCHED>
static __global__ void __launch_bounds__(RT_THREADS)
reduce_parts_kernel(ReduceParams r) {
  const ReduceSection s = r.s[blockIdx.y];
  if (!BATCHED) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < s.count;
         e += gridDim.x * blockDim.x) {
      float acc = 0.f;
      for (int q = 0; q < s.n_parts; ++q) acc += s.part[(size_t)q * s.count + e];
      s.out[e] = acc;
    }
    return;
  }
  const long long total = (long long)s.batch * s.count;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long tn = e / s.count;
    const int i = (int)(e - tn * s.count);
    const float* part = s.part + tn * s.part_stride + i;
    float acc = 0.f;
    for (int q = 0; q < s.n_parts; ++q) acc += part[(size_t)q * s.count];
    s.out[tn * s.out_stride + i] = acc;
  }
}

// Sums each family's partials of a launch in order; one launch for all.
static cudaError_t reduce_families(const PlanParams& p, bool lag, bool mom,
                                   cudaStream_t stream) {
  ReduceParams r;
  r.n = 0;
  long long most = 1;
  auto add = [&](const float* part, float* out, int n_parts, int count,
                 long long part_stride, long long out_stride) {
    r.s[r.n].part = part;
    r.s[r.n].out = out;
    r.s[r.n].n_parts = n_parts;
    r.s[r.n].count = count;
    r.s[r.n].batch = p.batch;
    r.s[r.n].part_stride = part_stride;
    r.s[r.n].out_stride = out_stride;
    ++r.n;
    const long long total = (long long)p.batch * count;
    most = total > most ? total : most;
  };
  if (lag && p.lag_part != p.lag_out)  // else the lag CTAs wrote the sums
    add(p.lag_part, p.lag_out, p.lag_slabs, (p.H + 1) * p.d * p.d, p.lag_part_stride,
        p.lag_out_stride);
  if (mom && p.K > 0)
    add(p.mom_part, p.mom_out, p.mom_slabs, p.K * 2 * p.d, p.mom_part_stride,
        p.mom_out_stride);
  for (int j = 0; j < p.n_welch; ++j) {
    const WelchMember& w = p.welch[j];
    add(w.part, w.out, w.n_groups, w.F * p.d, w.part_stride, w.out_stride);
  }
  if (r.n == 0) return cudaSuccess;
  long long blocks = (most + RT_THREADS - 1) / RT_THREADS;
  blocks = blocks > 1024 ? 1024 : blocks;
  auto kernel = p.batch > 1 ? reduce_parts_kernel<true> : reduce_parts_kernel<false>;
  kernel<<<dim3((unsigned)blocks, r.n), RT_THREADS, 0, stream>>>(r);
  return cudaGetLastError();
}
