// Lagged sums, fused lag + window moments and rolling window moments for
// Hopper (sm_90a), fp32 in, fp32 or fp64 accumulation.
//
// cross_lag_kernel replaces src/repro/kernels/window_stats/kernel.py:
// cross_window_stats_pallas (body _lag_kernel): S(h) = sum_k a_k b_{k+h}^T,
// h = 0..H.  lag_moments_sym_kernel (H = 0, one problem),
// lag_moments_batched_kernel (H = 0, a batch of tenants of up to 32
// channels) and fused_lag_moments_kernel (the rest) replace kernel.py:
// fused_lag_moments_pallas (body _fused_kernel): the masked lag sums plus
// the masked K-window moment sums, from one launch.
//
// Bound on the H100 of the lag sums at H > 0: operations.  At d = 64, H =
// 16 they are (H+1) * n * d^2 * 2 = 9.1 GFLOP of fp32 FMAs per 65,536
// starts against 17 MB of input, far above the card's fp32 ridge point.
// The (H+1, d, d) accumulator does not fit in one CTA's shared memory, so
// the work is split over (64 x 64 channel tile, group of up to three
// consecutive lags, slab of starts).  A CTA stages each step's rows once
// for its whole lag group through a cp.async ring and keeps a 4 x 4 register
// tile per lag, with a sliding window of the shifted rows (lag_role in
// stats_tiles.cuh).  At d <= 32 (the session's d = 16) the 64 x 64 tile is
// mostly padding, so cross_lag_kernel takes a tile sized by d there
// (small_lag_role: the whole tile and up to 17 lags in one CTA, one output
// column a thread).  Per-slab partials are summed in a fixed order by
// reduce_parts_kernel (no float atomics: runs are bit-identical).  The
// moment sums cost O(K) per row through exact window counts (see
// stats_tiles.cuh) and are bound by the one read of the rows.
//
// Every path of the port asks kernel 3 for H = 0 (a moments-only plan's
// chunks and merge boundaries, the moments finalize's tail), and there the
// function is small: S(0) = sum_{t: m_t} y_t y_t^T is symmetric, so it needs
// n d (d+1) operations (0.27 GFLOP at the main path's chunk, d = 64) against
// the same 17 MB, and the bound is the read of the series: the series is
// read once for both halves, only the distinct entries are computed, and
// nothing goes through device memory but the clusters' sums.
// lag_moments_sym_kernel does it in one launch:
//   * CTA = (pair of 64-channel tiles I <= J, slab of rows); the slabs of a
//     pair form clusters of up to LM_MAX_CLUSTER CTAs (16: above the
//     portable 8, which the H100 allows), and the grid is one wave: no more
//     clusters than the device holds at once (ops.sym_shape, from CUDA's
//     occupancy calculator).
//   * A CTA stages its rows once, through a cp.async ring of LM_STAGES
//     steps of LM_ROWS rows, the float4 slots of a row swizzled (lm_slot)
//     so that eight threads loading eight 8-channel blocks hit distinct
//     banks.  The slab's segments of the start mask's prefix count come
//     with the first step; they give the mask of each row and, converted
//     once, the exact window counts c_w(t) (moment_role's arithmetic).
//   * From the staged rows each thread accumulates an 8 x 8 register tile
//     of S(0) (16 floats of shared memory for 64 FMAs); a diagonal tile
//     pair has only its upper-triangular 8 x 8 blocks (36 of 64 at d = 64),
//     and the threads beyond one per block take further rows of the step
//     (row lanes).  A step whose rows are all valid starts runs unrolled,
//     without the mask test.  For I = J each thread also sums one channel's
//     moments over a row lane.
//   * The fixed-order reduction stays inside the launch: the row lanes in
//     order in shared memory; the slabs of a cluster in rank order through
//     distributed shared memory, CTA `rank` summing the rank-th share of
//     the entries; the clusters of a pair in order, share by share, by the
//     last CTA to arrive with that share, counted by an integer arrival
//     counter (acquire-release) that it resets, so a replayed CUDA graph
//     finds it at zero.  No float atomics: runs are bit-identical.
//   * Each upper entry is written to (i, j) and (j, i): S(0) is exactly
//     symmetric.
// At the chunk the loop's 128-bit shared-memory loads and its FMAs are in
// balance (4 loads per 64 FMAs a thread and row), and the reduction's chain
// of barriers and L2 round trips is a fixed cost of a few microseconds;
// PERF.md has the breakdown.
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
#include <cooperative_groups.h>

#include "stats_tiles.cuh"

namespace cg = cooperative_groups;

#define WM_UNROLL 8

struct MomentParams {
  const float* x;  // (n, d) series
  float* out;      // (n_out, 2, d), n_out = n - w + 1
  int n, d, w, n_out;
  int chain;       // starts per thread
  int ctas;        // ceil(ceil(n_out / chain) * d / RT_THREADS)
};

// Both PlanParams kernels take a batch of tenants on a tenant-major grid
// (stats_tiles.cuh); at batch 1 they are the one-problem launches.  Kernel 3
// at a batch above 1 runs here at H > 0, and at H = 0 above 32 channels
// (lag_moments_sym_kernel below is built for one large problem,
// lag_moments_batched_kernel for many small ones of up to 32 channels).
// cross_lag_kernel takes its lag role's tile by d (lag_tile: small_lag_role
// at d <= 32, where a 64 x 64 tile is mostly padding); kernel 3's two-role
// kernel keeps lag_role at every width.
template <bool BATCHED, int TW>
static __global__ void __launch_bounds__(RT_THREADS, RT_MIN_CTAS) cross_lag_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tn = BATCHED ? blockIdx.x / p.tenant_ctas : 0;
  lag_tile_role<TW, BATCHED>(p, blockIdx.x - tn * p.tenant_ctas, tn, smem);
}

template <bool BATCHED>
static __global__ void __launch_bounds__(RT_THREADS, RT_MIN_CTAS) fused_lag_moments_kernel(PlanParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tn = BATCHED ? blockIdx.x / p.tenant_ctas : 0;
  const int b = blockIdx.x - tn * p.tenant_ctas;
  if (b < p.lag_ctas) {
    lag_role<BATCHED>(p, b, tn, smem);
  } else {
    moment_role<BATCHED>(p, b - p.lag_ctas, tn, smem);
  }
}

extern "C" int rt_cross_lag_sums(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PlanParams q = *p;
  q.tenant_ctas = q.lag_ctas;
  const unsigned grid = plan_grid(q, q.tenant_ctas);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = plan_smem_bytes(q, lag_tile(q.d), true, false, false);
  auto kernel = RT_PICK_KERNEL(cross_lag_kernel, q);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, RT_THREADS, smem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(q, true, false, st);
}

extern "C" int rt_fused_lag_moments(const PlanParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PlanParams q = *p;
  q.tenant_ctas = q.lag_ctas + q.mom_ctas;
  const unsigned grid = plan_grid(q, q.tenant_ctas);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = plan_smem_bytes(q, RT_TILE, true, true, false);
  auto kernel = q.batch > 1 ? fused_lag_moments_kernel<true> : fused_lag_moments_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, RT_THREADS, smem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_families(q, true, true, st);
}

// ------------------------------------------------ kernel 3 at H = 0
// Design constants, chosen by timing their variants on the H100 (PERF.md);
// those the Python side needs are mirrored by _build.LAGMOM_CONSTANTS,
// checked at load.
#define LM_ROWS 56        // rows per ring step (a multiple of the 7 row lanes at d = 64)
#define LM_STAGES 2       // cp.async ring steps
#define LM_MAX_CLUSTER 16  // most CTAs (slabs) per cluster (above 8: non-portable, H100)
#define LM_MAX_SLAB 512   // most rows per CTA (its prefix-count segments in shared memory)
#define LM_MIN_CTAS 2     // CTAs per SM the kernel is built for (128 registers)
#define LM_BLK 8          // register tile: LM_BLK x LM_BLK entries of S(0) a thread
#define LM_MOM_LANES (RT_THREADS / RT_TILE)  // row lanes of the moment sums
#define LM_FAST_LANES 7   // row lanes of a full diagonal tile pair (256 threads / 36 blocks)
#define LM_RED_FLOATS (RT_THREADS * LM_BLK * LM_BLK)        // every thread's tile
#define LM_PART_FLOATS (RT_TILE * RT_TILE + 2 * RT_MAX_WINDOWS * RT_TILE)  // a CTA's partial

struct LagMomParams {
  const float* y;     // (rows, d) series
  const int* prefix;  // (n + 1,) prefix[i] = number of valid starts below i
  float* part;        // (pairs, groups, LM_PART_FLOATS) cluster partials (groups > 1)
  float* lag_out;     // (d, d) S(0)
  float* mom_out;     // (K, 2, d)
  int* arrive;        // (pairs, cluster) arrival counters: zero before and after a launch
  int n, d, rows, K;  // starts, channels, moment rows, windows
  int windows[RT_MAX_WINDOWS];
  int d_tiles, pairs;  // 64-channel tiles; tile pairs I <= J
  int slab;            // rows per CTA, at most LM_MAX_SLAB
  int cluster;         // CTAs per cluster: consecutive slabs of one tile pair
  int groups;          // clusters per tile pair
  int vec;             // 16-byte copies (d % 4 == 0, y 16-byte aligned)
};

// (a, b), a <= b, of entry `idx` of the upper triangle of a T x T grid, row
// by row (a = 0 holds b = 0..T-1, a = 1 holds b = 1..T-1, ...).
__device__ __forceinline__ void upper_pair(int idx, int T, int& a, int& b) {
  a = 0;
  while (idx >= T - a) {
    idx -= T - a;
    ++a;
  }
  b = a + idx;
}

__host__ __device__ __forceinline__ int lm_round4(int x) { return (x + 3) & ~3; }

// The arrival count of one share of a tile pair's sums: an integer add with
// acquire-release semantics at device scope.  The CTA barrier before it
// orders every thread's stores of the share before the release; the last
// arriver's acquire, and its CTA barrier after, order them before its reads.
__device__ __forceinline__ int arrive_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// A cluster barrier in two halves: arrive when this CTA has read what it
// needs of the others' shared memory, wait before it may leave.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Dynamic shared memory, in floats: the ring (or, after the loop, every
// thread's tile for the row-lane sum), the CTA's partial, the slab's
// segments of the prefix count ([K + 1][slab + 1] ints) and the arrival
// flag.
__host__ __device__ __forceinline__ int lm_ring_floats(const LagMomParams& p) {
  return LM_STAGES * LM_ROWS * RT_TILE * (p.pairs > 1 ? 2 : 1);
}
__host__ __device__ __forceinline__ int lm_smem_floats(const LagMomParams& p) {
  const int ring = lm_ring_floats(p);
  return (ring > LM_RED_FLOATS ? ring : LM_RED_FLOATS) + LM_PART_FLOATS +
         lm_round4((p.K + 1) * (p.slab + 1)) + 4;
}

// The CTA's view of its tile pair: channel offsets, 8 x 8 blocks and row lanes.
struct LmTile {
  int i0, j0;     // first channels of tiles I and J
  bool diag;      // I == J: upper blocks only, and the moment sums
  int nbi, nbj;   // 8-channel blocks of tiles I and J below d
  int nblk;       // the pair's blocks: nbi (nbi + 1) / 2 or nbi nbj
  __device__ LmTile(const LagMomParams& p, int pair) {
    int I, J;
    upper_pair(pair, p.d_tiles, I, J);
    diag = I == J;
    i0 = I * RT_TILE;
    j0 = J * RT_TILE;
    nbi = (min(RT_TILE, p.d - i0) + LM_BLK - 1) / LM_BLK;
    nbj = (min(RT_TILE, p.d - j0) + LM_BLK - 1) / LM_BLK;
    nblk = diag ? nbi * (nbi + 1) / 2 : nbi * nbj;
  }
  // block `b` of the pair -> (block row, block column)
  __device__ void block(int b, int& bi, int& bj) const {
    if (diag) {
      upper_pair(b, nbi, bi, bj);
    } else {
      bi = b / nbj;
      bj = b % nbj;
    }
  }
};

// Writes entry e of a tile pair's summed partial to its place in the
// output.  Entries [0, 64 nblk): entry q = 8 r + c of block b at e = q nblk +
// b, written to (i, j) and (j, i), the lower half of a diagonal block
// skipped (its mirror is written); then, for a diagonal pair, (2k + moment)
// * 64 + channel of the moment sums.
__device__ __forceinline__ void lm_store(const LagMomParams& p, const LmTile& t, int e,
                                         float v) {
  const int E = t.nblk * LM_BLK * LM_BLK;
  if (e < E) {
    const int q = e / t.nblk;
    int bi, bj;
    t.block(e % t.nblk, bi, bj);
    const int r = q / LM_BLK, c = q % LM_BLK;
    if (t.diag && bi == bj && r > c) return;
    const int i = t.i0 + bi * LM_BLK + r, j = t.j0 + bj * LM_BLK + c;
    if (i < p.d && j < p.d) {
      p.lag_out[(size_t)i * p.d + j] = v;
      p.lag_out[(size_t)j * p.d + i] = v;
    }
  } else {
    const int em = e - E, c = t.i0 + em % RT_TILE;
    if (c < p.d) p.mom_out[(size_t)(em / RT_TILE) * p.d + c] = v;
  }
}

// Entries [e0, e1) of a tile pair's sums over its clusters' stored sums, in
// cluster order, written to the output (L2 loads: other SMs stored them).
__device__ __forceinline__ void lm_share_sum(const LagMomParams& p, const LmTile& t, int pair,
                                             int e0, int e1) {
  const float* first = p.part + (size_t)pair * p.groups * LM_PART_FLOATS;
  for (int e = e0 + threadIdx.x; e < e1; e += RT_THREADS) {
    float v = 0.f;
    for (int q0 = 0; q0 < p.groups; q0 += 32) {  // 32 loads in flight, summed in order
      float x[32];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        x[j] = q0 + j < p.groups ? __ldcg(first + (size_t)(q0 + j) * LM_PART_FLOATS + e) : 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (q0 + j < p.groups) v += x[j];
    }
    lm_store(p, t, e, v);
  }
}

// sum_{l < lanes} x[l * stride], in order l = 0, 1, ..., eight loads in flight.
__device__ __forceinline__ float lanes_sum(const float* x, int stride, int lanes) {
  float v = 0.f;
  for (int l0 = 0; l0 < lanes; l0 += 8) {
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = l0 + j < lanes ? x[(l0 + j) * stride] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (l0 + j < lanes) v += y[j];
  }
  return v;
}

// Window k of the launch (an unrolled select: a dynamic index into the
// parameter struct would copy it to local memory).
template <typename Params>
__device__ __forceinline__ int lm_window(const Params& p, int k) {
  int w = 0;
#pragma unroll
  for (int q = 0; q < RT_MAX_WINDOWS; ++q)
    if (q == k) w = p.windows[q];
  return w;
}

// The float4 slot of a staged 64-channel row that holds channels 4f ..
// 4f + 3: in the upper half the two float4 of each 8-channel block swap
// places, so that the first float4 of the row's eight blocks lie in eight
// distinct groups of banks (eight threads loading eight blocks: one
// wavefront, not two).
__host__ __device__ __forceinline__ int lm_slot(int f) { return f ^ ((f >> 3) & 1); }

// Starts copying rows [0, LM_ROWS) of the 64-channel tile at column c0 into
// shared rows of RT_TILE floats, the float4 slots swizzled by lm_slot: as
// stage_rows, a negative src_row(r) or a column at or past d gives zeros.
template <typename RowOf>
__device__ __forceinline__ void lm_stage_rows(float* dst, const float* src, int d, int c0,
                                              bool vec, RowOf src_row) {
  if (vec) {
    for (int e = threadIdx.x; e < LM_ROWS * (RT_TILE / 4); e += RT_THREADS) {
      const int r = e / (RT_TILE / 4), c = 4 * (e % (RT_TILE / 4));
      const long long row = src_row(r);
      const bool ok = row >= 0 && c0 + c < d;
      cp_async16(dst + r * RT_TILE + 4 * lm_slot(c >> 2), ok ? src + row * d + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < LM_ROWS * RT_TILE; e += RT_THREADS) {
      const int r = e / RT_TILE, c = e % RT_TILE;
      const long long row = src_row(r);
      const bool ok = row >= 0 && c0 + c < d;
      cp_async4(dst + r * RT_TILE + 4 * lm_slot(c >> 2) + (c & 3),
                ok ? src + row * d + c0 + c : src, ok);
    }
  }
}

// acc += a b^T for one staged row: a and b the thread's 8 channels of tiles
// I and J, two float4 each at the offsets oa and ob in the staged rows a_row
// and b_row (16 floats of shared memory for 64 FMAs).
__device__ __forceinline__ void lag_row(const float* a_row, const float* b_row, int2 oa, int2 ob,
                                        float acc[LM_BLK][LM_BLK]) {
  const float4 a0 = *reinterpret_cast<const float4*>(a_row + oa.x);
  const float4 a1 = *reinterpret_cast<const float4*>(a_row + oa.y);
  const float4 b0 = *reinterpret_cast<const float4*>(b_row + ob.x);
  const float4 b1 = *reinterpret_cast<const float4*>(b_row + ob.y);
  const float av[LM_BLK] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[LM_BLK] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < LM_BLK; ++i)
#pragma unroll
    for (int j = 0; j < LM_BLK; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}
static_assert(LM_ROWS % LM_FAST_LANES == 0, "a full step gives each row lane the same rows");

// CTA -> (tile pair, cluster of that pair, rank): blockIdx.x = (pair *
// groups + g) * cluster + rank; the CTA's slab of rows is g * cluster + rank
// (tests/test_torch_lagmom_plan.py models the walk).  KW >= K: the moment
// sums a thread keeps in registers (the main path's K = 1 and 2 need no
// more, so the 8 x 8 tile fits the 128 registers of two CTAs per SM).
template <int KW>
static __global__ void __launch_bounds__(RT_THREADS, LM_MIN_CTAS)
lag_moments_sym_kernel(LagMomParams p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int cl = blockIdx.x / C;
  const int pair = cl / p.groups, g = cl % p.groups;
  const int slab = g * C + rank;
  const LmTile t(p, pair);
  // the blocks of S(0) in row lanes (lane >= lanes: none); the moment sums
  // of channel col in row lane mlane
  const int lanes = RT_THREADS / t.nblk;
  const int blk = threadIdx.x % t.nblk, lane = threadIdx.x / t.nblk;
  const int col = threadIdx.x % RT_TILE, mlane = threadIdx.x / RT_TILE;
  const int mcol = 4 * lm_slot(col >> 2) + (col & 3);  // channel col's place in a staged row
  int bi, bj;
  t.block(blk, bi, bj);
  // the offsets of the thread's blocks in a staged row: two float4 each
  const int2 oa = make_int2(4 * lm_slot(2 * bi), 4 * lm_slot(2 * bi + 1));
  const int2 ob = make_int2(4 * lm_slot(2 * bj), 4 * lm_slot(2 * bj + 1));

  const int stage = lm_ring_floats(p) / LM_STAGES;
  const int ring = lm_ring_floats(p);
  float* part_s = smem + (ring > LM_RED_FLOATS ? ring : LM_RED_FLOATS);
  // the slab's prefix counts: pre[i] = prefix[s0 + i] and, for window k,
  // pre[(k + 1) (slab + 1) + i] = prefix[s0 + i + 1 - w_k], clamped to [0, n]
  int* pre = reinterpret_cast<int*>(part_s + LM_PART_FLOATS);
  int* flag = pre + lm_round4((p.K + 1) * (p.slab + 1));

  // rows [s0, s1): the moment rows, or for an off-diagonal pair the starts
  const int s0 = slab * p.slab;
  const int s1 = min(s0 + p.slab, t.diag ? p.rows : min(p.rows, p.n));
  const int len = max(s1 - s0, 0);
  const int steps = (len + LM_ROWS - 1) / LM_ROWS;

  auto issue = [&](int s) {
    float* As = smem + (s % LM_STAGES) * stage;
    const int r0 = s0 + s * LM_ROWS;
    auto row_of = [&](int r) -> long long { return r0 + r < s1 ? r0 + r : -1; };
    lm_stage_rows(As, p.y, p.d, t.i0, p.vec != 0, row_of);
    if (!t.diag) lm_stage_rows(As + LM_ROWS * RT_TILE, p.y, p.d, t.j0, p.vec != 0, row_of);
  };
  // the prefix counts come with the first step's rows: the start mask of
  // row t is pre[t + 1] - pre[t], its window counts c_w(t) = pre[t + 1] -
  // prefix[t + 1 - w] (moment_role's arithmetic)
  const int n_w = t.diag ? p.K : 0;
  for (int e = threadIdx.x; e < (n_w + 1) * (len + 1); e += RT_THREADS) {
    const int k = e / (len + 1) - 1, i = e % (len + 1);
    const int idx = k < 0 ? min(s0 + i, p.n) : min(max(s0 + i + 1 - lm_window(p, k), 0), p.n);
    cp_async4(pre + (k + 1) * (p.slab + 1) + i, p.prefix + idx, true);
  }
  for (int s = 0; s < LM_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  float acc[LM_BLK][LM_BLK];
#pragma unroll
  for (int i = 0; i < LM_BLK; ++i)
#pragma unroll
    for (int j = 0; j < LM_BLK; ++j) acc[i][j] = 0.f;
  float m1[KW], m2[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) m1[k] = m2[k] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<LM_STAGES - 2>();  // step s has landed (and with step 0 the prefix counts)
    __syncthreads();                 // ... for every thread; step s-1's slot is free
    if (s == 0 && t.diag) {
      // the window counts, once: prefix[t + 1] - prefix[t + 1 - w] as floats, in place
      for (int e = threadIdx.x; e < p.K * len; e += RT_THREADS) {
        int* slot = pre + (e / len + 1) * (p.slab + 1) + e % len;
        *reinterpret_cast<float*>(slot) = (float)(pre[e % len + 1] - *slot);  // exact below 2^24
      }
      __syncthreads();
    }
    if (s + LM_STAGES - 1 < steps) issue(s + LM_STAGES - 1);
    cp_async_commit();
    const float* As = smem + (s % LM_STAGES) * stage;
    const float* Bs = t.diag ? As : As + LM_ROWS * RT_TILE;
    const int r_end = min(LM_ROWS, len - s * LM_ROWS);
    const int* cnt = pre + s * LM_ROWS;  // cnt[r] = prefix[row r of the step]
    if (lanes == LM_FAST_LANES && r_end == LM_ROWS && s0 + (s + 1) * LM_ROWS <= p.n &&
               cnt[LM_ROWS] - cnt[0] == LM_ROWS) {
      // every row of the step a valid start: the thread's rows unrolled, no test
      if (lane < LM_FAST_LANES) {
        const float* a_row = As + lane * RT_TILE;
        const float* b_row = Bs + lane * RT_TILE;
#pragma unroll
        for (int j = 0; j < LM_ROWS / LM_FAST_LANES; ++j)
          lag_row(a_row + j * LM_FAST_LANES * RT_TILE, b_row + j * LM_FAST_LANES * RT_TILE, oa,
                  ob, acc);
      }
    } else if (lane < lanes) {
      for (int r = lane; r < r_end; r += lanes) {
        if (cnt[r + 1] == cnt[r]) continue;  // a masked start adds nothing
        lag_row(As + r * RT_TILE, Bs + r * RT_TILE, oa, ob, acc);
      }
    }
    if (t.diag) {
      // window k's counts at counts[k (slab + 1) + r]
      const float* counts = reinterpret_cast<const float*>(pre + p.slab + 1) + s * LM_ROWS;
      for (int r = mlane; r < r_end; r += LM_MOM_LANES) {
        const float v = As[r * RT_TILE + mcol], v2 = v * v;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          if (k < p.K) {
            const float wgt = counts[k * (p.slab + 1) + r];
            m1[k] = fmaf(wgt, v, m1[k]);
            m2[k] = fmaf(wgt, v2, m2[k]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read out: it now holds the row lanes' tiles

  // the row lanes in order: entry q = 8 r + c of block b is e = q nblk + b
  float* red = smem;
  const int E = t.nblk * LM_BLK * LM_BLK;
  if (lane < lanes) {
#pragma unroll
    for (int i = 0; i < LM_BLK; ++i)
#pragma unroll
      for (int j = 0; j < LM_BLK; ++j) red[lane * E + (i * LM_BLK + j) * t.nblk + blk] = acc[i][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += RT_THREADS) part_s[e] = lanes_sum(red + e, E, lanes);
  int total = E;
  if (t.diag) {  // the moment sums, their row lanes in order: (2k + moment) * 64 + channel
    const int M = 2 * p.K * RT_TILE;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      if (k < p.K) {
        red[mlane * M + (2 * k) * RT_TILE + col] = m1[k];
        red[mlane * M + (2 * k + 1) * RT_TILE + col] = m2[k];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < M; e += RT_THREADS)
      part_s[E + e] = lanes_sum(red + e, M, LM_MOM_LANES);
    total += M;
  }

  // the cluster's slabs in rank order, through distributed shared memory:
  // CTA `rank` sums its share of the entries
  cluster.sync();
  const int share = (total + C - 1) / C;
  const int e0 = rank * share, e1 = min(e0 + share, total);
  const float* src[LM_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < LM_MAX_CLUSTER; ++q)
    src[q] = q < C ? cluster.map_shared_rank(part_s, q) : part_s;
  float* mine = p.part + (size_t)cl * LM_PART_FLOATS;
  for (int e = e0 + threadIdx.x; e < e1; e += 2 * RT_THREADS) {
    // two entries, every rank's load in flight, then each sum in rank order
    const int f = e + RT_THREADS;
    float x[2][LM_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < LM_MAX_CLUSTER; ++q) {
      x[0][q] = q < C ? src[q][e] : 0.f;
      x[1][q] = q < C && f < e1 ? src[q][f] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < LM_MAX_CLUSTER; ++q)
        if (q < C) v += x[h][q];
      if (h == 0 || f < e1) {
        if (p.groups == 1) {
          lm_store(p, t, h ? f : e, v);
        } else {
          mine[h ? f : e] = v;
        }
      }
    }
  }
  cluster_arrive();  // this CTA is done with the others' shared memory
  if (p.groups > 1) {
    // share `rank` of the pair's clusters, in order, by the last to arrive with it
    __syncthreads();  // the CTA's stores of its share precede the count
    if (threadIdx.x == 0) {
      int* counter = p.arrive + pair * C + rank;
      const int last = arrive_acq_rel(counter) == p.groups - 1;
      if (last) *counter = 0;  // every cluster has counted: ready for the next launch
      *flag = last;
    }
    __syncthreads();
    if (*flag) lm_share_sum(p, t, pair, e0, e1);
  }
  cluster_wait();  // no CTA leaves while another may still read its shared memory
}


// The launch alone: an empty kernel on the grid, cluster and shared memory
// of a launch of lag_moments_sym_kernel (timed beside short launches,
// never on the path).
static __global__ void lag_moments_empty_kernel(LagMomParams) {}

// The launch's dynamic shared memory, allowed in full: two CTAs of up to
// 113 KB share an SM only with the carveout at its most shared memory.
template <typename Kern>
static cudaError_t lm_attributes(Kern kernel, int smem, int cluster) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {  // above the portable cluster size (H100: up to 16)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename Kern>
static int lm_launch(Kern kernel, const LagMomParams* p, void* stream) {
  const int smem = lm_smem_floats(*p) * (int)sizeof(float);
  cudaError_t err = lm_attributes(kernel, smem, p->cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->pairs * p->groups * p->cluster);
  cfg.blockDim = dim3(RT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, *p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static void (*lm_kernel(int K))(LagMomParams) {
  static_assert(RT_MAX_WINDOWS == 8, "lm_kernel instantiates KW = 1, 2, 4, 8");
  if (K == 1) return lag_moments_sym_kernel<1>;
  if (K == 2) return lag_moments_sym_kernel<2>;
  if (K <= 4) return lag_moments_sym_kernel<4>;
  return lag_moments_sym_kernel<8>;
}

extern "C" int rt_lag_moments_sym(const LagMomParams* p, void* stream) {
  if (p->cluster < 1 || p->cluster > LM_MAX_CLUSTER || p->slab > LM_MAX_SLAB ||
      p->K < 1 || p->K > RT_MAX_WINDOWS)
    return (int)cudaErrorInvalidValue;
  return lm_launch(lm_kernel(p->K), p, stream);
}

// out[0]: CTAs of the launch `p` that fit on one SM; out[1]: its clusters
// that can be resident at once on the device.
extern "C" int rt_lag_moments_occupancy(const LagMomParams* p, int* out) {
  void (*kernel)(LagMomParams) = lm_kernel(p->K);
  const int smem = lm_smem_floats(*p) * (int)sizeof(float);
  cudaError_t err = lm_attributes(kernel, smem, p->cluster);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, RT_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->pairs * p->groups * p->cluster);
  cfg.blockDim = dim3(RT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out + 1, kernel, &cfg);
}

extern "C" int rt_lag_moments_empty(const LagMomParams* p, void* stream) {
  return lm_launch(lag_moments_empty_kernel, p, stream);
}

// ------------------------------------- kernel 3 at H = 0, batched, d <= 32
// A multi-tenant session asks kernel 3 for many small problems of one
// shape: a query's moments tail (4,096 tenants of (158, 16)), a moments-only
// plan's chunk and merge boundary (65,536 tenants of (383, 16) and (254,
// 16)).  Bound on the H100: bytes (a tenant's rows are read once; S(0) needs
// d (d + 1) operations a valid start).  lag_moments_batched_kernel serves
// them in one launch, with no partials through device memory:
//   * A CTA owns `tenants` consecutive tenants, whole.  It copies a tenant's
//     rows [0, rows) once into shared memory (cp.async, 16-byte pieces when
//     d % 4 == 0: a tenant's rows are contiguous), rows of TW floats, the
//     channels past d zero, into one slot, which takes the next tenant's
//     copy as soon as this one's rows are summed (a ring of two or three
//     slots ran slower on the H100: fewer CTAs a SM).  A tenant's
//     start mask (bools) comes through registers, loaded a tenant ahead, and
//     is counted into the prefix count P in shared memory by a ballot a warp;
//     the window counts c_w(t) = P[min(t + 1, n)] - P[clamp(t + 1 - w, 0,
//     n)] (moment_role's arithmetic, exact integers) are converted once into
//     floats.  Both are built during the previous tenant's phases, so a
//     tenant takes three CTA barriers: its rows in; its row lanes in; the
//     next tenant's prefix count in.
//   * The tile is sized by d (lag_tile: TW = 16 channels up to 16, 32 up to
//     32).  S(0)'s upper-triangular 4 x 4 blocks (10 at TW = 16, 36 at 32)
//     go one to a thread, in `lanes` row lanes: lane l sums the valid starts
//     t = l, l + lanes, ... in ascending order, two float4 loads for 16 FMAs
//     a row; a masked start adds nothing (the symmetric path's rule: a
//     non-finite value in a masked start's row stays out of a tenant's S(0)
//     whether it is summed alone or in a batch).  The moment sums go
//     one channel to a thread, in RT_THREADS / TW row lanes over every row.
//   * The row lanes are summed in lane order in shared memory; each upper
//     entry of S(0) is stored to (i, j) and (j, i), each moment sum once.  No
//     float atomics, and nothing of a tenant's sums depends on the batch or
//     on the CTA that holds it: tenant i's outputs are bitwise the same in
//     any batch.
// Design constants (mirrored by _build.LAGMOM_CONSTANTS, checked at load):
#define LM_BATCH_SLOT 16384  // most floats of a tenant's staged rows (rows x TW)
#define LM_BATCH_BLK 4       // register tile of S(0): LM_BATCH_BLK x LM_BATCH_BLK entries a thread
#define LM_BATCH_MIN_CTAS 4  // CTAs per SM the kernel is built for (64 registers)

struct LagMomBatchParams {
  const float* y;             // (batch, rows, d) series
  const unsigned char* mask;  // (batch, n) start mask (bool)
  float* lag_out;             // (batch, d, d) S(0)
  float* mom_out;             // (batch, K, 2, d)
  int batch, n, d, rows, K;   // tenants, starts, channels, moment rows, windows
  int windows[RT_MAX_WINDOWS];
  int tenants;                // tenants per CTA (consecutive)
  int lanes;                  // row lanes of S(0)
  int vec;                    // 16-byte copies (d % 4 == 0, y 16-byte aligned)
};

// S(0)'s upper blocks at tile TW.
__host__ __device__ constexpr int lb_blocks(int tw) {
  return (tw / LM_BATCH_BLK) * (tw / LM_BATCH_BLK + 1) / 2;
}

// Dynamic shared memory, in floats: the slot of staged rows, the row
// lanes of S(0) and of the moment sums, the window counts as floats (K x
// rows), the prefix count (n + 1 ints), the valid starts of each warp in
// each of the mask's four rounds, and the start mask (n bytes).
__host__ __device__ __forceinline__ int lb_smem_floats(const LagMomBatchParams& p, int tw) {
  return p.rows * tw + p.lanes * lb_blocks(tw) * 16 + RT_THREADS * 2 * p.K +
         lm_round4(p.K * p.rows) + lm_round4(p.n + 1) + 4 * RT_THREADS / 32 +
         lm_round4((p.n + 3) / 4);
}

// acc += a b^T for one staged row: a and b the thread's LM_BATCH_BLK channels
// of S(0)'s block rows and columns.
__device__ __forceinline__ void lb_row(float4 a4, float4 b4,
                                       float acc[LM_BATCH_BLK][LM_BATCH_BLK]) {
  const float a[LM_BATCH_BLK] = {a4.x, a4.y, a4.z, a4.w};
  const float b[LM_BATCH_BLK] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int r = 0; r < LM_BATCH_BLK; ++r)
#pragma unroll
    for (int c = 0; c < LM_BATCH_BLK; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

template <int TW>
static __global__ void __launch_bounds__(RT_THREADS, LM_BATCH_MIN_CTAS)
lag_moments_batched_kernel(LagMomBatchParams p) {
  static_assert(RT_THREADS % TW == 0 && TW % LM_BATCH_BLK == 0, "tile layout");
  constexpr int NB = lb_blocks(TW);
  constexpr int ML = RT_THREADS / TW;  // row lanes of the moment sums
  constexpr int WARPS = RT_THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  const float* ys = smem;                         // [rows][TW] the staged tenant
  float* red_s = smem + p.rows * TW;             // [lanes][LM_BATCH_BLK][NB][LM_BATCH_BLK]
  float* red_m = red_s + p.lanes * NB * 16;      // [ML][2K][TW]
  float* cnt = red_m + RT_THREADS * 2 * p.K;     // [K][rows] window counts c_w(t)
  int* pre = reinterpret_cast<int*>(cnt + lm_round4(p.K * p.rows));  // [n + 1]
  int* wsum = pre + lm_round4(p.n + 1);          // [4][WARPS] valid starts a warp
  unsigned char* valid = reinterpret_cast<unsigned char*>(wsum + 4 * WARPS);  // [n]
  const int tn0 = blockIdx.x * p.tenants;
  const int count = min(p.tenants, p.batch - tn0);
  const int d = p.d;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;

  // thread x holds mask bytes x + RT_THREADS j, j < E <= 4 (n <= rows <= 1024)
  const int E = (p.n + RT_THREADS - 1) / RT_THREADS;
  unsigned char mb[4];
  int below[4];
  auto load_mask = [&](int tn) {
    const unsigned char* m = p.mask + (size_t)tn * p.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = threadIdx.x + RT_THREADS * j;
      mb[j] = j < E && idx < p.n ? m[idx] : 0;
    }
  };
  // the prefix count, in two halves around a barrier: each round j's valid
  // starts a warp (a ballot) and those below each thread within its warp;
  // then pre[idx + 1], the valid starts up to byte idx, and the mask itself
  auto count_warps = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned bits = __ballot_sync(0xffffffffu, mb[j] != 0);
      below[j] = __popc(bits & ((1u << wl) - 1u));
      if (j < E && wl == 0) wsum[j * WARPS + warp] = __popc(bits);
    }
  };
  auto build_prefix = [&]() {
    int run = 0;  // valid starts before byte threadIdx.x + RT_THREADS j
    for (int q = 0; q < warp; ++q) run += wsum[q];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = threadIdx.x + RT_THREADS * j;
      if (j < E && idx < p.n) {
        valid[idx] = mb[j] != 0;
        pre[idx + 1] = run + below[j] + (mb[j] != 0);
      }
      if (j + 1 < E)  // the rest of round j, and round j + 1's earlier warps
        for (int q = warp; q < WARPS + warp; ++q) run += wsum[j * WARPS + q];
    }
    if (threadIdx.x == 0) pre[0] = 0;
  };
  // the window counts c_w(t) = pre[min(t + 1, n)] - pre[clamp(t + 1 - w, 0, n)],
  // as floats (exact below 2^24)
  auto build_counts = [&]() {
    for (int k = 0; k < p.K; ++k) {
      const int w = lm_window(p, k);
      for (int t = threadIdx.x; t < p.rows; t += RT_THREADS)
        cnt[k * p.rows + t] = (float)(pre[min(t + 1, p.n)] - pre[min(max(t + 1 - w, 0), p.n)]);
    }
  };
  auto issue = [&](int tn) {
    float* dst = smem;
    const float* src = p.y + (size_t)tn * p.rows * d;
    if (p.vec && d == TW) {  // staged rows as they lie
      for (int e = threadIdx.x; e < p.rows * (TW / 4); e += RT_THREADS)
        cp_async16(dst + 4 * e, src + 4 * e, true);
    } else if (p.vec) {
      const int per_row = d / 4, total = p.rows * per_row;
      for (int e = threadIdx.x; e < total; e += RT_THREADS) {
        const int r = e / per_row;
        cp_async16(dst + r * TW + 4 * (e - r * per_row), src + 4 * e, true);
      }
    } else {
      for (int e = threadIdx.x; e < p.rows * d; e += RT_THREADS) {
        const int r = e / d;
        cp_async4(dst + r * TW + (e - r * d), src + e, true);
      }
    }
  };

  if (d < TW)  // the channels past d stay zero: no copy writes them
    for (int e = threadIdx.x; e < p.rows * TW; e += RT_THREADS) smem[e] = 0.f;
  load_mask(tn0);
  issue(tn0);
  cp_async_commit();
  // the first tenant's prefix count and window counts; each later tenant's
  // come in the phases of the one before
  count_warps();
  __syncthreads();
  build_prefix();
  __syncthreads();
  build_counts();

  int bi, bj;
  upper_pair(threadIdx.x % NB, TW / LM_BATCH_BLK, bi, bj);
  const int blk = threadIdx.x % NB, lane = threadIdx.x / NB;
  const int col = threadIdx.x % TW, mlane = threadIdx.x / TW;
  for (int i = 0; i < count; ++i) {
    const int tn = tn0 + i;
    if (i + 1 < count) load_mask(tn + 1);
    cp_async_wait<0>();  // this tenant's rows have landed
    __syncthreads();     // ... for every thread; its mask and window counts are in

    // S(0): the thread's block over its row lane's valid starts, ascending,
    // two rows' loads in flight
    if (lane < p.lanes) {
      float acc[LM_BATCH_BLK][LM_BATCH_BLK];
#pragma unroll
      for (int r = 0; r < LM_BATCH_BLK; ++r)
#pragma unroll
        for (int c = 0; c < LM_BATCH_BLK; ++c) acc[r][c] = 0.f;
      const float* oa = ys + LM_BATCH_BLK * bi;
      const float* ob = ys + LM_BATCH_BLK * bj;
      for (int t = lane; t < p.n; t += 2 * p.lanes) {
        const int u = t + p.lanes;
        const bool vt = valid[t], vu = u < p.n && valid[u];  // a masked start adds nothing
        const float4 at = *reinterpret_cast<const float4*>(oa + t * TW);
        const float4 bt = *reinterpret_cast<const float4*>(ob + t * TW);
        float4 au = at, bu = bt;
        if (vu) {
          au = *reinterpret_cast<const float4*>(oa + u * TW);
          bu = *reinterpret_cast<const float4*>(ob + u * TW);
        }
        if (vt) lb_row(at, bt, acc);
        if (vu) lb_row(au, bu, acc);
      }
#pragma unroll
      for (int r = 0; r < LM_BATCH_BLK; ++r)  // row r of the blocks: consecutive threads, consecutive float4
        reinterpret_cast<float4*>(red_s + (lane * LM_BATCH_BLK + r) * NB * LM_BATCH_BLK)[blk] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    // the moment sums: channel col over its row lane's rows, ascending
    {
      float m1[RT_MAX_WINDOWS], m2[RT_MAX_WINDOWS];
#pragma unroll
      for (int k = 0; k < RT_MAX_WINDOWS; ++k) m1[k] = m2[k] = 0.f;
#pragma unroll 4
      for (int t = mlane; t < p.rows; t += ML) {
        const float v = ys[t * TW + col], v2 = v * v;
#pragma unroll
        for (int k = 0; k < RT_MAX_WINDOWS; ++k) {
          if (k < p.K) {
            const float wgt = cnt[k * p.rows + t];
            m1[k] = fmaf(wgt, v, m1[k]);
            m2[k] = fmaf(wgt, v2, m2[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RT_MAX_WINDOWS; ++k) {
        if (k < p.K) {
          red_m[(mlane * 2 * p.K + 2 * k) * TW + col] = m1[k];
          red_m[(mlane * 2 * p.K + 2 * k + 1) * TW + col] = m2[k];
        }
      }
    }
    if (i + 1 < count) count_warps();  // the next tenant's
    __syncthreads();  // the row lanes are in; the slot is read out

    if (i + 1 < count) issue(tn + 1);  // into the slot this one left
    cp_async_commit();
    // the row lanes in order: S(0)'s upper entries (entry e = (r NB + block)
    // LM_BATCH_BLK + c of a lane) stored to (i, j) and (j, i); the moment sums
    // ((2k + moment) d + channel) stored
    float* lag = p.lag_out + (size_t)tn * d * d;
    float* mom = p.mom_out + (size_t)tn * 2 * p.K * d;
    for (int e = threadIdx.x; e < NB * 16 + 2 * p.K * d; e += RT_THREADS) {
      if (e >= NB * 16) {
        const int f = e - NB * 16;
        mom[f] = lanes_sum(red_m + (f / d) * TW + f % d, 2 * p.K * TW, ML);
        continue;
      }
      const int c = e % LM_BATCH_BLK, b = (e / LM_BATCH_BLK) % NB;
      const int r = e / (LM_BATCH_BLK * NB);
      int ei, ej;
      upper_pair(b, TW / LM_BATCH_BLK, ei, ej);
      const int row = LM_BATCH_BLK * ei + r, cl = LM_BATCH_BLK * ej + c;
      if ((ei == ej && r > c) || row >= d || cl >= d) continue;
      const float v = lanes_sum(red_s + e, NB * 16, p.lanes);
      lag[row * d + cl] = v;
      if (row != cl) lag[cl * d + row] = v;
    }
    if (i + 1 < count) {  // the next tenant's prefix count, then its window counts
      build_prefix();
      __syncthreads();
      build_counts();
    }
  }
  cp_async_wait<0>();
}

extern "C" int rt_lag_moments_batched(const LagMomBatchParams* p, void* stream) {
  const int tw = lag_tile(p->d);
  if (p->d < 1 || tw == RT_TILE || p->batch < 1 || p->n < 0 || p->n > p->rows ||
      p->rows * tw > LM_BATCH_SLOT || p->K < 1 || p->K > RT_MAX_WINDOWS || p->tenants < 1 ||
      p->lanes < 1 ||
      p->lanes * lb_blocks(tw) > RT_THREADS)
    return (int)cudaErrorInvalidValue;
  auto kernel = tw == RT_SMALL_TILE ? lag_moments_batched_kernel<RT_SMALL_TILE>
                                    : lag_moments_batched_kernel<RT_MID_TILE>;
  const int smem = lb_smem_floats(*p, tw) * (int)sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((p->batch + p->tenants - 1) / p->tenants);
  kernel<<<grid, RT_THREADS, smem, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int rt_lagmom_params_size() { return (int)sizeof(LagMomParams); }
extern "C" int rt_lagmom_batch_params_size() { return (int)sizeof(LagMomBatchParams); }

// The constants _build.LAGMOM_CONSTANTS mirrors, in its order (checked at load).
extern "C" void rt_lagmom_constants(int* out) {
  const int v[] = {LM_ROWS, LM_STAGES, LM_MAX_CLUSTER, LM_MAX_SLAB, LM_BLK, LM_BATCH_SLOT,
                   LM_BATCH_BLK};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
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
