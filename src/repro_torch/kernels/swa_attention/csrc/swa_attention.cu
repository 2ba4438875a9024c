// Sliding-window causal attention for Hopper (sm_90a), bf16 and fp32.
//
// Replaces src/repro/kernels/swa_attention/kernel.py: swa_attention_pallas
// (body _kernel): out[b, q, h] = softmax_k(q . k / sqrt(D)) v over the keys
// k in (q - W, q], with f32 accumulation and the output in the input's type.
//
// Contract (the port's own, not the TPU kernel's): q (B, S, H, D) and k, v
// (B, S, KVH, D) as the projections produce them, out (B, S, H, D); query
// head h reads KV head h / G, G = H / KVH.  No transpose, no repeat of K/V
// to H heads, no padding of S: every load and store is masked against the
// true S and D.
//
// Bound on the H100: operations.  At the serving prefill's shape (B, H, S,
// D) = (4, 32, 8000, 80), W = 4096, the 3.12e9 unmasked (q, k) pairs cost
// 4 D FLOP each, 1.0 TFLOP (1.01 ms at the 989 TFLOP/s bf16 peak), against
// 0.41 GB moved (0.12 ms).  So the bf16 kernel runs both products on the
// tensor cores (mma.sync m16n8k16, f32 accumulation).
//
// bf16 design: the S*G (position, head) rows of one (b, KV head) are
// flattened, f = s G + g, and one CTA of 8 warps takes 128 consecutive rows
// (32 positions x the 4 heads of an h2o-danube KV head), each warp 16 rows.
// Every K/V tile of 64 keys is staged into shared memory once for all the
// CTA's heads, and the CTA walks only the tiles that meet its rows' windows,
// [max(0, s_lo - W + 1), s_hi]; a warp skips the products of a tile that
// lies wholly outside its own rows' windows (a fully masked tile changes
// neither m, l nor acc), and masks only the tiles that cross a window edge.
// The tiles come through a two-stage cp.async ring: the next tile's copy is
// in flight while this one is multiplied.  S = Q K^T and O += P V run on
// mma.sync, Q and K through ldmatrix, V through ldmatrix.trans; Q stays in
// shared memory so that a thread needs at most 128 registers and two CTAs
// share an SM (tools/kernel_variants/ holds the design variants timed).
// Shared-memory rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall in 8 distinct bank groups for any D that is a multiple of 16
// (D = 80 is 5 k-steps of 16).
//
// Numerics: the online softmax (m, l, acc) lives in f32 registers.  Masked
// logits take the reference's finite sentinel -1e30 and their
// probabilities are set to exactly 0 (with -INFINITY a row whose first tile
// is fully masked would give inf - inf = NaN); the output divides by l only
// where l > 0.  P is rounded to bf16 for the P V product (the tensor cores
// take bf16 operands), as the model's own path rounds its probabilities
// (repro/models/attention.py:133); l sums the unrounded f32 P.  Each output
// row is written by one CTA, without atomics: two launches are bitwise
// equal.
//
// fp32 design (SIMT FMA, for the f32 models; TF32 stays off): a CTA of 4
// warps takes 16 rows, 4 per warp; per tile of 32 keys staged in shared
// memory, lane j scores key j, the warp reduces max and sum by shuffles, and
// lane c accumulates output columns c, c + 32, c + 64, c + 96.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SWA_ROWS 128    // bf16: flattened rows per CTA, 16 per warp
#define SWA_KEYS 64     // bf16: keys per tile
#define SWA_THREADS 256
#define SWA_F32_ROWS 16  // fp32: rows per CTA, 4 per warp
#define SWA_F32_KEYS 32  // fp32: keys per tile, one per lane
#define SWA_MAX_D 128
#define SWA_NEG_INF (-1e30f)

struct SwaParams {
  const void* q;    // (B, S, H, D)
  const void* k;    // (B, S, KVH, D)
  const void* v;    // (B, S, KVH, D)
  void* out;        // (B, S, H, D)
  int B, S, H, KVH, D, G;
  int window;       // W >= 1: keys in (q - W, q]
  int dtype;        // 0: float32, 1: bfloat16
  float scale;      // logit scale, 1 / sqrt(D) by default
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte copy global -> shared in flight (cp.async); zero-filled when
// !full (the source address is then not read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying `rows` rows of a (.., D) bf16 operand into shared-memory
// rows of DK (+ 8 padding) elements, 16 bytes at a time; rows for which
// row_off returns < 0 and columns >= D are zero.
template <int DK, typename RowOff>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int rows, int D, RowOff row_off) {
  constexpr int LD = DK + 8;
  constexpr int CH = DK / 8;
  for (int c = threadIdx.x; c < rows * CH; c += SWA_THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const long long off = row_off(r);
    const bool ok = off >= 0 && col < D;
    cp_async16(dst + r * LD + col, ok ? src + off + col : src, ok);
  }
}

// Two CTAs per SM (128 registers a thread): Q stays in shared memory and
// its fragments are re-read with ldmatrix at every tile.
template <int DK>
static __global__ void __launch_bounds__(SWA_THREADS, 2) swa_bf16_kernel(SwaParams p) {
  constexpr int LD = DK + 8;
  constexpr int NT_S = SWA_KEYS / 8;  // key n-tiles of S
  constexpr int NT_O = DK / 8;        // column n-tiles of O
  constexpr int KS = DK / 16;         // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [SWA_ROWS][LD]
  __nv_bfloat16* kbuf = qs + SWA_ROWS * LD;                         // [2][SWA_KEYS][LD]
  __nv_bfloat16* vbuf = kbuf + 2 * SWA_KEYS * LD;                   // [2][SWA_KEYS][LD]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.G, S = p.S, D = p.D, W = p.window;
  const int rows_total = S * G;
  const int f0 = blockIdx.x * SWA_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.out);

  // the CTA's rows, their positions and the key tiles their windows reach
  const int f_last = min(f0 + SWA_ROWS, rows_total) - 1;
  const int s_lo = f0 / G, s_hi = f_last / G;
  const int kt0 = (max(0, s_lo - W + 1) / SWA_KEYS) * SWA_KEYS;
  const int n_tiles = (s_hi - kt0) / SWA_KEYS + 1;

  auto q_off = [&](int r) -> long long {
    const int f = f0 + r;
    if (f >= rows_total) return -1;
    return ((long long)(b * S + f / G) * p.H + kvh * G + f % G) * D;
  };
  auto stage_kv = [&](int kt, int buf) {
    auto kv_off = [&](int r) -> long long {
      const int j = kt + r;
      if (j >= S) return -1;
      return ((long long)(b * S + j) * p.KVH + kvh) * D;
    };
    stage_bf16<DK>(kbuf + buf * SWA_KEYS * LD, K, SWA_KEYS, D, kv_off);
    stage_bf16<DK>(vbuf + buf * SWA_KEYS * LD, V, SWA_KEYS, D, kv_off);
  };
  stage_bf16<DK>(qs, Q, SWA_ROWS, D, q_off);
  cp_async_commit();
  stage_kv(kt0, 0);
  cp_async_commit();

  // this warp's 16 rows, and the two rows of this thread (g and g + 8)
  const int wf0 = f0 + warp * 16;
  const bool warp_live = wf0 < rows_total;
  const int w_lo = wf0 / G, w_hi = min(wf0 + 15, rows_total - 1) / G;
  const int fa = wf0 + lane / 4, fb = fa + 8;
  const int pos_a = fa / G, pos_b = fb / G;
  const int t2 = 2 * (lane % 4);
  const __nv_bfloat16* q_lane =
      qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);

  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = SWA_NEG_INF, m_b = SWA_NEG_INF, l_a = 0.f, l_b = 0.f;
  const float scale2 = p.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt0 + it * SWA_KEYS;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy flies while this one is used
      stage_kv(kt + SWA_KEYS, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kbuf + buf * SWA_KEYS * LD;
    const __nv_bfloat16* vs = vbuf + buf * SWA_KEYS * LD;
    if (warp_live && kt <= w_hi && kt + SWA_KEYS - 1 >= w_lo - W + 1) {
      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float sc[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4];
        ldsm_x4(qf, q_lane + kk * 16);
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          uint32_t bk[4];
          const int key = np * 16 + (lane % 8) + 8 * (lane / 16);
          ldsm_x4(bk, ks + key * LD + kk * 16 + 8 * ((lane / 8) % 2));
          mma_bf16(sc[2 * np], qf, bk[0], bk[1]);
          mma_bf16(sc[2 * np + 1], qf, bk[2], bk[3]);
        }
      }

      // mask (only where the tile crosses a row's window edge), then the
      // online softmax in the log2 domain
      const bool inner = kt + SWA_KEYS - 1 <= w_lo && kt > w_hi - W;
      float mx_a = SWA_NEG_INF, mx_b = SWA_NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + j * 8 + t2 + (e & 1);
          const int pos = e < 2 ? pos_a : pos_b;
          const bool ok = inner || (key <= pos && key > pos - W);
          sc[j][e] = ok ? sc[j][e] * scale2 : SWA_NEG_INF;
        }
        mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + j * 8 + t2 + (e & 1);
          const int pos = e < 2 ? pos_a : pos_b;
          const bool ok = inner || (key <= pos && key > pos - W);
          const float pr = ok ? ex2(sc[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          sc[j][e] = pr;
          if (e < 2) sum_a += pr; else sum_b += pr;
        }
      }
      l_a = alpha_a * l_a + sum_a;  // this thread's columns; summed over the quad at the end
      l_b = alpha_b * l_b + sum_b;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        acc[j][0] *= alpha_a;
        acc[j][1] *= alpha_a;
        acc[j][2] *= alpha_b;
        acc[j][3] *= alpha_b;
      }

      // O += P V: P's accumulator fragments are the A operand, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < SWA_KEYS / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < NT_O / 2; ++dp) {
          uint32_t bv[4];
          const int key = kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
          ldsm_x4_trans(bv, vs + key * LD + dp * 16 + 8 * (lane / 16));
          mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  if (!warp_live) return;
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float div_a = l_a > 0.f ? l_a : 1.f, div_b = l_b > 0.f ? l_b : 1.f;
  const long long off_a = ((long long)(b * S + pos_a) * p.H + kvh * G + fa % G) * D;
  const long long off_b = ((long long)(b * S + pos_b) * p.H + kvh * G + fb % G) * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int col = j * 8 + t2;
    if (col >= D) continue;
    if (fa < rows_total)
      *reinterpret_cast<__nv_bfloat162*>(O + off_a + col) =
          __floats2bfloat162_rn(acc[j][0] / div_a, acc[j][1] / div_a);
    if (fb < rows_total)
      *reinterpret_cast<__nv_bfloat162*>(O + off_b + col) =
          __floats2bfloat162_rn(acc[j][2] / div_b, acc[j][3] / div_b);
  }
}

static __global__ void __launch_bounds__(128) swa_f32_kernel(SwaParams p) {
  __shared__ float qs[SWA_F32_ROWS][SWA_MAX_D];
  __shared__ float ks[SWA_F32_KEYS][SWA_MAX_D + 1];  // +1: lane j reads row j
  __shared__ float vs[SWA_F32_KEYS][SWA_MAX_D];
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.G, S = p.S, D = p.D, W = p.window;
  const int rows_total = S * G;
  const int f0 = blockIdx.x * SWA_F32_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* Q = static_cast<const float*>(p.q);
  const float* K = static_cast<const float*>(p.k);
  const float* V = static_cast<const float*>(p.v);
  float* O = static_cast<float*>(p.out);

  for (int i = threadIdx.x; i < SWA_F32_ROWS * D; i += blockDim.x) {
    const int r = i / D, c = i % D, f = f0 + r;
    qs[r][c] = f < rows_total
                   ? Q[((long long)(b * S + f / G) * p.H + kvh * G + f % G) * D + c]
                   : 0.f;
  }
  const int f_last = min(f0 + SWA_F32_ROWS, rows_total) - 1;
  const int s_lo = f0 / G, s_hi = f_last / G;
  const int k_begin = max(0, s_lo - W + 1);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = SWA_NEG_INF;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  for (int kt = (k_begin / SWA_F32_KEYS) * SWA_F32_KEYS; kt <= s_hi; kt += SWA_F32_KEYS) {
    __syncthreads();
    for (int i = threadIdx.x; i < SWA_F32_KEYS * D; i += blockDim.x) {
      const int r = i / D, c = i % D, j = kt + r;
      const long long off = ((long long)(b * S + j) * p.KVH + kvh) * D + c;
      ks[r][c] = j < S ? K[off] : 0.f;
      vs[r][c] = j < S ? V[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + warp * 4 + i;
      if (f >= rows_total) continue;  // warp-uniform
      const int pos = f / G, key = kt + lane;
      const bool ok = key <= pos && key > pos - W;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(qs[warp * 4 + i][c], ks[lane][c], s);
      s = ok ? s * p.scale : SWA_NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      const float pr = ok ? expf(s - mn) : 0.f;
      float sum = pr;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m[i] = mn;
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int col = lane + 32 * c4;
        float a = acc[i][c4] * alpha;
        for (int j = 0; j < SWA_F32_KEYS; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pr, j);
          if (col < D) a = fmaf(pj, vs[j][col], a);
        }
        acc[i][c4] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + warp * 4 + i;
    if (f >= rows_total) continue;
    const float div = l[i] > 0.f ? l[i] : 1.f;
    float* orow = O + ((long long)(b * S + f / G) * p.H + kvh * G + f % G) * D;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = lane + 32 * c4;
      if (col < D) orow[col] = acc[i][c4] / div;
    }
  }
}

template <int DK>
static int launch_bf16(const SwaParams* p, cudaStream_t st) {
  const int smem = (SWA_ROWS + 4 * SWA_KEYS) * (DK + 8) * (int)sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_bf16_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((p->S * p->G + SWA_ROWS - 1) / SWA_ROWS, p->KVH, p->B);
  swa_bf16_kernel<DK><<<grid, SWA_THREADS, smem, st>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int rt_swa_attention(const SwaParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p->D < 1 || p->D > SWA_MAX_D) return (int)cudaErrorInvalidValue;
  if (p->dtype == 0) {
    dim3 grid((p->S * p->G + SWA_F32_ROWS - 1) / SWA_F32_ROWS, p->KVH, p->B);
    swa_f32_kernel<<<grid, 128, 0, st>>>(*p);
    return (int)cudaGetLastError();
  }
  if (p->D % 8 != 0) return (int)cudaErrorInvalidValue;
  switch ((p->D + 15) / 16) {
    case 1: return launch_bf16<16>(p, st);
    case 2: return launch_bf16<32>(p, st);
    case 3: return launch_bf16<48>(p, st);
    case 4: return launch_bf16<64>(p, st);
    case 5: return launch_bf16<80>(p, st);
    case 6: return launch_bf16<96>(p, st);
    case 7: return launch_bf16<112>(p, st);
    default: return launch_bf16<128>(p, st);
  }
}

extern "C" int rt_swa_params_size() { return (int)sizeof(SwaParams); }
