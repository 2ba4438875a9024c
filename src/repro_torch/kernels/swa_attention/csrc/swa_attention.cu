// Sliding-window causal attention for Hopper (sm_90a), bf16 and fp32.
//
// Replaces src/repro/kernels/swa_attention/kernel.py: swa_attention_pallas
// (body _kernel): out[b, q, h] = softmax_k(q . k / sqrt(D)) v over the keys
// k in (q - W, q], with f32 accumulation and the output in the input's type.
//
// Contract (the port's own, not the TPU kernel's): q (B, S, H, D) and k
// (B, S, KVH, D), v (B, S, KVH, DV) as the projections produce them, out
// (B, S, H, DV); query head h reads KV head h / G, G = H / KVH.  D (q and
// k) is at most 192 and DV at most 128: multi-head latent attention
// (deepseek-v2) attends with q/k of 192 (nope 128 + rope 64) and v of 128,
// and every GQA model with one D <= 128 for the three.  No transpose, no
// repeat of K/V to H heads, no padding of S: every load and store is
// masked against the true S, D and DV.
//
// Bound on the H100: operations.  At the serving prefill's shape (B, H, S,
// D) = (4, 32, 8000, 80), W = 4096, the 3.12e9 unmasked (q, k) pairs cost
// 4 D FLOP each, 1.0 TFLOP (1.01 ms at the 989 TFLOP/s bf16 peak), against
// 0.41 GB moved (0.12 ms).  Beside the products, each pair costs one ex2 on
// the SFU (16 a clock per SM: about 0.75 ms at 1.98 GHz), so a design that
// runs the softmax after the products cannot get below about 1.8 ms; this
// one overlaps them.  Measured on an H100 SXM at 700 W (PERF.md), this
// design runs at about 2.2-2.3 ms, and with parts compiled out
// (tools/kernel_variants/variants_bench.py) the softmax alone takes 1.68
// ms, the K/V stream alone 1.51 (every CTA reads its whole window of K and
// V from L2, 5.3 GB a prefill layer) and the two products alone 0.68 and
// 1.04 ms.  Three consumer warpgroups (192 rows a CTA) cut that stream by a
// third against two; 64-key tiles keep their S accumulators within the 160
// registers a consumer thread has at 512 threads.  At deepseek-v2's prefill
// (q/k (4, 8000, 128, 192), v of 128, G = 1, W = S: 10.49 TFLOP, 10.60 ms)
// it measured 19.7 ms (PERF.md): at G = 1 every CTA streams its head's whole
// prefix from L2.
//
// bf16 design (FlashAttention-3's shape): the S*G (position, head) rows of
// one (b, KV head) are flattened, f = s G + g, and one CTA takes SWA_ROWS
// consecutive rows: SWA_CONSUMERS consumer warpgroups of 64 rows each, and
// one producer warpgroup.
//  - The producer (one thread, its warpgroup's registers given up with
//    setmaxnreg.dec) keeps K and V tiles of SWA_KEYS keys in flight by TMA
//    through a ring of SWA_STAGES stages with full / empty mbarriers.  The
//    tensor maps are rank 4 over (D, KVH, S, B); a box is (16, 1, SWA_KEYS,
//    1): one panel of 16 columns (32 bytes) at a 32-byte swizzle.  Keys
//    j >= S and columns >= D come back zero-filled from the box edge.
//  - D is split into DK / 16 panels (DK = D rounded up to 16): panel p
//    holds columns [16 p, 16 p + 16) of every row, 32 bytes a row, and is
//    exactly one k-step of Q K^T.  V's DV / 16 panels (DV rounded up
//    likewise) serve P V as an MN-major B operand (wgmma's transpose bit):
//    the leading byte offset steps from panel to panel along DV, the stride
//    byte offset from 8 keys to the next.  So any D and DV that are
//    multiples of 8 take one layout; the columns past the true D (DV) are
//    zero in Q and K (V).
//  - One instantiation per (DK, DV): (16, 16) to (128, 128) in steps of 16,
//    and (192, 128); a shape runs in the smallest one that covers both
//    widths (its columns past the true widths read as zero).  The ring
//    keeps SWA_STAGES stages where they fit beside Q in a block's 227 KB,
//    so every D <= 128 keeps 4; at (192, 128) Q takes 72 KB and a K and V
//    stage 40 KB, and the ring 3.
//  - Q's flattened rows form no TMA box when G does not divide 64, so each
//    consumer warpgroup stages its own 64 rows once with 16-byte loads into
//    the same swizzled panels.
//  - Each consumer warpgroup computes S = Q K^T as wgmma m64nSWA_KEYSk16
//    (Q and K from shared memory), the online softmax on the accumulator
//    fragments (f32, log2 domain), and O += P V as wgmma m64nDKk16 with P
//    converted in registers from the S accumulator into the A operand.  O
//    (64 x DV f32) stays in registers.
//  - Overlap: the next tile's Q K^T and this tile's P V are issued
//    together, and the softmax of the next tile runs while P V is in
//    flight; the consumer warpgroups take turns to issue their products
//    through named barriers, so one warpgroup's exponentials run under
//    another's wgmma.
//  - The CTA walks only the key tiles its rows reach, [max(0, s_lo - W +
//    1), s_hi]; a warpgroup skips the products of a tile wholly outside its
//    own rows' windows and masks only the tiles that cross a window edge.
//    Row blocks run in reverse order, so the CTAs with full windows start
//    first and those with s < W (less work) fill the tail.
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
// warps takes 16 rows, 4 per warp; per tile of 32 keys staged in dynamic
// shared memory (53 KB at D = 192, DV = 128: above the 48 KB of static
// arrays), lane j scores key j, the warp reduces max and sum by shuffles,
// and lane c accumulates output columns c, c + 32, c + 64, c + 96.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Design constants of the bf16 path (those the Python side mirrors are
// checked at load through rt_swa_constants).
#define SWA_KEYS 64        // keys per K/V tile: the N of S = Q K^T
#define SWA_STAGES 4       // K/V tiles in the ring
#define SWA_CONSUMERS 3    // consumer warpgroups, 64 flattened rows each
#define SWA_PANEL 16       // D columns per shared-memory panel: 32 bytes, one k-step
#define SWA_WG_ROWS 64     // flattened rows per consumer warpgroup (wgmma's M)
#define SWA_ROWS (SWA_WG_ROWS * SWA_CONSUMERS)
#define SWA_THREADS (128 * (SWA_CONSUMERS + 1))
// setmaxnreg moves registers within the CTA's launch allocation, 128 a
// thread at 512 threads: the producer keeps 24, and each consumer warpgroup
// takes (128 x 4 - 24) / 3 = 162, rounded down to a multiple of 8
#define SWA_PRODUCER_REGS 24
#define SWA_CONSUMER_REGS 160
#define SWA_F32_ROWS 16  // fp32: rows per CTA, 4 per warp
#define SWA_F32_KEYS 32  // fp32: keys per tile, one per lane
#define SWA_MAX_D 192       // q and k head dim
#define SWA_MAX_DV 128      // v head dim
#define SWA_SMEM_MAX 232448  // shared memory a block may take (227 KB)
#define SWA_NEG_INF (-1e30f)
#define SWA_FLT_MAX 3.402823466e38f

struct SwaParams {
  const void* q;    // (B, S, H, D)
  const void* k;    // (B, S, KVH, D)
  const void* v;    // (B, S, KVH, DV)
  void* out;        // (B, S, H, DV)
  int B, S, H, KVH, D, DV, G;
  int window;       // W >= 1: keys in (q - W, q]
  int dtype;        // 0: float32, 1: bfloat16
  float scale;      // logit scale, 1 / sqrt(D) by default
};

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// Wait for the completion of the barrier's phase of this parity.
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

// TMA: one box of a rank-4 tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// named barriers of the consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers to this point: reads of a wgmma's accumulator stay after
// the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 3
// (32-byte swizzle).  K-major (Q, K): 8-row groups SBO = 256 bytes apart,
// LBO unused (1).  MN-major (V): 8-key groups SBO = 256 bytes apart, the
// 16-column panels LBO apart.
__device__ __forceinline__ uint64_t sw32_desc(const void* ptr, uint32_t lbo_bytes) {
  const uint64_t a = smem_addr(ptr);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
}

// Byte offset of element (row, col) in a stack of 32-byte-swizzled panels
// of `rows` rows: panel col / 16, row r at 32 r, and its two 16-byte halves
// swapped in rows 4-7 of every 8 (bit 4 of the address ^= bit 7).
__device__ __forceinline__ int sw32_offset(int row, int col, int rows) {
  const int half = ((col >> 3) & 1) ^ ((row >> 2) & 1);
  return (col >> 4) * rows * 32 + row * 32 + half * 16 + (col & 7) * 2;
}

// S (64 x SWA_KEYS, f32) = / += A (64 x 16) B (16 x SWA_KEYS), A and B from
// shared memory, both K-major; acc = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// O (64 x N, f32) += P (64 x 16, bf16 registers) V (16 x N), V from shared
// memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <bool B>
struct Masked {
  static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- bf16 --

// The CTA's rows and key tiles.  Row blocks run in reverse (blockIdx.x 0
// takes the last rows): full windows first.
struct SwaTiles {
  int f0, kt0, n_tiles;
};

__device__ __forceinline__ SwaTiles swa_tiles(const SwaParams& p) {
  const int rows_total = p.S * p.G;
  const int n_blocks = (rows_total + SWA_ROWS - 1) / SWA_ROWS;
  SwaTiles t;
  t.f0 = (n_blocks - 1 - (int)blockIdx.x) * SWA_ROWS;
  const int f_last = min(t.f0 + SWA_ROWS, rows_total) - 1;
  const int s_lo = t.f0 / p.G, s_hi = f_last / p.G;
  t.kt0 = (max(0, s_lo - p.window + 1) / SWA_KEYS) * SWA_KEYS;
  t.n_tiles = (s_hi - t.kt0) / SWA_KEYS + 1;
  return t;
}

// Shared memory of the (DK, DV) instantiation: Q's panels, then the ring
// of K tiles, the ring of V tiles and the full / empty barriers.  The ring
// keeps SWA_STAGES stages where they fit, else as many as fit.
template <int DK, int DV>
struct SwaSmem {
  static constexpr int K_PANELS = DK / SWA_PANEL;
  static constexpr int V_PANELS = DV / SWA_PANEL;
  static constexpr int Q_BYTES = K_PANELS * SWA_ROWS * 32;
  static constexpr int K_BYTES = K_PANELS * SWA_KEYS * 32;  // one K tile
  static constexpr int V_BYTES = V_PANELS * SWA_KEYS * 32;  // one V tile
  static constexpr int ALIGN = 1024;
  static constexpr int FIT = (SWA_SMEM_MAX - ALIGN - Q_BYTES) / (K_BYTES + V_BYTES + 16);
  static constexpr int STAGES = FIT < SWA_STAGES ? FIT : SWA_STAGES;
  static constexpr int BYTES = Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && BYTES + ALIGN <= SWA_SMEM_MAX, "the ring does not fit");
};

template <int DK, int DV>
__device__ __forceinline__ void swa_consumer(const SwaParams& p, const SwaTiles& t,
                                             unsigned char* qs, unsigned char* ks,
                                             unsigned char* vs, uint64_t* full,
                                             uint64_t* empty) {
  using Sm = SwaSmem<DK, DV>;
  constexpr int NS = SWA_KEYS / 2;  // S accumulator registers a thread
  constexpr int NO = DV / 2;        // O accumulator registers a thread
  // the warpgroup index through a shuffle, so that the compiler sees it
  // uniform: a wgmma under a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.G, S = p.S, D = p.D, DVt = p.DV, W = p.window;
  const int rows_total = S * G;

  // stage this warpgroup's 64 rows of Q (zero past the rows and past D)
  {
    const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q);
    constexpr int CH = DK / 8;  // 16-byte chunks a row
    for (int c = tid; c < SWA_WG_ROWS * CH; c += 128) {
      const int r = wg * SWA_WG_ROWS + c / CH, col = (c % CH) * 8, f = t.f0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (f < rows_total && col < D)
        val = *reinterpret_cast<const uint4*>(
            Q + ((long long)(b * S + f / G) * p.H + kvh * G + f % G) * D + col);
      if (p.scale < 0.f) {  // q (s k) = (-q) (|s| k), exactly: the softmax takes |scale|
        val.x ^= 0x80008000u;
        val.y ^= 0x80008000u;
        val.z ^= 0x80008000u;
        val.w ^= 0x80008000u;
      }
      *reinterpret_cast<uint4*>(qs + sw32_offset(r, col, SWA_ROWS)) = val;
    }
    // generic-proxy writes, read by wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + SWA_CONSUMERS + wg, 128);
  }

  // this warpgroup's rows, and the two rows of this thread (g and g + 8)
  const int wf0 = t.f0 + wg * SWA_WG_ROWS;
  const bool live = wf0 < rows_total;
  const int w_lo = wf0 / G, w_hi = min(wf0 + SWA_WG_ROWS - 1, rows_total - 1) / G;
  const int fa = wf0 + warp * 16 + lane / 4, fb = fa + 8;
  const int pos_a = fa / G, pos_b = fb / G;
  const int t2 = 2 * (lane % 4);
  const unsigned char* q_wg = qs + wg * SWA_WG_ROWS * 32;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float s[NS];
  uint32_t pa[SWA_KEYS / 16][4];  // P as the A operand of P V, bf16 pairs
  float m_a = SWA_NEG_INF, m_b = SWA_NEG_INF, l_a = 0.f, l_b = 0.f;
  const float scale2 = fabsf(p.scale) * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  // a warp's lane 0 releases a stage once its warp is done with it
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };
  // the turn of this warpgroup to issue products, and the next one's
  auto turn_wait = [&]() { bar_sync(1 + wg, 256); };
  auto turn_pass = [&]() { bar_arrive(1 + (wg + 1) % SWA_CONSUMERS, 256); };
  auto issue_s = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < Sm::K_PANELS; ++kk)
      wgmma_ss(s, sw32_desc(q_wg + kk * SWA_ROWS * 32, 16),
               sw32_desc(ks + stage * Sm::K_BYTES + kk * SWA_KEYS * 32, 16), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < SWA_KEYS / 16; ++kk)
      wgmma_rs(o, pa[kk], sw32_desc(vs + stage * Sm::V_BYTES + kk * 16 * 32, SWA_KEYS * 32));
    wgmma_commit();
  };
  // The online softmax of S in the log2 domain, masked only where the tile
  // crosses a row's window edge (Masked<true>), without branches: leaves P
  // in s and returns the factors (alpha_a, alpha_b) that rescale O and l.
  // The row max is taken on the raw logits (the scale is positive) and each
  // probability is ex2(s * scale2 - m) in one FMA; a masked probability is
  // exactly 0, and a row whose window misses the tile keeps m = -1e30.
  auto softmax = [&](auto masked, int kt, float& alpha_a, float& alpha_b) {
    constexpr bool MASK = decltype(masked)::value;
    fence_regs(s);
    const int ra = pos_a - kt - t2, rb = pos_b - kt - t2;  // keys kt + t2 + c, c = 8 j + e % 2
    auto ok = [&](int j, int e) -> bool {
      if constexpr (!MASK) return true;
      const int c = j * 8 + (e & 1), r = e < 2 ? ra : rb;
      return (c <= r) & (c > r - W);
    };
    float mx_a = -SWA_FLT_MAX, mx_b = -SWA_FLT_MAX;
#pragma unroll
    for (int j = 0; j < SWA_KEYS / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(ok(j, 0) ? s[4 * j] : -SWA_FLT_MAX,
                               ok(j, 1) ? s[4 * j + 1] : -SWA_FLT_MAX));
      mx_b = fmaxf(mx_b, fmaxf(ok(j, 2) ? s[4 * j + 2] : -SWA_FLT_MAX,
                               ok(j, 3) ? s[4 * j + 3] : -SWA_FLT_MAX));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    const float mn_a = fmaxf(m_a, mx_a * scale2), mn_b = fmaxf(m_b, mx_b * scale2);
    alpha_a = ex2(m_a - mn_a);
    alpha_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < SWA_KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = ex2(fmaf(s[4 * j + e], scale2, e < 2 ? -mn_a : -mn_b));
        s[4 * j + e] = ok(j, e) ? pr : 0.f;
        if (e < 2) sum_a += s[4 * j + e]; else sum_b += s[4 * j + e];
      }
    }
    l_a = alpha_a * l_a + sum_a;  // this thread's columns; summed over the quad at the end
    l_b = alpha_b * l_b + sum_b;
  };
  // O *= alpha, and P rounded to bf16 into the A fragments: the m64nN
  // accumulator's n8 blocks 2 kk and 2 kk + 1 are the k16 A fragment kk
  auto rescale_and_pack = [&](float alpha_a, float alpha_b) {
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
#pragma unroll
    for (int kk = 0; kk < SWA_KEYS / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // This warpgroup's tiles: those that meet the union of its rows' windows,
  // [max(0, w_lo - W + 1), w_hi], are [it_lo, it_hi]; the others it only
  // waits for and releases (a fully masked tile changes neither m, l nor
  // O).  Every warpgroup takes n_tiles + 1 turns, so that the turns pair up.
  const int it_lo = live ? (max(0, w_lo - W + 1) - t.kt0) / SWA_KEYS : t.n_tiles;
  const int it_hi = live ? (w_hi - t.kt0) / SWA_KEYS : t.n_tiles - 1;
  auto skip = [&](int it) {
    const int stage = it % Sm::STAGES;
    mbar_wait(&full[stage], (it / Sm::STAGES) & 1);
    turn_wait();
    turn_pass();
    release(stage);
  };
  // the softmax of tile it, whose S has been issued (mask only where the
  // tile crosses a row's window edge), then O rescaled and P packed; with
  // have_pv, the earlier tile's P V in flight is waited for and its stage
  // released between the two
  auto consume = [&](int it, bool have_pv, int pv_stage) {
    const int kt = t.kt0 + it * SWA_KEYS;
    float alpha_a, alpha_b;
    if (kt + SWA_KEYS - 1 <= w_lo && kt > w_hi - W)  // inside every row's window
      softmax(Masked<false>(), kt, alpha_a, alpha_b);
    else
      softmax(Masked<true>(), kt, alpha_a, alpha_b);
    if (have_pv) {
      wgmma_wait<0>();
      fence_regs(o);
      release(pv_stage);
    }
    rescale_and_pack(alpha_a, alpha_b);
  };

  // warpgroup 0 takes the first turn
  if (wg == SWA_CONSUMERS - 1) bar_arrive(1, 256);
  int it = 0;
  for (; it < it_lo; ++it) skip(it);
  if (it_lo <= it_hi) {
    int stage = it % Sm::STAGES;
    mbar_wait(&full[stage], (it / Sm::STAGES) & 1);
    turn_wait();
    wgmma_fence();
    issue_s(stage);
    turn_pass();
    wgmma_wait<0>();
    consume(it, false, 0);
    for (++it; it <= it_hi; ++it) {
      const int prev = stage;
      stage = it % Sm::STAGES;
      mbar_wait(&full[stage], (it / Sm::STAGES) & 1);
      turn_wait();
      wgmma_fence();
      issue_s(stage);  // the next S and the last P V in flight together
      issue_pv(prev);
      turn_pass();
      wgmma_wait<1>();
      consume(it, true, prev);
    }
    turn_wait();  // the last tile's P V
    wgmma_fence();
    issue_pv(stage);
    turn_pass();
    wgmma_wait<0>();
    fence_regs(o);
    release(stage);
  } else {
    turn_wait();
    turn_pass();
  }
  for (; it < t.n_tiles; ++it) skip(it);
  // warpgroup 0 takes the last turn that was passed to it
  if (wg == 0) bar_sync(1, 256);

  if (!live) return;
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float div_a = l_a > 0.f ? l_a : 1.f, div_b = l_b > 0.f ? l_b : 1.f;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.out);
  const long long off_a = ((long long)(b * S + pos_a) * p.H + kvh * G + fa % G) * DVt;
  const long long off_b = ((long long)(b * S + pos_b) * p.H + kvh * G + fb % G) * DVt;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = j * 8 + t2;
    if (col >= DVt) continue;
    if (fa < rows_total)
      *reinterpret_cast<__nv_bfloat162*>(O + off_a + col) =
          __floats2bfloat162_rn(o[4 * j] / div_a, o[4 * j + 1] / div_a);
    if (fb < rows_total)
      *reinterpret_cast<__nv_bfloat162*>(O + off_b + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / div_b, o[4 * j + 3] / div_b);
  }
}

// Warpgroups 0 .. SWA_CONSUMERS - 1 consume, the last one produces: one
// if / else at the top, so that setmaxnreg is honoured.
template <int DK, int DV>
static __global__ void __launch_bounds__(SWA_THREADS, 1)
    swa_bf16_kernel(const __grid_constant__ SwaParams p, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap) {
  using Sm = SwaSmem<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + Sm::ALIGN - 1) & ~(uintptr_t)(Sm::ALIGN - 1));
  unsigned char* ks = qs + Sm::Q_BYTES;              // [stage][panel][key][32 bytes]
  unsigned char* vs = ks + Sm::STAGES * Sm::K_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + Sm::STAGES * Sm::V_BYTES);
  uint64_t* empty = full + Sm::STAGES;
  const SwaTiles t = swa_tiles(p);

  if (threadIdx.x == 0) {
    for (int i = 0; i < Sm::STAGES; ++i) {
      mbar_init(&full[i], 1);                   // the producer's expect_tx
      mbar_init(&empty[i], 4 * SWA_CONSUMERS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) == SWA_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SWA_PRODUCER_REGS));
    if (threadIdx.x == 128 * SWA_CONSUMERS) {
      const int b = blockIdx.z, kvh = blockIdx.y;
      for (int it = 0; it < t.n_tiles; ++it) {
        const int stage = it % Sm::STAGES, kt = t.kt0 + it * SWA_KEYS;
        mbar_wait(&empty[stage], ((it / Sm::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], Sm::K_BYTES + Sm::V_BYTES);
        // K panel p and V panel p in turn, then the K panels past DV
#pragma unroll 1
        for (int pn = 0; pn < Sm::K_PANELS; ++pn) {
          tma_load4(ks + stage * Sm::K_BYTES + pn * SWA_KEYS * 32, &kmap, pn * SWA_PANEL, kvh,
                    kt, b, &full[stage]);
          if (DK == DV || pn < Sm::V_PANELS)
            tma_load4(vs + stage * Sm::V_BYTES + pn * SWA_KEYS * 32, &vmap, pn * SWA_PANEL, kvh,
                      kt, b, &full[stage]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SWA_CONSUMER_REGS));
    swa_consumer<DK, DV>(p, t, qs, ks, vs, full, empty);
  }
}

// Floats of the f32 path's dynamic shared memory: Q rows (D a row), K rows
// (an odd stride, so that lane j reading row j meets no bank conflict) and V
// rows (DV a row).
__host__ __device__ __forceinline__ int swa_f32_ks_stride(int d) { return d | 1; }
__host__ __device__ __forceinline__ int swa_f32_smem_floats(int d, int dv) {
  return SWA_F32_ROWS * d + SWA_F32_KEYS * (swa_f32_ks_stride(d) + dv);
}

static __global__ void __launch_bounds__(128) swa_f32_kernel(SwaParams p) {
  extern __shared__ float f32_smem[];
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.G, S = p.S, D = p.D, DV = p.DV, W = p.window;
  const int KS = swa_f32_ks_stride(D);
  float* qs = f32_smem;                       // [SWA_F32_ROWS][D]
  float* ks = qs + SWA_F32_ROWS * D;          // [SWA_F32_KEYS][KS]
  float* vs = ks + SWA_F32_KEYS * KS;         // [SWA_F32_KEYS][DV]
  const int rows_total = S * G;
  const int f0 = blockIdx.x * SWA_F32_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* Q = static_cast<const float*>(p.q);
  const float* K = static_cast<const float*>(p.k);
  const float* V = static_cast<const float*>(p.v);
  float* O = static_cast<float*>(p.out);

  for (int i = threadIdx.x; i < SWA_F32_ROWS * D; i += blockDim.x) {
    const int r = i / D, c = i % D, f = f0 + r;
    qs[r * D + c] = f < rows_total
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
      ks[r * KS + c] = j < S ? K[((long long)(b * S + j) * p.KVH + kvh) * D + c] : 0.f;
    }
    for (int i = threadIdx.x; i < SWA_F32_KEYS * DV; i += blockDim.x) {
      const int r = i / DV, c = i % DV, j = kt + r;
      vs[r * DV + c] = j < S ? V[((long long)(b * S + j) * p.KVH + kvh) * DV + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + warp * 4 + i;
      if (f >= rows_total) continue;  // warp-uniform
      const int pos = f / G, key = kt + lane;
      const bool ok = key <= pos && key > pos - W;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(qs[(warp * 4 + i) * D + c], ks[lane * KS + c], s);
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
          if (col < DV) a = fmaf(pj, vs[j * DV + col], a);
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
    float* orow = O + ((long long)(b * S + f / G) * p.H + kvh * G + f % G) * DV;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = lane + 32 * c4;
      if (col < DV) orow[col] = acc[i][c4] / div;
    }
  }
}

// ------------------------------------------------------------- host --

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), fetched through the runtime's entry-point query (no -lcuda)
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// K (B, S, KVH, D) or V (B, S, KVH, DV) bf16 as a rank-4 map over (cols,
// KVH, S, B); a box is one 16-column panel of SWA_KEYS keys, 32-byte
// swizzled, zero past S and past cols.
static int kv_map(CUtensorMap* map, const SwaParams* p, const void* base, int cols) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)cols * 2;
  cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)p->KVH, (cuuint64_t)p->S,
                        (cuuint64_t)p->B};
  cuuint64_t strides[3] = {row, row * p->KVH, row * p->KVH * p->S};
  cuuint32_t box[4] = {SWA_PANEL, 1, SWA_KEYS, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DK, int DV>
static int launch_bf16(const SwaParams* p, cudaStream_t st) {
  using Sm = SwaSmem<DK, DV>;
  const int smem = Sm::BYTES + Sm::ALIGN;
  CUtensorMap kmap, vmap;
  int err = kv_map(&kmap, p, p->k, p->D);
  if (err == 0) err = kv_map(&vmap, p, p->v, p->DV);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(swa_bf16_kernel<DK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p->S * p->G + SWA_ROWS - 1) / SWA_ROWS, p->KVH, p->B);
  swa_bf16_kernel<DK, DV><<<grid, SWA_THREADS, smem, st>>>(*p, kmap, vmap);
  return (int)cudaGetLastError();
}

extern "C" int rt_swa_attention(const SwaParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p->D < 1 || p->D > SWA_MAX_D || p->DV < 1 || p->DV > SWA_MAX_DV)
    return (int)cudaErrorInvalidValue;
  if (p->dtype == 0) {
    const int smem = swa_f32_smem_floats(p->D, p->DV) * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(swa_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p->S * p->G + SWA_F32_ROWS - 1) / SWA_F32_ROWS, p->KVH, p->B);
    swa_f32_kernel<<<grid, 128, smem, st>>>(*p);
    return (int)cudaGetLastError();
  }
  if (p->D % 8 != 0 || p->DV % 8 != 0) return (int)cudaErrorInvalidValue;
  // the smallest instantiation that covers both widths
  const int dk = (p->D + 15) / 16, dv = (p->DV + 15) / 16;
  if (dk > 8) return launch_bf16<192, 128>(p, st);
  switch (dk > dv ? dk : dv) {
    case 1: return launch_bf16<16, 16>(p, st);
    case 2: return launch_bf16<32, 32>(p, st);
    case 3: return launch_bf16<48, 48>(p, st);
    case 4: return launch_bf16<64, 64>(p, st);
    case 5: return launch_bf16<80, 80>(p, st);
    case 6: return launch_bf16<96, 96>(p, st);
    case 7: return launch_bf16<112, 112>(p, st);
    default: return launch_bf16<128, 128>(p, st);
  }
}

extern "C" int rt_swa_params_size() { return (int)sizeof(SwaParams); }

// The design constants the Python side mirrors (_build.SWA_CONSTANTS order).
extern "C" void rt_swa_constants(int* out) {
  const int c[] = {SWA_KEYS,  SWA_STAGES, SWA_CONSUMERS, SWA_WG_ROWS,
                   SWA_PANEL, SWA_MAX_D,  SWA_MAX_DV,    SWA_SMEM_MAX};
  for (int i = 0; i < (int)(sizeof(c) / sizeof(c[0])); ++i) out[i] = c[i];
}
