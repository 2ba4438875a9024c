// Variants of the banded matvec kernel, timed by variants_bench.py (not part of
// the library): 0-2 stage x through shared memory (8, 16, 32 rows per pass),
// 3-4 read x through L1 (4, 8 rows per thread), 5 reads float4 of x with a
// register window (4 columns per thread, halo <= 4, d % 4 == 0).
#include <cuda_runtime.h>
#include <stdint.h>

struct BP { const float* coef; const float* x; float* y; int m, d, b, h, rpc; };

// V0-like with templated rows per pass
template <int PASS>
__global__ void __launch_bounds__(256) v_smem(BP p) {
  extern __shared__ float xs[];
  const int h = p.h, width = 256 + 2 * h;
  const int col_tiles = (p.d + 255) / 256;
  const int c0 = (blockIdx.x % col_tiles) * 256;
  const int n0 = (blockIdx.x / col_tiles) * p.rpc;
  const int n1 = min(n0 + p.rpc, p.m);
  const int r = c0 + threadIdx.x;
  for (int n = n0; n < n1; n += PASS) {
    const int rows = min(PASS, n1 - n);
    for (int k = 0; k < rows; ++k) {
      const float* xrow = p.x + (size_t)(n + k) * p.d;
      for (int j = threadIdx.x; j < width; j += 256) {
        const int col = c0 - h + j;
        xs[k * width + j] = (col >= 0 && col < p.d) ? __ldg(xrow + col) : 0.f;
      }
    }
    __syncthreads();
    if (r < p.d) {
      float acc[PASS];
#pragma unroll
      for (int k = 0; k < PASS; ++k) acc[k] = 0.f;
      for (int o = -h; o <= h; ++o) {
        const float a = __ldg(p.coef + (size_t)(p.b + o) * p.d + r);
        const float* xo = xs + threadIdx.x + h + o;
#pragma unroll
        for (int k = 0; k < PASS; ++k)
          if (k < rows) acc[k] = fmaf(a, xo[k * width], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < PASS; ++k)
        if (k < rows) p.y[(size_t)(n + k) * p.d + r] = acc[k];
    }
    __syncthreads();
  }
}

// no shared memory: x through L1, R rows per thread
template <int R>
__global__ void __launch_bounds__(256) v_ldg(BP p) {
  const int col_tiles = (p.d + 255) / 256;
  const int r = (blockIdx.x % col_tiles) * 256 + threadIdx.x;
  const int n0 = (blockIdx.x / col_tiles) * p.rpc;
  const int n1 = min(n0 + p.rpc, p.m);
  if (r >= p.d) return;
  const int lo = max(-p.h, -r), hi = min(p.h, p.d - 1 - r);
  for (int n = n0; n < n1; n += R) {
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.f;
    for (int o = lo; o <= hi; ++o) {
      const float a = __ldg(p.coef + (size_t)(p.b + o) * p.d + r);
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (n + k < n1) acc[k] = fmaf(a, __ldg(p.x + (size_t)(n + k) * p.d + r + o), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (n + k < n1) p.y[(size_t)(n + k) * p.d + r] = acc[k];
  }
}

// 4 columns per thread, float4 body (d % 4 == 0, h <= 4), register sliding window
__global__ void __launch_bounds__(256) v_vec4(BP p) {
  const int col_tiles = (p.d + 1023) / 1024;
  const int c = (blockIdx.x % col_tiles) * 1024 + threadIdx.x * 4;
  const int n0 = (blockIdx.x / col_tiles) * p.rpc;
  const int n1 = min(n0 + p.rpc, p.m);
  if (c >= p.d) return;
  const int h = p.h;
  float a[9][4];
  for (int o = -h; o <= h; ++o) {
    const float4 v = *reinterpret_cast<const float4*>(p.coef + (size_t)(p.b + o) * p.d + c);
    a[o + 4][0] = v.x; a[o + 4][1] = v.y; a[o + 4][2] = v.z; a[o + 4][3] = v.w;
  }
  for (int n = n0; n < n1; ++n) {
    const float* xr = p.x + (size_t)n * p.d;
    float w[12];  // columns c-4 .. c+7
    const float4 lft = c >= 4 ? __ldg(reinterpret_cast<const float4*>(xr + c - 4)) : make_float4(0, 0, 0, 0);
    const float4 mid = __ldg(reinterpret_cast<const float4*>(xr + c));
    const float4 rgt = c + 4 < p.d ? __ldg(reinterpret_cast<const float4*>(xr + c + 4)) : make_float4(0, 0, 0, 0);
    w[0] = lft.x; w[1] = lft.y; w[2] = lft.z; w[3] = lft.w;
    w[4] = mid.x; w[5] = mid.y; w[6] = mid.z; w[7] = mid.w;
    w[8] = rgt.x; w[9] = rgt.y; w[10] = rgt.z; w[11] = rgt.w;
    float out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int o = -4; o <= 4; ++o)
        if (o >= -h && o <= h) acc = fmaf(a[o + 4][q], w[4 + q + o], acc);
      out[q] = acc;
    }
    *reinterpret_cast<float4*>(p.y + (size_t)n * p.d + c) = make_float4(out[0], out[1], out[2], out[3]);
  }
}

extern "C" int launch(int variant, const BP* p, int ctas, int smem) {
  switch (variant) {
    case 0: v_smem<8><<<ctas, 256, smem>>>(*p); break;
    case 1: v_smem<16><<<ctas, 256, smem>>>(*p); break;
    case 2: v_smem<32><<<ctas, 256, smem>>>(*p); break;
    case 3: v_ldg<4><<<ctas, 256>>>(*p); break;
    case 4: v_ldg<8><<<ctas, 256>>>(*p); break;
    case 5: v_vec4<<<ctas, 256>>>(*p); break;
  }
  return (int)cudaGetLastError();
}
