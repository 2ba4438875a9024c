// Variants of the rolling window-moments kernel, timed by variants_bench.py
// (not part of the library): 0 one channel per thread, 1-2 four channels per
// thread with float4 loads and stores (4 or 8 rows in flight; d % 4 == 0).
#include <cuda_runtime.h>
struct MP { const float* x; float* out; int n, d, w, n_out, chain, ctas; };
#define U 8
__global__ void __launch_bounds__(256) wm_scalar(MP p) {
  const long long g = (long long)blockIdx.x * 256 + threadIdx.x;
  const int c = (int)(g % p.d);
  const long long sb = (g / p.d) * p.chain;
  if (sb >= p.n_out) return;
  const int s0 = (int)sb, s_end = min(s0 + p.chain, p.n_out);
  const float* __restrict__ xc = p.x + c;
  float* __restrict__ out = p.out + c;
  const size_t d = (size_t)p.d;
  double a1 = 0.0, a2 = 0.0;
  for (int t = s0; t < s0 + p.w; t += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = (t + u < s0 + p.w) ? __ldg(xc + (size_t)(t + u) * d) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) { const double x = v[u]; a1 += x; a2 += x * x; }
  }
  out[(size_t)s0 * 2 * d] = (float)a1; out[(size_t)s0 * 2 * d + d] = (float)a2;
  for (int s = s0 + 1; s < s_end; s += U) {
    float vin[U], vout[U];
#pragma unroll
    for (int u = 0; u < U; ++u) { const bool ok = s + u < s_end;
      vin[u] = ok ? __ldg(xc + (size_t)(s + u + p.w - 1) * d) : 0.f;
      vout[u] = ok ? __ldg(xc + (size_t)(s + u - 1) * d) : 0.f; }
#pragma unroll
    for (int u = 0; u < U; ++u) if (s + u < s_end) {
      const double xi = vin[u], xo = vout[u]; a1 += xi - xo; a2 += xi * xi - xo * xo;
      out[(size_t)(s + u) * 2 * d] = (float)a1; out[(size_t)(s + u) * 2 * d + d] = (float)a2; }
  }
}
template <int UU>
__global__ void __launch_bounds__(256) wm_vec4(MP p) {
  const int dq = p.d / 4;
  const long long g = (long long)blockIdx.x * 256 + threadIdx.x;
  const int c = (int)(g % dq) * 4;
  const long long sb = (g / dq) * p.chain;
  if (sb >= p.n_out) return;
  const int s0 = (int)sb, s_end = min(s0 + p.chain, p.n_out);
  const float* __restrict__ xc = p.x + c;
  float* __restrict__ out = p.out + c;
  const size_t d = (size_t)p.d;
  double a1[4] = {0, 0, 0, 0}, a2[4] = {0, 0, 0, 0};
  for (int t = s0; t < s0 + p.w; t += UU) {
    float4 v[UU];
#pragma unroll
    for (int u = 0; u < UU; ++u) v[u] = (t + u < s0 + p.w) ? __ldg(reinterpret_cast<const float4*>(xc + (size_t)(t + u) * d)) : make_float4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < UU; ++u) {
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) { const double x = e[k]; a1[k] += x; a2[k] += x * x; }
    }
  }
  *reinterpret_cast<float4*>(out + (size_t)s0 * 2 * d) = make_float4(a1[0], a1[1], a1[2], a1[3]);
  *reinterpret_cast<float4*>(out + (size_t)s0 * 2 * d + d) = make_float4(a2[0], a2[1], a2[2], a2[3]);
  for (int s = s0 + 1; s < s_end; s += UU) {
    float4 vin[UU], vout[UU];
#pragma unroll
    for (int u = 0; u < UU; ++u) { const bool ok = s + u < s_end;
      vin[u] = ok ? __ldg(reinterpret_cast<const float4*>(xc + (size_t)(s + u + p.w - 1) * d)) : make_float4(0, 0, 0, 0);
      vout[u] = ok ? __ldg(reinterpret_cast<const float4*>(xc + (size_t)(s + u - 1) * d)) : make_float4(0, 0, 0, 0); }
#pragma unroll
    for (int u = 0; u < UU; ++u) if (s + u < s_end) {
      const float ei[4] = {vin[u].x, vin[u].y, vin[u].z, vin[u].w};
      const float eo[4] = {vout[u].x, vout[u].y, vout[u].z, vout[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) { const double xi = ei[k], xo = eo[k]; a1[k] += xi - xo; a2[k] += xi * xi - xo * xo; }
      *reinterpret_cast<float4*>(out + (size_t)(s + u) * 2 * d) = make_float4(a1[0], a1[1], a1[2], a1[3]);
      *reinterpret_cast<float4*>(out + (size_t)(s + u) * 2 * d + d) = make_float4(a2[0], a2[1], a2[2], a2[3]);
    }
  }
}
extern "C" int launch(int variant, const MP* p) {
  switch (variant) {
    case 0: wm_scalar<<<p->ctas, 256>>>(*p); break;
    case 1: wm_vec4<4><<<p->ctas, 256>>>(*p); break;
    case 2: wm_vec4<8><<<p->ctas, 256>>>(*p); break;
  }
  return (int)cudaGetLastError();
}
