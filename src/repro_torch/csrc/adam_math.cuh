// The D-Adam half-step of one element (Alg. 1 lines 4-6, no bias
// correction), shared by fused_adam.cu and gossip.cu.
//
// The operations and their order are those of the TPU kernel
// (src/repro/kernels/fused_adam.py:_adam_kernel), in f32:
//   g += wd * p;  m = b1*m + (1-b1)*g;  v = b2*v + ((1-b2)*g)*g;
//   p -= (eta*m) / (sqrt(v) + tau),  or (eta*m) * rsqrt(v + 1e-30) at tau == 0.
// The constants arrive as f32 values that the host rounded from doubles
// (1-b1 and 1-b2 included), as JAX's closure constants are. The sources
// are built without FMA contraction (-fmad=false), so each product and sum
// rounds as in the plain PyTorch version, which runs one op at a time.
//
// The moments m and v are f32 or bf16 (make_optimizer(moment_dtype=)): a
// bf16 moment is widened to f32 on load (exact), the step is computed in
// f32, and the new moment is rounded once, at the store, to nearest-even,
// as JAX's .astype(bfloat16) and torch's .to(bfloat16) round. Four
// elements travel together: 16 bytes for f32, 8 for bf16.
#pragma once

#include <cuda_bf16.h>

struct AdamConsts {
  float eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau, weight_decay;
};

__device__ __forceinline__ void adam_half_step(float p, float g, float m,
                                               float v, const AdamConsts& c,
                                               float* po, float* mo,
                                               float* vo) {
  if (c.weight_decay != 0.0f) g = g + c.weight_decay * p;
  m = c.beta1 * m + c.one_minus_beta1 * g;
  v = c.beta2 * v + c.one_minus_beta2 * g * g;
  float step = (c.tau == 0.0f) ? c.eta * m * rsqrtf(v + 1e-30f)
                               : c.eta * m / (sqrtf(v) + c.tau);
  *po = p - step;
  *mo = m;
  *vo = v;
}

// Four consecutive moments, element i4 counted in groups of four.
__device__ __forceinline__ float4 load_moment4(const float* __restrict__ m,
                                               long long i4) {
  return reinterpret_cast<const float4*>(m)[i4];
}

__device__ __forceinline__ float4 load_moment4(
    const __nv_bfloat16* __restrict__ m, long long i4) {
  const uint2 raw = reinterpret_cast<const uint2*>(m)[i4];
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store_moment4(float* __restrict__ m,
                                              long long i4, float4 x) {
  reinterpret_cast<float4*>(m)[i4] = x;
}

__device__ __forceinline__ void store_moment4(__nv_bfloat16* __restrict__ m,
                                              long long i4, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  reinterpret_cast<uint2*>(m)[i4] = raw;
}

// One moment element, for the scalar tail.
__device__ __forceinline__ float load_moment(const float* m, long long i) {
  return m[i];
}

__device__ __forceinline__ float load_moment(const __nv_bfloat16* m,
                                             long long i) {
  return __bfloat162float(m[i]);
}

__device__ __forceinline__ void store_moment(float* m, long long i, float x) {
  m[i] = x;
}

__device__ __forceinline__ void store_moment(__nv_bfloat16* m, long long i,
                                             float x) {
  m[i] = __float2bfloat16_rn(x);
}
