// Loads and stores of the packed path's buffers in their own dtype, f32 or
// bf16, widened to f32 for the arithmetic and rounded back once, at the
// store, to nearest-even (as JAX's .astype(bfloat16) and torch's
// .to(bfloat16) round). A bf16 value widens to f32 exactly. Shared by
// fused_adam.cu, gossip.cu and sign_compress.cu.
//
// Two widths: four consecutive elements (16 bytes of f32, 8 of bf16),
// indexed in groups of four, and one 16-byte vector of each dtype (4 f32
// or 8 bf16 elements), indexed by element.
//
// On the host, with_dtype picks the template instance: each kernel has one
// C entry, which takes the element width of each operand group in bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
struct Dtype {
  using type = T;
};

// f(Dtype<float>{}) for 4 bytes, f(Dtype<__nv_bfloat16>{}) for 2;
// cudaErrorInvalidValue for any other width.
template <typename F>
int with_dtype(int bytes, F&& f) {
  if (bytes == 4) return f(Dtype<float>{});
  if (bytes == 2) return f(Dtype<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ float4 widen4(uint2 raw) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ uint2 narrow4(float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  return raw;
}

// Four consecutive elements, element i4 counted in groups of four.
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long i4) {
  return reinterpret_cast<const float4*>(x)[i4];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ x,
                                        long long i4) {
  return widen4(reinterpret_cast<const uint2*>(x)[i4]);
}

__device__ __forceinline__ void store4(float* __restrict__ x, long long i4,
                                       float4 v) {
  reinterpret_cast<float4*>(x)[i4] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ x,
                                       long long i4, float4 v) {
  reinterpret_cast<uint2*>(x)[i4] = narrow4(v);
}

// Four f32 values rounded through T and widened back: what a store in T
// and a reload give.
template <typename T>
__device__ __forceinline__ float4 round4(float4 v);

template <>
__device__ __forceinline__ float4 round4<float>(float4 v) {
  return v;
}

template <>
__device__ __forceinline__ float4 round4<__nv_bfloat16>(float4 v) {
  return widen4(narrow4(v));
}

// One element, for the scalar heads and tails.
__device__ __forceinline__ float load1(const float* x, long long i) {
  return x[i];
}

__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ void store1(float* x, long long i, float v) {
  x[i] = v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* x, long long i,
                                       float v) {
  x[i] = __float2bfloat16_rn(v);
}

// The elements one 16-byte vector of T holds.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// N consecutive elements from element e on (16-byte aligned), widened:
// N / 4 float4 loads of f32, N / 8 uint4 loads of bf16.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ x,
                                         long long e, float* o) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + e + j);
    o[j] = a.x;
    o[j + 1] = a.y;
    o[j + 2] = a.z;
    o[j + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ x,
                                         long long e, float* o) {
#pragma unroll
  for (int j = 0; j < N; j += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e + j);
    const float4 lo = widen4(make_uint2(raw.x, raw.y));
    const float4 hi = widen4(make_uint2(raw.z, raw.w));
    o[j] = lo.x;
    o[j + 1] = lo.y;
    o[j + 2] = lo.z;
    o[j + 3] = lo.w;
    o[j + 4] = hi.x;
    o[j + 5] = hi.y;
    o[j + 6] = hi.z;
    o[j + 7] = hi.w;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ x, long long e,
                                          const float* v) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    *reinterpret_cast<float4*>(x + e + j) =
        make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ x,
                                          long long e, const float* v) {
#pragma unroll
  for (int j = 0; j < N; j += 8) {
    const uint2 lo = narrow4(make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
    const uint2 hi =
        narrow4(make_float4(v[j + 4], v[j + 5], v[j + 6], v[j + 7]));
    *reinterpret_cast<uint4*>(x + e + j) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}
