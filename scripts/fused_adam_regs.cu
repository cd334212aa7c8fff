// The register-only design of fused_adam, the other side of the A/B that
// chose src/repro_torch/csrc/fused_adam.cu's (scripts/fused_adam_ab.py
// builds both and times them in one process). It takes the same
// arguments, the same head / body / tail plan and the same persistent
// grid and deal of the body as the kept kernel, but moves the
// data through registers alone: each thread issues all eight loads of its
// next 8 elements (two 4-element groups kThreads * 4 apart, so a warp's
// load is 512 contiguous bytes) with the streaming hint (ld.global.cs)
// before any of the math, then stores with st.global.cs. No shared
// memory, so the occupancy (not a ring) sets the bytes in flight.
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kMaxDevices = 64;

template <typename M>
__host__ __device__ constexpr long long quantum() {
  return 16 / (long long)sizeof(M);
}

__device__ __forceinline__ float4 load4_cs(const float* src) {
  return __ldcs(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ float4 load4_cs(const __nv_bfloat16* src) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(src));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4_cs(float* dst, float4 x) {
  __stcs(reinterpret_cast<float4*>(dst), x);
}

__device__ __forceinline__ void store4_cs(__nv_bfloat16* dst, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  __stcs(reinterpret_cast<uint2*>(dst), raw);
}

__device__ __forceinline__ void step4(float4 P, float4 G, float4 M4,
                                      float4 V, const AdamConsts& c,
                                      float4* PO, float4* MO, float4* VO) {
  adam_half_step(P.x, G.x, M4.x, V.x, c, &PO->x, &MO->x, &VO->x);
  adam_half_step(P.y, G.y, M4.y, V.y, c, &PO->y, &MO->y, &VO->y);
  adam_half_step(P.z, G.z, M4.z, V.z, c, &PO->z, &MO->z, &VO->z);
  adam_half_step(P.w, G.w, M4.w, V.w, c, &PO->w, &MO->w, &VO->w);
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
    fused_adam_regs_kernel(const float* __restrict__ p,
                           const float* __restrict__ g,
                           const M* __restrict__ m, const M* __restrict__ v,
                           float* __restrict__ po, M* __restrict__ mo,
                           M* __restrict__ vo, long long n, long long head,
                           long long body, AdamConsts c) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
       k < n - body; k += stride) {
    const long long i = k < head ? k : k + body;
    float pn, mn, vn;
    adam_half_step(p[i], g[i], load1(m, i), load1(v, i), c, &pn,
                   &mn, &vn);
    po[i] = pn;
    store1(mo, i, mn);
    store1(vo, i, vn);
  }
  // the kept kernel's deal, in chunks of kThreads * kPerThread: whole
  // chunks round robin, then an even share in quanta of the rest
  constexpr int kChunk = kThreads * kPerThread;
  const long long round = (long long)gridDim.x * kChunk;
  const long long rounds = body / round;
  const long long rest = head + rounds * round;
  const long long rest_units = (body - rounds * round) / quantum<M>();
  const long long rest_lo =
      rest + (long long)blockIdx.x * rest_units / gridDim.x * quantum<M>();
  const long long rest_hi =
      rest + ((long long)blockIdx.x + 1) * rest_units / gridDim.x *
                 quantum<M>();
  const int pieces = (int)rounds + (rest_hi > rest_lo ? 1 : 0);
  for (int t = 0; t < pieces; ++t) {
    const long long base =
        t < rounds ? head + ((long long)t * gridDim.x + blockIdx.x) * kChunk
                   : rest_lo;
    const int len = t < rounds ? kChunk : (int)(rest_hi - rest_lo);
    const int i0 = threadIdx.x * 4, i1 = i0 + kThreads * 4;
    const bool a0 = i0 < len, a1 = i1 < len;
    const long long e0 = base + i0, e1 = base + i1;
    float4 P0, G0, M0, V0, P1, G1, M1, V1;
    if (a0) {
      P0 = load4_cs(p + e0);
      G0 = load4_cs(g + e0);
      M0 = load4_cs(m + e0);
      V0 = load4_cs(v + e0);
    }
    if (a1) {
      P1 = load4_cs(p + e1);
      G1 = load4_cs(g + e1);
      M1 = load4_cs(m + e1);
      V1 = load4_cs(v + e1);
    }
    float4 PO, MO, VO;
    if (a0) {
      step4(P0, G0, M0, V0, c, &PO, &MO, &VO);
      store4_cs(po + e0, PO);
      store4_cs(mo + e0, MO);
      store4_cs(vo + e0, VO);
    }
    if (a1) {
      step4(P1, G1, M1, V1, c, &PO, &MO, &VO);
      store4_cs(po + e1, PO);
      store4_cs(mo + e1, MO);
      store4_cs(vo + e1, VO);
    }
  }
}

template <typename M>
cudaError_t grid_limit(int device, int* blocks) {
  static int cached[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_adam_regs_kernel<M>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  *blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < kMaxDevices) cached[device] = *blocks;
  return cudaSuccess;
}

template <typename M>
int launch(const float* p, const float* g, const M* m, const M* v, float* po,
           M* mo, M* vo, long long n, long long head, long long body,
           const AdamConsts* c, void* stream) {
  if (n <= 0) return 0;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = grid_limit<M>(device, &limit);
  if (err != cudaSuccess) return (int)err;
  long long blocks = body > 0
                         ? (body + kThreads * kPerThread - 1) /
                               (kThreads * kPerThread)
                         : (n + kThreads - 1) / kThreads;
  if (blocks > limit) blocks = limit;
  if (blocks < 1) blocks = 1;
  fused_adam_regs_kernel<M><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, po, mo, vo, n, head, body, *c);
  return (int)cudaGetLastError();
}

}  // namespace

// The kept kernel's entry, argument for argument; f32 params only.
extern "C" int fused_adam(const void* p, const void* g, const void* m,
                          const void* v, void* po, void* mo, void* vo,
                          long long n, long long head, long long body,
                          const AdamConsts* c, int param_bytes,
                          int moment_bytes, void* stream) {
  if (param_bytes != 4) return (int)cudaErrorInvalidValue;
  return with_dtype(moment_bytes, [&](auto mt) {
    using M = typename decltype(mt)::type;
    return launch(static_cast<const float*>(p), static_cast<const float*>(g),
                  static_cast<const M*>(m), static_cast<const M*>(v),
                  static_cast<float*>(po), static_cast<M*>(mo),
                  static_cast<M*>(vo), n, head, body, c, stream);
  });
}
