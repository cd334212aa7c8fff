// fused_adam: the D-Adam local step in one pass over f32 buffers.
//
// Replaces the TPU kernel src/repro/kernels/fused_adam.py:fused_adam
// (_adam_kernel, pallas_call at line 66).
//
// Bound on the H100: bytes. Per element it reads p, g, m, v and writes
// p, m, v: 28 bytes against about 15 f32 operations, far below the card's
// operations-per-byte line. The design spends nothing but the one pass:
// a grid-stride loop of 16-byte (float4) loads and stores where the four
// pointers of each side are 16-byte aligned, a scalar tail, no shared
// memory. Outputs are out of place.
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void fused_adam_kernel(const float* __restrict__ p,
                                  const float* __restrict__ g,
                                  const float* __restrict__ m,
                                  const float* __restrict__ v,
                                  float* __restrict__ po,
                                  float* __restrict__ mo,
                                  float* __restrict__ vo, long long n,
                                  long long n_vec, AdamConsts c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n_vec; i += stride) {
    float4 P = reinterpret_cast<const float4*>(p)[i];
    float4 G = reinterpret_cast<const float4*>(g)[i];
    float4 M = reinterpret_cast<const float4*>(m)[i];
    float4 V = reinterpret_cast<const float4*>(v)[i];
    float4 PO, MO, VO;
    adam_half_step(P.x, G.x, M.x, V.x, c, &PO.x, &MO.x, &VO.x);
    adam_half_step(P.y, G.y, M.y, V.y, c, &PO.y, &MO.y, &VO.y);
    adam_half_step(P.z, G.z, M.z, V.z, c, &PO.z, &MO.z, &VO.z);
    adam_half_step(P.w, G.w, M.w, V.w, c, &PO.w, &MO.w, &VO.w);
    reinterpret_cast<float4*>(po)[i] = PO;
    reinterpret_cast<float4*>(mo)[i] = MO;
    reinterpret_cast<float4*>(vo)[i] = VO;
  }
  for (long long i = n_vec * 4 + tid; i < n; i += stride) {
    adam_half_step(p[i], g[i], m[i], v[i], c, &po[i], &mo[i], &vo[i]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// vec != 0 promises that all seven pointers are 16-byte aligned.
extern "C" int fused_adam_f32(const float* p, const float* g, const float* m,
                              const float* v, float* po, float* mo, float* vo,
                              long long n, int vec, float eta, float beta1,
                              float one_minus_beta1, float beta2,
                              float one_minus_beta2, float tau,
                              float weight_decay, void* stream) {
  if (n <= 0) return 0;
  AdamConsts c{eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau,
               weight_decay};
  const long long n_vec = vec ? n / 4 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  fused_adam_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, po, mo, vo, n, n_vec, c);
  return (int)cudaGetLastError();
}
