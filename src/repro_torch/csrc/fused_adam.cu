// fused_adam: the D-Adam local step in one pass over the packed buffers.
//
// Replaces the TPU kernel src/repro/kernels/fused_adam.py:fused_adam
// (_adam_kernel, pallas_call at line 66).
//
// Bound on the H100: bytes. Per element it reads p, g, m, v and writes
// p, m, v: 28 bytes with f32 moments, 20 with bf16 ones, against about 15
// f32 operations, far below the card's operations-per-byte line. The
// design spends nothing but the one pass: a grid-stride loop that moves
// four elements a thread (16-byte loads and stores of f32, 8-byte ones of
// bf16) where the pointers are aligned for them, a scalar tail, no shared
// memory. Outputs are out of place. The moments are f32 or bf16 (one
// template, two entry points); p and g are f32.
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

constexpr int kThreads = 256;

template <typename M>
__global__ void fused_adam_kernel(const float* __restrict__ p,
                                  const float* __restrict__ g,
                                  const M* __restrict__ m,
                                  const M* __restrict__ v,
                                  float* __restrict__ po,
                                  M* __restrict__ mo,
                                  M* __restrict__ vo, long long n,
                                  long long n_vec, AdamConsts c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n_vec; i += stride) {
    float4 P = reinterpret_cast<const float4*>(p)[i];
    float4 G = reinterpret_cast<const float4*>(g)[i];
    float4 M4 = load_moment4(m, i);
    float4 V = load_moment4(v, i);
    float4 PO, MO, VO;
    adam_half_step(P.x, G.x, M4.x, V.x, c, &PO.x, &MO.x, &VO.x);
    adam_half_step(P.y, G.y, M4.y, V.y, c, &PO.y, &MO.y, &VO.y);
    adam_half_step(P.z, G.z, M4.z, V.z, c, &PO.z, &MO.z, &VO.z);
    adam_half_step(P.w, G.w, M4.w, V.w, c, &PO.w, &MO.w, &VO.w);
    reinterpret_cast<float4*>(po)[i] = PO;
    store_moment4(mo, i, MO);
    store_moment4(vo, i, VO);
  }
  for (long long i = n_vec * 4 + tid; i < n; i += stride) {
    float pn, mn, vn;
    adam_half_step(p[i], g[i], load_moment(m, i), load_moment(v, i), c, &pn,
                   &mn, &vn);
    po[i] = pn;
    store_moment(mo, i, mn);
    store_moment(vo, i, vn);
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

template <typename M>
int launch_fused_adam(const float* p, const float* g, const M* m, const M* v,
                      float* po, M* mo, M* vo, long long n, int vec,
                      AdamConsts c, void* stream) {
  if (n <= 0) return 0;
  const long long n_vec = vec ? n / 4 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  fused_adam_kernel<M><<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, po, mo, vo, n, n_vec, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 when it
// was accepted). vec != 0 promises that the four elements of each group
// are one aligned load or store: the f32 pointers 16-byte aligned, the
// bf16 ones 8-byte aligned.
extern "C" int fused_adam_f32(const float* p, const float* g, const float* m,
                              const float* v, float* po, float* mo, float* vo,
                              long long n, int vec, float eta, float beta1,
                              float one_minus_beta1, float beta2,
                              float one_minus_beta2, float tau,
                              float weight_decay, void* stream) {
  return launch_fused_adam(p, g, m, v, po, mo, vo, n, vec,
                           AdamConsts{eta, beta1, one_minus_beta1, beta2,
                                      one_minus_beta2, tau, weight_decay},
                           stream);
}

// f32 p and g, bf16 m and v.
extern "C" int fused_adam_f32_bf16m(const float* p, const float* g,
                                    const __nv_bfloat16* m,
                                    const __nv_bfloat16* v, float* po,
                                    __nv_bfloat16* mo, __nv_bfloat16* vo,
                                    long long n, int vec, float eta,
                                    float beta1, float one_minus_beta1,
                                    float beta2, float one_minus_beta2,
                                    float tau, float weight_decay,
                                    void* stream) {
  return launch_fused_adam(p, g, m, v, po, mo, vo, n, vec,
                           AdamConsts{eta, beta1, one_minus_beta1, beta2,
                                      one_minus_beta2, tau, weight_decay},
                           stream);
}
