// Gossip over the resident packed (K, rows, 128) f32 state.
//
// gossip_mix replaces src/repro/kernels/gossip.py:gossip_mix (_mix_kernel,
// pallas_call at line 124):
//     out[k] = w_self * x[k] + sum_j w_j * x[src_j(k)]
// accumulated in f32, the self term first, then the offsets in order.
//
// gossip_adam_mix replaces src/repro/kernels/gossip.py:gossip_adam_mix
// (_gossip_adam_kernel, pallas_call at line 258): the Adam half-step of
// worker k and of every source worker src_j(k), recomputed from their
// (p, g, m, v), each rounded to p's dtype (f32 here), then mixed as above;
// it writes the mixed p and worker k's own m and v.
//
// consensus_mix replaces src/repro/kernels/gossip.py:consensus_mix
// (_consensus_kernel, pallas_call at line 307), CD-Adam's line 8:
//     out = x + gamma * sum_s w_s * (hat_nbr_s - hat_self)
// with acc = 0 and the offsets added in order, the TPU kernel's order. The
// neighbour copies are aligned to the destination worker already, so all
// operands are read at one index; their pointers and weights come by value
// in the kernel's parameter block (at most kMaxConsensusDegree of them).
//
// The source table src is a (deg, K) int32 device array built once per
// topology from topology.offset_perm, so ring offsets and torus GridShifts
// take one code path; the weights are a (1 + deg,) f32 device array, self
// weight first. A block serves one worker (blockIdx.y) and loads its deg
// source indices and weights into shared memory once.
//
// Bound on the H100: bytes. gossip_mix must read x once and write out once;
// this design reads x[k] and x[src_j(k)], (1 + deg) reads per output, and
// relies on the 50 MB L2 only by chance. gossip_adam_mix must read p, g, m,
// v once and write p, m, v once (7 buffers); this design reads 4 * (1 + deg)
// operand buffers, 15 buffers on the ring. The least traffic needs one block
// to serve all K workers of a row tile; that is left for a later change.
// consensus_mix must read x, hat_self and the deg neighbour copies once and
// write out once, and this design does exactly that: (3 + deg) buffers, 5 on
// the ring, with 2 + 3 deg f32 operations per element.
// Loads and stores are 16 bytes (float4); the wrappers check the alignment.
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMixDegree = 32;        // kernels.gossip.MAX_FUSED_DEGREE
constexpr int kMaxGossipAdamDegree = 8;  // kernels.gossip.MAX_GOSSIP_ADAM_DEGREE
constexpr int kMaxConsensusDegree = 32;  // kernels.gossip.MAX_CONSENSUS_DEGREE

struct ConsensusNbrs {
  const float4* hat[kMaxConsensusDegree];
  float w[kMaxConsensusDegree];
};

__device__ __forceinline__ float4 scale4(float w, float4 a) {
  return make_float4(w * a.x, w * a.y, w * a.z, w * a.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void gossip_mix_kernel(const float4* __restrict__ x,
                                  float4* __restrict__ out,
                                  const int* __restrict__ src,
                                  const float* __restrict__ weights, int K,
                                  int deg, long long per_worker) {
  __shared__ int s_src[kMaxMixDegree];
  __shared__ float s_w[kMaxMixDegree + 1];
  const int k = blockIdx.y;
  if (threadIdx.x < deg) s_src[threadIdx.x] = src[threadIdx.x * K + k];
  if (threadIdx.x <= deg) s_w[threadIdx.x] = weights[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* xk = x + (long long)k * per_worker;
  float4* ok = out + (long long)k * per_worker;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per_worker; i += stride) {
    float4 acc = scale4(s_w[0], xk[i]);
    for (int j = 0; j < deg; ++j) {
      acc = add4(acc, scale4(s_w[j + 1], x[(long long)s_src[j] * per_worker + i]));
    }
    ok[i] = acc;
  }
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__global__ void consensus_mix_kernel(const float4* __restrict__ x,
                                     const float4* __restrict__ hat_self,
                                     float4* __restrict__ out,
                                     ConsensusNbrs nbrs, int deg,
                                     long long n4, float gamma) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 hs = hat_self[i];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < deg; ++j) {
      acc = add4(acc, scale4(nbrs.w[j], sub4(nbrs.hat[j][i], hs)));
    }
    out[i] = add4(x[i], scale4(gamma, acc));
  }
}

__device__ __forceinline__ float4 half_step4(const float4* __restrict__ p,
                                             const float4* __restrict__ g,
                                             const float4* __restrict__ m,
                                             const float4* __restrict__ v,
                                             long long i, const AdamConsts& c,
                                             float4* mo, float4* vo) {
  float4 P = p[i], G = g[i], M = m[i], V = v[i], PO;
  adam_half_step(P.x, G.x, M.x, V.x, c, &PO.x, &mo->x, &vo->x);
  adam_half_step(P.y, G.y, M.y, V.y, c, &PO.y, &mo->y, &vo->y);
  adam_half_step(P.z, G.z, M.z, V.z, c, &PO.z, &mo->z, &vo->z);
  adam_half_step(P.w, G.w, M.w, V.w, c, &PO.w, &mo->w, &vo->w);
  return PO;
}

__global__ void gossip_adam_mix_kernel(
    const float4* __restrict__ p, const float4* __restrict__ g,
    const float4* __restrict__ m, const float4* __restrict__ v,
    float4* __restrict__ po, float4* __restrict__ mo, float4* __restrict__ vo,
    const int* __restrict__ src, const float* __restrict__ weights, int K,
    int deg, long long per_worker, AdamConsts c) {
  __shared__ int s_src[kMaxGossipAdamDegree];
  __shared__ float s_w[kMaxGossipAdamDegree + 1];
  const int k = blockIdx.y;
  if (threadIdx.x < deg) s_src[threadIdx.x] = src[threadIdx.x * K + k];
  if (threadIdx.x <= deg) s_w[threadIdx.x] = weights[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long base = (long long)k * per_worker;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per_worker; i += stride) {
    float4 m_self, v_self, m_nbr, v_nbr;
    float4 acc = scale4(s_w[0], half_step4(p, g, m, v, base + i, c, &m_self,
                                           &v_self));
    for (int j = 0; j < deg; ++j) {
      const long long at = (long long)s_src[j] * per_worker + i;
      acc = add4(acc, scale4(s_w[j + 1],
                             half_step4(p, g, m, v, at, c, &m_nbr, &v_nbr)));
    }
    po[base + i] = acc;
    mo[base + i] = m_self;
    vo[base + i] = v_self;
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

dim3 grid_for(long long per_worker, int K) {
  long long bx = (per_worker + kThreads - 1) / kThreads;
  long long cap = (long long)sm_count() * 16 / K;
  if (cap < 1) cap = 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, (unsigned)K);
}

}  // namespace

// Both entry points take n_per_worker = rows * 128 f32 elements (a multiple
// of 4) and return cudaGetLastError() after the launch; 1 marks a degree
// outside the kernel's table (cudaErrorInvalidValue).
extern "C" int gossip_mix_f32(const float* x, float* out, const int* src,
                              const float* weights, int K, int deg,
                              long long n_per_worker, void* stream) {
  if (deg < 0 || deg > kMaxMixDegree) return (int)cudaErrorInvalidValue;
  const long long per_worker = n_per_worker / 4;
  if (per_worker == 0 || K == 0) return 0;
  gossip_mix_kernel<<<grid_for(per_worker, K), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), src,
      weights, K, deg, per_worker);
  return (int)cudaGetLastError();
}

extern "C" int gossip_adam_mix_f32(const float* p, const float* g,
                                   const float* m, const float* v, float* po,
                                   float* mo, float* vo, const int* src,
                                   const float* weights, int K, int deg,
                                   long long n_per_worker, float eta,
                                   float beta1, float one_minus_beta1,
                                   float beta2, float one_minus_beta2,
                                   float tau, float weight_decay,
                                   void* stream) {
  if (deg < 1 || deg > kMaxGossipAdamDegree) return (int)cudaErrorInvalidValue;
  const long long per_worker = n_per_worker / 4;
  if (per_worker == 0 || K == 0) return 0;
  AdamConsts c{eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau,
               weight_decay};
  gossip_adam_mix_kernel<<<grid_for(per_worker, K), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(g),
      reinterpret_cast<const float4*>(m), reinterpret_cast<const float4*>(v),
      reinterpret_cast<float4*>(po), reinterpret_cast<float4*>(mo),
      reinterpret_cast<float4*>(vo), src, weights, K, deg, per_worker, c);
  return (int)cudaGetLastError();
}

// n is the element count of each (K, rows, 128) buffer, a multiple of 4;
// nbr_ptrs and weights are HOST arrays of deg entries, copied by value into
// the launch. Returns cudaGetLastError() after the launch; 1 marks a degree
// outside the kernel's table (cudaErrorInvalidValue).
extern "C" int consensus_mix_f32(const float* x, const float* hat_self,
                                 float* out, const void* const* nbr_ptrs,
                                 const float* weights, int deg, long long n,
                                 float gamma, void* stream) {
  if (deg < 1 || deg > kMaxConsensusDegree || n % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n4 = n / 4;
  if (n4 == 0) return 0;
  ConsensusNbrs nbrs{};
  for (int j = 0; j < deg; ++j) {
    nbrs.hat[j] = static_cast<const float4*>(nbr_ptrs[j]);
    nbrs.w[j] = weights[j];
  }
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  consensus_mix_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x),
      reinterpret_cast<const float4*>(hat_self), reinterpret_cast<float4*>(out),
      nbrs, deg, n4, gamma);
  return (int)cudaGetLastError();
}
