// Gossip over the resident packed (K, rows, 128) f32 state.
//
// gossip_mix replaces src/repro/kernels/gossip.py:gossip_mix (_mix_kernel,
// pallas_call at line 124):
//     out[k] = w_self * x[k] + sum_j w_j * x[src_j(k)]
// accumulated in f32, the self term first, then the offsets in order.
//
// gossip_adam_mix replaces src/repro/kernels/gossip.py:gossip_adam_mix
// (_gossip_adam_kernel, pallas_call at line 258): the Adam half-step of
// every worker from its (p, g, m, v), rounded to p's dtype (f32 here), then
// mixed as above; it writes the mixed p and each worker's own m and v.
// The moments are f32 or bf16 (computed in f32, rounded at the store:
// adam_math.cuh); p and g are f32.
// Bound: bytes, p, g, m, v read once and p, m, v written once (7 buffers:
// 28 bytes an element, 20 with bf16 moments).
// One block owns a tile of n float4 columns of every worker, the same
// index range in each: it takes the K half-steps of the tile once, writes
// m and v at once and keeps the half-step p in shared memory ([K][n],
// K * n * 16 B, at most kAdamTileBytes), then after one barrier writes
// out[k] = w_self * p'[k] + sum_j w_j * p'[src_j(k)] from there, in
// gossip_mix's order. So every buffer crosses memory once, and the result
// is the plain version's to the bit (the same operations in the same
// order, no FMA contraction).
//
// consensus_mix replaces src/repro/kernels/gossip.py:consensus_mix
// (_consensus_kernel, pallas_call at line 307), CD-Adam's line 8:
//     out = x + gamma * sum_s w_s * (hat_nbr_s - hat_self)
// with acc = 0 and the offsets added in order, the TPU kernel's order. The
// neighbour copies are aligned to the destination worker already, so all
// operands are read at one index; their pointers and weights come by value
// in the kernel's parameter block (at most kMaxConsensusDegree of them).
//
// payload_mix replaces src/repro/kernels/gossip.py:payload_mix (_mix_kernel
// with identity index maps, pallas_call at line 161), the mix of D-Adam's
// staleness-bounded and overlapped rounds:
//     out[k] = w_self * x[k] + sum_i w_i * payload_i[k]
// in gossip_mix's order: the self term first, then the payloads in order.
// The runtime has already chosen each payload (fresh shift or buffered
// copy) for every destination worker, so every operand is read at one
// index; the payload pointers and weights travel by value in the
// parameter block, as consensus_mix's do (at most kMaxMixDegree of them).
//
// The source table src is a (deg, K) int32 device array built once per
// topology from topology.offset_perm, so ring offsets and torus GridShifts
// take one code path; the weights are a (1 + deg,) f32 device array, self
// weight first. A gossip_mix block serves one worker (blockIdx.y) and loads
// its deg source indices and weights into shared memory once;
// gossip_adam_mix reads the table and the weights through the read-only
// cache.
//
// Bound on the H100: bytes. gossip_mix must read x once and write out once;
// this design reads x[k] and x[src_j(k)], (1 + deg) reads per output, and
// relies on the 50 MB L2 only by chance. gossip_adam_mix reads and writes
// the 7 buffers once (above).
// consensus_mix must read x, hat_self and the deg neighbour copies once and
// write out once, and this design does exactly that: (3 + deg) buffers, 5 on
// the ring, with 2 + 3 deg f32 operations per element. payload_mix must read
// x and the deg payloads once and write out once, and does exactly that:
// (2 + deg) buffers, 4 on the ring, 7 over one-peer-exponential's union of
// 5 offsets, with 1 + 2 deg f32 operations per element.
// Loads and stores are 16 bytes (float4); the wrappers check the alignment.
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMixDegree = 32;        // kernels.gossip.MAX_FUSED_DEGREE
constexpr int kMaxGossipAdamDegree = 8;  // kernels.gossip.MAX_GOSSIP_ADAM_DEGREE
constexpr int kMaxConsensusDegree = 32;  // kernels.gossip.MAX_CONSENSUS_DEGREE
// gossip_adam_mix's shared memory per block: the most a block may take
// without opting in, static and dynamic together. The kernel has no static
// shared memory (its weights come through the read-only cache), so the
// dynamic tile may take all of it.
constexpr int kAdamTileBytes = 48 * 1024;

struct ConsensusNbrs {
  const float4* hat[kMaxConsensusDegree];
  float w[kMaxConsensusDegree];
};

struct MixPayloads {
  const float4* p[kMaxMixDegree];
  float w[kMaxMixDegree];
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

__global__ void payload_mix_kernel(const float4* __restrict__ x,
                                   float4* __restrict__ out,
                                   MixPayloads pay, float w_self, int deg,
                                   long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 acc = scale4(w_self, x[i]);
    for (int j = 0; j < deg; ++j) {
      acc = add4(acc, scale4(pay.w[j], pay.p[j][i]));
    }
    out[i] = acc;
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

template <typename M>
__device__ __forceinline__ float4 half_step4(const float4* __restrict__ p,
                                             const float4* __restrict__ g,
                                             const M* __restrict__ m,
                                             const M* __restrict__ v,
                                             long long i, const AdamConsts& c,
                                             float4* mo, float4* vo) {
  float4 P = p[i], G = g[i], M4 = load_moment4(m, i),
         V = load_moment4(v, i), PO;
  adam_half_step(P.x, G.x, M4.x, V.x, c, &PO.x, &mo->x, &vo->x);
  adam_half_step(P.y, G.y, M4.y, V.y, c, &PO.y, &mo->y, &vo->y);
  adam_half_step(P.z, G.z, M4.z, V.z, c, &PO.z, &mo->z, &vo->z);
  adam_half_step(P.w, G.w, M4.w, V.w, c, &PO.w, &mo->w, &vo->w);
  return PO;
}

template <typename M>
__global__ void __launch_bounds__(kThreads) gossip_adam_mix_kernel(
    const float4* __restrict__ p, const float4* __restrict__ g,
    const M* __restrict__ m, const M* __restrict__ v,
    float4* __restrict__ po, M* __restrict__ mo, M* __restrict__ vo,
    const int* __restrict__ src, const float* __restrict__ weights, int K,
    int deg, long long per_worker, int n, AdamConsts c) {
  extern __shared__ float4 s_half[];  // [K][n]: the tile's half-step p
  const long long i0 = (long long)blockIdx.x * n;
  const int total = K * n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int kw = e / n;
    const long long i = i0 + (e - kw * n);
    if (i < per_worker) {
      const long long at = (long long)kw * per_worker + i;
      float4 m_new, v_new;
      s_half[e] = half_step4(p, g, m, v, at, c, &m_new, &v_new);
      store_moment4(mo, at, m_new);
      store_moment4(vo, at, v_new);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int kw = e / n;
    const int ii = e - kw * n;
    const long long i = i0 + ii;
    if (i < per_worker) {
      float4 acc = scale4(__ldg(weights), s_half[e]);
      for (int j = 0; j < deg; ++j) {
        acc = add4(acc, scale4(__ldg(weights + j + 1),
                               s_half[__ldg(src + j * K + kw) * n + ii]));
      }
      po[(long long)kw * per_worker + i] = acc;
    }
  }
}

// the float4 columns of a gossip_adam_mix tile: the widest power of two
// up to kThreads whose [K][n] half-steps fit in kAdamTileBytes (0 when
// not even one column does)
int adam_tile_cols(int K) {
  int n = kThreads;
  while (n > 0 && (long long)K * n * 16 > kAdamTileBytes) n /= 2;
  return n;
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

unsigned flat_blocks(long long n4) {
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)blocks;
}

dim3 grid_for(long long per_worker, int K) {
  long long bx = (per_worker + kThreads - 1) / kThreads;
  long long cap = (long long)sm_count() * 16 / K;
  if (cap < 1) cap = 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, (unsigned)K);
}

template <typename M>
int launch_gossip_adam_mix(const float* p, const float* g, const M* m,
                           const M* v, float* po, M* mo, M* vo,
                           const int* src, const float* weights, int K,
                           int deg, long long n_per_worker, AdamConsts c,
                           void* stream) {
  if (deg < 1 || deg > kMaxGossipAdamDegree) return (int)cudaErrorInvalidValue;
  const long long per_worker = n_per_worker / 4;
  if (per_worker == 0 || K == 0) return 0;
  const int n = adam_tile_cols(K);
  if (n == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (per_worker + n - 1) / n;
  gossip_adam_mix_kernel<M><<<(unsigned)blocks, kThreads, (size_t)K * n * 16,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(g),
      m, v, reinterpret_cast<float4*>(po), mo, vo, src, weights, K, deg,
      per_worker, n, c);
  return (int)cudaGetLastError();
}

}  // namespace

// The gossip_mix and gossip_adam_mix entry points take n_per_worker =
// rows * 128 elements (a multiple of 4) and return cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) marks a degree outside the kernel's table, or a
// K whose gossip_adam_mix tile would not fit in shared memory (K > 3072).
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
  return launch_gossip_adam_mix(
      p, g, m, v, po, mo, vo, src, weights, K, deg, n_per_worker,
      AdamConsts{eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau,
                 weight_decay},
      stream);
}

// f32 p and g, bf16 m and v (8-byte aligned).
extern "C" int gossip_adam_mix_f32_bf16m(
    const float* p, const float* g, const __nv_bfloat16* m,
    const __nv_bfloat16* v, float* po, __nv_bfloat16* mo, __nv_bfloat16* vo,
    const int* src, const float* weights, int K, int deg,
    long long n_per_worker, float eta, float beta1, float one_minus_beta1,
    float beta2, float one_minus_beta2, float tau, float weight_decay,
    void* stream) {
  return launch_gossip_adam_mix(
      p, g, m, v, po, mo, vo, src, weights, K, deg, n_per_worker,
      AdamConsts{eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau,
                 weight_decay},
      stream);
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
  consensus_mix_kernel<<<flat_blocks(n4), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x),
      reinterpret_cast<const float4*>(hat_self), reinterpret_cast<float4*>(out),
      nbrs, deg, n4, gamma);
  return (int)cudaGetLastError();
}

// n is the element count of each (K, rows, 128) buffer, a multiple of 4;
// payload_ptrs and weights are HOST arrays of deg entries, copied by value
// into the launch. Returns cudaGetLastError() after the launch; 1 marks a
// degree outside the kernel's table (cudaErrorInvalidValue).
extern "C" int payload_mix_f32(const float* x, float* out,
                               const void* const* payload_ptrs,
                               const float* weights, int deg, long long n,
                               float self_weight, void* stream) {
  if (deg < 1 || deg > kMaxMixDegree || n % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n4 = n / 4;
  if (n4 == 0) return 0;
  MixPayloads pay{};
  for (int j = 0; j < deg; ++j) {
    pay.p[j] = static_cast<const float4*>(payload_ptrs[j]);
    pay.w[j] = weights[j];
  }
  payload_mix_kernel<<<flat_blocks(n4), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), pay,
      self_weight, deg, n4);
  return (int)cudaGetLastError();
}
