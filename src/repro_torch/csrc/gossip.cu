// Gossip over the resident packed (K, rows, 128) state, f32 or bf16.
//
// gossip_mix replaces src/repro/kernels/gossip.py:gossip_mix (_mix_kernel,
// pallas_call at line 124):
//     out[k] = w_self * x[k] + sum_j w_j * x[src_j(k)]
// accumulated in f32, the self term first, then the offsets in order.
//
// gossip_adam_mix replaces src/repro/kernels/gossip.py:gossip_adam_mix
// (_gossip_adam_kernel, pallas_call at line 258): the Adam half-step of
// every worker from its (p, g, m, v), rounded to p's dtype, then mixed as
// above; it writes the mixed p and each worker's own m and v. p and g are
// f32 or bf16 (T), m and v f32 or bf16 (M), computed in f32 and rounded at
// the store (adam_math.cuh).
// Bound: bytes, p, g, m, v read once and p, m, v written once (7 buffers:
// 3 T and 4 M, 28 bytes an element at f32 / f32, 14 at bf16 / bf16).
// One block owns a tile of n float4 columns of every worker, the same
// index range in each: it takes the K half-steps of the tile once, writes
// m and v at once and keeps the half-step p in shared memory ([K][n],
// K * n * 16 B, at most kAdamTileBytes; with bf16 params each half-step is
// rounded through bf16 and widened back before it goes there, the TPU
// kernel's order), then after one barrier writes
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
// The buffers of one call share one dtype T, f32 or bf16, and every sum
// runs in f32 with one rounding to T at the store. gossip_mix, payload_mix
// and consensus_mix move 16-byte vectors (4 f32 or 8 bf16 elements a
// thread), so a bf16 buffer halves their bytes; gossip_adam_mix moves
// groups of four elements (16 bytes of f32, 8 of bf16). The wrappers check
// the alignment. One payload_mix launch takes at most kMaxMixDegree
// payloads; the wrapper chains launches past that through an f32
// accumulator (acc_in, and an f32 out for all but the last), so the sum
// rounds to T once, as the plain version's does.
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
  const void* hat[kMaxConsensusDegree];
  float w[kMaxConsensusDegree];
};

struct MixPayloads {
  const void* p[kMaxMixDegree];
  float w[kMaxMixDegree];
};

__device__ __forceinline__ float4 scale4(float w, float4 a) {
  return make_float4(w * a.x, w * a.y, w * a.z, w * a.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// per_worker is in elements; each thread step moves one 16-byte vector
template <typename T>
__global__ void gossip_mix_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  const int* __restrict__ src,
                                  const float* __restrict__ weights, int K,
                                  int deg, long long per_worker) {
  constexpr int N = kVec<T>;
  __shared__ int s_src[kMaxMixDegree];
  __shared__ float s_w[kMaxMixDegree + 1];
  const int k = blockIdx.y;
  if (threadIdx.x < deg) s_src[threadIdx.x] = src[threadIdx.x * K + k];
  if (threadIdx.x <= deg) s_w[threadIdx.x] = weights[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long vecs = per_worker / N;
  const T* xk = x + (long long)k * per_worker;
  T* ok = out + (long long)k * per_worker;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < vecs; i += stride) {
    float acc[N], nb[N];
    load_vec<N>(xk, i * N, nb);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = s_w[0] * nb[e];
    for (int j = 0; j < deg; ++j) {
      load_vec<N>(x + (long long)s_src[j] * per_worker, i * N, nb);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = acc[e] + s_w[j + 1] * nb[e];
    }
    store_vec<N>(ok, i * N, acc);
  }
}

// acc_in (f32) replaces w_self * x where a chained launch goes on from
// the previous one's sum; out is T, or f32 where another launch follows
template <typename T, typename TO>
__global__ void payload_mix_kernel(const T* __restrict__ x,
                                   const float* __restrict__ acc_in,
                                   TO* __restrict__ out, MixPayloads pay,
                                   float w_self, int deg, long long n) {
  constexpr int N = kVec<T>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long vecs = n / N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < vecs; i += stride) {
    float acc[N], pv[N];
    if (acc_in != nullptr) {
      load_vec<N>(acc_in, i * N, acc);
    } else {
      load_vec<N>(x, i * N, pv);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = w_self * pv[e];
    }
    for (int j = 0; j < deg; ++j) {
      load_vec<N>(static_cast<const T*>(pay.p[j]), i * N, pv);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = acc[e] + pay.w[j] * pv[e];
    }
    store_vec<N>(out, i * N, acc);
  }
}

template <typename T>
__global__ void consensus_mix_kernel(const T* __restrict__ x,
                                     const T* __restrict__ hat_self,
                                     T* __restrict__ out, ConsensusNbrs nbrs,
                                     int deg, long long n, float gamma) {
  constexpr int N = kVec<T>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long vecs = n / N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < vecs; i += stride) {
    float hs[N], acc[N], hn[N];
    load_vec<N>(hat_self, i * N, hs);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
    for (int j = 0; j < deg; ++j) {
      load_vec<N>(static_cast<const T*>(nbrs.hat[j]), i * N, hn);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = acc[e] + nbrs.w[j] * (hn[e] - hs[e]);
    }
    load_vec<N>(x, i * N, hn);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = hn[e] + gamma * acc[e];
    store_vec<N>(out, i * N, acc);
  }
}

// the half-step of four elements (group i), rounded through T and widened
template <typename T, typename M>
__device__ __forceinline__ float4 half_step4(const T* __restrict__ p,
                                             const T* __restrict__ g,
                                             const M* __restrict__ m,
                                             const M* __restrict__ v,
                                             long long i, const AdamConsts& c,
                                             float4* mo, float4* vo) {
  float4 P = load4(p, i), G = load4(g, i), M4 = load4(m, i), V = load4(v, i),
         PO;
  adam_half_step(P.x, G.x, M4.x, V.x, c, &PO.x, &mo->x, &vo->x);
  adam_half_step(P.y, G.y, M4.y, V.y, c, &PO.y, &mo->y, &vo->y);
  adam_half_step(P.z, G.z, M4.z, V.z, c, &PO.z, &mo->z, &vo->z);
  adam_half_step(P.w, G.w, M4.w, V.w, c, &PO.w, &mo->w, &vo->w);
  return round4<T>(PO);
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads) gossip_adam_mix_kernel(
    const T* __restrict__ p, const T* __restrict__ g,
    const M* __restrict__ m, const M* __restrict__ v, T* __restrict__ po,
    M* __restrict__ mo, M* __restrict__ vo, const int* __restrict__ src,
    const float* __restrict__ weights, int K, int deg, long long per_worker,
    int n, AdamConsts c) {
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
      store4(mo, at, m_new);
      store4(vo, at, v_new);
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
      store4(po, (long long)kw * per_worker + i, acc);
    }
  }
}

// the four-element columns of a gossip_adam_mix tile: the widest power of
// two up to kThreads whose [K][n] f32 half-steps fit in kAdamTileBytes (0
// when not even one column does)
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

unsigned flat_blocks(long long vecs) {
  long long blocks = (vecs + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)blocks;
}

dim3 grid_for(long long vecs, int K) {
  long long bx = (vecs + kThreads - 1) / kThreads;
  long long cap = (long long)sm_count() * 16 / K;
  if (cap < 1) cap = 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, (unsigned)K);
}

template <typename T>
int launch_gossip_mix(const T* x, T* out, const int* src,
                      const float* weights, int K, int deg,
                      long long n_per_worker, void* stream) {
  if (deg < 0 || deg > kMaxMixDegree || n_per_worker % kVec<T> != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long vecs = n_per_worker / kVec<T>;
  if (vecs == 0 || K == 0) return 0;
  gossip_mix_kernel<T><<<grid_for(vecs, K), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, out, src, weights, K, deg, n_per_worker);
  return (int)cudaGetLastError();
}

template <typename T, typename M>
int launch_gossip_adam_mix(const T* p, const T* g, const M* m, const M* v,
                           T* po, M* mo, M* vo, const int* src,
                           const float* weights, int K, int deg,
                           long long n_per_worker, float eta, float beta1,
                           float one_minus_beta1, float beta2,
                           float one_minus_beta2, float tau,
                           float weight_decay, void* stream) {
  if (deg < 1 || deg > kMaxGossipAdamDegree) return (int)cudaErrorInvalidValue;
  const long long per_worker = n_per_worker / 4;
  if (per_worker == 0 || K == 0) return 0;
  const int n = adam_tile_cols(K);
  if (n == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (per_worker + n - 1) / n;
  gossip_adam_mix_kernel<T, M><<<(unsigned)blocks, kThreads,
                                 (size_t)K * n * 16,
                                 static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, po, mo, vo, src, weights, K, deg, per_worker, n,
      AdamConsts{eta, beta1, one_minus_beta1, beta2, one_minus_beta2, tau,
                 weight_decay});
  return (int)cudaGetLastError();
}

template <typename T>
int launch_consensus_mix(const T* x, const T* hat_self, T* out,
                         const void* const* nbr_ptrs, const float* weights,
                         int deg, long long n, float gamma, void* stream) {
  if (deg < 1 || deg > kMaxConsensusDegree || n % kVec<T> != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long vecs = n / kVec<T>;
  if (vecs == 0) return 0;
  ConsensusNbrs nbrs{};
  for (int j = 0; j < deg; ++j) {
    nbrs.hat[j] = nbr_ptrs[j];
    nbrs.w[j] = weights[j];
  }
  consensus_mix_kernel<T><<<flat_blocks(vecs), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, hat_self, out, nbrs, deg, n, gamma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_payload_mix(const T* x, const float* acc_in, void* out,
                       int out_f32, const void* const* payload_ptrs,
                       const float* weights, int deg, long long n,
                       float self_weight, void* stream) {
  if (deg < 1 || deg > kMaxMixDegree || n % kVec<T> != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long vecs = n / kVec<T>;
  if (vecs == 0) return 0;
  MixPayloads pay{};
  for (int j = 0; j < deg; ++j) {
    pay.p[j] = payload_ptrs[j];
    pay.w[j] = weights[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    payload_mix_kernel<T, float><<<flat_blocks(vecs), kThreads, 0, s>>>(
        x, acc_in, static_cast<float*>(out), pay, self_weight, deg, n);
  } else {
    payload_mix_kernel<T, T><<<flat_blocks(vecs), kThreads, 0, s>>>(
        x, acc_in, static_cast<T*>(out), pay, self_weight, deg, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) marks a degree outside the kernel's table, an
// element count that is not a whole number of the kernel's vectors, a K
// whose gossip_adam_mix tile would not fit in shared memory (K > 3072), or
// a width other than 4 (f32) and 2 (bf16). param_bytes is the element
// width of the buffer and of every buffer of its dtype (g, the payloads,
// the hats); moment_bytes that of gossip_adam_mix's m and v.
//
// gossip_mix: n_per_worker = rows * 128 elements.
extern "C" int gossip_mix(const void* x, void* out, const int* src,
                          const float* weights, int K, int deg,
                          long long n_per_worker, int param_bytes,
                          void* stream) {
  return with_dtype(param_bytes, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_gossip_mix(static_cast<const T*>(x), static_cast<T*>(out),
                             src, weights, K, deg, n_per_worker, stream);
  });
}

// gossip_adam_mix: n_per_worker = rows * 128 elements; the p and g
// buffers 16-byte (f32) or 8-byte (bf16) aligned, m and v likewise.
extern "C" int gossip_adam_mix(const void* p, const void* g, const void* m,
                               const void* v, void* po, void* mo, void* vo,
                               const int* src, const float* weights, int K,
                               int deg, long long n_per_worker, float eta,
                               float beta1, float one_minus_beta1,
                               float beta2, float one_minus_beta2, float tau,
                               float weight_decay, int param_bytes,
                               int moment_bytes, void* stream) {
  return with_dtype(param_bytes, [&](auto t) {
    return with_dtype(moment_bytes, [&](auto mt) {
      using T = typename decltype(t)::type;
      using M = typename decltype(mt)::type;
      return launch_gossip_adam_mix(
          static_cast<const T*>(p), static_cast<const T*>(g),
          static_cast<const M*>(m), static_cast<const M*>(v),
          static_cast<T*>(po), static_cast<M*>(mo), static_cast<M*>(vo), src,
          weights, K, deg, n_per_worker, eta, beta1, one_minus_beta1, beta2,
          one_minus_beta2, tau, weight_decay, stream);
    });
  });
}

// consensus_mix: n is the element count of each (K, rows, 128) buffer;
// nbr_ptrs and weights are HOST arrays of deg entries, copied by value into
// the launch.
extern "C" int consensus_mix(const void* x, const void* hat_self, void* out,
                             const void* const* nbr_ptrs,
                             const float* weights, int deg, long long n,
                             float gamma, int param_bytes, void* stream) {
  return with_dtype(param_bytes, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_consensus_mix(static_cast<const T*>(x),
                                static_cast<const T*>(hat_self),
                                static_cast<T*>(out), nbr_ptrs, weights, deg,
                                n, gamma, stream);
  });
}

// payload_mix: n is the element count of each (K, rows, 128) buffer;
// payload_ptrs and weights are HOST arrays of deg entries, copied by value
// into the launch. acc_in is null on a call's first launch (the sum starts
// at self_weight * x) and the previous launch's f32 out on a chained one;
// out is f32 when out_f32 != 0 (another launch follows), else the
// buffer's dtype.
extern "C" int payload_mix(const void* x, const float* acc_in, void* out,
                           int out_f32, const void* const* payload_ptrs,
                           const float* weights, int deg, long long n,
                           float self_weight, int param_bytes, void* stream) {
  return with_dtype(param_bytes, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_payload_mix(static_cast<const T*>(x), acc_in, out, out_f32,
                              payload_ptrs, weights, deg, n, self_weight,
                              stream);
  });
}
