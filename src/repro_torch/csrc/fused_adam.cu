// fused_adam: the D-Adam local step in one pass over the packed buffers.
//
// Replaces the TPU kernel src/repro/kernels/fused_adam.py:fused_adam
// (_adam_kernel, pallas_call at line 66).
//
// Bound on the H100: bytes. Per element it reads p, g, m, v and writes
// p, m, v: 3 of the parameter dtype T and 4 of the moment dtype M, 28
// bytes at f32 / f32, 22 at bf16 params and f32 moments, 20 at f32 params
// and bf16 moments, 14 at bf16 / bf16, against about 15 f32 operations,
// far below the card's operations-per-byte line. Each byte
// is touched once, so the design keeps the copies in flight without
// spending threads on them and streams through memory in order:
//
// - A persistent grid: the resident blocks an SM (by occupancy at this
//   kernel's shared memory: 2 at f32 / f32, 3 with one operand pair bf16, 4 at
//   bf16 / bf16) times the SM count, fewer for a short body. The
//   16-byte-aligned body is dealt in whole tiles round robin, so each round of
//   the grid's tiles is one contiguous window of every operand (blocks that
//   each took one contiguous run measured slower: the memory serves a window
//   in order better than hundreds of scattered streams), and what the last
//   whole round leaves is split evenly, in quanta of 16 bytes of the narrowest
//   operand (4 elements at f32 / f32, else 8), over all blocks: no ragged last
//   wave.
// - A ring of kStages stages in shared memory, each one tile (kTile
//   elements) of p, g, m and v. Thread 0 fills a stage with four 1D bulk
//   copies (cp.async.bulk, the TMA's linear form) that complete on the
//   stage's mbarrier; all threads compute from the stage, write p, m and v
//   back into it in place, and thread 0 sends them out with three bulk
//   stores (one bulk group a tile). A stage is refilled with the tile
//   kStages on once its stores have read it (wait_group.read 1, a tile
//   later), so kStages - 1 tiles load while one computes. The copies carry
//   an L2 cache policy (l2_policy): evict-normal, since evict-first, which
//   bytes touched once would seem to want, measured no faster.
// - The unaligned head (a view such as t[1:n+1]) and the ragged tail run
//   as scalar code in the same launch, spread over the whole grid. Where
//   the seven operands are misaligned by different amounts there is no
//   body, and the whole call runs that scalar loop.
//
// The tile, the stages, the hints, and this design against a register-only
// one (scripts/fused_adam_regs.cu) were chosen by scripts/fused_adam_ab.py:
// on an NVIDIA H100 80GB HBM3 every design there, the kernel this one
// replaced too, lands at 86-88% of the data-sheet rate: the card's memory,
// not the kernel, is what is left.
//
// The host path (kernels/fused_adam.py) costs 16-27 us a call on that
// card's hosts, up to a quarter of this kernel's time on one rank's
// comm='axis' shard: three output allocations and the ctypes call with its
// launch are most of it. The wrapper reads each operand once, computes the
// head and body, and passes the seven constants as one cached struct; this
// launcher caches the grid per device. The arithmetic is adam_math.cuh's
// adam_half_step, shared with gossip_adam_mix. Outputs are out of place. p and
// g are f32 or bf16 (T), m and v f32 or bf16 (M): one template, one entry
// that takes both widths and picks the instance. A stage holds kTile elements of each operand whatever its dtype, so
// a bf16 operand halves its bytes in the stage: 48 KB of ring at bf16 / bf16,
// 72 KB with one pair bf16, 96 KB at f32 / f32.
#include <cuda_runtime.h>

#include <cstdint>

#include "adam_math.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;   // elements of each operand a stage holds
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;

template <typename T, typename M>
__host__ __device__ constexpr int stage_bytes() {
  return kTile * (2 * (int)sizeof(T) + 2 * (int)sizeof(M));
}

// the body's unit: 16 bytes of the narrowest operand
template <typename T, typename M>
__host__ __device__ constexpr long long quantum() {
  return 16 / (long long)(sizeof(T) < sizeof(M) ? sizeof(T) : sizeof(M));
}

// the L2 cache policy of every bulk copy
__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from 16-byte-aligned global memory into
// shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(
          hopper::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar)), "l"(policy)
      : "memory");
}

// `bytes` from shared memory to 16-byte-aligned global memory, in the
// thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(hopper::smem_addr(src)), "r"(bytes), "l"(policy)
      : "memory");
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const T* __restrict__ p, const T* __restrict__ g,
                      const M* __restrict__ m, const M* __restrict__ v,
                      T* __restrict__ po, M* __restrict__ mo,
                      M* __restrict__ vo, long long n, long long head,
                      long long body, AdamConsts c) {
  // the scalar elements: the head [0, head) and the tail [head + body, n)
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
       k < n - body; k += stride) {
    const long long i = k < head ? k : k + body;
    float pn, mn, vn;
    adam_half_step(load1(p, i), load1(g, i), load1(m, i), load1(v, i), c,
                   &pn, &mn, &vn);
    store1(po, i, pn);
    store1(mo, i, mn);
    store1(vo, i, vn);
  }
  // this block's pieces of the body: whole tiles dealt round robin (a
  // round of the grid's tiles is one contiguous window of each operand,
  // so the card streams through memory in order), then its even share, in
  // quanta, of what the last whole round leaves
  const long long round = (long long)gridDim.x * kTile;
  const long long rounds = body / round;
  const long long rest = head + rounds * round;
  const long long rest_units = (body - rounds * round) / quantum<T, M>();
  const long long rest_lo =
      rest + (long long)blockIdx.x * rest_units / gridDim.x * quantum<T, M>();
  const long long rest_hi =
      rest + ((long long)blockIdx.x + 1) * rest_units / gridDim.x *
                 quantum<T, M>();
  const int tiles = (int)rounds + (rest_hi > rest_lo ? 1 : 0);
  if (tiles == 0) return;
  auto tile_base = [&](int t) {
    return t < rounds ? head + ((long long)t * gridDim.x + blockIdx.x) * kTile
                      : rest_lo;
  };
  auto tile_len = [&](int t) {
    return t < rounds ? kTile : (int)(rest_hi - rest_lo);
  };

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  auto stage = [&](int s) { return smem + s * stage_bytes<T, M>(); };
  // the stage's operands: p and g, then m and v
  auto sp = [&](int s) { return reinterpret_cast<T*>(stage(s)); };
  auto sg = [&](int s) { return sp(s) + kTile; };
  auto sm = [&](int s) { return reinterpret_cast<M*>(sp(s) + 2 * kTile); };
  auto sv = [&](int s) { return sm(s) + kTile; };

  uint64_t policy = 0;
  auto fill = [&](int t, int s) {
    const long long base = tile_base(t);
    const uint32_t len = (uint32_t)tile_len(t);
    hopper::mbar_arrive_expect_tx(&full[s],
                                  len * (2 * sizeof(T) + 2 * sizeof(M)));
    bulk_load(sp(s), p + base, len * sizeof(T), &full[s], policy);
    bulk_load(sg(s), g + base, len * sizeof(T), &full[s], policy);
    bulk_load(sm(s), m + base, len * sizeof(M), &full[s], policy);
    bulk_load(sv(s), v + base, len * sizeof(M), &full[s], policy);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    policy = l2_policy();
    for (int t = 0; t < kStages && t < tiles; ++t) fill(t, t);
  }
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (uint32_t)(t / kStages) & 1u);
    const int len = tile_len(t);
    T* ps = sp(s);
    const T* gs = sg(s);
    M* ms = sm(s);
    M* vs = sv(s);
    for (int i = threadIdx.x * 4; i < len; i += kThreads * 4) {
      const float4 P = load4(ps, i / 4);
      const float4 G = load4(gs, i / 4);
      const float4 M4 = load4(ms, i / 4);
      const float4 V = load4(vs, i / 4);
      float4 PO, MO, VO;
      adam_half_step(P.x, G.x, M4.x, V.x, c, &PO.x, &MO.x, &VO.x);
      adam_half_step(P.y, G.y, M4.y, V.y, c, &PO.y, &MO.y, &VO.y);
      adam_half_step(P.z, G.z, M4.z, V.z, c, &PO.z, &MO.z, &VO.z);
      adam_half_step(P.w, G.w, M4.w, V.w, c, &PO.w, &MO.w, &VO.w);
      store4(ps, i / 4, PO);
      store4(ms, i / 4, MO);
      store4(vs, i / 4, VO);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long base = tile_base(t);
      bulk_store(po + base, ps, len * sizeof(T), policy);
      bulk_store(mo + base, ms, len * sizeof(M), policy);
      bulk_store(vo + base, vs, len * sizeof(M), policy);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the previous tile's stores have read their stage: refill it
      if (t >= 1 && t - 1 + kStages < tiles) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        fill(t - 1 + kStages, (t - 1) % kStages);
      }
    }
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Blocks of the persistent grid on `device` (resident blocks an SM at the
// kernel's shared memory, times the SM count), found once per device.
template <typename T, typename M>
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
    err = cudaFuncSetAttribute(fused_adam_kernel<T, M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stage_bytes<T, M>() * kStages);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_adam_kernel<T, M>, kThreads,
        stage_bytes<T, M>() * kStages);
  }
  if (err != cudaSuccess) return err;
  *blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < kMaxDevices) cached[device] = *blocks;
  return cudaSuccess;
}

template <typename T, typename M>
int launch_fused_adam(const T* p, const T* g, const M* m, const M* v, T* po,
                      M* mo, M* vo, long long n, long long head,
                      long long body, const AdamConsts* c, void* stream) {
  if (n <= 0) return 0;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = grid_limit<T, M>(device, &limit);
  if (err != cudaSuccess) return (int)err;
  // a tile a block at least, or a thread an element of the scalar part
  long long blocks = body > 0 ? (body + kTile - 1) / kTile
                              : (n + kThreads - 1) / kThreads;
  if (blocks > limit) blocks = limit;
  if (blocks < 1) blocks = 1;
  fused_adam_kernel<T, M><<<(unsigned)blocks, kThreads,
                            body > 0 ? stage_bytes<T, M>() * kStages : 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, po, mo, vo, n, head, body, *c);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the persistent grid on `device` with f32 (4) or bf16 (2)
// params (param_bytes) and moments (moment_bytes): at most this many run,
// fewer for a short body; a negative cudaError_t on failure.
extern "C" int fused_adam_grid(int device, int param_bytes,
                               int moment_bytes) {
  int blocks = 0;
  const int err = with_dtype(param_bytes, [&](auto t) {
    return with_dtype(moment_bytes, [&](auto mt) {
      return (int)grid_limit<typename decltype(t)::type,
                             typename decltype(mt)::type>(device, &blocks);
    });
  });
  return err == 0 ? blocks : -err;
}

// Returns a cudaError_t (0 when the launch was accepted). p, g and po hold
// param_bytes an element, m, v, mo and vo moment_bytes (4: f32, 2: bf16).
// Elements [head, head + body) are the body: head + body <= n, body a
// multiple of 16 bytes of the narrowest operand (4 elements at f32 / f32,
// else 8), and when body > 0 all seven pointers advanced by head elements
// are 16-byte aligned. The rest run as scalars. c points to the seven f32
// constants in host memory, read at the launch.
extern "C" int fused_adam(const void* p, const void* g, const void* m,
                          const void* v, void* po, void* mo, void* vo,
                          long long n, long long head, long long body,
                          const AdamConsts* c, int param_bytes,
                          int moment_bytes, void* stream) {
  return with_dtype(param_bytes, [&](auto t) {
    return with_dtype(moment_bytes, [&](auto mt) {
      using T = typename decltype(t)::type;
      using M = typename decltype(mt)::type;
      return launch_fused_adam(
          static_cast<const T*>(p), static_cast<const T*>(g),
          static_cast<const M*>(m), static_cast<const M*>(v),
          static_cast<T*>(po), static_cast<M*>(mo), static_cast<M*>(vo), n,
          head, body, c, stream);
    });
  });
}
