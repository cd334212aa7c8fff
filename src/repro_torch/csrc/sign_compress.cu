// CHOCO error-feedback sign compression over f32 or bf16 buffers viewed as
// (K, n).
//
// Replaces src/repro/kernels/sign_compress.py:sign_compress_stacked
// (_absmean_stacked_kernel, pallas_call at line 174; _apply_stacked_kernel,
// line 192) and sign_compress (lines 65 and 78), its K = 1 case. Per worker
// k and segment s (a leaf's row range of the resident buffer, or the whole
// worker):
//     scale[k, s] = sum |x - hat| over the segment / n_true[s]
//     q           = int8 sign(x - hat)
//     hat_out     = hat + scale[k, s] * sign(x - hat)
// with sign(d) = (d > 0) - (d < 0), so zeros (and the zero padding of the
// resident buffer) stay zero in q and hat_out.
//
// x, hat and hat_out share one dtype T, f32 or bf16: d, |d| and the sums
// are f32 over the widened values, and hat_out is rounded once to T, at
// the store, to nearest-even (dtype.cuh), as the TPU kernel's .astype.
//
// Bound on the H100: bytes. The function must read x and hat once and write q
// (1 byte) and hat_out (4 bytes) once: 13 bytes an element (7 in bf16). No q
// can be scaled before its segment's sum is known, a sum over up to 9.75 M
// elements a worker (DeepFM's embedding leaf), so hat is read twice. But q =
// sign(x - hat) needs no scale: the first pass writes it, and the second pass
// reads hat and q (5 bytes) in place of x and hat (8 bytes). That is 18 bytes
// an element with no reuse at all (10 in bf16), against the 21 of the three
// launches this kernel replaces (absmean_kernel, scale_kernel and
// apply_kernel, which read x and hat twice); whatever of hat and q the
// second pass finds in the 50 MB L2 brings it closer to 13.
//
// One launch. A persistent grid (occupancy x SMs blocks) walks a fixed list
// of work items built on the host (kernels/sign_compress.py:schedule),
// taking items in list order from an atomic counter; each item is one tile
// (at most TILE elements of one segment of one worker):
//   A (first pass): reads x and hat in 16-byte loads, kUnroll of each in
//     flight per thread, writes q and the tile's sum |x - hat| into
//     partials[k, t] (each thread in a fixed order, then a fixed tree over
//     the block), then publishes its arrival on the segment's counter (a
//     fence, then an atomic add). The A item that brings the counter to the
//     segment's tile count sums the segment's partials in a fixed order
//     (thread i its tiles i, i + kThreads, ... in tile order, then the same
//     tree), writes scale[k, s] and, after a fence, adds one more: the
//     scale is taken once per segment and is the same in every run.
//   B (second pass): thread 0 waits until the counter reaches tile count +
//     1 (acquire), reads the scale, and the block reads hat and q and
//     writes hat_out.
// No deadlock: the list puts every A item of a segment before any B item
// of it, and blocks claim items in list order, each finishing its item
// before it starts the next (the next index is claimed one item ahead,
// so each block's claims rise). So the claimed, unfinished item of lowest
// index is always running (were it a block's claim ahead, that block's
// current item would be unfinished and lower): an A item never waits, and
// for a B item every A item of its segment has a lower index, is finished,
// and the last of them has published the scale. The kernel thus finishes
// even if not every block is resident. The list orders the
// work by worker; a segment's B items run in descending tile order, so the
// tiles read last in the first pass are read first in the second, and
// start two grids' worth of items after the segment's last A item, so that
// a block rarely finds its segment unfinished.
// Cache hints: x is read once (L2 evict_first) and hat and q are read
// last in the second pass (evict_first); hat_out is a streaming store.
// Marking hat and q evict_last in the first pass changed nothing
// measurable on the H100, and an L2 set-aside for persisting lines made
// the kernel slower, so neither is used: the times stay near the 18-byte
// floor. The counters are zeroed on the stream at every call; nothing
// persists between calls.
//
// The 2D worker x model layout (sign_compress_stacked(reduce_axis=)): x
// is one model shard's block of each segment, and a segment's scale is
// the sum over the M shards of a worker divided by the segment's global
// true count. A sum across processes cannot happen inside a launch, so
// the same kernel runs as two launches of one call, each over its own
// half of the work list:
//   phase 1 walks the A items only: q and the partials as above, and the
//     A item that completes a segment writes the segment's sum of
//     |x - hat| (in the same fixed order, not divided) where the scale
//     would go;
//   phase 2 walks the B items only: the scales are an input (the host
//     summed the M shards' sums in model-index order and divided by the
//     true counts), so no B item waits.
// Phase 0 is the one launch above. The bytes are the same 18 an element
// over the two launches.
// Loads move four elements (16 bytes of f32, 8 of bf16) and q accesses 4
// (char4) when vec != 0; the last (b - a) % 4 elements of a tile then take
// the scalar path.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
// float4 loads of each operand in flight per thread; with 256 threads and
// at most 80 registers a thread, 3 blocks fit on an SM (78 on sm_90a)
constexpr int kUnroll = 4;

// x, hat and hat_out point to T (the kernel's template argument)
struct Args {
  const void* x;
  const void* hat;
  signed char* q;
  void* hat_out;
  float* scales;
  float* partials;
  // counters[0]: the next item; counters[1 + k * L + s]: segment (k, s)
  unsigned* counters;
  const long long* tile_start;
  const long long* tile_end;
  const int* tile_seg;
  const int* seg_first;
  const float* n_true;
  const int* items;
  int n_items, K, T, L;
  long long n;
  int vec;
  // 0: both passes in one launch; 1: first pass only (writes the raw
  // sums); 2: second pass only (the scales are an input)
  int phase;
};

// A fixed tree over the block; the sum is valid in thread 0. The leading
// barrier lets one block call it twice in a row.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  __syncthreads();
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
  }
  return v;
}

__device__ __forceinline__ int sgn(float d) { return (d > 0.f) - (d < 0.f); }

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// x and hat are not written by the kernel: the non-coherent path, not
// allocated in L1; ld_hint adds an L2 priority. Four elements from group
// i4 on, widened to f32.
__device__ __forceinline__ float4 ld_in(const float* p, long long i4) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p + 4 * i4));
  return v;
}

__device__ __forceinline__ float4 ld_in(const __nv_bfloat16* p,
                                        long long i4) {
  uint2 r;
  asm volatile("ld.global.nc.L1::no_allocate.v2.b32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p + 4 * i4));
  return widen4(r);
}

__device__ __forceinline__ float4 ld_hint(const float* p, long long i4,
                                          unsigned long long pol) {
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p + 4 * i4), "l"(pol));
  return v;
}

__device__ __forceinline__ float4 ld_hint(const __nv_bfloat16* p,
                                          long long i4,
                                          unsigned long long pol) {
  uint2 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v2.b32 {%0, %1}, [%2], "
      "%3;"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p + 4 * i4), "l"(pol));
  return widen4(r);
}

// hat_out is written once and not read in the launch: a streaming store
__device__ __forceinline__ void st_stream(float* p, long long i4, float4 v) {
  __stcs(reinterpret_cast<float4*>(p) + i4, v);
}

__device__ __forceinline__ void st_stream(__nv_bfloat16* p, long long i4,
                                          float4 v) {
  const uint2 r = narrow4(v);
  asm volatile("st.global.cs.v2.b32 [%0], {%1, %2};" ::"l"(p + 4 * i4),
               "r"(r.x), "r"(r.y)
               : "memory");
}

// q is written by other blocks of this launch: read at L2 (.cg)
__device__ __forceinline__ char4 ld_q(const char4* p,
                                      unsigned long long pol) {
  unsigned u;
  asm volatile("ld.global.cg.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(u)
               : "l"(p), "l"(pol));
  return *reinterpret_cast<char4*>(&u);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The first pass over [a, b) of the worker at base: writes q, returns this
// thread's sum of |x - hat|.
template <typename T>
__device__ __forceinline__ float first_pass(const Args& g, long long base,
                                            long long a, long long b) {
  const unsigned long long stream = evict_first_policy();
  const T* x = static_cast<const T*>(g.x) + base;
  const T* hat = static_cast<const T*>(g.hat) + base;
  float acc = 0.f;
  long long tail = a;
  if (g.vec) {
    char4* q4 = reinterpret_cast<char4*>(g.q + base);
    const long long e = b / 4;
    for (long long i0 = a / 4 + threadIdx.x; i0 < e;
         i0 += kThreads * kUnroll) {
      float4 X[kUnroll], H[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        if (i < e) {
          X[u] = ld_hint(x, i, stream);
          H[u] = ld_in(hat, i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        if (i < e) {
          const float dx = X[u].x - H[u].x, dy = X[u].y - H[u].y,
                      dz = X[u].z - H[u].z, dw = X[u].w - H[u].w;
          acc += fabsf(dx);
          acc += fabsf(dy);
          acc += fabsf(dz);
          acc += fabsf(dw);
          q4[i] = make_char4((signed char)sgn(dx), (signed char)sgn(dy),
                             (signed char)sgn(dz), (signed char)sgn(dw));
        }
      }
    }
    tail = b / 4 * 4;
  }
  for (long long i = tail + threadIdx.x; i < b; i += kThreads) {
    const float d = load1(x, i) - load1(hat, i);
    acc += fabsf(d);
    g.q[base + i] = (signed char)sgn(d);
  }
  return acc;
}

// The second pass over [a, b): hat_out = hat + sc * q.
template <typename T>
__device__ __forceinline__ void second_pass(const Args& g, long long base,
                                            long long a, long long b,
                                            float sc) {
  const unsigned long long drop = evict_first_policy();
  const T* hat = static_cast<const T*>(g.hat) + base;
  T* out = static_cast<T*>(g.hat_out) + base;
  long long tail = a;
  if (g.vec) {
    const char4* q4 = reinterpret_cast<const char4*>(g.q + base);
    const long long e = b / 4;
    for (long long i0 = a / 4 + threadIdx.x; i0 < e;
         i0 += kThreads * kUnroll) {
      float4 H[kUnroll];
      char4 Q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        if (i < e) {
          H[u] = ld_hint(hat, i, drop);
          Q[u] = ld_q(q4 + i, drop);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        if (i < e) {
          st_stream(out, i, make_float4(H[u].x + sc * (float)Q[u].x,
                                        H[u].y + sc * (float)Q[u].y,
                                        H[u].z + sc * (float)Q[u].z,
                                        H[u].w + sc * (float)Q[u].w));
        }
      }
    }
    tail = b / 4 * 4;
  }
  for (long long i = tail + threadIdx.x; i < b; i += kThreads) {
    store1(out, i, load1(hat, i) + sc * (float)__ldcg(g.q + base + i));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    sign_compress_kernel(const Args g) {
  __shared__ int next_item;
  __shared__ int last_arrival;
  __shared__ float seg_scale;
  // an empty segment has no tile and no A item: its scale (its sum in
  // phase 1) is 0; in phase 2 the scales are an input
  for (int i = blockIdx.x * kThreads + threadIdx.x;
       g.phase != 2 && i < g.K * g.L; i += gridDim.x * kThreads) {
    const int s = i % g.L;
    if (g.seg_first[s + 1] == g.seg_first[s]) g.scales[i] = 0.f;
  }
  if (threadIdx.x == 0) next_item = (int)atomicAdd(g.counters, 1u);
  __syncthreads();
  int item = next_item;
  while (item < g.n_items) {
    int ahead = 0;
    if (threadIdx.x == 0) ahead = (int)atomicAdd(g.counters, 1u);
    const int code = g.items[item];
    const int kt = code >> 1;
    const int k = kt / g.T, t = kt % g.T, s = g.tile_seg[t];
    const long long base = (long long)k * g.n;
    const long long a = g.tile_start[t], b = g.tile_end[t];
    unsigned* seg_count = g.counters + 1 + k * g.L + s;
    const unsigned tiles = (unsigned)(g.seg_first[s + 1] - g.seg_first[s]);
    if ((code & 1) == 0) {
      const float sum = block_sum(first_pass<T>(g, base, a, b));
      if (threadIdx.x == 0) {
        g.partials[(long long)k * g.T + t] = sum;
        __threadfence();
        const unsigned before = atomicAdd(seg_count, 1u);
        if (before == tiles - 1) __threadfence();
        last_arrival = before == tiles - 1;
      }
      __syncthreads();
      if (last_arrival) {
        const float* part = g.partials + (long long)k * g.T + g.seg_first[s];
        float acc = 0.f;
        for (unsigned i = threadIdx.x; i < tiles; i += kThreads) {
          acc += __ldcg(part + i);
        }
        acc = block_sum(acc);
        if (threadIdx.x == 0) {
          g.scales[k * g.L + s] = g.phase == 1 ? acc : acc / g.n_true[s];
          __threadfence();
          atomicAdd(seg_count, 1u);
        }
      }
    } else {
      if (threadIdx.x == 0) {
        if (g.phase == 0) {
          while (ld_acquire(seg_count) < tiles + 1) __nanosleep(64);
        }
        seg_scale = __ldcg(g.scales + k * g.L + s);
      }
      __syncthreads();
      second_pass<T>(g, base, a, b, seg_scale);
    }
    if (threadIdx.x == 0) next_item = ahead;
    __syncthreads();
    item = next_item;
  }
}

template <typename T>
int launch_sign_compress(const T* x, const T* hat, signed char* q,
                         T* hat_out, float* scales, float* partials,
                         unsigned* counters, const long long* tile_start,
                         const long long* tile_end, const int* tile_seg,
                         const int* seg_first, const float* n_true,
                         const int* items, int n_items, int K, int T_,
                         int L, long long n, int vec, int grid, int phase,
                         void* stream) {
  if (K <= 0 || L <= 0 || n <= 0 || n_items <= 0) return 0;
  if (K > 65535 || grid <= 0 || phase < 0 || phase > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counters, 0, sizeof(unsigned) * (1 + (size_t)K * L), s);
  if (err != cudaSuccess) return (int)err;
  const Args g{x,        hat,        q,        hat_out,  scales,
               partials, counters,   tile_start, tile_end, tile_seg,
               seg_first, n_true,    items,    n_items,  K,
               T_,       L,          n,        vec,      phase};
  sign_compress_kernel<T><<<grid < n_items ? grid : n_items, kThreads, 0,
                            s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the persistent grid on `device` for x of param_bytes (4: f32,
// 2: bf16): resident blocks per SM by occupancy times the SM count; a
// negative cudaError_t on failure.
extern "C" int sign_compress_grid(int device, int param_bytes) {
  int sms = 0, per_sm = 0;
  int err =
      (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == 0) {
    err = with_dtype(param_bytes, [&](auto t) {
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sign_compress_kernel<typename decltype(t)::type>, kThreads,
          0);
    });
  }
  if (err != 0) return -err;
  return sms * (per_sm > 0 ? per_sm : 1);
}

// x, hat, hat_out: K * n elements of param_bytes (4: f32, 2: bf16); q:
// K * n int8; scales: K * L f32; partials: K * T f32 scratch; counters:
// 1 + K * L uint32 scratch, zeroed here on the stream. tile_start /
// tile_end (int64), tile_seg (int32, T entries), seg_first (int32, L + 1
// entries), n_true (f32, L entries) and items (int32, n_items entries:
// ((k * T + t) << 1) | pass; 2 K T in phase 0, the K T A items in phase
// 1, the K T B items in phase 2) are device tables. In phase 1 `scales`
// receives the raw per-segment sums and n_true is not read; in phase 2
// `scales` is read and partials are not used. vec != 0 promises that
// every tile starts at a multiple of 4 within its worker, that every
// worker starts 16 bytes aligned (K == 1 or n a multiple of 4) and that x,
// hat, q and hat_out are 16-byte aligned. Launches min(grid, n_items)
// blocks. Returns the first non-zero cudaError_t of the memset and the
// launch.
extern "C" int sign_compress(const void* x, const void* hat, signed char* q,
                             void* hat_out, float* scales, float* partials,
                             unsigned* counters, const long long* tile_start,
                             const long long* tile_end, const int* tile_seg,
                             const int* seg_first, const float* n_true,
                             const int* items, int n_items, int K, int T_,
                             int L, long long n, int vec, int grid, int phase,
                             int param_bytes, void* stream) {
  return with_dtype(param_bytes, [&](auto t) {
    using T = typename decltype(t)::type;
    return launch_sign_compress(
        static_cast<const T*>(x), static_cast<const T*>(hat), q,
        static_cast<T*>(hat_out), scales, partials, counters, tile_start,
        tile_end, tile_seg, seg_first, n_true, items, n_items, K, T_, L, n,
        vec, grid, phase, stream);
  });
}
