// rwkv_scan: the RWKV6 WKV recurrence, per (batch row, head), over the
// whole sequence in one launch.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan.py: rwkv_scan
// (_wkv_kernel, pallas_call at line 78). It computes that kernel's
// function, not its block structure. With the state S (D x D, key x value)
// and every operand in f32:
//
//   kv_ij = k_i * v_j
//   y_j   = sum_i r_i * (S_ij + u_i * kv_ij)
//   S_ij  = w_i * S_ij + kv_ij
//
// r, k, v are (B, S, H, D) f32 or bf16 and w is (B, S, H, D) f32, all read
// in place through their strides (the head dim must be unit-stride); u is
// (H, D) f32; the state in and out is a contiguous (B, H, D, D) f32 tensor
// (the state in may start at any float: it is read as float2 only when it
// starts on an 8-byte boundary);
// y is a contiguous (B, S, H, D) f32 tensor. kernels/rwkv_scan.py binds
// it to PyTorch through ctypes (rwkv_scan_fwd below).
//
// Bound on the H100: per (b, h, t) the recurrence does 4 * D^2 operations
// on 4 * D inputs and D outputs, so at the serving shapes (D = 64) it sits
// near the balance point, bytes binding by a hair (~5.4 GFLOP against
// ~0.3 GB at B = 8, S = 1024, H = 40). The TPU kernel's sequential chunk
// grid becomes a loop inside the block, so the parallelism is only across
// (b, h, value column j), and what binds a design that keeps the state on
// chip is latency and issue slots. This design answers with:
//
//   - the key dim split across lanes: L = D / 16 lanes (D / 8 at D = 32)
//     share one pair of value columns (j, j + 1), each holding 16 (8) keys
//     of S[:, j] and S[:, j + 1] in registers (128 threads a block at
//     D = 64), in groups of 4 keys interleaved across the lanes so that
//     their float4 reads of shared memory hit distinct banks; one read of
//     r_i, k_i and w_i serves both columns. The lanes' partial y_j meet by
//     __shfl_xor_sync in a fixed order, so every lane gets the same sum,
//     two steps an iteration so that one step's reduction overlaps the
//     next step's work;
//   - the bonus term taken out of the inner loop: y_j = sum_i r_i * S_ij +
//     v_j * (sum_i r_i * u_i * k_i), the second sum computed once per step
//     for the block, so the inner loop is one fmaf for y and the state's
//     multiply, multiply and add;
//   - double-buffered staging: r, k, v (at their own type) and w are
//     copied into shared memory with 16-byte cp.async, CT = 1024 / D time
//     steps a chunk, chunk c + 1 in flight while chunk c is computed (and
//     chunk 0 while the state loads). bf16 r and k are converted to f32
//     once per chunk, in the pass that sums the bonus term. Operands whose
//     base or strides are not 16-byte multiples are staged with plain
//     loads by the same kernel instead;
//   - a decode step (S = 1) stages nothing and waits at no barrier: each
//     thread reads its keys of r, k, w and u and its columns of v from
//     device memory and sums its own keys' share of the bonus term, so the
//     launch is the state's read and write.
//
// Rounding: -fmad=false keeps the state's operations apart, and they are
// written as __fmul_rn / __fadd_rn besides: each element is w * S rounded
// plus k * v rounded, exactly the plain version's
// `w[..., :, None] * S + k[..., :, None] * v[..., None, :]`, so the final
// state is bit-equal, and two calls that carry it equal one call. y sums
// in another order than the plain version's einsum (f32 tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Params {
  int S, H, vec;
  int svec;  // the state in is 8-byte aligned: read as float2
  long long rs_b, rs_s, rs_h;  // element strides; the head dim is unit
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long ws_b, ws_s, ws_h;
  long long us_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr int JC = 2;  // value columns per thread

// Per head dim: KE keys per thread (16, 8 at D = 32 for more threads), so
// L = D / KE lanes share each pair of columns; CT time steps per staged
// chunk (a stage of r, k, v and w is 10 to 16 KB, two stages and the f32
// copies of one chunk's r and k fit the 48 KB of static shared memory).
template <typename T, int D>
struct Cfg {
  static constexpr int KE = D == 32 ? 8 : 16;
  static constexpr int L = D / KE;
  static constexpr int THREADS = D / JC * L;
  static constexpr int CT = 1024 / D;
  static constexpr bool CONV = sizeof(T) == 2;  // r, k staged as bf16
};

// Copy n rows of D values (row stride `stride` elements) into dst[CT][D].
template <typename U, int D, int THREADS>
__device__ __forceinline__ void stage_rows(U* dst, const U* src,
                                           long long stride, int n,
                                           bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(U);  // values per 16-byte copy
    constexpr int PR = D / PER;          // copies per row
    for (int idx = threadIdx.x; idx < n * PR; idx += THREADS) {
      const int c = idx / PR;
      const int p = idx - c * PR;
      cp_async16(dst + c * D + p * PER, src + c * stride + p * PER);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * D; idx += THREADS) {
      const int c = idx / D;
      const int d = idx - c * D;
      dst[c * D + d] = src[c * stride + d];
    }
  }
}

// four consecutive values (16- or 8-byte aligned) as f32
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS)
    rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, float* __restrict__ y,
                     float* __restrict__ sf, Params p) {
  using C = Cfg<T, D>;
  constexpr int L = C::L;
  constexpr int THREADS = C::THREADS;
  constexpr int CT = C::CT;
  constexpr int NW = (THREADS + 31) / 32;
  constexpr int NG = C::KE / 4;  // groups of 4 keys per thread
  // two stages of r, k, v (at T) and w (f32), each [CT][D], as raw bytes
  // (no constructors run on shared memory); then, for bf16, the chunk's r
  // and k in f32
  constexpr int TB = 2 * CT * D * (int)sizeof(T);
  constexpr int FB = C::CONV ? CT * D * 4 : 0;
  __shared__ __align__(16) unsigned char raw[3 * TB + 2 * CT * D * 4 + 2 * FB];
  __shared__ __align__(16) float us[D];
  __shared__ float ruk[CT];  // sum_i r_i * u_i * k_i per step
  using Rows = T[CT][D];
  using FRows = float[CT][D];
  Rows* rs = reinterpret_cast<Rows*>(raw);
  Rows* ks = reinterpret_cast<Rows*>(raw + TB);
  Rows* vs = reinterpret_cast<Rows*>(raw + 2 * TB);
  FRows* ws = reinterpret_cast<FRows*>(raw + 3 * TB);
  float(*rf)[D] = reinterpret_cast<float(*)[D]>(raw + 3 * TB + 2 * CT * D * 4);
  float(*kf)[D] = rf + CT;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j0 = JC * (tid / L);  // value columns j0 + q, q < JC
  const int lane = tid % L;  // key groups lane + L * g, g < NG
  const long long slab = ((long long)b * p.H + h) * D * D;
  const bool vec = p.vec != 0;
  const bool svec = p.svec != 0;

  const T* rb = r + b * p.rs_b + h * p.rs_h;
  const T* kb = k + b * p.ks_b + h * p.ks_h;
  const T* vb = v + b * p.vs_b + h * p.vs_h;
  const float* wb = w + b * p.ws_b + h * p.ws_h;
  float* yb = y + ((long long)b * p.S * p.H + h) * D + j0;

  // this thread's state: keys i(g, e) = 4 * (lane + L * g) + e, columns
  // j0 .. j0 + JC - 1
  float st[NG][4][JC];
  auto load_state = [&] {
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < JC; q += 2) {
          const float* src =
              s0 + slab + (long long)(4 * (lane + L * g) + e) * D + j0 + q;
          const float2 s2 = svec ? load2(src) : make_float2(src[0], src[1]);
          st[g][e][q] = s2.x;
          st[g][e][q + 1] = s2.y;
        }
  };
  // y's partial sums of one step, over this thread's keys: r_i * S_ij,
  // while the state steps on (r, k, w in f32 at the thread's keys)
  auto step = [&](const float* rr, const float* kk, const float* ww,
                  const float* vj, float* acc) {
#pragma unroll
    for (int q = 0; q < JC; ++q) acc[q] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < JC; ++q) {
          float& s = st[g][e][q];
          const int i = 4 * g + e;
          acc[q] = fmaf(rr[i], s, acc[q]);
          s = __fadd_rn(__fmul_rn(ww[i], s), __fmul_rn(kk[i], vj[q]));
        }
  };
  // the lanes' partials meet in a fixed order; lane 0 writes y_t
  auto finish = [&](float* acc, const float* vj, float bonus, int t) {
#pragma unroll
    for (int o = 1; o < L; o <<= 1)
#pragma unroll
      for (int q = 0; q < JC; ++q)
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
    if (lane == 0) {
      float* yt = yb + (long long)t * p.H * D;
#pragma unroll
      for (int q = 0; q < JC; q += 2)
        *reinterpret_cast<float2*>(yt + q) =
            make_float2(fmaf(vj[q], bonus, acc[q]),
                        fmaf(vj[q + 1], bonus, acc[q + 1]));
    }
  };
  auto store_state = [&] {
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < JC; q += 2)
          *reinterpret_cast<float2*>(
              sf + slab + (long long)(4 * (lane + L * g) + e) * D + j0 + q) =
              make_float2(st[g][e][q], st[g][e][q + 1]);
  };

  if (p.S == 1) {
    // a decode step: no staging and no barrier; each thread reads its keys
    // of r, k, w and u and its columns of v straight from device memory,
    // and takes its own keys' share of the bonus term
    load_state();
    float rr[4 * NG], kk[4 * NG], ww[4 * NG], uu[4 * NG], vj[JC], acc[JC];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int i0 = 4 * (lane + L * g);
      if (vec) {  // 4 keys a load
        load4(rb + i0, rr + 4 * g);
        load4(kb + i0, kk + 4 * g);
        load4(wb + i0, ww + 4 * g);
        load4(u + h * p.us_h + i0, uu + 4 * g);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rr[4 * g + e] = to_f32(rb[i0 + e]);
          kk[4 * g + e] = to_f32(kb[i0 + e]);
          ww[4 * g + e] = wb[i0 + e];
          uu[4 * g + e] = u[h * p.us_h + i0 + e];
        }
      }
    }
    float bonus = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) bonus = fmaf(rr[i] * uu[i], kk[i], bonus);
#pragma unroll
    for (int q = 0; q < JC; ++q) vj[q] = to_f32(vb[j0 + q]);
    step(rr, kk, ww, vj, acc);
#pragma unroll
    for (int q = 0; q < JC; ++q) acc[q] = fmaf(vj[q], bonus, acc[q]);
    finish(acc, vj, 0.f, 0);
    store_state();
    return;
  }

  const int n_chunks = (p.S + CT - 1) / CT;
  auto issue = [&](int ci) {
    const int buf = ci & 1;
    const long long t0 = (long long)ci * CT;
    const int n = min(CT, p.S - (int)t0);
    stage_rows<T, D, THREADS>(&rs[buf][0][0], rb + t0 * p.rs_s, p.rs_s, n,
                              vec);
    stage_rows<T, D, THREADS>(&ks[buf][0][0], kb + t0 * p.ks_s, p.ks_s, n,
                              vec);
    stage_rows<T, D, THREADS>(&vs[buf][0][0], vb + t0 * p.vs_s, p.vs_s, n,
                              vec);
    stage_rows<float, D, THREADS>(&ws[buf][0][0], wb + t0 * p.ws_s, p.ws_s,
                                  n, vec);
  };
  // the first chunk's copies fly while the state and u load
  if (n_chunks > 0) issue(0);
  cp_async_commit();
  load_state();
  for (int i = tid; i < D; i += THREADS) us[i] = u[h * p.us_h + i];

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int t0 = ci * CT;
    const int n = min(CT, p.S - t0);
    if (ci > 0) __syncthreads();  // every thread is done with chunk ci - 1
    if (ci + 1 < n_chunks) issue(ci + 1);
    cp_async_commit();
    cp_async_wait_1();  // this thread's copies of chunk ci have landed
    __syncthreads();    // and everyone else's
    // one warp per step: r and k in f32 (bf16 only) and the bonus term's
    // key sum
    {
      const int warp = tid / 32;
      const int wl = tid % 32;
      for (int c = warp; c < n; c += NW) {
        float s = 0.f;
        for (int i = wl; i < D; i += 32) {
          const float ri = to_f32(rs[buf][c][i]);
          const float ki = to_f32(ks[buf][c][i]);
          if constexpr (C::CONV) {
            rf[c][i] = ri;
            kf[c][i] = ki;
          }
          s = fmaf(ri * us[i], ki, s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (wl == 0) ruk[c] = s;
      }
    }
    __syncthreads();
    const float(*rc)[D] =
        C::CONV ? rf : reinterpret_cast<const float(*)[D]>(&rs[buf][0][0]);
    const float(*kc)[D] =
        C::CONV ? kf : reinterpret_cast<const float(*)[D]>(&ks[buf][0][0]);
    // r, k, w of step c at this thread's keys, and v at its columns
    auto operands = [&](int c, float* rr, float* kk, float* ww, float* vj) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int i0 = 4 * (lane + L * g);
        const float4 r4 = *reinterpret_cast<const float4*>(&rc[c][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&kc[c][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[buf][c][i0]);
        rr[4 * g] = r4.x, rr[4 * g + 1] = r4.y, rr[4 * g + 2] = r4.z,
        rr[4 * g + 3] = r4.w;
        kk[4 * g] = k4.x, kk[4 * g + 1] = k4.y, kk[4 * g + 2] = k4.z,
        kk[4 * g + 3] = k4.w;
        ww[4 * g] = w4.x, ww[4 * g + 1] = w4.y, ww[4 * g + 2] = w4.z,
        ww[4 * g + 3] = w4.w;
      }
#pragma unroll
      for (int q = 0; q < JC; q += 2) {
        const float2 v2 = load2(&vs[buf][c][j0 + q]);
        vj[q] = v2.x;
        vj[q + 1] = v2.y;
      }
    };
    // two steps an iteration: one step's reduction overlaps the next
#pragma unroll 2
    for (int c = 0; c < n; ++c) {
      float rr[4 * NG], kk[4 * NG], ww[4 * NG], vj[JC], acc[JC];
      operands(c, rr, kk, ww, vj);
      step(rr, kk, ww, vj, acc);
      finish(acc, vj, ruk[c], t0 + c);
    }
  }
  store_state();
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sf, int B,
           const Params& p, cudaStream_t stream) {
  const dim3 grid(p.H, B);
  rwkv_scan_kernel<T, D><<<grid, Cfg<T, D>::THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, sf, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* sf, int B,
             int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, sf, B, p, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, sf, B, p, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, s0, y, sf, B, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, long long sb, long long ss, long long sh,
               int size) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sb * size) % 16 == 0 &&
         (ss * size) % 16 == 0 && (sh * size) % 16 == 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (r, k and v alike; w, u and the states are
// f32). Returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for a dtype or head dim it has no
// instance of.
extern "C" int rwkv_scan_fwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sf, int dtype, int B,
    int S, int H, int D, long long rs_b, long long rs_s, long long rs_h,
    long long ks_b, long long ks_s, long long ks_h, long long vs_b,
    long long vs_s, long long vs_h, long long ws_b, long long ws_s,
    long long ws_h, long long us_h, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int size = dtype == 1 ? 2 : 4;
  const int vec = aligned16(r, rs_b, rs_s, rs_h, size) &&
                  aligned16(k, ks_b, ks_s, ks_h, size) &&
                  aligned16(v, vs_b, vs_s, vs_h, size) &&
                  aligned16(w, ws_b, ws_s, ws_h, 4) &&
                  aligned16(u, 0, 0, us_h, 4);
  const int svec = reinterpret_cast<uintptr_t>(s0) % 8 == 0;
  Params p{S,    H,    vec,  svec, rs_b, rs_s, rs_h, ks_b, ks_s,
           ks_h, vs_b, vs_s, vs_h, ws_b, ws_s, ws_h, us_h};
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sff = static_cast<float*>(sf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(r, k, v, wf, uf, s0f, yf, sff, B, D, p, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(r, k, v, wf, uf, s0f, yf, sff, B, D, p,
                                   st);
  return (int)cudaErrorInvalidValue;
}
