// flash_attention: GQA attention with an online softmax, causal and
// sliding-window masks, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel, pallas_call at line 114). It computes
// that kernel's function, not its block structure:
//
//   s = (q . k) * scale          f32, scale = 1/sqrt(D) rounded on the host
//   s = ok ? s : -1e30           causal: k <= q; window w > 0: q - k < w
//   online softmax, m from -1e30 and l from 0, per key tile
//   out = acc / max(l, 1e-30)    cast to q's dtype
//
// with query and key positions both counted from 0 and query head h
// reading kv head h / (Hq / Hk). q is (B, S, Hq, D), k and v (B, T, Hk, D),
// read in place through their strides (the head dim must be unit-stride);
// the output is a contiguous (B, S, Hq, D) tensor of q's dtype.
// kernels/flash_attention.py binds it to PyTorch through ctypes
// (flash_attention_fwd below).
//
// Bound on the H100: at the serving shapes (S = T = 1024, D = 64, bf16) the
// two products are ~34 GFLOP against ~84 MB, so operations bind it, and the
// card's peak for them is its bf16 tensor cores. Two designs:
//
// bf16, D in {32, 64, 96, 112, 128}: tensor cores (flash_wgmma_kernel).
//   - One block per (128-row query tile, query head, batch row), the tiles
//     of a head heaviest (latest, under a causal mask) first: two consumer
//     warpgroups of 64 query rows each and one producer warp.
//   - The producer loads the Q tile once and streams the K and V tiles,
//     64 keys each, with TMA, as bf16, into a ring of five shared-memory
//     stages, each with a full and an empty mbarrier. The tensor maps
//     describe the strided 4-D (B, S, H, D) views and are encoded on the
//     host at each call (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPointByVersion); the tiles land swizzled (128 B
//     rows for D = 64 and 128, 64 B for 32 and 96, 32 B for 112), and rows
//     past S or T arrive as zeros.
//   - S = Q K^T: wgmma m64n64k16, Q and K from shared memory, K-major, f32
//     accumulator (bf16 products are exact in f32; only the order of the
//     sum differs from the plain version).
//   - Softmax in registers on the accumulator fragment: each row's max and
//     sum across the four threads that share it, by shuffles; only tiles
//     that cross the causal diagonal, the window's edge or T take the mask.
//     Scores are kept in log2 units (s * scale * log2 e) and the
//     exponentials are 2^(x - m) by ex2.approx (relative error ~1e-6, far
//     inside the bf16 output's rounding).
//   - O += P V: P stays in registers as wgmma's A operand (the S
//     accumulator's layout is the A fragment's), V is the B operand from
//     shared memory, MN-major (the transpose flag). P is split into
//     P_hi = bf16(p) and P_lo = bf16(p - P_hi), and both go through the
//     product: a single bf16 P would put an error of up to 2^-9 * sum p|v|
//     on outputs near zero, where hi + lo keeps p to about 2^-17.
//   - Software-pipelined: key tile i's S = Q K^T is issued together with
//     tile i - 1's P V, and tile i's softmax runs while that P V is on the
//     tensor cores; O is rescaled once it has landed.
//
// f32, D in {32, 64, 96, 112, 128}: tensor cores in 3xTF32
// (flash_tf32x3_kernel). One TF32 product keeps 11 bits of each operand,
// too coarse for the f32 tolerance. Each operand is split as x = hi + lo,
// hi = x with its low 13 mantissa bits cleared (a TF32 value) and
// lo = x - hi (exact in f32), and each product is the three TF32 products
// hi.hi + hi.lo + lo.hi on an f32 accumulator: the dropped lo.lo and the
// tensor core's reading of lo as TF32 leave about 2^-21 of each product.
// Both products, S = Q K^T and O = P V, take that split. Each k step's
// three mma sum into a zeroed fragment that is then added to the running
// S or O by f32 additions (mma_3xtf32_add): the tensor core truncates as
// it adds into an accumulator, and carried over T = 1500 keys that lay
// 9.4e-6 from a float64 reference at outputs up to 0.73, where the plain
// version lay 9.3e-7 (H100). Bound: 3 TF32
// products of 2 D operations per kept (query, key) pair at the tensor
// cores' 495 TFLOP/s, against 67 TFLOP/s for one f32 product on the CUDA
// cores.
//   - Why mma.sync and not wgmma: wgmma takes .tf32 operands from shared
//     memory only K-major (the transpose flags are for 16-bit types), so
//     P V would need a transposed V tile, and the split copies (K lo, V^T
//     hi and lo, Q hi and lo) beside the raw ring would take ~160 KB per
//     stage at D = 128 with 64-key tiles: no multi-stage ring fits in 227
//     KB. mma.sync.m16n8k8 takes fragments that the threads load
//     themselves, so one raw f32 copy of each tile serves, and each
//     fragment is split in registers as it is loaded: a mask and a
//     subtraction (cvt.rna.tf32.f32 in place of the mask ran 13-16%
//     slower on the H100).
//   - One block per (128-row query tile, query head, batch row), the tiles
//     of a head heaviest (latest, under a causal mask) first; 8 warps of
//     16 query rows. Registers hold the S and O accumulators; the Q tile
//     waits raw in shared memory and its fragments are split at each use
//     (Q beside O in registers spilled at every D). Two 16-row tiles a
//     warp, sharing each K and V fragment, took 246 registers at D = 64
//     and ran slower for the halved warps.
//   - The Q tile and the K and V tiles of 64 keys arrive by 16-byte
//     cp.async; K and V go through a two-stage ring (zero-filled past T;
//     a tile's copies overlap the previous tile's products), with padded
//     rows (D + 8 floats for Q and K, D + 4 for V) so that every fragment
//     load is free of bank conflicts. cp.async needs 16-byte-aligned bases
//     and strides; the wrapper raises on anything else.
//   - No shuffles between the products: the k index of each m16n8k8 is
//     permuted. In Q K^T logical k (t, t + 4) is head dims (2t, 2t + 1),
//     so a K fragment is one 8-byte load; in P V it is keys (2t, 2t + 1),
//     which is where the S accumulator holds them, so P's A fragment is
//     the accumulator itself.
//   - Softmax in registers on the accumulator fragment, as in the bf16
//     kernel: log2 units, ex2.approx (relative error ~1e-6, inside the
//     2e-5 budget with the split's ~2^-21), the mask only on tiles that
//     cross an edge of the band for the warp's rows; a warp skips a key
//     tile that holds no valid key for any of its rows.
//
// Both write their products as explicit wgmma / mma, so -fmad=false does
// not split them; the division stays IEEE (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"


namespace {

// 2^x by the special-function unit (ex2.approx, about 2 ulp)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

// ---- f32: 3xTF32 on the tensor cores --------------------------------------

constexpr int kFRows = 128;    // query rows per block
constexpr int kFKeys = 64;     // keys per tile
constexpr int kFStages = 2;    // K/V ring depth

struct FParams {
  int S, T, Hq, group, causal, window;
  long long qs_b, qs_s, qs_h;  // element strides; the head dim is unit
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  float scale;
};

// Per head dim: the padded row strides (floats; Q's rows as K's), the
// dynamic shared memory of the Q tile and the ring, and two blocks an SM
// where D <= 64 leaves room.
template <int D>
struct FCfg {
  static constexpr int THREADS = 32 * kFRows / 16;  // a warp per 16 rows
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 4;
  static constexpr int Q_TILE = kFRows * KS;        // floats
  static constexpr int STAGE = kFKeys * (KS + VS);  // floats
  static constexpr int SMEM = (Q_TILE + kFStages * STAGE) * 4;
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static_assert(kFKeys * D / 4 % THREADS == 0 &&
                    kFRows * D / 4 % THREADS == 0,
                "every thread copies the same number of 16-byte chunks");
};

// x = hi + lo: hi = x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi, exact in f32; the tensor core reads lo as TF32, an
// error of at most 2^-21 of x. Two instructions, a mask and a subtraction.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, tf32) * B (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three products of the split, the small ones first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// d += the three products, summed by the tensor core on a zeroed fragment
// and added to d by round-to-nearest f32 additions. The tensor core adds
// into its accumulator with truncation, so carried across a long sum (T / 8
// k steps of P V, three mma each) its error grows with every step and
// leans one way; a fresh fragment per step leaves each truncation to one
// step's 8 products.
__device__ __forceinline__ void mma_3xtf32_add(float (&d)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               const uint32_t (&bh)[2],
                                               const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// 16 bytes from global to shared memory; zero-filled when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of D floats from a strided view into shared memory rows of
// `stride` floats, 16 bytes a copy; rows from `limit` on are zeros (their
// address clamped to row 0, which exists)
template <int D, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, long long s_row,
                                          int first, int rows, int limit) {
  constexpr int CH = D / 4;  // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < rows * CH / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / CH;
    const int col = (c - r * CH) * 4;
    const bool ok = first + r < limit;
    const long long row = ok ? first + r : 0;
    cp_async16(dst + r * stride + col, src + row * s_row + col, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(FCfg<D>::THREADS, FCfg<D>::MIN_BLOCKS)
    flash_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        FParams p) {
  using C = FCfg<D>;
  constexpr int BN = kFKeys;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kFRows;
  const int q_hi = min(q0 + kFRows, p.S) - 1;
  const int n_kt = (p.T + BN - 1) / BN;
  const int kt_end = p.causal ? min(n_kt, q_hi / BN + 1) : n_kt;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BN : 0;
  const int n_tiles = kt_end - kt_begin;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragments' row (group) and column index
  const int t = lane % 4;
  const int hk = h / p.group;
  const float* kb = k + b * p.ks_b + hk * p.ks_h;
  const float* vb = v + b * p.vs_b + hk * p.vs_h;
  auto load_tile = [&](int kt, int slot) {
    float* ks = smem + C::Q_TILE + slot * C::STAGE;
    load_rows<D, C::THREADS>(ks, C::KS, kb, p.ks_s, kt * BN, BN, p.T);
    load_rows<D, C::THREADS>(ks + BN * C::KS, C::VS, vb, p.vs_s, kt * BN, BN,
                             p.T);
  };

  // the Q tile with the first key tile, then the rest of the ring
  load_rows<D, C::THREADS>(smem, C::KS, q + b * p.qs_b + h * p.qs_h, p.qs_s,
                           q0, kFRows, p.S);
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < n_tiles) load_tile(kt_begin + s, s);
    cp_async_commit();
  }

  // this warp's rows w_lo .. w_lo + 15; this thread's rows row_a and
  // row_a + 8 ("half" 0 and 1)
  const int w_lo = q0 + warp * 16;
  const int w_hi = w_lo + 15;
  const int row_a = w_lo + g;
  // Q's A fragments at k step kk: columns 8 kk + 2t, 8 kk + 2t + 1
  // (logical k t, t + 4) of both rows, an 8-byte load each
  const float* qa = smem + (warp * 16 + g) * C::KS + 2 * t;
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // scores and maxima in log2 units: s * scale * log2 e, so that
  // p = 2^(x - m) is exp(s * scale - m'); masked scores are -1e30 there
  const float scale_log2e = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // tile i has landed; every warp is done with i - 1
    if (i + kFStages - 1 < n_tiles)
      load_tile(kt_begin + i + kFStages - 1, (i + kFStages - 1) % kFStages);
    cp_async_commit();
    const int kv0 = (kt_begin + i) * BN;
    // a tile with no valid key for any of this warp's rows (or a warp
    // wholly past S) adds nothing
    if (w_lo >= p.S || (p.causal && kv0 > w_hi) ||
        (p.window > 0 && w_lo - (kv0 + BN - 1) >= p.window))
      continue;
    const float* ks = smem + C::Q_TILE + (i % kFStages) * C::STAGE;
    const float* vs = ks + BN * C::KS;

    // S = Q K^T: key block j of 8 keys, k steps of 8 head dims
    float sacc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
      const float2 x1 =
          *reinterpret_cast<const float2*>(qa + 8 * C::KS + 8 * kk);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 kx = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * C::KS + 8 * kk + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32(kx.x, bh[0], bl[0]);
        split_tf32(kx.y, bh[1], bl[1]);
        mma_3xtf32_add(sacc[j], ah, al, bh, bl);
      }
    }

    // scale, the mask where the tile crosses an edge of the band for this
    // warp's rows, then the online softmax (p in place of s)
    const bool edge = kv0 + BN > p.T || (p.causal && kv0 + BN - 1 > w_lo) ||
                      (p.window > 0 && w_hi - kv0 >= p.window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j][e] * scale_log2e;
        if (edge) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          bool ok = col < p.T;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && (row - col < p.window);
          x = ok ? x : kNegInf;
        }
        sacc[j][e] = x;
      }
    }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sacc[j][2 * half], sacc[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      corr[half] = fast_exp2(m[half] - m_new);
      m[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float pv = fast_exp2(sacc[j][e] - m_new);
          sacc[j][e] = pv;
          sum += pv;
        }
      }
      l[half] = l[half] * corr[half] + sum;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // O += P V: k step j is keys 8 j .. 8 j + 7 with logical k (t, t + 4)
    // = keys (8 j + 2t, 8 j + 2t + 1), so P's A fragment is sacc[j] as it
    // stands: a0..a3 = c0, c2, c1, c3
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(sacc[j][0], ph[0], pl[0]);
      split_tf32(sacc[j][2], ph[1], pl[1]);
      split_tf32(sacc[j][1], ph[2], pl[2]);
      split_tf32(sacc[j][3], ph[3], pl[3]);
      const float* v0 = vs + (8 * j + 2 * t) * C::VS + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[8 * n], bh[0], bl[0]);
        split_tf32(v0[C::VS + 8 * n], bh[1], bl[1]);
        mma_3xtf32_add(oacc[n], ph, pl, bh, bl);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half] + __shfl_xor_sync(0xffffffffu, l[half], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = row_a + 8 * half;
    if (row >= p.S) continue;
    float* orow = o + (((long long)b * p.S + row) * p.Hq + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(oacc[n][2 * half] / denom,
                      oacc[n][2 * half + 1] / denom);
  }
}

// the dynamic shared memory past 48 KB, once per device and kernel
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, uint64_t* set) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (*set >> dev & 1) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  *set |= uint64_t(1) << dev;
  return 0;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               const FParams& p, cudaStream_t stream) {
  static uint64_t attr_set = 0;
  const int e = allow_smem(flash_tf32x3_kernel<D>, FCfg<D>::SMEM, &attr_set);
  if (e != 0) return e;
  const dim3 grid((p.S + kFRows - 1) / kFRows, p.Hq, B);
  flash_tf32x3_kernel<D>
      <<<grid, FCfg<D>::THREADS, FCfg<D>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p);
  return (int)cudaGetLastError();
}

int launch_f32_d(const void* q, const void* k, const void* v, void* o, int B,
                 int D, const FParams& p, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_f32<32>(q, k, v, o, B, p, stream);
    case 64:
      return launch_f32<64>(q, k, v, o, B, p, stream);
    case 96:
      return launch_f32<96>(q, k, v, o, B, p, stream);
    case 112:
      return launch_f32<112>(q, k, v, o, B, p, stream);
    case 128:
      return launch_f32<128>(q, k, v, o, B, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- bf16: wgmma + TMA ----------------------------------------------------

namespace {

constexpr int kBM = 128;       // query rows per block: two warpgroups of 64
constexpr int kThreads = 288;  // two consumer warpgroups, one producer warp
constexpr int kStages = 5;     // K/V ring depth

struct WParams {
  int S, T, Hq, group, causal, window;
  float scale;
};

// Per head dim: 64 keys per tile (128 keys spill registers, and run
// slower at D = 64), the swizzle (columns per swizzle row CW, its bytes
// SW, the descriptor's mode) and shared memory.
template <int D>
struct WCfg {
  static constexpr int BN = 64;
  static constexpr int CW = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int SW = CW * 2;
  static constexpr int NC = D / CW;  // column chunks of a tile
  static constexpr uint32_t MODE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int Q_BYTES = kBM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  // + 1024 to align the tiles to the swizzle's repeat
  static constexpr int SMEM = BAR_OFF + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, WParams p) {
  using C = WCfg<D>;
  constexpr int BN = C::BN;
  constexpr int SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = base;                            // [chunk][kBM][CW]
  uint8_t* sk = base + C::Q_BYTES;               // [stage][chunk][BN][CW]
  uint8_t* sv = sk + kStages * C::KV_BYTES;      // [stage][chunk][BN][CW]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBM;
  const int q_hi = min(q0 + kBM, p.S) - 1;
  const int n_kt = (p.T + BN - 1) / BN;
  const int kt_end = p.causal ? min(n_kt, q_hi / BN + 1) : n_kt;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BN : 0;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one thread issues every copy
    if (threadIdx.x % 32 != 0) return;
    const int hk = h / p.group;
    hopper::mbar_arrive_expect_tx(qbar, C::Q_BYTES);
    for (int c = 0; c < C::NC; ++c)
      hopper::tma_load_4d(sq + c * kBM * SW, &tq, qbar, c * C::CW, h, q0, b);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int s = i % kStages;
      const uint32_t round = i / kStages;
      if (i >= kStages) hopper::mbar_wait(&empty[s], (round & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
      for (int c = 0; c < C::NC; ++c) {
        const int off = s * C::KV_BYTES + c * BN * SW;
        hopper::tma_load_4d(sk + off, &tk, &full[s], c * C::CW, hk, kt * BN,
                            b);
        hopper::tma_load_4d(sv + off, &tv, &full[s], c * C::CW, hk, kt * BN,
                            b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r0 .. r0 + 63; this thread the
  // accumulator rows row_a and row_a + 8 ("half" 0 and 1), columns
  // 8 j + 2 (lane % 4) + {0, 1}
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + wg * 64;
  const int row_a = r0 + (warp % 4) * 16 + lane / 4;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  // scores and maxima in log2 units: s * scale * log2 e, so that
  // p = 2^(x - m) is exp(s * scale - m'); masked scores are -1e30 there
  const float scale_log2e = p.scale * kLog2e;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float sacc[BN / 2];
  uint32_t ahi[BN / 16][4];  // P = P_hi + P_lo as bf16 A fragments
  uint32_t alo[BN / 16][4];
  const uint32_t q_addr = hopper::smem_addr(sq) + wg * 64 * SW;

  // S = Q K^T of the stage's K tile over D in steps of 16 (advancing
  // inside a swizzle row); issued, not waited for
  auto issue_qk = [&](int s) {
    const uint32_t k_addr = hopper::smem_addr(sk + s * C::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / C::CW;
      const int e = kk * 16 % C::CW;
      const uint64_t da = hopper::wgmma_desc(q_addr + c * kBM * SW + e * 2,
                                             16, 8 * SW, C::MODE);
      const uint64_t db = hopper::wgmma_desc(k_addr + c * BN * SW + e * 2,
                                             16, 8 * SW, C::MODE);
      hopper::wgmma_ss(sacc, da, db, kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
  };
  // O += P_hi V + P_lo V over the stage's keys in steps of 16; issued
  auto issue_pv = [&](int s) {
    const uint32_t v_addr = hopper::smem_addr(sv + s * C::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = hopper::wgmma_desc(v_addr + kk * 16 * SW, BN * SW,
                                             8 * SW, C::MODE);
      hopper::wgmma_rs(oacc, ahi[kk], dv);
      hopper::wgmma_rs(oacc, alo[kk], dv);
    }
    hopper::wgmma_commit();
  };
  // key tile kt's scores in sacc: scale, the mask where the tile crosses
  // an edge of the band, then the online softmax (p in place of s); returns
  // each row's correction of the running sums in corr
  auto softmax = [&](int kt, float* corr) {
#pragma unroll
    for (int i2 = 0; i2 < BN / 2; ++i2)
      hopper::warpgroup_fence_operand(sacc[i2]);
    const int kv0 = kt * BN;
    const bool edge = kv0 + BN > p.T || (p.causal && kv0 + BN - 1 > r0) ||
                      (p.window > 0 && r0 + 63 - kv0 >= p.window);
#pragma unroll
    for (int i2 = 0; i2 < BN / 2; ++i2) {
      float x = sacc[i2] * scale_log2e;
      if (edge) {
        const int col = kv0 + 8 * (i2 / 4) + 2 * (lane % 4) + (i2 % 2);
        const int row = row_a + 8 * ((i2 / 2) % 2);
        bool ok = col < p.T;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && (row - col < p.window);
        x = ok ? x : -1e30f;
      }
      sacc[i2] = x;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -1e30f;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        mx = fmaxf(mx, sacc[4 * jj + 2 * half]);
        mx = fmaxf(mx, sacc[4 * jj + 2 * half + 1]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      corr[half] = fast_exp2(m[half] - m_new);
      m[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = fast_exp2(sacc[4 * jj + 2 * half + e] - m_new);
          sacc[4 * jj + 2 * half + e] = pv;
          sum += pv;
        }
      }
      l[half] = l[half] * corr[half] + sum;
    }
  };
  // P as the A fragments, hi and lo: registers r of step kk hold the
  // accumulator pair 8 kk + 2 r, 8 kk + 2 r + 1
  auto convert = [&] {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sacc[8 * kk + 2 * r];
        const float x1 = sacc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        ahi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        alo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
    }
  };
  auto rescale = [&](const float* corr) {
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      oacc[4 * jj] *= corr[0];
      oacc[4 * jj + 1] *= corr[0];
      oacc[4 * jj + 2] *= corr[1];
      oacc[4 * jj + 3] *= corr[1];
    }
  };

  // Software-pipelined over the key tiles: tile i's S = Q K^T runs on the
  // tensor cores together with tile i - 1's P V, and tile i's softmax
  // overlaps that P V; O is rescaled once it has landed.
  hopper::mbar_wait(qbar, 0);
  if (kt_begin < kt_end) {
    float corr[2];
    hopper::mbar_wait(&full[0], 0);
    hopper::wgmma_fence();
    issue_qk(0);
    hopper::wgmma_wait<0>();
    softmax(kt_begin, corr);
    convert();
    int prev = 0;
    for (int kt = kt_begin + 1, i = 1; kt < kt_end; ++kt, ++i) {
      const int s = i % kStages;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
      for (int i2 = 0; i2 < D / 2; ++i2)
        hopper::warpgroup_fence_operand(oacc[i2]);
      hopper::wgmma_fence();
      issue_qk(s);
      issue_pv(prev);
      hopper::wgmma_wait<1>();  // S of tile i
      softmax(kt, corr);
      hopper::wgmma_wait<0>();  // P V of tile i - 1
#pragma unroll
      for (int i2 = 0; i2 < D / 2; ++i2)
        hopper::warpgroup_fence_operand(oacc[i2]);
      hopper::mbar_arrive(&empty[prev]);
      rescale(corr);
      convert();
      prev = s;
    }
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2)
      hopper::warpgroup_fence_operand(oacc[i2]);
    hopper::wgmma_fence();
    issue_pv(prev);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2)
      hopper::warpgroup_fence_operand(oacc[i2]);
    hopper::mbar_arrive(&empty[prev]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half] + __shfl_xor_sync(0xffffffffu, l[half], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = row_a + 8 * half;
    if (row >= p.S) continue;
    __nv_bfloat16* orow =
        o + (((long long)b * p.S + row) * p.Hq + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(oacc[4 * jj + 2 * half] / denom,
                                oacc[4 * jj + 2 * half + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) = v2;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D bf16 view (B, L, H, D) with element strides (sb, sl, sh) and a
// unit-stride D, cut into boxes of `rows` positions x cw columns of one
// head of one batch row.
bool encode(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
            long long sb, long long sl, long long sh, int cw, int rows,
            int sw_bytes) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = sw_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : sw_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hk, const long long* st, const WParams& p,
                 cudaStream_t stream) {
  using C = WCfg<D>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, p.S, p.Hq, D, st[0], st[1], st[2], C::CW, kBM,
              C::SW) ||
      !encode(&tk, k, B, p.T, Hk, D, st[3], st[4], st[5], C::CW, C::BN,
              C::SW) ||
      !encode(&tv, v, B, p.T, Hk, D, st[6], st[7], st[8], C::CW, C::BN,
              C::SW))
    return (int)cudaErrorInvalidValue;
  static uint64_t attr_set = 0;
  const int e = allow_smem(flash_wgmma_kernel<D>, C::SMEM, &attr_set);
  if (e != 0) return e;
  const dim3 grid((p.S + kBM - 1) / kBM, p.Hq, B);
  flash_wgmma_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return (int)cudaGetLastError();
}

int launch_wgmma_d(const void* q, const void* k, const void* v, void* o,
                   int B, int Hk, int D, const long long* st,
                   const WParams& p, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_wgmma<32>(q, k, v, o, B, Hk, st, p, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, B, Hk, st, p, stream);
    case 96:
      return launch_wgmma<96>(q, k, v, o, B, Hk, st, p, stream);
    case 112:
      return launch_wgmma<112>(q, k, v, o, B, Hk, st, p, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, B, Hk, st, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32 (the 3xTF32 kernel), 1 = bf16 (the wgmma kernel); the
// wrapper has checked the 16-byte rule of their copies (cp.async, TMA):
// 16-byte-aligned bases and strides. q, k, v and the output share the
// dtype. Returns cudaGetLastError() after the launch (0 when it was
// accepted), or
// cudaErrorInvalidValue for a dtype or head dim it has no instance of or a
// view the tensor maps refuse.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int Hq, int Hk, int D, long long qs_b, long long qs_s,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (T <= 0 || Hk <= 0 || Hq % Hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FParams p{S,    T,    Hq,   Hq / Hk, causal, window, qs_b, qs_s,
              qs_h, ks_b, ks_s, ks_h,    vs_b,   vs_s,   vs_h, scale};
    return launch_f32_d(q, k, v, o, B, D, p, st);
  }
  if (dtype == 1) {
    const long long strides[9] = {qs_b, qs_s, qs_h, ks_b, ks_s,
                                  ks_h, vs_b, vs_s, vs_h};
    WParams p{S, T, Hq, Hq / Hk, causal, window, scale};
    return launch_wgmma_d(q, k, v, o, B, Hk, D, strides, p, st);
  }
  return (int)cudaErrorInvalidValue;
}
