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
//
// Bound on the H100: at the serving shapes (S = T = 1024, D = 64, bf16) the
// two products are ~34 GFLOP against ~84 MB, so operations bind it. The
// card's peak for that work is its bf16 tensor cores; this first design
// does not use them. It keeps everything but the K/V tiles out of device
// memory and spends f32 FMAs on the CUDA cores:
//
//   - one block per (64-row query tile, head, batch row); the tiles of a
//     head run heaviest (latest, under a causal mask) first;
//   - one thread per query row holds its q row, m, l and acc[D] in
//     registers (two threads per row, each half of D, for D = 128, whose
//     partial dot products meet in one warp shuffle);
//   - each 64-key (32 for D = 128) K and V tile is staged in shared
//     memory as f32, read by all rows as broadcasts; a row's scores for
//     the tile wait in shared memory between the max and the exp pass;
//   - key tiles wholly outside the causal / window band are skipped, and
//     the ragged last query and key tiles are masked by bounds checks.
//
// Tensor cores (wgmma), TMA and warp specialisation are later work. The
// products are written as explicit fmaf, so -fmad=false does not split
// them; expf and the division stay IEEE (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // query rows per block
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

struct Params {
  int S, T, Hq, group, causal, window;
  long long qs_b, qs_s, qs_h;  // element strides; the head dim is unit
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* y) { *y = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(x);
}

// Per head dim: the key tile, the threads per query row and the dynamic
// shared memory (K and V tiles, then the tile's scores), all <= 48 KB.
template <int D>
struct Tile {
  static constexpr int BK = D > 64 ? 32 : 64;
  static constexpr int TPR = D > 64 ? 2 : 1;
  static constexpr int SMEM = (2 * BK * D + BK * kRows) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kRows * Tile<D>::TPR)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Params p) {
  constexpr int BK = Tile<D>::BK;
  constexpr int TPR = Tile<D>::TPR;
  constexpr int DP = D / TPR;  // head dims per thread
  constexpr int THREADS = kRows * TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* Vs = Ks + BK * D;                      // [BK][D]
  float* Ss = Vs + BK * D;                      // [BK][kRows]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int part = tid % TPR;
  const int q0 = qt * kRows;
  const int qpos = q0 + r;
  const bool row_ok = qpos < p.S;
  const int hk = h / p.group;
  const T* kb = k + b * p.ks_b + hk * p.ks_h;
  const T* vb = v + b * p.vs_b + hk * p.vs_h;

  float qr[DP];
  float acc[DP];
  const T* qrow = q + b * p.qs_b + (long long)qpos * p.qs_s + h * p.qs_h +
                  part * DP;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = row_ok ? to_f32(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_hi = min(q0 + kRows, p.S) - 1;
  const int n_kt = (p.T + BK - 1) / BK;
  const int kt_end = p.causal ? min(n_kt, q_hi / BK + 1) : n_kt;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int kv0 = kt * BK;
    const int n = min(BK, p.T - kv0);
    __syncthreads();  // every row is done with the previous tile
    for (int i = tid; i < n * D; i += THREADS) {
      const int j = i / D;
      const int d = i - j * D;
      Ks[i] = to_f32(kb[(long long)(kv0 + j) * p.ks_s + d]);
      Vs[i] = to_f32(vb[(long long)(kv0 + j) * p.vs_s + d]);
    }
    __syncthreads();
    // pass 1: this row's masked scores and their max (rows past S run on
    // a zero q so that the warp's shuffles stay converged; they store
    // nothing)
    float tile_max = kNegInf;
    for (int j = 0; j < n; ++j) {
      const float* kj = Ks + j * D + part * DP;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kj + d);
        s = fmaf(qr[d], k4.x, s);
        s = fmaf(qr[d + 1], k4.y, s);
        s = fmaf(qr[d + 2], k4.z, s);
        s = fmaf(qr[d + 3], k4.w, s);
      }
      if (TPR == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
      s *= p.scale;
      const int kpos = kv0 + j;
      bool ok = true;
      if (p.causal) ok = kpos <= qpos;
      if (p.window > 0) ok = ok && (qpos - kpos < p.window);
      s = ok ? s : kNegInf;
      if (part == 0) Ss[j * kRows + r] = s;
      tile_max = fmaxf(tile_max, s);
    }
    __syncwarp();  // the row's other thread reads what part 0 wrote
    // pass 2: rescale, then accumulate p * v
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= corr;
    for (int j = 0; j < n; ++j) {
      const float pj = expf(Ss[j * kRows + r] - m_new);
      l += pj;
      const float* vj = Vs + j * D + part * DP;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vj + d);
        acc[d] = fmaf(pj, v4.x, acc[d]);
        acc[d + 1] = fmaf(pj, v4.y, acc[d + 1]);
        acc[d + 2] = fmaf(pj, v4.z, acc[d + 2]);
        acc[d + 3] = fmaf(pj, v4.w, acc[d + 3]);
      }
    }
    m = m_new;
  }
  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + (((long long)b * p.S + qpos) * p.Hq + h) * D + part * DP;
#pragma unroll
  for (int d = 0; d < DP; ++d) store(acc[d] / denom, orow + d);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + kRows - 1) / kRows, p.Hq, B);
  flash_attention_kernel<T, D>
      <<<grid, kRows * Tile<D>::TPR, Tile<D>::SMEM, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, p, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, p, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and the output alike). Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a dtype or head dim it has no instance of.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int Hq, int Hk, int D, long long qs_b, long long qs_s,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (T <= 0 || Hk <= 0 || Hq % Hk != 0) return (int)cudaErrorInvalidValue;
  Params p{S,    T,    Hq,   Hq / Hk, causal, window, qs_b, qs_s,
           qs_h, ks_b, ks_s, ks_h,    vs_b,   vs_s,   vs_h, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, B, D, p, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(q, k, v, o, B, D, p, st);
  return (int)cudaErrorInvalidValue;
}
