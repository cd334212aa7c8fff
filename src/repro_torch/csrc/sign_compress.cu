// CHOCO error-feedback sign compression over f32 buffers viewed as (K, n).
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
// Each segment is cut into tiles of at most kernels.sign_compress.TILE
// elements; the host tables give each tile's element bounds and segment, and
// each segment's first tile. Three launches, no atomics:
//   1. absmean_kernel, grid (tiles, K): one block sums one tile of |x - hat|
//      (each thread in a fixed stride order, then a fixed tree over the
//      block) into partials[k, t];
//   2. scale_kernel, one thread per (k, s): sums the segment's partials in
//      tile order and divides by the f32 true count;
//   3. apply_kernel, grid (tiles, K): writes q and hat_out with the scale of
//      the tile's segment.
// The scale is thus the same in every run.
//
// Bound on the H100: bytes. The function must read x and hat once and write
// q (1 byte) and hat_out (4 bytes) once, 13 bytes per element; this design
// reads x and hat twice, 21 bytes. A single pass would have to hold each
// segment's sum before any q can be scaled; that is left for a later change.
// Loads are 16 bytes (float4) and q stores 4 (char4) when vec != 0; the last
// (b - a) % 4 elements of a tile then take the scalar path.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
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

__global__ void absmean_kernel(const float* __restrict__ x,
                               const float* __restrict__ hat,
                               const long long* __restrict__ tile_start,
                               const long long* __restrict__ tile_end,
                               long long n, int T, int vec,
                               float* __restrict__ partials) {
  const int t = blockIdx.x, k = blockIdx.y;
  const long long a = tile_start[t], b = tile_end[t];
  const float* xk = x + (long long)k * n;
  const float* hk = hat + (long long)k * n;
  float acc = 0.f;
  long long tail = a;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xk);
    const float4* h4 = reinterpret_cast<const float4*>(hk);
    for (long long i = a / 4 + threadIdx.x; i < b / 4; i += blockDim.x) {
      const float4 X = x4[i], H = h4[i];
      acc += fabsf(X.x - H.x);
      acc += fabsf(X.y - H.y);
      acc += fabsf(X.z - H.z);
      acc += fabsf(X.w - H.w);
    }
    tail = b / 4 * 4;
  }
  for (long long i = tail + threadIdx.x; i < b; i += blockDim.x) {
    acc += fabsf(xk[i] - hk[i]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[(long long)k * T + t] = acc;
}

__global__ void scale_kernel(const float* __restrict__ partials,
                             const int* __restrict__ seg_first,
                             const float* __restrict__ n_true, int K, int T,
                             int L, float* __restrict__ scales) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= K * L) return;
  const int k = idx / L, s = idx % L;
  float sum = 0.f;
  for (int t = seg_first[s]; t < seg_first[s + 1]; ++t) {
    sum += partials[(long long)k * T + t];
  }
  scales[idx] = sum / n_true[s];
}

__device__ __forceinline__ float sgn(float d) {
  return (float)((d > 0.f) - (d < 0.f));
}

__global__ void apply_kernel(const float* __restrict__ x,
                             const float* __restrict__ hat,
                             const long long* __restrict__ tile_start,
                             const long long* __restrict__ tile_end,
                             const int* __restrict__ tile_seg,
                             const float* __restrict__ scales, int L,
                             long long n, int vec,
                             signed char* __restrict__ q,
                             float* __restrict__ hat_out) {
  const int t = blockIdx.x, k = blockIdx.y;
  const long long a = tile_start[t], b = tile_end[t];
  const long long base = (long long)k * n;
  const float sc = scales[k * L + tile_seg[t]];
  long long tail = a;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4* h4 = reinterpret_cast<const float4*>(hat + base);
    float4* o4 = reinterpret_cast<float4*>(hat_out + base);
    char4* q4 = reinterpret_cast<char4*>(q + base);
    for (long long i = a / 4 + threadIdx.x; i < b / 4; i += blockDim.x) {
      const float4 X = x4[i], H = h4[i];
      const float sx = sgn(X.x - H.x), sy = sgn(X.y - H.y),
                  sz = sgn(X.z - H.z), sw = sgn(X.w - H.w);
      q4[i] = make_char4((signed char)sx, (signed char)sy, (signed char)sz,
                         (signed char)sw);
      o4[i] = make_float4(H.x + sc * sx, H.y + sc * sy, H.z + sc * sz,
                          H.w + sc * sw);
    }
    tail = b / 4 * 4;
  }
  for (long long i = tail + threadIdx.x; i < b; i += blockDim.x) {
    const float H = hat[base + i];
    const float s = sgn(x[base + i] - H);
    q[base + i] = (signed char)s;
    hat_out[base + i] = H + sc * s;
  }
}

}  // namespace

// x, hat, hat_out: K * n f32; q: K * n int8; scales: K * L f32; partials:
// K * T f32 scratch. tile_start / tile_end (int64), tile_seg (int32, T
// entries), seg_first (int32, L + 1 entries) and n_true (f32, L entries)
// are device tables. vec != 0 promises that every tile starts at a multiple
// of 4 within its worker, that every worker starts 16 bytes aligned (K == 1
// or n a multiple of 4) and that x, hat, q and hat_out are 16-byte aligned.
// Returns the first non-zero cudaGetLastError() of the three launches.
extern "C" int sign_compress_f32(const float* x, const float* hat,
                                 signed char* q, float* hat_out,
                                 float* scales, float* partials,
                                 const long long* tile_start,
                                 const long long* tile_end,
                                 const int* tile_seg, const int* seg_first,
                                 const float* n_true, int K, int T, int L,
                                 long long n, int vec, void* stream) {
  if (K <= 0 || L <= 0 || n <= 0) return 0;
  if (K > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (T > 0) {
    absmean_kernel<<<dim3((unsigned)T, (unsigned)K), kThreads, 0, s>>>(
        x, hat, tile_start, tile_end, n, T, vec, partials);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const int kl = K * L;
  scale_kernel<<<(kl + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partials, seg_first, n_true, K, T, L, scales);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (T > 0) {
    apply_kernel<<<dim3((unsigned)T, (unsigned)K), kThreads, 0, s>>>(
        x, hat, tile_start, tile_end, tile_seg, scales, L, n, vec, q,
        hat_out);
  }
  return (int)cudaGetLastError();
}
