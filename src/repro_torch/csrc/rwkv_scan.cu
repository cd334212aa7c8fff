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
// (H, D) f32; the state in and out is a contiguous (B, H, D, D) f32 tensor;
// y is a contiguous (B, S, H, D) f32 tensor.
//
// Bound on the H100: per (b, h, t) the recurrence does 4 * D^2 operations
// on 4 * D inputs and D outputs, so at the serving shapes (D = 64) it is
// near the balance point: ~5.4 GFLOP against ~0.3 GB at B = 8, S = 1024,
// H = 40, bytes binding by a hair. What binds this design is neither: the
// only parallelism is across (b, h, value column j), since the TPU
// kernel's sequential chunk grid becomes a loop, and that is 20,480
// threads at that shape and 2,560 at B = 1 or in decode, a fraction of
// what the card can keep in flight. Its answer is to keep the state on
// chip and never touch device memory for it inside the loop:
//
//   - one block per (head, batch row) with one thread per value column j;
//     the thread holds its column S[:, j] in D registers for the whole
//     sequence, so y_j needs no reduction across threads and the state is
//     read and written once per launch;
//   - r, k, v and w are staged in shared memory as f32, CT = 2048 / D
//     time steps at a time (32 KB), each thread loading its column of
//     every row, so one device-memory round trip serves CT steps; the
//     inner loop reads r_i, k_i, w_i and u_i as shared-memory broadcasts.
//
// Splitting the key dim across a warp (a shuffle reduction for y) and
// overlapping the next chunk's loads with the current chunk are later
// work. Rounding: -fmad=false keeps every product and sum its own IEEE
// operation, so the state is w * S rounded plus k * v rounded, exactly the
// plain version's `w[..., :, None] * S + k[..., :, None] * v[..., None, :]`;
// y sums over i in order, the plain version's einsum in its own order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Params {
  int S, H;
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

template <typename T, int D>
__global__ void __launch_bounds__(D)
    rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, float* __restrict__ y,
                     float* __restrict__ sf, Params p) {
  constexpr int CT = 2048 / D;  // time steps per staged chunk
  __shared__ float rs[CT][D];
  __shared__ float ks[CT][D];
  __shared__ float vs[CT][D];
  __shared__ float ws[CT][D];
  __shared__ float us[D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const long long slab = ((long long)b * p.H + h) * D * D;

  float st[D];  // this thread's column S[:, j]
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0[slab + i * D + j];
  us[j] = u[h * p.us_h + j];

  const T* rb = r + b * p.rs_b + h * p.rs_h + j;
  const T* kb = k + b * p.ks_b + h * p.ks_h + j;
  const T* vb = v + b * p.vs_b + h * p.vs_h + j;
  const float* wb = w + b * p.ws_b + h * p.ws_h + j;
  float* yb = y + ((long long)b * p.S * p.H + h) * D + j;

  for (int t0 = 0; t0 < p.S; t0 += CT) {
    const int n = min(CT, p.S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int c = 0; c < n; ++c) {
      const long long t = t0 + c;
      rs[c][j] = to_f32(rb[t * p.rs_s]);
      ks[c][j] = to_f32(kb[t * p.ks_s]);
      vs[c][j] = to_f32(vb[t * p.vs_s]);
      ws[c][j] = wb[t * p.ws_s];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[c][i] * vj;
        acc += rs[c][i] * (st[i] + us[i] * kv);
        st[i] = ws[c][i] * st[i] + kv;
      }
      yb[(long long)(t0 + c) * p.H * D] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) sf[slab + i * D + j] = st[i];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* sf, int B,
           const Params& p, cudaStream_t stream) {
  const dim3 grid(p.H, B);
  rwkv_scan_kernel<T, D><<<grid, D, 0, stream>>>(
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
  Params p{S,    H,    rs_b, rs_s, rs_h, ks_b, ks_s, ks_h,
           vs_b, vs_s, vs_h, ws_b, ws_s, ws_h, us_h};
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
