// Segmented 1-D Dirichlet stencil SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernel lobpcg_tpu/ops/pallas/stencil.py:stencil_matmat_pallas.
// Computes, on each of `seg_rows`-row segments of a row-major [n, k] block X,
//
//     Y[i, :] = scale * ((2 X[i, :] - X[i+1, :]) - X[i-1, :])
//
// with X[-1] / X[n] taken from the optional edge rows ([2, k]: row 0 is
// the row above X[0], row 1 the row below X[n-1]) and zero otherwise;
// rows across a segment boundary never couple.  The operation order is
// that of the plain version (lobpcg_tpu_torch/ops/cuda/stencil.py:
// stencil_matmat_reference).  f32 computes in f32; bf16 loads, upcasts
// to f32, computes and rounds once to bf16.
//
// Bound: device-memory bytes.  Three flops per element against one read
// and one write: ideally 2 * n * k * sizeof(T) bytes.  The neighbour
// rows X[i-1], X[i+1] lie k * sizeof(T) bytes away and are re-read
// through L1/L2 by the neighbouring row's threads, not from DRAM.
//
// Design: one thread per 16-byte vector of a row (4 f32 or 8 bf16)
// when k and every pointer allow it, else one thread per element;
// neighbouring threads walk along k, so each warp issues coalesced
// 512-byte (or 128-byte) row segments.  The segment test is `i % seg_rows`.
// What this simple design leaves on the table: no shared-memory row
// tiling to make the halo reuse explicit, no multi-row work per thread,
// no persistent grid, no TMA.  wgmma does not apply (no contraction).
// Those are tuning steps for later work, measured against a copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// One thread per V consecutive elements of one row.  kv = k / V.
template <typename T, int V>
__global__ void stencil1d_kernel(const T* __restrict__ X, T* __restrict__ Y,
                                 const T* __restrict__ edge, float scale,
                                 int64_t n, int64_t kv, int64_t seg_rows) {
  using VT = Vec<T, V>;
  const int64_t total = n * kv;
  const VT* Xv = reinterpret_cast<const VT*>(X);
  const VT* Ev = reinterpret_cast<const VT*>(edge);
  VT* Yv = reinterpret_cast<VT*>(Y);
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = idx / kv;
    const int64_t c = idx - i * kv;
    const VT x = Xv[idx];
    VT up, dn;
    bool has_up = false, has_dn = false;
    if (i % seg_rows != 0) {
      up = Xv[idx - kv];
      has_up = true;
    } else if (i == 0 && edge != nullptr) {
      up = Ev[c];
      has_up = true;
    }
    if ((i + 1) % seg_rows != 0) {
      dn = Xv[idx + kv];
      has_dn = true;
    } else if (i == n - 1 && edge != nullptr) {
      dn = Ev[kv + c];
      has_dn = true;
    }
    VT y;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float pv = has_up ? to_f32(up.v[j]) : 0.0f;
      const float nx = has_dn ? to_f32(dn.v[j]) : 0.0f;
      const float t = 2.0f * to_f32(x.v[j]) - nx;
      y.v[j] = from_f32<T>(scale * (t - pv));
    }
    Yv[idx] = y;
  }
}

template <typename T, int V>
int launch(const void* X, void* Y, const void* edge, float scale, int64_t n,
           int64_t k, int64_t seg_rows, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (k / V);
  // A grid-stride loop covers whatever the grid cap leaves.
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  stencil1d_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(Y), static_cast<const T*>(edge),
      scale, n, k / V, seg_rows);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch(const void* X, void* Y, const void* edge, float scale, int64_t n,
             int64_t k, int64_t seg_rows, void* stream) {
  if (n <= 0 || k <= 0 || seg_rows <= 0 || n % seg_rows != 0) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % V == 0 && aligned16(X) && aligned16(Y) && (edge == nullptr || aligned16(edge)))
    return launch<T, V>(X, Y, edge, scale, n, k, seg_rows, s);
  return launch<T, 1>(X, Y, edge, scale, n, k, seg_rows, s);
}

}  // namespace

extern "C" {

// X, Y: [n, k] row-major on the device; edge: [2, k] or null; stream: a
// cudaStream_t.  Returns cudaGetLastError() after the launch (0 = ok).
int lobpcg_stencil1d_f32(const void* X, void* Y, const void* edge, float scale,
                         int64_t n, int64_t k, int64_t seg_rows, void* stream) {
  return dispatch<float>(X, Y, edge, scale, n, k, seg_rows, stream);
}

int lobpcg_stencil1d_bf16(const void* X, void* Y, const void* edge, float scale,
                          int64_t n, int64_t k, int64_t seg_rows, void* stream) {
  return dispatch<__nv_bfloat16>(X, Y, edge, scale, n, k, seg_rows, stream);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
