// Fused 7-point 3-D Dirichlet Laplacian SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernel lobpcg_tpu/ops/pallas/stencil3d.py:
// stencil3d_matmat_pallas.  X is the flat C-order [nx*ny*nz, k] block of a
// grid-shaped field (row r = (i*ny + j)*nz + l), row-major in k, or a
// batch of such blocks, [batch, nx*ny*nz, k] (one problem after another,
// as jax.vmap maps the Pallas kernel over a leading axis).  Computes
//
//     Y[i,j,l] = scale * (((2X - X[i+1] - X[i-1]) + (2X - X[j+1] - X[j-1]))
//                         + (2X - X[l+1] - X[l-1]))
//
// with every neighbour outside the grid taken as zero (Dirichlet on all
// six faces) for each problem of the batch.  A batch is the same walk
// over batch*nx*ny*nz rows: the row's plane p = problem*nx + i counts the
// problems' i-planes one after another, and the i faces are tested on
// i = p % nx, so no i neighbour crosses from one problem into the next
// (the j and l faces lie inside a plane).  The operation order is that of the plain version
// (lobpcg_tpu_torch/ops/cuda/stencil3d.py:stencil3d_matmat_reference, the
// sum of three separable passes times scale), so the two agree to the
// bit in f32.  bf16 loads, upcasts to f32, computes and rounds once.
//
// Bound: device-memory bytes.  About 12 flops per element against one
// read and one write: ideally 2 * n * k * sizeof(T) bytes.  The l, j and
// i neighbours lie k, nz*k and ny*nz*k elements away and are re-read by
// other threads through L1/L2, not from DRAM, as long as an i-plane
// (ny*nz*k*sizeof(T) bytes, 1.6 MB at 160^2 x 16 f32) stays in the 50 MB L2.
//
// Design: one thread per 16-byte vector of a row (4 f32 or 8 bf16) when k
// and both pointers allow it, else one thread per element, as in
// stencil1d.cu; (i, j, l) come from the flat row by two divisions, and
// each face is a predicate on one coordinate.  Any nx, ny, nz >= 1 and
// any k >= 1: the TPU gates (nz % 8, k % 128, the VMEM ring of i-planes)
// are facts of the TPU.  Left for later work: shared-memory tiling of
// an (i, j) block with its halo, several rows per thread, TMA.

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
__global__ void stencil3d_kernel(const T* __restrict__ X, T* __restrict__ Y,
                                 float scale, int64_t batch, int64_t nx, int64_t ny,
                                 int64_t nz, int64_t kv) {
  using VT = Vec<T, V>;
  const int64_t n = nx * ny * nz;
  const int64_t total = batch * n * kv;
  const int64_t sl = kv;            // l-neighbour stride, in vectors
  const int64_t sj = nz * kv;       // j-neighbour stride
  const int64_t si = ny * nz * kv;  // i-neighbour stride
  const VT* Xv = reinterpret_cast<const VT*>(X);
  VT* Yv = reinterpret_cast<VT*>(Y);
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = idx / kv;   // row over the whole batch
    const int64_t q = r / nz;
    const int64_t l = r - q * nz;
    const int64_t p = q / ny;     // i-plane over the batch: problem * nx + i
    const int64_t j = q - p * ny;
    const int64_t i = p % nx;     // the problem's own plane
    const VT x = Xv[idx];
    VT im, ip, jm, jp, lm, lp;
    const bool has_im = i > 0, has_ip = i < nx - 1;
    const bool has_jm = j > 0, has_jp = j < ny - 1;
    const bool has_lm = l > 0, has_lp = l < nz - 1;
    if (has_im) im = Xv[idx - si];
    if (has_ip) ip = Xv[idx + si];
    if (has_jm) jm = Xv[idx - sj];
    if (has_jp) jp = Xv[idx + sj];
    if (has_lm) lm = Xv[idx - sl];
    if (has_lp) lp = Xv[idx + sl];
    VT y;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float x2 = 2.0f * to_f32(x.v[c]);
      const float pi = (x2 - (has_ip ? to_f32(ip.v[c]) : 0.0f))
                       - (has_im ? to_f32(im.v[c]) : 0.0f);
      const float pj = (x2 - (has_jp ? to_f32(jp.v[c]) : 0.0f))
                       - (has_jm ? to_f32(jm.v[c]) : 0.0f);
      const float pl = (x2 - (has_lp ? to_f32(lp.v[c]) : 0.0f))
                       - (has_lm ? to_f32(lm.v[c]) : 0.0f);
      y.v[c] = from_f32<T>(scale * ((pi + pj) + pl));
    }
    Yv[idx] = y;
  }
}

template <typename T, int V>
int launch(const void* X, void* Y, float scale, int64_t batch, int64_t nx,
           int64_t ny, int64_t nz, int64_t k, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = batch * nx * ny * nz * (k / V);
  // A grid-stride loop covers whatever the grid cap leaves.
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  stencil3d_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(Y), scale, batch, nx, ny, nz, k / V);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch(const void* X, void* Y, float scale, int64_t batch, int64_t nx,
             int64_t ny, int64_t nz, int64_t k, void* stream) {
  if (batch <= 0 || nx <= 0 || ny <= 0 || nz <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % V == 0 && aligned16(X) && aligned16(Y))
    return launch<T, V>(X, Y, scale, batch, nx, ny, nz, k, s);
  return launch<T, 1>(X, Y, scale, batch, nx, ny, nz, k, s);
}

}  // namespace

extern "C" {

// X, Y: [batch, nx*ny*nz, k] row-major on the device (batch 1: one
// [nx*ny*nz, k] block); stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 = ok).
int lobpcg_stencil3d_f32(const void* X, void* Y, float scale, int64_t batch,
                         int64_t nx, int64_t ny, int64_t nz, int64_t k,
                         void* stream) {
  return dispatch<float>(X, Y, scale, batch, nx, ny, nz, k, stream);
}

int lobpcg_stencil3d_bf16(const void* X, void* Y, float scale, int64_t batch,
                          int64_t nx, int64_t ny, int64_t nz, int64_t k,
                          void* stream) {
  return dispatch<__nv_bfloat16>(X, Y, scale, batch, nx, ny, nz, k, stream);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
