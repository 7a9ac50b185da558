// Streaming copy of a device block for Hopper (sm_90a).
//
// Replaces the TPU kernel bench.py:_copy_fn, the double-buffered
// HBM -> VMEM -> HBM copy of an [n, k] f32 block that measures the
// attainable memory rate under the SpMM headline's roofline.  Y = X for
// `numel` contiguous f32 values; every element is copied (the TPU kernel
// copied only whole 2048-row tiles).
//
// Bound: device-memory bytes, one read and one write of each element,
// 2 * numel * 4 bytes; no arithmetic.
//
// Design: a grid-stride loop with one 16-byte vector load and store per
// thread and step when both pointers are 16-byte aligned; the numel % 4
// trailing floats are copied by the first threads of block 0.  A pointer
// that is not 16-byte aligned takes the same loop on single floats.
// Loads and stores carry the streaming cache hint (evict first): a copy
// of gigabytes gains nothing from keeping its lines in L2.  Offsets are
// 64-bit ([4M, 256] is 2^30 elements).  On the H100 this matched
// Tensor.copy_ (a CUDA device-to-device memcpy), while variants that
// held four or eight vectors a thread, or capped the grid at 16 blocks an
// SM, were slower.  Not tried: TMA bulk copies through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void copy_kernel(const T* __restrict__ X, T* __restrict__ Y, int64_t count,
                            const float* __restrict__ tail_src, float* __restrict__ tail_dst,
                            int tail) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * kThreads)
    __stcs(Y + i, __ldcs(X + i));
  if (blockIdx.x == 0 && threadIdx.x < tail) tail_dst[threadIdx.x] = tail_src[threadIdx.x];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* X, void* Y, int64_t count, const float* tail_src, float* tail_dst,
           int tail, cudaStream_t stream) {
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // the tail alone still needs block 0
  // The grid-stride loop covers whatever the grid cap leaves.
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  copy_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(Y), count, tail_src, tail_dst, tail);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X, Y: numel contiguous f32 values on the device; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 = ok).
int lobpcg_copy_f32(const void* X, void* Y, int64_t numel, void* stream) {
  if (numel <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(X);
  float* yf = static_cast<float*>(Y);
  if (aligned16(X) && aligned16(Y)) {
    const int64_t nv = numel / 4;
    const int tail = (int)(numel - nv * 4);
    return launch<float4>(X, Y, nv, xf + nv * 4, yf + nv * 4, tail, s);
  }
  return launch<float>(X, Y, numel, xf, yf, 0, s);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
