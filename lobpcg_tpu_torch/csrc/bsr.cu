// Block-sparse x dense SpMMs for Hopper (sm_90a): four entry points.
//
// Replaces the TPU kernels of lobpcg_tpu/ops/pallas/bsr.py:
//
//   K3  bsr_matmat_pallas         block-ELL:   Y[blk i] = sum_r blocks[i,r] . X[blk cols[i,r]]
//   K4  bsr_strip_matmat_pallas   strip-ELL:   Y[strip s] = strip_vals[s] . X[rows of strip_cols[s]]
//   K5  bsr_window_matmat_pallas  strip-window: Y[strip s] = win_vals[s] . X[lo[s]*bs : lo[s]*bs + W]
//   K6  bsr_window_matmat_pallas_edges  K5 against the halo-extended frame
//       [halo_up | X | halo_dn] of a row shard, given as three buffers:
//       edge_top = [halo_up | X[:W]], X, edge_bot = [X[-W:] | halo_dn].
//       Each strip reads its window from the one buffer that holds it
//       whole (W <= the local rows makes the choice unique), so the frame
//       is never concatenated.  The concatenation copies X once more, but
//       with this one-thread-per-row body the per-strip source choice
//       costs more than that copy: on the H100 K6 is slower than the
//       concatenation plus K5 (PERF.md, chip_smoke.py's k6 phase).  The
//       edge buffers pay for themselves only once the shared body is
//       near its byte bound (ROADMAP: the K5/K6 redesign).
//
// X [n, k] and Y are row-major f32; block and strip values are row-major
// f32 ([nb, R, bs, bs] / [ns, strip, W]); indices are int32.  All three
// run in full f32 FFMA (no TF32, no bf16): the TPU kernels pin
// Precision.HIGHEST because bf16 passes cost 3.6e-3 relative error.  The
// sums run in index order (r, then j; or w), each term one FFMA.
//
// K4 and K5 are one body: a dense strip row times gathered X rows.  K5
// gathers the contiguous window rows lo[s]*bs + w; K4 gathers
// strip_cols[s, w / bs] * bs + w % bs.  Rows >= n of the last
// (zero-padded) strip are not written.
//
// Bound: on this card device-memory bytes for K3 at solver widths; the
// formats' stored zeros (ELL padding blocks, the zeros inside a block,
// the window's padding columns) are read and multiplied all the same, so
// the kernels do more work than the nonzeros need.  The count the bound
// uses (PERF.md) is the matrix's nonzeros, X once and Y once.
//
// Design: one thread per output row x 16-byte column vector (4 f32) when
// k % 4 == 0 and the pointers are 16-byte aligned, else one thread per
// output element.  Neighbouring threads walk along k, so the X row loads
// of a warp are coalesced and the matrix value each needs is one
// broadcast load.  Left for later work: shared-memory tiles of the strip
// values and of the gathered X rows, several output rows per thread,
// TMA loads of the window slab, tensor-core passes (3xTF32 split) for
// the window product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

// K3.  One thread per (row of block i, V columns).  kv = k / V.
template <int V>
__global__ void bsr_ell_kernel(const int32_t* __restrict__ cols,
                               const float* __restrict__ blocks,
                               const float* __restrict__ X, float* __restrict__ Y,
                               int64_t nb, int64_t R, int64_t bs, int64_t kv) {
  using VT = Vec<V>;
  const int64_t total = nb * bs * kv;
  const VT* Xv = reinterpret_cast<const VT*>(X);
  VT* Yv = reinterpret_cast<VT*>(Y);
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = idx / kv;
    const int64_t cv = idx - row * kv;
    const int64_t i = row / bs;
    const int64_t ri = row - i * bs;
    float acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = 0.0f;
    for (int64_t r = 0; r < R; ++r) {
      const int64_t col = cols[i * R + r];
      const float* a = blocks + ((i * R + r) * bs + ri) * bs;
      const VT* xb = Xv + col * bs * kv + cv;
      for (int64_t j = 0; j < bs; ++j) {
        const float aj = a[j];
        const VT x = xb[j * kv];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = fmaf(aj, x.v[c], acc[c]);
      }
    }
    VT y;
#pragma unroll
    for (int c = 0; c < V; ++c) y.v[c] = acc[c];
    Yv[idx] = y;
  }
}

// One output row's window product, the body K5 and K6 share: acc +=
// a[w] * xb[w] for w = 0 .. W-1 in that order, one FFMA per term, so the
// two kernels give bit-identical sums on the same window.
template <int V>
__device__ __forceinline__ void window_row(const float* __restrict__ a,
                                           const Vec<V>* __restrict__ xb,
                                           int64_t W, int64_t kv, float* acc) {
  for (int64_t w = 0; w < W; ++w) {
    const float aw = a[w];
    const Vec<V> x = xb[w * kv];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = fmaf(aw, x.v[c], acc[c]);
  }
}

// K4 (WINDOW = false) and K5 (WINDOW = true).  One thread per (output
// row, V columns); vals is [ns * strip, W]; idx_arr is strip_cols
// [ns, Rs] for K4, or the window starts lo [ns] for K5.
template <int V, bool WINDOW>
__global__ void bsr_strip_kernel(const int32_t* __restrict__ idx_arr, int64_t Rs,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ X, float* __restrict__ Y,
                                 int64_t n_out, int64_t strip, int64_t W,
                                 int64_t bs, int64_t kv) {
  using VT = Vec<V>;
  const int64_t total = n_out * kv;
  const VT* Xv = reinterpret_cast<const VT*>(X);
  VT* Yv = reinterpret_cast<VT*>(Y);
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = t / kv;
    const int64_t cv = t - row * kv;
    const int64_t s = row / strip;
    const float* a = vals + row * W;  // row s*strip + rr of [ns*strip, W]
    float acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = 0.0f;
    if (WINDOW) {
      window_row<V>(a, Xv + (int64_t)idx_arr[s] * bs * kv + cv, W, kv, acc);
    } else {
      for (int64_t u = 0; u < Rs; ++u) {
        const VT* xb = Xv + (int64_t)idx_arr[s * Rs + u] * bs * kv + cv;
        const float* au = a + u * bs;
        for (int64_t j = 0; j < bs; ++j) {
          const float aj = au[j];
          const VT x = xb[j * kv];
#pragma unroll
          for (int c = 0; c < V; ++c) acc[c] = fmaf(aj, x.v[c], acc[c]);
        }
      }
    }
    VT y;
#pragma unroll
    for (int c = 0; c < V; ++c) y.v[c] = acc[c];
    Yv[t] = y;
  }
}

// K6.  One thread per (output row, V columns), as K5.  The window of
// strip s starts at row start = lo[s]*bs of the extended frame
// [halo_up (hrows) | X (n_loc) | halo_dn (hrows)]; with
// body_hi = hrows + n_loc - W it lies whole in
//   edge_top at start                 when start <  hrows,
//   edge_bot at start - body_hi       when start >  body_hi,
//   X        at start - hrows         otherwise.
template <int V>
__global__ void bsr_window_edges_kernel(const int32_t* __restrict__ lo,
                                        const float* __restrict__ vals,
                                        const float* __restrict__ X,
                                        const float* __restrict__ top,
                                        const float* __restrict__ bot,
                                        float* __restrict__ Y, int64_t n_out,
                                        int64_t strip, int64_t W, int64_t bs,
                                        int64_t kv, int64_t hrows, int64_t body_hi) {
  using VT = Vec<V>;
  const int64_t total = n_out * kv;
  VT* Yv = reinterpret_cast<VT*>(Y);
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = t / kv;
    const int64_t cv = t - row * kv;
    const int64_t start = (int64_t)lo[row / strip] * bs;
    const float* src;
    int64_t off;
    if (start < hrows) {
      src = top;
      off = start;
    } else if (start > body_hi) {
      src = bot;
      off = start - body_hi;
    } else {
      src = X;
      off = start - hrows;
    }
    float acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = 0.0f;
    window_row<V>(vals + row * W, reinterpret_cast<const VT*>(src) + off * kv + cv,
                  W, kv, acc);
    VT y;
#pragma unroll
    for (int c = 0; c < V; ++c) y.v[c] = acc[c];
    Yv[t] = y;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int64_t grid_for(int64_t total, int threads) {
  // A grid-stride loop covers whatever the grid cap leaves.
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return blocks;
}

template <int V>
int launch_ell(const int32_t* cols, const float* blocks, const float* X, float* Y,
               int64_t nb, int64_t R, int64_t bs, int64_t k, cudaStream_t s) {
  const int threads = 256;
  const int64_t total = nb * bs * (k / V);
  bsr_ell_kernel<V><<<(unsigned)grid_for(total, threads), threads, 0, s>>>(
      cols, blocks, X, Y, nb, R, bs, k / V);
  return (int)cudaGetLastError();
}

template <int V, bool WINDOW>
int launch_strip(const int32_t* idx, int64_t Rs, const float* vals, const float* X,
                 float* Y, int64_t n_out, int64_t strip, int64_t W, int64_t bs,
                 int64_t k, cudaStream_t s) {
  const int threads = 256;
  const int64_t total = n_out * (k / V);
  bsr_strip_kernel<V, WINDOW><<<(unsigned)grid_for(total, threads), threads, 0, s>>>(
      idx, Rs, vals, X, Y, n_out, strip, W, bs, k / V);
  return (int)cudaGetLastError();
}

template <bool WINDOW>
int dispatch_strip(const void* idx, int64_t Rs, const void* vals, const void* X,
                   void* Y, int64_t n_out, int64_t strip, int64_t W, int64_t bs,
                   int64_t k, void* stream) {
  if (n_out <= 0 || strip <= 0 || W <= 0 || bs <= 0 || k <= 0 || Rs <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* vp = static_cast<const float*>(vals);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return launch_strip<4, WINDOW>(ip, Rs, vp, xp, yp, n_out, strip, W, bs, k, s);
  return launch_strip<1, WINDOW>(ip, Rs, vp, xp, yp, n_out, strip, W, bs, k, s);
}

template <int V>
int launch_edges(const int32_t* lo, const float* vals, const float* X,
                 const float* top, const float* bot, float* Y, int64_t n_out,
                 int64_t strip, int64_t W, int64_t bs, int64_t k, int64_t hrows,
                 int64_t n_loc, cudaStream_t s) {
  const int threads = 256;
  const int64_t total = n_out * (k / V);
  bsr_window_edges_kernel<V><<<(unsigned)grid_for(total, threads), threads, 0, s>>>(
      lo, vals, X, top, bot, Y, n_out, strip, W, bs, k / V, hrows, hrows + n_loc - W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3.  cols: [nb, R] int32 block columns (padding blocks zero at column
// 0); blocks: [nb, R, bs, bs]; X, Y: [nb*bs, k].  Returns
// cudaGetLastError() after the launch (0 = ok).
int lobpcg_bsr_ell_f32(const void* cols, const void* blocks, const void* X,
                       void* Y, int64_t nb, int64_t R, int64_t bs, int64_t k,
                       void* stream) {
  if (nb <= 0 || R <= 0 || bs <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* cp = static_cast<const int32_t*>(cols);
  const float* bp = static_cast<const float*>(blocks);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return launch_ell<4>(cp, bp, xp, yp, nb, R, bs, k, s);
  return launch_ell<1>(cp, bp, xp, yp, nb, R, bs, k, s);
}

// K4.  strip_cols: [ns, Rs] int32; strip_vals: [ns, strip, Rs*bs];
// X: [rows, k]; Y: [n_out, k] with n_out <= ns*strip.
int lobpcg_bsr_strip_f32(const void* strip_cols, int64_t Rs, const void* strip_vals,
                         const void* X, void* Y, int64_t n_out, int64_t strip,
                         int64_t bs, int64_t k, void* stream) {
  return dispatch_strip<false>(strip_cols, Rs, strip_vals, X, Y, n_out, strip,
                               Rs * bs, bs, k, stream);
}

// K5.  lo: [ns] int32 window starts in blocks; win_vals: [ns, strip, W];
// X: [rows, k] with lo[s]*bs + W <= rows; Y: [n_out, k], n_out <= ns*strip.
int lobpcg_bsr_window_f32(const void* lo, const void* win_vals, const void* X,
                          void* Y, int64_t n_out, int64_t strip, int64_t W,
                          int64_t bs, int64_t k, void* stream) {
  return dispatch_strip<true>(lo, 1, win_vals, X, Y, n_out, strip, W, bs, k, stream);
}

// K6.  lo: [ns] int32 window starts in blocks of the extended frame
// (hrows + n_loc + hrows rows); win_vals: [ns, strip, W] with
// W <= n_loc; X: [n_loc, k]; edge_top = [halo_up | X[:W]] and
// edge_bot = [X[-W:] | halo_dn]: [hrows + W, k] each; Y: [n_out, k],
// n_out <= ns*strip.  The 16-byte path needs all four row pointers
// aligned.
int lobpcg_bsr_window_edges_f32(const void* lo, const void* win_vals, const void* X,
                                const void* edge_top, const void* edge_bot, void* Y,
                                int64_t n_out, int64_t strip, int64_t W, int64_t bs,
                                int64_t k, int64_t hrows, int64_t n_loc, void* stream) {
  if (n_out <= 0 || strip <= 0 || W <= 0 || bs <= 0 || k <= 0 || hrows < 0 ||
      W > n_loc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lp = static_cast<const int32_t*>(lo);
  const float* vp = static_cast<const float*>(win_vals);
  const float* xp = static_cast<const float*>(X);
  const float* tp = static_cast<const float*>(edge_top);
  const float* bp = static_cast<const float*>(edge_bot);
  float* yp = static_cast<float*>(Y);
  if (k % 4 == 0 && aligned16(X) && aligned16(edge_top) && aligned16(edge_bot) &&
      aligned16(Y))
    return launch_edges<4>(lp, vp, xp, tp, bp, yp, n_out, strip, W, bs, k, hrows,
                           n_loc, s);
  return launch_edges<1>(lp, vp, xp, tp, bp, yp, n_out, strip, W, bs, k, hrows,
                         n_loc, s);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
