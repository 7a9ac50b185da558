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
//       is never concatenated.
//
// X [n, k] and Y are row-major f32; block and strip values are row-major
// f32 ([nb, R, bs, bs] / [ns, strip, W]); indices are int32.  All four
// run in full f32 FFMA (no TF32, no bf16): the TPU kernels pin
// Precision.HIGHEST because bf16 passes cost 3.6e-3 relative error.  Each
// output sums its terms in index order (r, then j; or w), one FFMA each.
//
// Bound: on this card device-memory bytes for K3 at solver widths; the
// formats' stored zeros (ELL padding blocks, the zeros inside a block,
// the window's padding columns) are read all the same, so the kernels
// move more bytes than the nonzeros need.  The count the bound uses
// (PERF.md) is the matrix's nonzeros, X once and Y once.
//
// K3 and K4: one thread per output row x 16-byte column vector (4 f32)
// when k % 4 == 0 and the pointers are 16-byte aligned, else one thread
// per output element.  Neighbouring threads walk along k, so the X row
// loads of a warp are coalesced and the matrix value each needs is one
// broadcast load.  K4 gathers strip_cols[s, w / bs] * bs + w % bs.
//
// K5 and K6: one register-tiled shared-memory tile kernel.
// - The format's own floor.  win_vals is dense [strip, W] per strip (the
//   JAX package's format, byte-identical): on the banded SPD test matrix
//   (n 1M, bs 8, strip 256, W 384) it holds 6.9x the nonzeros, 1.61 GB,
//   so win_vals + X + Y at k 128 cannot move in less than 0.80 ms at 3.35
//   TB/s, and the dense window product (103 GFLOP) takes 1.54 ms at the
//   67 TFLOP/s FFMA peak.  The nonzero bound of PERF.md (0.39 ms) is out
//   of reach for this format; reading win_vals bounds the kernel.
// - Tiles.  One CTA computes BM rows of one strip (a strip of 256 is
//   several row tiles sharing lo[s]; a ragged strip such as 264 at bs 24
//   is masked) times BN columns, BN in {16, 32, 64, 128} picked from k
//   alone, so a solver block of 16-48 columns does not fill a 128-wide
//   tile with padding.  The grid is one-dimensional with the column tile
//   fastest, so for k > 128 the CTAs that share a win_vals tile run
//   together and re-read it from L2.  Each thread holds a TM x TN tile of
//   Y in registers (4 x 8 at BN 128): one float4 of win_vals and two of X
//   feed 32 FFMAs, where the one-thread-per-row body this replaces fed one
//   16-byte X load to 4 FFMAs and was load-bound (6.7 TFLOP/s, 15.4 ms).
// - The window in chunks of BK rows.  Each thread loads its part of the
//   chunk's [BM, BK] win_vals slice into registers PREFETCH chunks ahead
//   (16-byte loads when W % 4 == 0); __syncthreads_or decides whether any
//   of it is nonzero.  Only then is the slice stored to shared memory
//   (transposed and padded, so each thread reads its rows as float4
//   without bank conflicts) and the [BK, BN] slab of X rows lo[s]*bs + w0
//   requested with cp.async; the product of the chunk runs LAG chunks
//   later, when the slab has landed (LAG + 1 buffers).  A ragged W is
//   zero-filled; no [W, k] slab is ever held, so any W works.
// - Zero chunks cost their win_vals loads and one barrier: a 32-row tile
//   of a +-3-block band touches 80 of the 384 window columns, so the X
//   loads and FFMAs of 19 of its 24 chunks are skipped.  Each output
//   still sums its terms in order w = 0 .. W-1, one FFMA each, and adding
//   an exact zero product changes an f32 sum at most in the sign of a
//   zero, so for finite X the skip changes no value.  A NaN or Inf of X meets a
//   stored zero only in a skipped chunk and is then not carried (the
//   one-thread-per-row body and the Pallas dot made it NaN); the solver
//   never feeds non-finite blocks.
// - Why FFMA, not tensor cores.  The reference pins the product to full
//   f32; 3xTF32 would triple the tensor-core work to reach it, and after
//   the skip the FFMA time (~0.3 ms at peak) is below the bytes'.
// - K6 picks its source buffer once per CTA (lo[s] is uniform over a
//   strip) and then runs K5's kernel unchanged with another base
//   pointer: same tiles, same order, so K6 is bit-equal to K5 on the
//   concatenated frame, and as fast.  The 16-byte path (X, edge buffers
//   and Y 16-byte aligned, k % 4 == 0) differs from the 4-byte path only
//   in how X is staged and Y stored, never in the arithmetic.
// - Tile shapes (WinShape), chosen by timing variants on the H100
//   (PERF.md, PR 5): BN <= 64: BM 64, BK 32, PREFETCH 2, LAG 2; BN 128:
//   BM 32, BK 16, PREFETCH 4, LAG 3.  Narrow tiles favour long chunks
//   (fewer barriers per byte of win_vals); the 128-wide tile favours short
//   row tiles (fewer window columns per tile, so more chunks skipped).

#include <climits>
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

// K4.  One thread per (output row, V columns); vals is [ns * strip, W];
// strip_cols is [ns, Rs].
template <int V>
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
    VT y;
#pragma unroll
    for (int c = 0; c < V; ++c) y.v[c] = acc[c];
    Yv[t] = y;
  }
}

// --- K5 / K6: the register-tiled strip-window product -----------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies of 4 or 16 bytes; with full false
// nothing is read and the destination is zero-filled (src stays a valid
// address all the same).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile of a BN-column launch.  RT row threads, each with TM rows;
// CT = BN / TN column threads, each with TN columns.  A thread's rows and
// columns are float4 groups strided across the tile, so the threads of a
// quarter warp read neighbouring 16-byte words of shared memory and store
// neighbouring 16-byte words of Y.  Each thread loads AV float4s of a
// chunk's [BM, BK] win_vals slice.  __launch_bounds__ asks for 512 / NT
// CTAs an SM, at most 128 registers a thread.
template <int BN>
struct WinShape {
  static constexpr int BM = BN >= 128 ? 32 : 64, BK = BN >= 128 ? 16 : 32;
  static constexpr int P = BN >= 128 ? 4 : 2, E = BN >= 128 ? 3 : 2;
};

template <int BN_>
struct WinTile {
  static constexpr int BM = WinShape<BN_>::BM, BN = BN_, BK = WinShape<BN_>::BK;
  static constexpr int P = WinShape<BN_>::P, E = WinShape<BN_>::E;
  static constexpr int TM = BM >= 128 ? 8 : 4, TN = BN >= 64 ? 8 : 4;
  static constexpr int RT = BM / TM, CT = BN / TN, NT = RT * CT;
  static constexpr int AV = BM * BK / 4 / NT;
  static constexpr int APITCH = BM + 4;  // As[w][row], padded
  static constexpr int A_ELEMS = BK * APITCH, B_ELEMS = BK * BN;
  static constexpr int SMEM = (E + 1) * (A_ELEMS + B_ELEMS) * (int)sizeof(float);
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BK % 4 == 0, "float4 groups");
  static_assert(NT % 32 == 0 && AV >= 1 && AV * 4 * NT == BM * BK && NT <= 512,
                "thread layout");
  static_assert(P >= 1 && E >= 1 && E < 32, "prefetch depth and lag");
};

// One CTA: row tile (blockIdx / ctiles) of the strips, column tile
// (blockIdx % ctiles).  The window of strip s starts at row
// start = lo[s]*bs of the frame [top rows hrows | X | bot]; with
// body_hi = hrows + n_loc - W it lies whole in
//   top at start                 when start <  hrows,
//   bot at start - body_hi       when start >  body_hi,
//   X   at start - hrows         otherwise.
// K5 passes hrows 0 and body_hi INT64_MAX: always X at start.  va: W % 4
// == 0 and win_vals 16-byte aligned (float4 loads of win_vals).
//
// Chunk j of the window: its win_vals slice reaches registers P chunks
// ahead (plain loads); at step j every thread tests its part,
// __syncthreads_or decides for the CTA, and a nonzero chunk is stored to
// shared memory (transposed) and its X slab requested with cp.async.
// The product of chunk j runs at step j + E, when the slab has had E
// steps to land; E + 1 buffers hold the chunks in flight.  An all-zero
// chunk costs its win_vals loads and one barrier, nothing else.
template <int BN, bool VB>
__global__ void __launch_bounds__(WinTile<BN>::NT, 512 / WinTile<BN>::NT)
    bsr_window_tile_kernel(const int32_t* __restrict__ lo, const float* __restrict__ vals,
                           const float* __restrict__ X, const float* __restrict__ top,
                           const float* __restrict__ bot, float* __restrict__ Y,
                           int64_t n_out, int64_t strip, int64_t W, int64_t bs,
                           int64_t k, int64_t hrows, int64_t body_hi, int64_t rtiles,
                           int64_t ctiles, int va) {
  using T = WinTile<BN>;
  constexpr int BM = T::BM, BK = T::BK, P = T::P, E = T::E, TM = T::TM, TN = T::TN;
  constexpr int RT = T::RT, CT = T::CT, NT = T::NT, AV = T::AV, AP = T::APITCH;
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [E + 1][BK][AP]
  float* const Bs = As + (E + 1) * T::A_ELEMS;        // [E + 1][BK][BN]

  const int tid = threadIdx.x;
  const int ty = tid / CT, tx = tid - ty * CT;
  const int64_t tile = blockIdx.x / ctiles;
  const int64_t c0 = (blockIdx.x - tile * ctiles) * BN;
  const int64_t s = tile / rtiles;
  const int64_t r0 = (tile - s * rtiles) * BM;  // first row of the tile in strip s
  const int64_t row0 = s * strip + r0;          // its output row
  int64_t nrows = strip - r0 < BM ? strip - r0 : BM;
  if (n_out - row0 < nrows) nrows = n_out - row0;
  if (nrows <= 0) return;  // the whole CTA: rows past n_out

  const int64_t start = (int64_t)lo[s] * bs;
  const float* src;
  if (start < hrows)
    src = top + start * k;
  else if (start > body_hi)
    src = bot + (start - body_hi) * k;
  else
    src = X + (start - hrows) * k;
  const float* const arow = vals + row0 * W;  // win_vals row row0
  const int64_t nchunks = (W + BK - 1) / BK;

  // Chunk ch's win_vals: float4 group f = tid + i * NT is row f / (BK / 4),
  // columns 4 * (f % (BK / 4)) + 0..3 of the [BM, BK] slice.
  auto load_a = [&](int64_t ch, float4 (&dst)[AV]) {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int f = tid + i * NT;
      const int r = f / (BK / 4);
      const int64_t w = ch * BK + 4 * (f - r * (BK / 4));
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < nrows && w < W) {
        const float* p = arow + r * W + w;
        if (va) {
          q = *reinterpret_cast<const float4*>(p);
        } else {
          q.x = p[0];
          if (w + 1 < W) q.y = p[1];
          if (w + 2 < W) q.z = p[2];
          if (w + 3 < W) q.w = p[3];
        }
      }
      dst[i] = q;
    }
  };

  // Store chunk j's win_vals (transposed) and request its X slab, buffer b.
  auto stage = [&](int64_t ch, const float4 (&av)[AV], int b) {
    float* const as = As + b * T::A_ELEMS;
    float* const bsm = Bs + b * T::B_ELEMS;
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int f = tid + i * NT;
      const int r = f / (BK / 4), c = 4 * (f - r * (BK / 4));
      as[(c + 0) * AP + r] = av[i].x;
      as[(c + 1) * AP + r] = av[i].y;
      as[(c + 2) * AP + r] = av[i].z;
      as[(c + 3) * AP + r] = av[i].w;
    }
    const int64_t w0 = ch * BK;
    if (VB) {
      constexpr int NV = BK * BN / 4;
#pragma unroll
      for (int it = 0; it < (NV + NT - 1) / NT; ++it) {
        const int i = tid + it * NT;
        if (NV % NT != 0 && i >= NV) break;
        const int r = i / (BN / 4), v = i - (i / (BN / 4)) * (BN / 4);
        const bool ok = w0 + r < W && c0 + 4 * v < k;
        cp_async16(bsm + r * BN + 4 * v, ok ? src + (w0 + r) * k + c0 + 4 * v : src, ok);
      }
    } else {
      constexpr int NE = BK * BN;
#pragma unroll
      for (int it = 0; it < (NE + NT - 1) / NT; ++it) {
        const int i = tid + it * NT;
        if (NE % NT != 0 && i >= NE) break;
        const int r = i / BN, c = i - (i / BN) * BN;
        const bool ok = w0 + r < W && c0 + c < k;
        cp_async4(bsm + r * BN + c, ok ? src + (w0 + r) * k + c0 + c : src, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

  float4 areg[P][AV];
#pragma unroll
  for (int u = 0; u < P; ++u) load_a(u, areg[u]);

  unsigned flags = 0;  // bit e: chunk (step - e) was staged
  int bin = 0;         // buffer of the chunk staged at this step
  for (int64_t j0 = 0; j0 < nchunks + E; j0 += P) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int64_t j = j0 + u;
      if (j >= nchunks + E) break;
      cp_async_wait<E - 1>();  // this thread's X slab of chunk j - E landed
      bool nz = false;
      if (j < nchunks) {
#pragma unroll
        for (int i = 0; i < AV; ++i)
          nz |= areg[u][i].x != 0.0f || areg[u][i].y != 0.0f ||
                areg[u][i].z != 0.0f || areg[u][i].w != 0.0f;
      }
      // Also: chunk j - E's slab and values visible to all, and the
      // buffer of chunk j - E - 1 (computed at the last step) free.
      const int any = __syncthreads_or(nz);
      if (any) stage(j, areg[u], bin);
      cp_async_commit();
      if (j + P < nchunks) load_a(j + P, areg[u]);
      flags = (flags << 1) | (any ? 1u : 0u);
      bin = bin == E ? 0 : bin + 1;
      if ((flags >> E) & 1u) {  // the product of chunk j - E
        const int b = bin;  // (j - E) % (E + 1) == (j + 1) % (E + 1)
        const float* const as = As + b * T::A_ELEMS;
        const float* const bsm = Bs + b * T::B_ELEMS;
#pragma unroll
        for (int w = 0; w < BK; ++w) {
          float a[TM], bv[TN];
#pragma unroll
          for (int g = 0; g < TM / 4; ++g)
            *reinterpret_cast<float4*>(&a[4 * g]) =
                *reinterpret_cast<const float4*>(&as[w * AP + g * RT * 4 + ty * 4]);
#pragma unroll
          for (int g = 0; g < TN / 4; ++g)
            *reinterpret_cast<float4*>(&bv[4 * g]) =
                *reinterpret_cast<const float4*>(&bsm[w * BN + g * CT * 4 + tx * 4]);
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = (m / 4) * RT * 4 + ty * 4 + (m % 4);
    if (r >= nrows) continue;
    float* const yrow = Y + (row0 + r) * k;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int64_t col = c0 + g * CT * 4 + tx * 4;
      if (VB) {
        if (col < k)
          *reinterpret_cast<float4*>(yrow + col) =
              make_float4(acc[m][4 * g], acc[m][4 * g + 1], acc[m][4 * g + 2],
                          acc[m][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < k) yrow[col + j] = acc[m][4 * g + j];
      }
    }
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

template <int V>
int launch_strip(const int32_t* idx, int64_t Rs, const float* vals, const float* X,
                 float* Y, int64_t n_out, int64_t strip, int64_t W, int64_t bs,
                 int64_t k, cudaStream_t s) {
  const int threads = 256;
  const int64_t total = n_out * (k / V);
  bsr_strip_kernel<V><<<(unsigned)grid_for(total, threads), threads, 0, s>>>(
      idx, Rs, vals, X, Y, n_out, strip, W, bs, k / V);
  return (int)cudaGetLastError();
}

template <int BN, bool VB>
int launch_window_tile(const int32_t* lo, const float* vals, const float* X,
                       const float* top, const float* bot, float* Y, int64_t n_out,
                       int64_t strip, int64_t W, int64_t bs, int64_t k, int64_t hrows,
                       int64_t body_hi, cudaStream_t s) {
  using T = WinTile<BN>;
  const int64_t rtiles = (strip + T::BM - 1) / T::BM;
  const int64_t ctiles = (k + BN - 1) / BN;
  const int64_t blocks = (n_out + strip - 1) / strip * rtiles * ctiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  auto kernel = bsr_window_tile_kernel<BN, VB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int va = W % 4 == 0 && aligned16(vals);
  kernel<<<(unsigned)blocks, T::NT, T::SMEM, s>>>(lo, vals, X, top, bot, Y, n_out,
                                                    strip, W, bs, k, hrows, body_hi,
                                                    rtiles, ctiles, va);
  return (int)cudaGetLastError();
}

// The tile width from k alone, so K5 and K6 pick the same tiles.
template <bool VB>
int launch_window(const int32_t* lo, const float* vals, const float* X,
                  const float* top, const float* bot, float* Y, int64_t n_out,
                  int64_t strip, int64_t W, int64_t bs, int64_t k, int64_t hrows,
                  int64_t body_hi, cudaStream_t s) {
  if (k <= 16)
    return launch_window_tile<16, VB>(lo, vals, X, top, bot, Y, n_out, strip, W, bs, k,
                                      hrows, body_hi, s);
  if (k <= 32)
    return launch_window_tile<32, VB>(lo, vals, X, top, bot, Y, n_out, strip, W, bs, k,
                                      hrows, body_hi, s);
  if (k <= 64)
    return launch_window_tile<64, VB>(lo, vals, X, top, bot, Y, n_out, strip, W, bs, k,
                                      hrows, body_hi, s);
  return launch_window_tile<128, VB>(lo, vals, X, top, bot, Y, n_out, strip, W, bs, k,
                                     hrows, body_hi, s);
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
  if (n_out <= 0 || strip <= 0 || bs <= 0 || k <= 0 || Rs <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(strip_cols);
  const float* vp = static_cast<const float*>(strip_vals);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return launch_strip<4>(ip, Rs, vp, xp, yp, n_out, strip, Rs * bs, bs, k, s);
  return launch_strip<1>(ip, Rs, vp, xp, yp, n_out, strip, Rs * bs, bs, k, s);
}

// K5.  lo: [ns] int32 window starts in blocks; win_vals: [ns, strip, W];
// X: [rows, k] with lo[s]*bs + W <= rows; Y: [n_out, k], n_out <= ns*strip.
int lobpcg_bsr_window_f32(const void* lo, const void* win_vals, const void* X,
                          void* Y, int64_t n_out, int64_t strip, int64_t W,
                          int64_t bs, int64_t k, void* stream) {
  if (n_out <= 0 || strip <= 0 || W <= 0 || bs <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lp = static_cast<const int32_t*>(lo);
  const float* vp = static_cast<const float*>(win_vals);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return launch_window<true>(lp, vp, xp, xp, xp, yp, n_out, strip, W, bs, k, 0,
                               INT64_MAX, s);
  return launch_window<false>(lp, vp, xp, xp, xp, yp, n_out, strip, W, bs, k, 0,
                              INT64_MAX, s);
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
  const int64_t body_hi = hrows + n_loc - W;
  if (k % 4 == 0 && aligned16(X) && aligned16(edge_top) && aligned16(edge_bot) &&
      aligned16(Y))
    return launch_window<true>(lp, vp, xp, tp, bp, yp, n_out, strip, W, bs, k, hrows,
                               body_hi, s);
  return launch_window<false>(lp, vp, xp, tp, bp, yp, n_out, strip, W, bs, k, hrows,
                              body_hi, s);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
