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
// Bound: device-memory bytes.  The formats' stored zeros (ELL padding
// blocks, the zeros inside a block, the strip formats' padding columns)
// are read all the same, so each kernel's floor is its format's bytes,
// above the nonzero count the bound of PERF.md uses.
//
// K4, K5 and K6: one register-tiled shared-memory tile kernel
// (strip_tile_kernel), which differs between them only in where row w of
// a strip's columns lies in X (the row map): lo[s]*bs + w of the frame
// for K5/K6, strip_cols[s, w / bs]*bs + w % bs for K4.
// - The format's own floor.  win_vals / strip_vals are dense [strip, W]
//   per strip (the JAX package's formats, byte-identical): on the banded
//   test matrix (n 1M, bs 8, strip 256) the window is W 384 and holds
//   6.9x the nonzeros (1.61 GB), the strip-ELL union W 304 (1.27 GB), so
//   values + X + Y at k 128 cannot move in less than 0.80 / 0.70 ms at
//   3.35 TB/s; reading the values bounds the kernel.
// - Tiles.  One CTA computes BM rows of one strip (a strip of 256 is
//   several row tiles; a ragged strip such as 264 at bs 24 is masked)
//   times BN columns, BN in {16, 32, 64, 128} picked from k alone, so a
//   solver block of 16-48 columns does not fill a 128-wide tile with
//   padding.  The grid is one-dimensional with the column tile fastest, so
//   for k > 128 the CTAs that share a values tile run together and re-read
//   it from L2.  Each thread holds a TM x TN tile of Y in registers (4 x 8
//   at BN 128): one float4 of values and two of X feed 32 FFMAs.
// - The columns in chunks of BK.  Each thread loads its part of the
//   chunk's [BM, BK] values slice into registers PREFETCH chunks ahead
//   (16-byte loads when W % 4 == 0); __syncthreads_or decides whether any
//   of it is nonzero.  Only then is the slice stored to shared memory
//   (transposed and padded, so each thread reads its rows as float4
//   without bank conflicts) and the [BK, BN] slab of X rows requested with
//   cp.async, row by row through the row map (at bs 8 a K4 chunk of 16 is
//   two contiguous 8-row runs; K4 reads each row from a table of the
//   strip's X rows that the CTA builds in shared memory at its start, W
//   ints, so no division or index load sits before a copy); the product
//   of the chunk runs LAG chunks later, when the slab has landed (LAG + 1
//   buffers).  A ragged W is zero-filled; no [W, k] slab is ever held, so
//   any W works (up to kStripUnionMax for K4's table).
// - Zero chunks cost their values loads and one barrier: a 32-row tile of
//   a +-3-block band touches 80 of the 384 window columns (of the 304
//   union columns for K4), so the X loads and FFMAs of most chunks are
//   skipped.  Each output still sums its terms in order w = 0 .. W-1, one
//   FFMA each, and adding an exact zero product changes an f32 sum at most
//   in the sign of a zero, so for finite X the skip changes no value.
// - Non-finite X.  0 * NaN and 0 * Inf are NaN, so the Pallas dot (and
//   the plain version) carry a NaN or Inf of X into every output whose
//   row meets it, through stored zeros too.  One pass over X (and K6's
//   halos) first sets a device flag when any element is NaN or Inf
//   (nonfinite_kernel: X's bytes once, no host
//   sync; lobpcg_nonfinite_f32, which the wrappers call just before the
//   kernel); the tile kernel reads the flag and, when it is set, skips no
//   chunk.  Then every product of the plain version is formed, and the
//   non-finite pattern of Y equals the plain version's whatever the
//   order of the sums.  For finite X the flag is clear and nothing else
//   changes.
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
//   (fewer barriers per byte of values); the 128-wide tile favours short
//   row tiles (fewer columns per tile, so more chunks skipped).
//
// Batches (K3, K5 and K6).  X [batch, n, k] and Y [batch, n_out, k], one
// problem after another, all sharing the matrix (what jax.vmap makes of
// the Pallas kernels over an unmapped matrix); K6's edge buffers are
// [batch, hrows + W, k] too, each problem's own halos.  The column-tile axis runs
// over batch x ctiles tiles, ctiles = ceil(k / BN) per problem: tile t
// belongs to problem t / ctiles and starts at column (t % ctiles) * BN of
// that problem, so a tile never straddles two problems, whatever k is,
// and its X and Y rows are the problem's own (the base pointers move by
// one problem's X and Y, or for a K6 window in an edge buffer by one
// problem's edge buffer: the row map carries each buffer's stride).  The column tile stays the fastest index of the
// grid, so the CTAs of one row tile, every problem's, run together and
// re-read the tile's matrix values from L2: the matrix leaves DRAM about
// once per batch apply, and a batch apply moves the matrix once plus each
// problem's X and Y.  Each output sums its terms in the unbatched order,
// so each problem's Y equals its lone launch bit for bit.  One non-finite
// flag pass covers the whole batch (a NaN in one problem turns the skip
// off for all, which changes no finite problem's value).  K4 takes no
// batch (batch 1).
//
// K3: a block-row tile kernel (ell_tile_kernel).
// - The floor.  On the 160^3 Laplacian (nb 512,000, R 7, bs 8) 87% of the
//   stored block values are zeros (tridiagonal diagonal blocks, diagonal
//   neighbour blocks), and blocks (0.92 GB) + X + Y at k 16 take 0.43 ms
//   at 3.35 TB/s, while the FFMAs of all stored values take 0.11 ms at 67
//   TFLOP/s: bytes bound it.
// - Tiles.  One CTA computes BR block rows (from the thread and shared-
//   memory budget, 16 at bs 8 and k <= 16) times BN columns (BN from k as
//   for K5).  Thread (block row il, row group rg, column thread tx) holds
//   a 4 x TN tile of its block row's outputs: rows rg*4 .. rg*4+3 (those
//   below bs), columns tx*4 + g*CT*4 + 0..3.  Four rows a thread rather
//   than eight: twice the warps for the same shared memory, 10-18% faster
//   on the H100 at every shape timed (PERF.md, Findings); a fourth stage
//   and L1-cached X copies were slower.
// - What bounds it.  Each block row gathers its R X slabs, so the SMs take
//   in R x X's bytes (through L2) besides the blocks: 3.0 GB at 160^3 x 16,
//   11.4 GB on the band-72 matrix x 128.  The kernel runs at ~4.4 TB/s of
//   that traffic at every shape measured, above the DRAM floor of the
//   bytes it must move; only reusing X slabs across the block rows of a
//   tile would cut it.
// - Staging.  For each r in turn, the tile's [bs, bs] blocks (contiguous
//   in blocks, R*bs*bs apart) and their gathered X slabs (rows
//   cols[i, r]*bs .. +bs, BN columns) are copied to shared memory with
//   cp.async, STAGES r-steps in flight (three, ~14 KB a stage at bs 8 and
//   BN 16).  Each block row's copies are made by its own threads, so the
//   X rows of one slab are read as contiguous 64-512 byte runs.
// - Order.  Each output sums r, then j, one FFMA each, as the one-thread-
//   per-row body it replaces did, so the result is the same bit for bit.
//   K3 skips nothing: a padding block (zero, at column 0) carries a NaN of
//   X rows 0 .. bs-1 as the Pallas dot does.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

constexpr int64_t kSmemMax = 227 * 1024;  // dynamic shared memory a CTA can have
constexpr int64_t kStripUnionMax = 32768;  // K4's union columns (its row table)

// --- The non-finite flag ------------------------------------------------------

__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;  // NaN or +-Inf
}

// Sets *flag = 1 when any of the n floats at x is NaN or +-Inf; never
// clears it.  vec: x 16-byte aligned (float4 loads, then the tail).
__global__ void __launch_bounds__(256) nonfinite_kernel(const float* __restrict__ x,
                                                        int64_t n, int vec,
                                                        int* __restrict__ flag) {
  bool bad = false;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int64_t n4 = n / 4;
    for (int64_t i = t; i < n4; i += stride) {
      const float4 v = x4[i];
      bad |= nonfinite(v.x) | nonfinite(v.y) | nonfinite(v.z) | nonfinite(v.w);
    }
    done = 4 * n4;
  }
  for (int64_t i = done + t; i < n; i += stride) bad |= nonfinite(x[i]);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

cudaError_t mark_nonfinite(const float* x, int64_t n, int* flag, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;  // a grid-stride loop covers the rest
  nonfinite_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, n, aligned16(x), flag);
  return cudaGetLastError();
}

// --- K4 / K5 / K6: the register-tiled strip product ---------------------------

// The row maps.  Each gives, per strip s, an object whose row(w) points at
// the first element of the X row holding column w of the strip's values,
// and whose any() is a valid address for zero-filled copies.
// K5 / K6: row lo[s]*bs + w of the frame [top rows hrows | X | bot]; a
// problem of a batch is xs elements further on in X and es in top and bot.
struct WindowRows {
  const int32_t* lo;
  const float* X;
  const float* top;
  const float* bot;
  int64_t bs, k, hrows, body_hi, xs, es;
};

// K4: row strip_cols[s, w / bs]*bs + w % bs of X (xs elements a problem).
struct StripRows {
  const int32_t* cols;
  const float* X;
  int64_t Rs, bs, k, xs;
};

// The shared memory a row map needs beyond the tiles: K4's row table,
// padded by 32 entries so that no address a ragged chunk forms past W
// lies outside it.
template <class Map>
constexpr int64_t map_smem(int64_t W) {
  return std::is_same<Map, StripRows>::value ? (W + 32) * (int64_t)sizeof(int) : 0;
}

struct ContiguousAt {
  const float* src;
  int64_t k, ps;  // ps: the source buffer's elements a problem
  __device__ const float* row(int64_t w) const { return src + w * k; }
  __device__ const float* any() const { return src; }
  // The same rows of problem p of a batch.
  __device__ ContiguousAt problem(int64_t p) const { return {src + p * ps, k, ps}; }
};

struct GatheredAt {  // tab: the strip's X row of each column, in shared memory
  const int* tab;
  const float* X;
  int64_t k, xs;
  __device__ const float* row(int64_t w) const { return X + (int64_t)tab[w] * k; }
  __device__ const float* any() const { return X; }
  __device__ GatheredAt problem(int64_t p) const { return {tab, X + p * xs, k, xs}; }
};

// The window of strip s starts at row start = lo[s]*bs of the frame
// [top rows hrows | X | bot]; with body_hi = hrows + n_loc - W it lies
// whole in
//   top at start                 when start <  hrows,
//   bot at start - body_hi       when start >  body_hi,
//   X   at start - hrows         otherwise.
// K5 passes hrows 0 and body_hi INT64_MAX: always X at start.
__device__ __forceinline__ ContiguousAt rows_of(const WindowRows& m, int64_t s, int*,
                                                int64_t) {
  const int64_t start = (int64_t)m.lo[s] * m.bs;
  if (start < m.hrows) return {m.top + start * m.k, m.k, m.es};
  if (start > m.body_hi) return {m.bot + (start - m.body_hi) * m.k, m.k, m.es};
  return {m.X + (start - m.hrows) * m.k, m.k, m.xs};
}

// K4's row table, built by the CTA's threads before the first barrier:
// tab[w] = strip_cols[s, w / bs]*bs + w % bs for w < W (32-bit: W <=
// kStripUnionMax, rows < 2^31).
__device__ __forceinline__ GatheredAt rows_of(const StripRows& m, int64_t s, int* tab,
                                              int64_t W) {
  const int32_t* const cols = m.cols + s * m.Rs;
  const int bs = (int)m.bs;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int u = w / bs;
    tab[w] = cols[u] * bs + (w - u * bs);
  }
  return {tab, m.X, m.k, m.xs};
}

// The tile of a BN-column launch.  RT row threads, each with TM rows;
// CT = BN / TN column threads, each with TN columns.  A thread's rows and
// columns are float4 groups strided across the tile, so the threads of a
// quarter warp read neighbouring 16-byte words of shared memory and store
// neighbouring 16-byte words of Y.  Each thread loads AV float4s of a
// chunk's [BM, BK] values slice.  __launch_bounds__ asks for 512 / NT
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

// One CTA: row tile (blockIdx / (batch * ctiles)) of the strips, column
// tile ct = blockIdx % (batch * ctiles): problem ct / ctiles, its column
// tile ct % ctiles.  ys: one problem's Y elements (the row map moves its
// sources to the problem).  va: W % 4
// == 0 and vals 16-byte aligned (float4 loads of the values).  nonfinite:
// the flag of nonfinite_kernel over the whole batch (set: no chunk is
// skipped).
//
// Chunk j of the strip's columns: its values slice reaches registers P
// chunks ahead (plain loads); at step j every thread tests its part,
// __syncthreads_or decides for the CTA, and a nonzero chunk is stored to
// shared memory (transposed) and its X slab requested with cp.async.
// The product of chunk j runs at step j + E, when the slab has had E
// steps to land; E + 1 buffers hold the chunks in flight.  An all-zero
// chunk costs its values loads and one barrier, nothing else.
template <int BN, bool VB, class Map>
__global__ void __launch_bounds__(WinTile<BN>::NT, 512 / WinTile<BN>::NT)
    strip_tile_kernel(Map map, const float* __restrict__ vals, float* __restrict__ Y,
                      int64_t n_out, int64_t strip, int64_t W, int64_t k,
                      int64_t rtiles, int64_t ctiles, int64_t batch, int64_t ys, int va,
                      const int* __restrict__ nonfinite) {
  using T = WinTile<BN>;
  constexpr int BM = T::BM, BK = T::BK, P = T::P, E = T::E, TM = T::TM, TN = T::TN;
  constexpr int RT = T::RT, CT = T::CT, NT = T::NT, AV = T::AV, AP = T::APITCH;
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [E + 1][BK][AP]
  float* const Bs = As + (E + 1) * T::A_ELEMS;        // [E + 1][BK][BN]

  const int tid = threadIdx.x;
  const int ty = tid / CT, tx = tid - ty * CT;
  const int64_t tile = blockIdx.x / (batch * ctiles);
  const int64_t ct = blockIdx.x - tile * (batch * ctiles);
  const int64_t prob = ct / ctiles;
  const int64_t c0 = (ct - prob * ctiles) * BN;
  Y += prob * ys;
  const int64_t s = tile / rtiles;
  const int64_t r0 = (tile - s * rtiles) * BM;  // first row of the tile in strip s
  const int64_t row0 = s * strip + r0;          // its output row
  int64_t nrows = strip - r0 < BM ? strip - r0 : BM;
  if (n_out - row0 < nrows) nrows = n_out - row0;
  if (nrows <= 0) return;  // the whole CTA: rows past n_out

  // (K4's row table follows the tiles; the barrier of step 0 publishes it.)
  const auto rows =
      rows_of(map, s, reinterpret_cast<int*>(Bs + (E + 1) * T::B_ELEMS), W).problem(prob);
  const bool keep_all = *nonfinite != 0;
  const float* const arow = vals + row0 * W;  // values row row0
  const int64_t nchunks = (W + BK - 1) / BK;

  // Chunk ch's values: float4 group f = tid + i * NT is row f / (BK / 4),
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

  // Store chunk j's values (transposed) and request its X slab, buffer b.
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
        cp_async16(bsm + r * BN + 4 * v, ok ? rows.row(w0 + r) + c0 + 4 * v : rows.any(),
                   ok);
      }
    } else {
      constexpr int NE = BK * BN;
#pragma unroll
      for (int it = 0; it < (NE + NT - 1) / NT; ++it) {
        const int i = tid + it * NT;
        if (NE % NT != 0 && i >= NE) break;
        const int r = i / BN, c = i - (i / BN) * BN;
        const bool ok = w0 + r < W && c0 + c < k;
        cp_async4(bsm + r * BN + c, ok ? rows.row(w0 + r) + c0 + c : rows.any(), ok);
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
        nz = keep_all;
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

template <int BN, bool VB, class Map>
cudaError_t launch_strip_tile(const Map& map, const float* vals, float* Y, int64_t n_out,
                              int64_t strip, int64_t W, int64_t k, int64_t batch,
                              const int* flag, cudaStream_t s) {
  using T = WinTile<BN>;
  const int64_t rtiles = (strip + T::BM - 1) / T::BM;
  const int64_t ctiles = (k + BN - 1) / BN;
  const int64_t blocks = (n_out + strip - 1) / strip * rtiles * ctiles * batch;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int64_t smem = T::SMEM + map_smem<Map>(W);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = strip_tile_kernel<BN, VB, Map>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int va = W % 4 == 0 && aligned16(vals);
  kernel<<<(unsigned)blocks, T::NT, (size_t)smem, s>>>(map, vals, Y, n_out, strip, W, k,
                                                        rtiles, ctiles, batch,
                                                        n_out * k, va, flag);
  return cudaGetLastError();
}

// The tile width from k alone (one problem's columns), so K5 and K6, and
// a batch and its lone problems, pick the same tiles.  batch: the problems
// (1: one product).
template <bool VB, class Map>
cudaError_t launch_strip(const Map& map, const float* vals, float* Y, int64_t n_out,
                         int64_t strip, int64_t W, int64_t k, int64_t batch,
                         const int* flag, cudaStream_t s) {
  if (k <= 16)
    return launch_strip_tile<16, VB>(map, vals, Y, n_out, strip, W, k, batch, flag, s);
  if (k <= 32)
    return launch_strip_tile<32, VB>(map, vals, Y, n_out, strip, W, k, batch, flag, s);
  if (k <= 64)
    return launch_strip_tile<64, VB>(map, vals, Y, n_out, strip, W, k, batch, flag, s);
  return launch_strip_tile<128, VB>(map, vals, Y, n_out, strip, W, k, batch, flag, s);
}

// --- K3: the block-row tile product -------------------------------------------

// Thread (il, rg, tx) of a BN-column launch: TM = 4 rows of block row il,
// CT column threads with TN columns each (float4 groups strided by CT*4).
// STAGES r-steps of blocks and X slabs are in flight.  Shared memory per
// block row and stage: SA floats of blocks (bs*bs rounded up to 4, plus 4
// so that the blocks of neighbouring block rows fall in other banks) and
// SX floats of X (bs*BN; plus 16 at BN 16, where two block rows share a
// quarter warp).
template <int BN>
struct EllTile {
  static constexpr int TM = 4, TN = BN >= 64 ? 8 : 4, CT = BN / TN, STAGES = 3;
  static constexpr int XPAD = BN == 16 ? 16 : 0;
};

struct EllShape {
  int BR, RG, SA, SX;
  int64_t smem;
};

constexpr int64_t kEllSmemTarget = 110 * 1024;  // two CTAs an SM

template <int BN>
EllShape ell_shape(int64_t bs);

// Whether a BN-column tile of one block row fits a CTA.
template <int BN>
bool ell_fits(int64_t bs) {
  const EllShape sh = ell_shape<BN>(bs);
  return sh.smem <= kSmemMax && sh.RG * EllTile<BN>::CT <= 256;
}

template <int BN>
EllShape ell_shape(int64_t bs) {
  using T = EllTile<BN>;
  EllShape sh;
  sh.RG = (int)((bs + T::TM - 1) / T::TM);
  sh.SA = (int)((bs * bs + 3) / 4 * 4 + 4);
  sh.SX = (int)(bs * BN + T::XPAD);
  const int64_t row_bytes = (int64_t)T::STAGES * (sh.SA + sh.SX) * (int64_t)sizeof(float);
  int64_t br = 128 / ((int64_t)sh.RG * T::CT);
  if (br * row_bytes > kEllSmemTarget) br = kEllSmemTarget / row_bytes;
  sh.BR = br < 1 ? 1 : (int)br;
  sh.smem = sh.BR * row_bytes;
  return sh;
}

// One CTA: block rows tile * BR .. + BR (blockIdx / (batch * ctiles)),
// column tile ct = blockIdx % (batch * ctiles): problem ct / ctiles, its
// column tile ct % ctiles.  xs: one problem's X elements (its Y holds
// nb*bs*k).  av: bs*bs % 4 == 0 and blocks 16-byte aligned (16-byte
// copies of the blocks).
template <int BN, bool VB>
__global__ void __launch_bounds__(256, 2)
    ell_tile_kernel(const int32_t* __restrict__ cols, const float* __restrict__ blocks,
                    const float* __restrict__ X, float* __restrict__ Y, int64_t nb,
                    int64_t R, int64_t bs, int64_t k, int BR, int RG, int SA, int SX,
                    int64_t ctiles, int64_t batch, int64_t xs, int av) {
  using T = EllTile<BN>;
  constexpr int TM = T::TM, TN = T::TN, CT = T::CT, S = T::STAGES;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);  // [S][BR][SA] then [S][BR][SX]

  const int tid = threadIdx.x;
  const int tx = tid % CT, rest = tid / CT;
  const int rg = rest % RG, il = rest / RG;
  const int tpb = RG * CT, q0 = rg * CT + tx;  // the block row's threads, this one's rank
  const int64_t tile = blockIdx.x / (batch * ctiles);
  const int64_t ct = blockIdx.x - tile * (batch * ctiles);
  const int64_t prob = ct / ctiles;
  const int64_t c0 = (ct - prob * ctiles) * BN;
  X += prob * xs;
  Y += prob * (nb * bs * k);
  const int64_t i = tile * BR + il;
  const bool live = i < nb;
  float* const as0 = sm + il * SA;
  float* const xs0 = sm + (int64_t)S * BR * SA + il * SX;
  const int64_t nA = bs * bs;

  // Request block (i, r) and its X slab into stage st.
  auto issue = [&](int64_t r, int st) {
    if (!live) return;
    float* const as = as0 + (int64_t)st * BR * SA;
    float* const xs = xs0 + (int64_t)st * BR * SX;
    const float* const a = blocks + (i * R + r) * nA;
    if (av) {
      for (int64_t q = q0; q < nA / 4; q += tpb) cp_async16(as + 4 * q, a + 4 * q, true);
    } else {
      for (int64_t q = q0; q < nA; q += tpb) cp_async4(as + q, a + q, true);
    }
    const float* const xb = X + (int64_t)__ldg(cols + i * R + r) * bs * k + c0;
    if (VB) {
      const int64_t nv = bs * (BN / 4);
      for (int64_t q = q0; q < nv; q += tpb) {
        const int64_t j = q / (BN / 4), v = q - j * (BN / 4);
        const bool ok = c0 + 4 * v < k;
        cp_async16(xs + j * BN + 4 * v, ok ? xb + j * k + 4 * v : xb, ok);
      }
    } else {
      const int64_t ne = bs * BN;
      for (int64_t q = q0; q < ne; q += tpb) {
        const int64_t j = q / BN, c = q - j * BN;
        const bool ok = c0 + c < k;
        cp_async4(xs + j * BN + c, ok ? xb + j * k + c : xb, ok);
      }
    }
  };

  // Row t of this thread within its block (rows past bs read row bs - 1
  // and are not stored).
  int offa[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    const int ri = rg * TM + t;
    offa[t] = (ri < bs ? ri : (int)bs - 1) * (int)bs;
  }

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < R) issue(st, st);
    cp_async_commit();
  }
  for (int64_t r = 0; r < R; ++r) {
    cp_async_wait<S - 2>();  // this thread's copies of step r landed
    __syncthreads();         // everyone's; and step r - 1's stage is free
    if (r + S - 1 < R) issue(r + S - 1, (int)((r + S - 1) % S));
    cp_async_commit();
    const int st = (int)(r % S);
    const float* const as = as0 + (int64_t)st * BR * SA;
    const float* const xs = xs0 + (int64_t)st * BR * SX;
#pragma unroll 4
    for (int64_t j = 0; j < bs; ++j) {
      float a[TM], b[TN];
#pragma unroll
      for (int t = 0; t < TM; ++t) a[t] = as[offa[t] + j];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        *reinterpret_cast<float4*>(&b[4 * g]) =
            *reinterpret_cast<const float4*>(&xs[j * BN + g * CT * 4 + tx * 4]);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int t = 0; t < TM; ++t) {
    const int64_t ri = rg * TM + t;
    if (ri >= bs) continue;
    float* const yrow = Y + (i * bs + ri) * k;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int64_t col = c0 + g * CT * 4 + tx * 4;
      if (VB) {
        if (col < k)
          *reinterpret_cast<float4*>(yrow + col) =
              make_float4(acc[t][4 * g], acc[t][4 * g + 1], acc[t][4 * g + 2],
                          acc[t][4 * g + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < k) yrow[col + c] = acc[t][4 * g + c];
      }
    }
  }
}

template <int BN, bool VB>
cudaError_t launch_ell_tile(const int32_t* cols, const float* blocks, const float* X,
                            float* Y, int64_t nb, int64_t R, int64_t bs, int64_t k,
                            int64_t batch, int64_t xs, cudaStream_t s) {
  const EllShape sh = ell_shape<BN>(bs);
  const int nt = sh.BR * sh.RG * EllTile<BN>::CT;
  if (sh.smem > kSmemMax || nt > 256) return cudaErrorInvalidValue;
  const int64_t ctiles = (k + BN - 1) / BN;
  const int64_t blocks_n = (nb + sh.BR - 1) / sh.BR * ctiles * batch;
  if (blocks_n > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = ell_tile_kernel<BN, VB>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sh.smem);
  if (e != cudaSuccess) return e;
  const int av = nb > 0 && (bs * bs) % 4 == 0 && aligned16(blocks);
  kernel<<<(unsigned)blocks_n, nt, (size_t)sh.smem, s>>>(cols, blocks, X, Y, nb, R, bs, k,
                                                        sh.BR, sh.RG, sh.SA, sh.SX, ctiles,
                                                        batch, xs, av);
  return cudaGetLastError();
}

// BN from k (one problem's columns), as for K5; narrower where a wide tile
// of one block row does not fit a CTA (bs above 64).
template <bool VB>
cudaError_t launch_ell(const int32_t* cols, const float* blocks, const float* X, float* Y,
                       int64_t nb, int64_t R, int64_t bs, int64_t k, int64_t batch,
                       int64_t xs, cudaStream_t s) {
  if (k > 64 && ell_fits<128>(bs))
    return launch_ell_tile<128, VB>(cols, blocks, X, Y, nb, R, bs, k, batch, xs, s);
  if (k > 32 && ell_fits<64>(bs))
    return launch_ell_tile<64, VB>(cols, blocks, X, Y, nb, R, bs, k, batch, xs, s);
  if (k > 16 && ell_fits<32>(bs))
    return launch_ell_tile<32, VB>(cols, blocks, X, Y, nb, R, bs, k, batch, xs, s);
  return launch_ell_tile<16, VB>(cols, blocks, X, Y, nb, R, bs, k, batch, xs, s);
}

}  // namespace

extern "C" {

// K3.  cols: [nb, R] int32 block columns (padding blocks zero at column
// 0); blocks: [nb, R, bs, bs]; X: [batch, x_rows, k] (x_rows whole block
// rows that cols index; nb*bs unless X is a shard's frame); Y: [batch,
// nb*bs, k].  Returns cudaGetLastError() after the launch (0 = ok).
int lobpcg_bsr_ell_f32(const void* cols, const void* blocks, const void* X,
                       void* Y, int64_t nb, int64_t R, int64_t bs, int64_t k,
                       int64_t batch, int64_t x_rows, void* stream) {
  if (nb <= 0 || R <= 0 || bs <= 0 || k <= 0 || batch <= 0 || x_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* cp = static_cast<const int32_t*>(cols);
  const float* bp = static_cast<const float*>(blocks);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return (int)launch_ell<true>(cp, bp, xp, yp, nb, R, bs, k, batch, x_rows * k, s);
  return (int)launch_ell<false>(cp, bp, xp, yp, nb, R, bs, k, batch, x_rows * k, s);
}

// The non-finite flag of K4/K5/K6: *flag = 1 if any of the na, nb, nc
// floats at a, b, c is NaN or Inf, else 0 (n 0: the span is skipped).
int lobpcg_nonfinite_f32(const void* a, int64_t na, const void* b, int64_t nb,
                         const void* c, int64_t nc, void* flag, void* stream) {
  if (na < 0 || nb < 0 || nc < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* fp = static_cast<int*>(flag);
  cudaError_t e = cudaMemsetAsync(fp, 0, sizeof(int), s);
  if (e == cudaSuccess) e = mark_nonfinite(static_cast<const float*>(a), na, fp, s);
  if (e == cudaSuccess) e = mark_nonfinite(static_cast<const float*>(b), nb, fp, s);
  if (e == cudaSuccess) e = mark_nonfinite(static_cast<const float*>(c), nc, fp, s);
  return (int)e;
}

// K4.  strip_cols: [ns, Rs] int32; strip_vals: [ns, strip, Rs*bs];
// X: [rows, k]; Y: [n_out, k] with n_out <= ns*strip.  flag: the
// non-finite flag of X (lobpcg_nonfinite_f32), one int32 on the device.
int lobpcg_bsr_strip_f32(const void* strip_cols, int64_t Rs, const void* strip_vals,
                         const void* X, void* Y, int64_t n_out, int64_t strip,
                         int64_t bs, int64_t k, const void* flag, void* stream) {
  if (n_out <= 0 || strip <= 0 || bs <= 0 || k <= 0 || Rs <= 0 ||
      Rs * bs > kStripUnionMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  const int* fp = static_cast<const int*>(flag);
  const StripRows map{static_cast<const int32_t*>(strip_cols), xp, Rs, bs, k, 0};
  const float* vp = static_cast<const float*>(strip_vals);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return (int)launch_strip<true>(map, vp, yp, n_out, strip, Rs * bs, k, 1, fp, s);
  return (int)launch_strip<false>(map, vp, yp, n_out, strip, Rs * bs, k, 1, fp, s);
}

// K5.  lo: [ns] int32 window starts in blocks; win_vals: [ns, strip, W];
// X: [batch, rows, k] with lo[s]*bs + W <= rows; Y: [batch, n_out, k],
// n_out <= ns*strip.  flag: the non-finite flag of the whole batch's X.
int lobpcg_bsr_window_f32(const void* lo, const void* win_vals, const void* X,
                          void* Y, int64_t n_out, int64_t strip, int64_t W,
                          int64_t bs, int64_t k, int64_t batch, int64_t rows,
                          const void* flag, void* stream) {
  if (n_out <= 0 || strip <= 0 || W <= 0 || bs <= 0 || k <= 0 || batch <= 0 ||
      rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(X);
  float* yp = static_cast<float*>(Y);
  const int* fp = static_cast<const int*>(flag);
  const WindowRows map{static_cast<const int32_t*>(lo), xp, xp, xp, bs, k, 0, INT64_MAX,
                       rows * k, 0};
  const float* vp = static_cast<const float*>(win_vals);
  if (k % 4 == 0 && aligned16(X) && aligned16(Y))
    return (int)launch_strip<true>(map, vp, yp, n_out, strip, W, k, batch, fp, s);
  return (int)launch_strip<false>(map, vp, yp, n_out, strip, W, k, batch, fp, s);
}

// K6.  lo: [ns] int32 window starts in blocks of the extended frame
// (hrows + n_loc + hrows rows); win_vals: [ns, strip, W] with
// W <= n_loc; X: [batch, n_loc, k]; edge_top = [halo_up | X[:W]] and
// edge_bot = [X[-W:] | halo_dn] of each problem: [batch, hrows + W, k]
// each; Y: [batch, n_out, k], n_out <= ns*strip.  The 16-byte path needs
// all four row pointers aligned.  flag: the non-finite flag of the
// frames (X and the edge buffers of the whole batch).
int lobpcg_bsr_window_edges_f32(const void* lo, const void* win_vals, const void* X,
                                const void* edge_top, const void* edge_bot, void* Y,
                                int64_t n_out, int64_t strip, int64_t W, int64_t bs,
                                int64_t k, int64_t hrows, int64_t n_loc, int64_t batch,
                                const void* flag, void* stream) {
  if (n_out <= 0 || strip <= 0 || W <= 0 || bs <= 0 || k <= 0 || hrows < 0 ||
      W > n_loc || batch <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(X);
  const float* tp = static_cast<const float*>(edge_top);
  const float* bp = static_cast<const float*>(edge_bot);
  float* yp = static_cast<float*>(Y);
  const int* fp = static_cast<const int*>(flag);
  const WindowRows map{static_cast<const int32_t*>(lo), xp, tp, bp, bs, k, hrows,
                       hrows + n_loc - W, n_loc * k, (hrows + W) * k};
  const float* vp = static_cast<const float*>(win_vals);
  if (k % 4 == 0 && aligned16(X) && aligned16(edge_top) && aligned16(edge_bot) &&
      aligned16(Y))
    return (int)launch_strip<true>(map, vp, yp, n_out, strip, W, k, batch, fp, s);
  return (int)launch_strip<false>(map, vp, yp, n_out, strip, W, k, batch, fp, s);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
