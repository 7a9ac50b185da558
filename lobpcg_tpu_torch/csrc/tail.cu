// The solver's tall elementwise tail for Hopper (sm_90a): four passes that
// XLA fuses inside the JAX package's jitted solve, each one kernel here.
//
// Replaces no Pallas kernel: in the JAX package these chains are jnp
// expressions that XLA fuses into one loop over the tall block
// (lobpcg_tpu/operators/linop.py BlockAntiDiagOperator.matmat,
// lobpcg_tpu/ops/residual.py get_residual, lobpcg_tpu/ops/ortho.py's
// projection update with lobpcg_tpu/ops/gram.py b_mm, and
// lobpcg_tpu/ops/masking.py shift_cols / mask_cols).  The port ran each
// operation of a chain as its own PyTorch pass over the block.
//
//   antidiag:  Y[i] = s[row(i)] * X[partner(i)]: B X of the anti-diagonal
//              B = {{0, D}, {D, 0}}, `copies` of it down the rows (the
//              split-real form is two), one half swap inside each copy;
//              s is D's diagonal (one value a row of a half) or one value
//              a row (the sharded form's row scales).
//   residual:  W = AX - (B X) * lam[j], B X the anti-diagonal's (the
//              partner row of X), a given block BX, or X itself (B None).
//   combine:   S = ((t0 + t1) + t2) + t3 over up to four terms (the
//              project-back sum of GEMM outputs), then optionally
//              U - S, then optionally times the live mask of each column.
//   compact:   Y[:, j] = U[:, clamp(j + shift, 0, k - 1)] * live_j: the
//              soft-locking compaction (shift 0: the column mask alone).
//
// Each gives the bits of the eager chain of PyTorch operations it
// replaces (lobpcg_tpu_torch/ops/cuda/tail.py: the *_reference plain
// versions spell that chain): every multiply, add and subtract is one
// __f*_rn / __d*_rn intrinsic in the chain's order, so nvcc contracts
// nothing into an FMA; the live mask is a multiply by 1 or 0, as
// mask_cols multiplies (a dead column holding Inf or NaN gives NaN, a
// negative value -0).  Real f32 and f64; any other dtype runs the plain
// version (tail.py).
//
// Bound: device-memory bytes.  One or two operations an element against
// every input element read once and the output written once: antidiag
// 2 n k (+ the row scales), residual 3 n k (2 n k for B None), combine
// (terms + U + 1) n k, compact 2 n k.
//
// Design: K1's walk (csrc/stencil1d.cu) without its neighbour rows.  The
// output [batch, n, k] is one flat run of items of W elements a problem
// (W: the widest power of two up to one 16-byte vector that divides k
// and puts every operand's base and strides on item boundaries, chosen by
// the host from K1's items_per_load, tail.py:item_width; 1 where an
// operand's column stride is not 1).  Each block takes a chunk of 256 * J items of one problem (the
// grid's y index), thread t items t, t + 256, ...: a warp reads 32
// consecutive items of each operand, coalesced; each thread loads all J
// items of every operand (32 bytes of each in flight) before it computes
// any.  The row and item column of an item are running counters stepped
// with a compare and a subtraction, one division a thread; the place of
// the row in its copy (antidiag, residual) is a third counter.  Operands
// are read through their strides (batch, row, column), so a column
// slice W[..., :nev] or a row slice runs without a copy.
//
// What it leaves out: shared memory and TMA (no element is read twice,
// the partner row of a half swap is another row of the same block); the
// reductions of the tail (column norms, Frobenius norms), whose summation
// order a fused pass would change.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;       // ops/cuda/tail.py:THREADS
constexpr int kBytesInFlight = 32;  // bytes of each operand a thread loads before it computes,
constexpr int kMaxItems = 8;        // in at most this many items
constexpr int kMaxTerms = 4;        // ops/cuda/tail.py:MAX_TERMS
constexpr int64_t kMaxBatch = 65535;  // problems: the grid's y extent
constexpr int64_t kMaxK = 1 << 30;    // columns + threads fit an int

template <int ItemBytes>
struct ItemsPerThread {
  static constexpr int value =
      kBytesInFlight / ItemBytes < kMaxItems ? kBytesInFlight / ItemBytes : kMaxItems;
};

template <int B> struct Raw;
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// An item: W elements, loaded and stored as one access of its size.
template <typename T, int W>
struct alignas(sizeof(T) * W) Item {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Item<T, W> load(const T* p) {
  using R = typename Raw<sizeof(T) * W>::type;
  const R r = *reinterpret_cast<const R*>(p);
  Item<T, W> out;
  memcpy(&out, &r, sizeof(R));
  return out;
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const Item<T, W>& v) {
  using R = typename Raw<sizeof(T) * W>::type;
  R r;
  memcpy(&r, &v, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

// Each operation rounded on its own, as each PyTorch pass stores it.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// A tall operand: element (p, r, j) at base[p * sb + r * sr + j * sc]
// (sc is 1 wherever W > 1).
template <typename T>
struct Tall {
  const T* base;
  int64_t sb, sr, sc;
  __device__ __forceinline__ const T* at(int64_t p, int64_t r, int64_t j) const {
    return base + p * sb + r * sr + j * sc;
  }
};

// Which columns are live: a mask of bytes (0 or 1, one a column; its
// problems mask_sb apart), or a count (j < count; one a problem from
// count_b, count_sb apart, when count_b is not null); kind 0: no mask.
struct Live {
  const unsigned char* mask;
  int64_t mask_sb;
  const int64_t* count_b;
  int64_t count_sb, count;
  int64_t kind;  // 0 none, 1 count, 2 mask
};

// The live-mask factor of column j of problem p: 1 or 0 in T, multiplied
// as mask_cols multiplies by the mask cast to the block's dtype.
template <typename T>
__device__ __forceinline__ T live_factor(const Live& lv, int64_t p, int64_t count, int64_t j) {
  const bool on = lv.kind == 2 ? lv.mask[p * lv.mask_sb + j] != 0 : j < count;
  return on ? T(1) : T(0);
}

// The walk of one thread over its items (K1's counters): row r of the
// problem, item column c, and the row's place sp in its copy of L rows.
struct Walk {
  int64_t r0;
  int r, c, dr, dc, kw;
  int64_t sp, L;

  __device__ __forceinline__ Walk(int64_t base, int kw_, int64_t L_) : kw(kw_), L(L_) {
    r0 = base / kw;
    const int q = static_cast<int>(base - r0 * kw) + static_cast<int>(threadIdx.x);
    r = q / kw;
    c = q - r * kw;
    dr = kThreads / kw;
    dc = kThreads - dr * kw;
    sp = wrap(r0 % L + r);
  }
  __device__ __forceinline__ int64_t row() const { return r0 + r; }
  // Bring the place back under L after a step of at most kThreads rows.
  __device__ __forceinline__ int64_t wrap(int64_t s) const {
    if (s >= L) {
      s -= L;
      if (s >= L) s = static_cast<int64_t>(static_cast<uint64_t>(s) % static_cast<uint64_t>(L));
    }
    return s;
  }
  __device__ __forceinline__ void step() {
    c += dc;
    int inc = dr;
    if (c >= kw) {
      c -= kw;
      ++inc;
    }
    r += inc;
    sp = wrap(sp + inc);
  }
};

// The half swap: the partner row of row `row` at place sp of its copy
// (h = L / 2 rows a half), and the index of its row scale: the place in
// its half (one value a row of a half) or the row itself (per_row).
struct Swap {
  const void* s;     // the row scales (null: no anti-diagonal B)
  int64_t s_sb;      // elements between two problems' scales (0: shared)
  int64_t per_row;   // s holds one value a row (else one a row of a half)
  int64_t L;         // rows a copy (n / copies)
};

__device__ __forceinline__ int64_t partner(int64_t row, int64_t sp, int64_t h) {
  return sp < h ? row + h : row - h;
}

__device__ __forceinline__ int64_t scale_index(int64_t row, int64_t sp, int64_t h,
                                               int64_t per_row) {
  return per_row ? row : (sp < h ? sp : sp - h);
}

// --- antidiag: Y = B X ---------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
tail_antidiag_kernel(Tall<T> X, T* __restrict__ Y, Swap sw, int kw, int64_t nitems) {
  constexpr int J = ItemsPerThread<sizeof(Item<T, W>)>::value;
  constexpr int kChunk = kThreads * J;
  const int64_t p = blockIdx.y;
  const T* s = static_cast<const T*>(sw.s) + p * sw.s_sb;
  const int64_t h = sw.L / 2;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  Walk wk(first, kw, sw.L);
  Item<T, W> x[J];
  T sv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (first + threadIdx.x + static_cast<int64_t>(j) * kThreads < nitems) {
      const int64_t row = wk.row();
      x[j] = load<T, W>(X.at(p, partner(row, wk.sp, h), static_cast<int64_t>(wk.c) * W));
      sv[j] = s[scale_index(row, wk.sp, h, sw.per_row)];
    }
    wk.step();
  }
  T* y = Y + p * nitems * W;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first + threadIdx.x + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      Item<T, W> out;
#pragma unroll
      for (int e = 0; e < W; ++e) out.v[e] = mul(sv[j], x[j].v[e]);
      store<T, W>(y + idx * W, out);
    }
  }
}

// --- residual: W = AX - (B X) * lam ------------------------------------------

enum class BMode { kIdentity, kGiven, kSwap };

template <typename T, int W, BMode M>
__global__ void __launch_bounds__(kThreads)
tail_residual_kernel(Tall<T> AX, Tall<T> X, Swap sw, const T* __restrict__ lam, int64_t lam_sb,
                     T* __restrict__ Y, int kw, int64_t nitems) {
  constexpr int J = ItemsPerThread<sizeof(Item<T, W>)>::value;
  constexpr int kChunk = kThreads * J;
  const int64_t p = blockIdx.y;
  const T* s = M == BMode::kSwap ? static_cast<const T*>(sw.s) + p * sw.s_sb : nullptr;
  const int64_t h = sw.L / 2;
  const T* lp = lam + p * lam_sb;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  Walk wk(first, kw, sw.L);
  Item<T, W> ax[J], x[J];
  T sv[J];
  int col[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (first + threadIdx.x + static_cast<int64_t>(j) * kThreads < nitems) {
      const int64_t row = wk.row();
      const int64_t c = static_cast<int64_t>(wk.c) * W;
      col[j] = static_cast<int>(c);
      ax[j] = load<T, W>(AX.at(p, row, c));
      if constexpr (M == BMode::kSwap) {
        x[j] = load<T, W>(X.at(p, partner(row, wk.sp, h), c));
        sv[j] = s[scale_index(row, wk.sp, h, sw.per_row)];
      } else {
        x[j] = load<T, W>(X.at(p, row, c));  // X, or the given BX
      }
    }
    wk.step();
  }
  T* y = Y + p * nitems * W;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first + threadIdx.x + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      Item<T, W> out;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        T bx = x[j].v[e];
        if constexpr (M == BMode::kSwap) bx = mul(sv[j], bx);
        out.v[e] = sub(ax[j].v[e], mul(bx, lp[col[j] + e]));
      }
      store<T, W>(y + idx * W, out);
    }
  }
}

// --- combine: mask * (U - (((t0 + t1) + t2) + t3)) ---------------------------

template <typename T>
struct Terms {
  Tall<T> t[kMaxTerms];
  int64_t nt;
};

// Y may be t[0] itself (the caller's scratch): every element is read
// before it is written, by the same thread, so Y carries no __restrict__.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
tail_combine_kernel(Terms<T> tm, Tall<T> U, Live lv, T* Y, int kw, int64_t nitems) {
  constexpr int J = ItemsPerThread<sizeof(Item<T, W>)>::value;
  constexpr int kChunk = kThreads * J;
  const int64_t p = blockIdx.y;
  const int64_t count = lv.kind == 1 ? (lv.count_b ? lv.count_b[p * lv.count_sb] : lv.count) : 0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  Walk wk(first, kw, 1);
  Item<T, W> t[kMaxTerms][J], u[J];
  int col[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (first + threadIdx.x + static_cast<int64_t>(j) * kThreads < nitems) {
      const int64_t row = wk.row();
      const int64_t c = static_cast<int64_t>(wk.c) * W;
      col[j] = static_cast<int>(c);
#pragma unroll
      for (int q = 0; q < kMaxTerms; ++q)
        if (q < tm.nt) t[q][j] = load<T, W>(tm.t[q].at(p, row, c));
      if (U.base != nullptr) u[j] = load<T, W>(U.at(p, row, c));
    }
    wk.step();
  }
  T* y = Y + p * nitems * W;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first + threadIdx.x + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      Item<T, W> out;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        T v = t[0][j].v[e];
#pragma unroll
        for (int q = 1; q < kMaxTerms; ++q)
          if (q < tm.nt) v = add(v, t[q][j].v[e]);
        if (U.base != nullptr) v = sub(u[j].v[e], v);
        if (lv.kind != 0) v = mul(v, live_factor<T>(lv, p, count, col[j] + e));
        out.v[e] = v;
      }
      store<T, W>(y + idx * W, out);
    }
  }
}

// --- compact: Y[:, j] = U[:, clamp(j + shift, 0, k - 1)] * live_j ------------

// Y may be U itself when nothing is shifted (the caller's scratch): every
// element is read before it is written, by the same thread, so Y carries
// no __restrict__.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
tail_compact_kernel(Tall<T> U, const int64_t* __restrict__ shift_b, int64_t shift_sb,
                    int64_t shift, int64_t shifted, Live lv, T* Y, int kw,
                    int64_t k, int64_t nitems) {
  constexpr int J = ItemsPerThread<sizeof(Item<T, W>)>::value;
  constexpr int kChunk = kThreads * J;
  const int64_t p = blockIdx.y;
  const int64_t sh = shift_b != nullptr ? shift_b[p * shift_sb] : shift;
  const int64_t count = lv.kind == 1 ? (lv.count_b ? lv.count_b[p * lv.count_sb] : lv.count) : 0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  Walk wk(first, kw, 1);
  Item<T, W> u[J];
  int col[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (first + threadIdx.x + static_cast<int64_t>(j) * kThreads < nitems) {
      const int64_t row = wk.row();
      const int64_t c = static_cast<int64_t>(wk.c) * W;
      col[j] = static_cast<int>(c);
      if (shifted) {
        // A gather: each element from its own source column.
#pragma unroll
        for (int e = 0; e < W; ++e) {
          int64_t src = c + e + sh;
          src = src < 0 ? 0 : (src > k - 1 ? k - 1 : src);
          u[j].v[e] = *U.at(p, row, src);
        }
      } else {
        u[j] = load<T, W>(U.at(p, row, c));
      }
    }
    wk.step();
  }
  T* y = Y + p * nitems * W;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first + threadIdx.x + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      Item<T, W> out;
#pragma unroll
      for (int e = 0; e < W; ++e)
        out.v[e] = mul(u[j].v[e], live_factor<T>(lv, p, count, col[j] + e));
      store<T, W>(y + idx * W, out);
    }
  }
}

// --- launches -------------------------------------------------------------------

// The grid of `batch` problems of n * k / W items each; false if it does
// not fit.
template <typename T, int W>
bool grid_of(int64_t batch, int64_t n, int64_t k, dim3* grid, int64_t* nitems) {
  constexpr int J = ItemsPerThread<sizeof(Item<T, W>)>::value;
  *nitems = n * (k / W);
  const int64_t blocks = (*nitems + kThreads * J - 1) / (kThreads * J);
  if (blocks > 0x7fffffff || blocks < 1) return false;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  return true;
}

bool takes(int64_t batch, int64_t n, int64_t k, int64_t w, size_t itemsize) {
  return batch > 0 && batch <= kMaxBatch && n > 0 && k > 0 && k < kMaxK && w > 0 &&
         w * itemsize <= 16 && (w & (w - 1)) == 0 && k % w == 0;
}

// The operand is on item boundaries: base, batch and row strides, unit
// column stride (W > 1).
template <typename T>
bool aligned(const Tall<T>& t, int64_t w) {
  if (t.base == nullptr || w == 1) return true;
  return t.sc == 1 && reinterpret_cast<uintptr_t>(t.base) % (w * sizeof(T)) == 0 &&
         t.sb % w == 0 && t.sr % w == 0;
}

bool swap_takes(const Swap& sw, int64_t n) {
  return sw.s != nullptr && sw.L >= 2 && sw.L % 2 == 0 && n % sw.L == 0 && sw.s_sb >= 0;
}

bool live_takes(const Live& lv) {
  return (lv.kind == 0) || (lv.kind == 1 && lv.count_sb >= 0) ||
         (lv.kind == 2 && lv.mask != nullptr && lv.mask_sb >= 0);
}

template <typename T>
Tall<T> tall(const void* p, int64_t sb, int64_t sr, int64_t sc) {
  return Tall<T>{static_cast<const T*>(p), sb, sr, sc};
}

template <typename T, int W>
int antidiag_w(Tall<T> X, void* Y, Swap sw, int64_t batch, int64_t n, int64_t k,
               cudaStream_t st) {
  dim3 grid;
  int64_t nitems;
  if (!grid_of<T, W>(batch, n, k, &grid, &nitems)) return static_cast<int>(cudaErrorInvalidValue);
  tail_antidiag_kernel<T, W><<<grid, kThreads, 0, st>>>(X, static_cast<T*>(Y), sw,
                                                        static_cast<int>(k / W), nitems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int residual_w(Tall<T> AX, Tall<T> X, Swap sw, const void* lam, int64_t lam_sb, void* Y,
               int64_t batch, int64_t n, int64_t k, bool given, cudaStream_t st) {
  dim3 grid;
  int64_t nitems;
  if (!grid_of<T, W>(batch, n, k, &grid, &nitems)) return static_cast<int>(cudaErrorInvalidValue);
  const auto l = static_cast<const T*>(lam);
  const auto y = static_cast<T*>(Y);
  const int kw = static_cast<int>(k / W);
  if (sw.s != nullptr)
    tail_residual_kernel<T, W, BMode::kSwap><<<grid, kThreads, 0, st>>>(AX, X, sw, l, lam_sb, y,
                                                                        kw, nitems);
  else if (given)
    tail_residual_kernel<T, W, BMode::kGiven><<<grid, kThreads, 0, st>>>(AX, X, sw, l, lam_sb, y,
                                                                         kw, nitems);
  else
    tail_residual_kernel<T, W, BMode::kIdentity><<<grid, kThreads, 0, st>>>(AX, X, sw, l, lam_sb,
                                                                            y, kw, nitems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int combine_w(const Terms<T>& tm, Tall<T> U, const Live& lv, void* Y, int64_t batch, int64_t n,
              int64_t k, cudaStream_t st) {
  dim3 grid;
  int64_t nitems;
  if (!grid_of<T, W>(batch, n, k, &grid, &nitems)) return static_cast<int>(cudaErrorInvalidValue);
  tail_combine_kernel<T, W><<<grid, kThreads, 0, st>>>(tm, U, lv, static_cast<T*>(Y),
                                                       static_cast<int>(k / W), nitems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int compact_w(Tall<T> U, const int64_t* shift_b, int64_t shift_sb, int64_t shift,
              int64_t shifted, const Live& lv, void* Y, int64_t batch, int64_t n, int64_t k,
              cudaStream_t st) {
  dim3 grid;
  int64_t nitems;
  if (!grid_of<T, W>(batch, n, k, &grid, &nitems)) return static_cast<int>(cudaErrorInvalidValue);
  tail_compact_kernel<T, W><<<grid, kThreads, 0, st>>>(U, shift_b, shift_sb, shift, shifted, lv,
                                                       static_cast<T*>(Y),
                                                       static_cast<int>(k / W), k, nitems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int antidiag(const void* X, int64_t xsb, int64_t xsr, int64_t xsc, void* Y, const void* s,
             int64_t s_sb, int64_t per_row, int64_t batch, int64_t n, int64_t k, int64_t L,
             int64_t w, void* stream) {
  const Tall<T> x = tall<T>(X, xsb, xsr, xsc);
  const Swap sw{s, s_sb, per_row, L};
  const Tall<T> y = tall<T>(Y, n * k, k, 1);
  if (!takes(batch, n, k, w, sizeof(T)) || X == nullptr || Y == nullptr || !swap_takes(sw, n) ||
      !aligned(x, w) || !aligned(y, w))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (sizeof(T) == 4 && w > 2) return antidiag_w<T, sizeof(T) == 4 ? 4 : 2>(x, Y, sw, batch, n, k, st);
  if (w == 2) return antidiag_w<T, 2>(x, Y, sw, batch, n, k, st);
  return antidiag_w<T, 1>(x, Y, sw, batch, n, k, st);
}

template <typename T>
int residual(const void* AX, int64_t asb, int64_t asr, int64_t asc, const void* X, int64_t xsb,
             int64_t xsr, int64_t xsc, const void* BX, int64_t bsb, int64_t bsr, int64_t bsc,
             const void* s, int64_t s_sb, int64_t per_row, int64_t L, const void* lam,
             int64_t lam_sb, void* Y, int64_t batch, int64_t n, int64_t k, int64_t w,
             void* stream) {
  const Tall<T> ax = tall<T>(AX, asb, asr, asc);
  // The block B scales: BX where given, else X (its partner rows when s).
  const bool given = BX != nullptr;
  const Tall<T> x = given ? tall<T>(BX, bsb, bsr, bsc) : tall<T>(X, xsb, xsr, xsc);
  const Swap sw{s, s_sb, per_row, s != nullptr ? L : 2};
  const Tall<T> y = tall<T>(Y, n * k, k, 1);
  if (!takes(batch, n, k, w, sizeof(T)) || AX == nullptr || x.base == nullptr || lam == nullptr ||
      Y == nullptr || lam_sb < 0 || (given && s != nullptr) ||
      (s != nullptr && !swap_takes(sw, n)) || !aligned(ax, w) || !aligned(x, w) ||
      !aligned(y, w))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (sizeof(T) == 4 && w > 2)
    return residual_w<T, sizeof(T) == 4 ? 4 : 2>(ax, x, sw, lam, lam_sb, Y, batch, n, k, given, st);
  if (w == 2) return residual_w<T, 2>(ax, x, sw, lam, lam_sb, Y, batch, n, k, given, st);
  return residual_w<T, 1>(ax, x, sw, lam, lam_sb, Y, batch, n, k, given, st);
}

template <typename T>
int combine(const void* const* terms, const int64_t* strides, int64_t nt, const void* U,
            int64_t usb, int64_t usr, int64_t usc, const Live& lv, void* Y, int64_t batch,
            int64_t n, int64_t k, int64_t w, void* stream) {
  Terms<T> tm{};
  tm.nt = nt;
  if (nt < 1 || nt > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t q = 0; q < nt; ++q) {
    tm.t[q] = tall<T>(terms[q], strides[3 * q], strides[3 * q + 1], strides[3 * q + 2]);
    if (terms[q] == nullptr || !aligned(tm.t[q], w)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tall<T> u = tall<T>(U, usb, usr, usc);
  const Tall<T> y = tall<T>(Y, n * k, k, 1);
  if (!takes(batch, n, k, w, sizeof(T)) || Y == nullptr || !live_takes(lv) || !aligned(u, w) ||
      !aligned(y, w))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (sizeof(T) == 4 && w > 2) return combine_w<T, sizeof(T) == 4 ? 4 : 2>(tm, u, lv, Y, batch, n, k, st);
  if (w == 2) return combine_w<T, 2>(tm, u, lv, Y, batch, n, k, st);
  return combine_w<T, 1>(tm, u, lv, Y, batch, n, k, st);
}

template <typename T>
int compact(const void* U, int64_t usb, int64_t usr, int64_t usc, const void* shift_b,
            int64_t shift_sb, int64_t shift, const Live& lv, void* Y, int64_t batch, int64_t n,
            int64_t k, int64_t w, void* stream) {
  const Tall<T> u = tall<T>(U, usb, usr, usc);
  const Tall<T> y = tall<T>(Y, n * k, k, 1);
  const auto sb = static_cast<const int64_t*>(shift_b);
  const int64_t shifted = sb != nullptr || shift != 0;
  if (!takes(batch, n, k, w, sizeof(T)) || U == nullptr || Y == nullptr || lv.kind == 0 ||
      !live_takes(lv) || shift_sb < 0 || !aligned(y, w) || (!shifted && !aligned(u, w)) ||
      (shifted && U == Y))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (sizeof(T) == 4 && w > 2)
    return compact_w<T, sizeof(T) == 4 ? 4 : 2>(u, sb, shift_sb, shift, shifted, lv, Y, batch, n,
                                                k, st);
  if (w == 2) return compact_w<T, 2>(u, sb, shift_sb, shift, shifted, lv, Y, batch, n, k, st);
  return compact_w<T, 1>(u, sb, shift_sb, shift, shifted, lv, Y, batch, n, k, st);
}

Live live_of(const void* mask, int64_t mask_sb, const void* count_b, int64_t count_sb,
             int64_t count, int64_t kind) {
  return Live{static_cast<const unsigned char*>(mask), mask_sb,
              static_cast<const int64_t*>(count_b), count_sb, count, kind};
}

}  // namespace

extern "C" {

// antidiag: Y [batch, n, k] (contiguous) = the half swap of X (element
// (p, r, j) at X + p xsb + r xsr + j xsc) inside each copy of L rows,
// row r times its scale: s[p s_sb + r] (per_row) or s[p s_sb + (r mod L)
// mod (L / 2)].  w: the elements of an item (ops/cuda/tail.py:
// item_width).  Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int lobpcg_tail_antidiag_f32(const void* X, int64_t xsb, int64_t xsr, int64_t xsc, void* Y,
                             const void* s, int64_t s_sb, int64_t per_row, int64_t batch,
                             int64_t n, int64_t k, int64_t L, int64_t w, void* stream) {
  return antidiag<float>(X, xsb, xsr, xsc, Y, s, s_sb, per_row, batch, n, k, L, w, stream);
}

int lobpcg_tail_antidiag_f64(const void* X, int64_t xsb, int64_t xsr, int64_t xsc, void* Y,
                             const void* s, int64_t s_sb, int64_t per_row, int64_t batch,
                             int64_t n, int64_t k, int64_t L, int64_t w, void* stream) {
  return antidiag<double>(X, xsb, xsr, xsc, Y, s, s_sb, per_row, batch, n, k, L, w, stream);
}

// residual: Y = AX - (B X) * lam[p lam_sb + j]; B X = BX where BX is not
// null, else antidiag's product of X where s is not null, else X.
int lobpcg_tail_residual_f32(const void* AX, int64_t asb, int64_t asr, int64_t asc,
                             const void* X, int64_t xsb, int64_t xsr, int64_t xsc,
                             const void* BX, int64_t bsb, int64_t bsr, int64_t bsc,
                             const void* s, int64_t s_sb, int64_t per_row, int64_t L,
                             const void* lam, int64_t lam_sb, void* Y, int64_t batch,
                             int64_t n, int64_t k, int64_t w, void* stream) {
  return residual<float>(AX, asb, asr, asc, X, xsb, xsr, xsc, BX, bsb, bsr, bsc, s, s_sb,
                         per_row, L, lam, lam_sb, Y, batch, n, k, w, stream);
}

int lobpcg_tail_residual_f64(const void* AX, int64_t asb, int64_t asr, int64_t asc,
                             const void* X, int64_t xsb, int64_t xsr, int64_t xsc,
                             const void* BX, int64_t bsb, int64_t bsr, int64_t bsc,
                             const void* s, int64_t s_sb, int64_t per_row, int64_t L,
                             const void* lam, int64_t lam_sb, void* Y, int64_t batch,
                             int64_t n, int64_t k, int64_t w, void* stream) {
  return residual<double>(AX, asb, asr, asc, X, xsb, xsr, xsc, BX, bsb, bsr, bsc, s, s_sb,
                          per_row, L, lam, lam_sb, Y, batch, n, k, w, stream);
}

// combine: Y = live * (U - (((t0 + t1) + t2) + t3)) over the nt terms
// (terms: nt pointers; strides: 3 a term, batch, row, column); U null: no
// subtraction; live_kind 0: no mask, 1: columns j < count (count_b: one
// count a problem, count_sb apart, or null), 2: the byte mask (mask_sb
// between problems).  Y may be terms[0].
int lobpcg_tail_combine_f32(const void* terms, const void* strides, int64_t nt, const void* U,
                            int64_t usb, int64_t usr, int64_t usc, const void* mask,
                            int64_t mask_sb, const void* count_b, int64_t count_sb,
                            int64_t count, int64_t live_kind, void* Y, int64_t batch,
                            int64_t n, int64_t k, int64_t w, void* stream) {
  return combine<float>(static_cast<const void* const*>(terms),
                        static_cast<const int64_t*>(strides), nt, U, usb, usr, usc,
                        live_of(mask, mask_sb, count_b, count_sb, count, live_kind), Y, batch,
                        n, k, w, stream);
}

int lobpcg_tail_combine_f64(const void* terms, const void* strides, int64_t nt, const void* U,
                            int64_t usb, int64_t usr, int64_t usc, const void* mask,
                            int64_t mask_sb, const void* count_b, int64_t count_sb,
                            int64_t count, int64_t live_kind, void* Y, int64_t batch,
                            int64_t n, int64_t k, int64_t w, void* stream) {
  return combine<double>(static_cast<const void* const*>(terms),
                         static_cast<const int64_t*>(strides), nt, U, usb, usr, usc,
                         live_of(mask, mask_sb, count_b, count_sb, count, live_kind), Y, batch,
                         n, k, w, stream);
}

// compact: Y[p, r, j] = U[p, r, clamp(j + shift, 0, k - 1)] * live(p, j),
// shift = shift_b[p shift_sb] where shift_b is not null; live as
// combine's (kind 1 or 2).  Y may be U where nothing is shifted.
int lobpcg_tail_compact_f32(const void* U, int64_t usb, int64_t usr, int64_t usc,
                            const void* shift_b, int64_t shift_sb, int64_t shift,
                            const void* mask, int64_t mask_sb, const void* count_b,
                            int64_t count_sb, int64_t count, int64_t live_kind, void* Y,
                            int64_t batch, int64_t n, int64_t k, int64_t w, void* stream) {
  return compact<float>(U, usb, usr, usc, shift_b, shift_sb, shift,
                        live_of(mask, mask_sb, count_b, count_sb, count, live_kind), Y, batch,
                        n, k, w, stream);
}

int lobpcg_tail_compact_f64(const void* U, int64_t usb, int64_t usr, int64_t usc,
                            const void* shift_b, int64_t shift_sb, int64_t shift,
                            const void* mask, int64_t mask_sb, const void* count_b,
                            int64_t count_sb, int64_t count, int64_t live_kind, void* Y,
                            int64_t batch, int64_t n, int64_t k, int64_t w, void* stream) {
  return compact<double>(U, usb, usr, usc, shift_b, shift_sb, shift,
                         live_of(mask, mask_sb, count_b, count_sb, count, live_kind), Y, batch,
                         n, k, w, stream);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
