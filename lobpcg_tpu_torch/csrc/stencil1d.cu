// Segmented 1-D Dirichlet stencil SpMM for Hopper (sm_90a), and the BdG
// operator's diagonal and the Chebyshev step carried into its walk.
//
// Replaces the TPU kernel lobpcg_tpu/ops/pallas/stencil.py:stencil_matmat_pallas.
// Computes, on each of `seg_rows`-row segments of a row-major [n, k] block X,
//
//     Y[i, :] = scale * ((2 X[i, :] - X[i+1, :]) - X[i-1, :])
//
// with X[-1] / X[n] taken from the optional edge rows ([2, k]: row 0 is
// the row above X[0], row 1 the row below X[n-1]) and zero otherwise;
// rows across a segment boundary never couple.
//
// Batched edge rows (a lockstep batch of a row-sharded solve): X holds
// `batch` problems of n / batch rows each, one after another, and the
// edge table is [batch, 2, k]: the row that starts problem t reads
// edge[t, 0] above it, the row that ends it edge[t, 1] below it.  The
// problems' boundaries are segment boundaries (seg_rows divides
// n / batch), so each problem is the unbatched product on its own rows
// with its own edge pair: the grid's y index is the problem, whose
// blocks walk its rows only (blockIdx.y moves X, Y and the edge table
// by one problem), and the edge test is the unbatched one on the
// problem's rows.  The operation order is
// that of the plain version (lobpcg_tpu_torch/ops/cuda/stencil.py:
// stencil_matmat_reference).  f32 computes in f32; bf16 loads, upcasts
// to f32, computes and rounds once to bf16.
//
// Two fused epilogues ride the same walk (one template, the epilogue
// chosen at compile time), in the JAX package what XLA fuses around the
// stencil inside the jitted solve (lobpcg_tpu/operators/linop.py
// SumOperator, lobpcg_tpu/operators/chebyshev.py):
//
//   stencil_diag:  A y = post * S(y) + diag * y, S the stencil above, post
//                  a number or one per problem, diag one value a row;
//   cheb_step:     one step of the Chebyshev filter, d' = c1 d + c2 (X - A y),
//                  y' = y + d'; the first step forms y = d = X / theta from
//                  X on the fly, the last does not write d'.
//
// Each gives the bits of the eager chain of PyTorch operations it
// replaces (ops/cuda/stencil.py: stencil_diag_reference,
// cheb_step_reference): every operation rounds (the __f*_rn intrinsics,
// so nothing contracts into an FMA), in bf16 to bf16 after every
// operation as the chain stores it, in the chain's order; the
// coefficients arrive as the f32 values the chain's operations use
// (ops/cuda/stencil.py: host_scalar, host_reciprocal).  Per-problem
// values (post, c1, c2, theta) are read once a block at its problem,
// blockIdx.y.
//
// Bound: device-memory bytes.  K1: four operations per element against
// one read and one write, at least 2 * n * k * sizeof(T) bytes.
// stencil_diag: one read of X and one write, 2 n k (+ the n diagonal
// values).  cheb_step: X, y and d read and y', d' written, 5 n k; the
// first step reads X only (3 n k), the last writes no d' (4 n k).
//
// Design: X is one flat run of n * k elements, and the rows above and
// below an element lie k elements before and after it.  The kernel walks
// that run in items of W elements: W is a power of two up to one 16-byte
// vector that divides k and puts X, Y and the edge rows on W-element
// boundaries (the host picks the largest, ops/cuda/stencil.py:
// items_per_load), so an item never straddles two rows, and any width and
// any element-aligned base (a row slice X[1:]) runs this one kernel.
// Each block takes one chunk of 256 * J items; thread t loads items t,
// t + 256, ... of the chunk (a warp reads 32 consecutive items,
// coalesced), each with its rows above and below (L1/L2 hits: the
// neighbouring items of the chunk bring those lines from device memory),
// all J before it computes any, so that 32 bytes of X (at most 8 items)
// are in flight per thread; then it computes and stores them.  The row,
// column and place in its segment of an item are running counters
// stepped by 256 items with a compare and a subtraction: one 64-bit
// division per thread for the chunk's first row, none per item.
// Everything inside a chunk is 32-bit; item indices are 64-bit.  The
// batched edge form adds one problem offset per thread (blockIdx.y) and
// nothing per item; without a [batch, 2, k] table the grid's y extent is
// 1 and the offset 0.  Measured at [8M, 30] on the H100, against forms
// where each row found its problem itself: running problem counters
// stepped per item were 23% slower, one more 64-bit division per thread
// (the problem of the chunk's first row) 15% slower, and a 32-bit
// division on the edge path 20% slower.  The fused epilogues take the
// grid's y index as their problem always (a batch's per-problem
// coefficients need it), and add to each item its row's diagonal value
// (the row counter, one load an item) and, in cheb_step, the items of X
// and d at the same place.  bf16
// travels as its bits, two to a 32-bit word when W >= 2 (one conversion
// instruction rounds a pair).
//
// Chosen by measurement on the H100 (PERF.md section 6, tools/
// stencil_widths.py --tune on each version) over shared-memory tiles
// staged with cp.async on a persistent grid and over these direct loads
// on a persistent grid: both were slower at every f32 shape timed.
//
// What it leaves out: TMA (cp.async.bulk) and a shared-memory halo, which
// measured slower here; a register row-march; wgmma, which does not apply
// (no contraction).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;       // ops/cuda/stencil.py:THREADS
constexpr int kBytesInFlight = 32;  // X bytes a thread loads before it computes,
constexpr int kMaxItems = 8;        // in at most this many items

template <int ItemBytes>
struct ItemsPerThread {
  static constexpr int value =
      kBytesInFlight / ItemBytes < kMaxItems ? kBytesInFlight / ItemBytes : kMaxItems;
};
constexpr int64_t kMaxK = 1 << 30;  // columns + threads fit an int
constexpr int64_t kMaxBatch = 65535;  // problems: the grid's y extent

// How elements are carried: as words of their bits, unpacked to f32 for
// the arithmetic and packed back.  bf16 goes two to a 32-bit word where an
// item holds two or more (one conversion instruction packs a pair, with
// the same rounding as two).  Elem: one element's storage (a diagonal
// value); round: a value stored in the element type and read back, as
// each operation of the eager chain stores its result.
struct F32 {
  using Word = float;
  using Elem = float;
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ void unpack(Word w, float* f) { f[0] = w; }
  static __device__ __forceinline__ Word pack(const float* f) { return f[0]; }
  static __device__ __forceinline__ float elem(Elem e) { return e; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

struct Bf16 {
  using Word = unsigned short;
  using Elem = unsigned short;
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ void unpack(Word w, float* f) {
    f[0] = __uint_as_float(static_cast<unsigned>(w) << 16);
  }
  static __device__ __forceinline__ Word pack(const float* f) {
    // Round to nearest even, as torch's .to(bfloat16).
    return __bfloat16_as_ushort(__float2bfloat16(f[0]));
  }
  static __device__ __forceinline__ float elem(Elem e) {
    return __uint_as_float(static_cast<unsigned>(e) << 16);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

struct Bf16Pair {
  using Word = unsigned int;
  using Elem = unsigned short;
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ void unpack(Word w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ Word pack(const float* f) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    Word w;
    memcpy(&w, &h, sizeof(w));
    return w;
  }
  static __device__ __forceinline__ float elem(Elem e) { return Bf16::elem(e); }
  static __device__ __forceinline__ float round(float v) { return Bf16::round(v); }
};

// An item: NW words, loaded and stored as one access of its size.
template <typename Word, int NW>
struct alignas(sizeof(Word) * NW) Items {
  Word v[NW];
};

template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename Word, int NW>
__device__ __forceinline__ Items<Word, NW> load_items(const Word* p) {
  using R = typename Raw<sizeof(Word) * NW>::type;
  const R r = *reinterpret_cast<const R*>(p);
  Items<Word, NW> out;
  memcpy(&out, &r, sizeof(R));
  return out;
}

template <typename Word, int NW>
__device__ __forceinline__ void store_items(Word* p, const Items<Word, NW>& v) {
  using R = typename Raw<sizeof(Word) * NW>::type;
  R r;
  memcpy(&r, &v, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

// The item of an edge row at word `at` if `use` and there are edge rows,
// else zeros (the plain version's padding; +0 in f32 and bf16 alike).
template <typename Word, int NW>
__device__ __forceinline__ Items<Word, NW> edge_items(const Word* __restrict__ edge,
                                                      bool use, int at) {
  if (use && edge != nullptr) return load_items<Word, NW>(edge + at);
  Items<Word, NW> zero;
  memset(&zero, 0, sizeof(zero));
  return zero;
}

// Bring a segment counter back under seg after a step of at most
// kThreads rows (the modulo only for segments shorter than that).
__device__ __forceinline__ int64_t wrap(int64_t sp, int64_t seg) {
  if (sp >= seg) {
    sp -= seg;
    if (sp >= seg)
      sp = static_cast<int64_t>(static_cast<uint32_t>(sp) % static_cast<uint32_t>(seg));
  }
  return sp;
}

// scale * ((2 x - below) - above), each operation rounded to f32 as the
// plain version's tensor operations round (no FMA contraction).
__device__ __forceinline__ float stencil_value(float x, float above, float below,
                                               float scale) {
  return __fmul_rn(scale, __fsub_rn(__fsub_rn(__fmul_rn(2.0f, x), below), above));
}

// What follows the walk's loads.
enum class Epilogue {
  kStencil,    // K1: Y = scale * S(X)
  kDiag,       // Y = post * S(X) + diag * X
  kCheb,       // a Chebyshev step on y = the walked block
  kChebFirst,  // the first step: the walked block is X, y = d = X / theta
};

// The fused epilogues' operands (K1 takes none).  Each scalar is replaced
// by its problem's entry of the [batch] f32 array beside it where that is
// not null.  `first` is the f32 reciprocal of theta, multiplied (PyTorch's
// X / theta for a host number), or theta where first_b gives it, divided
// (its division by a per-problem tensor).
struct Fused {
  const void* x;        // X (kCheb; kChebFirst walks X itself)
  const void* d;        // d (kCheb)
  void* d_out;          // d', or null: the last step writes y' only
  const void* diag;     // diag[p * diag_stride + row]
  int64_t diag_stride;  // elements between two problems' diagonals (0: shared)
  float post, c1, c2, first;
  const float* post_b;
  const float* c1_b;
  const float* c2_b;
  const float* first_b;
};

// C: how elements are carried; NW: words an item; E: the epilogue.  S:
// the walked block (X, or y of a Chebyshev step); kw: items a row;
// nitems: n * kw.  S and Y hold gridDim.y problems of n rows each and the
// edge table one pair a problem; block (x, y) walks chunk x of problem y
// (K1 without batched edge rows: gridDim.y is 1 and the edge table [2, k]).
template <typename C, int NW, Epilogue E>
__global__ void __launch_bounds__(kThreads)
stencil1d_kernel(const typename C::Word* __restrict__ S, typename C::Word* __restrict__ Y,
                 const typename C::Word* __restrict__ edge, float scale, int64_t n, int kw,
                 int64_t seg, int64_t nitems, Fused f) {
  using Word = typename C::Word;
  using IT = Items<Word, NW>;
  constexpr int J = ItemsPerThread<sizeof(IT)>::value;
  constexpr int kChunk = kThreads * J;
  constexpr bool kFused = E != Epilogue::kStencil;
  constexpr bool kCheb = E == Epilogue::kCheb || E == Epilogue::kChebFirst;
  const int64_t p = blockIdx.y;
  const int64_t off = p * nitems * NW;
  S += off;
  Y += off;
  if (edge != nullptr) edge += p * 2 * kw * NW;
  const Word* Xr = nullptr;
  const Word* Dr = nullptr;
  Word* Dout = nullptr;
  const typename C::Elem* diag = nullptr;
  float post = 1.0f, c1 = 0.0f, c2 = 0.0f, first = 1.0f;
  bool divide = false;
  if constexpr (kFused) {
    diag = static_cast<const typename C::Elem*>(f.diag) + p * f.diag_stride;
    post = f.post_b != nullptr ? f.post_b[p] : f.post;
  }
  if constexpr (kCheb) {
    c1 = f.c1_b != nullptr ? f.c1_b[p] : f.c1;
    c2 = f.c2_b != nullptr ? f.c2_b[p] : f.c2;
    if (f.d_out != nullptr) Dout = static_cast<Word*>(f.d_out) + off;
  }
  if constexpr (E == Epilogue::kCheb) {
    Xr = static_cast<const Word*>(f.x) + off;
    Dr = static_cast<const Word*>(f.d) + off;
  }
  if constexpr (E == Epilogue::kChebFirst) {
    divide = f.first_b != nullptr;
    first = divide ? f.first_b[p] : f.first;
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t first_item = base + threadIdx.x;
  // This thread's first item: row r0 + r, item column c, place sp in its
  // segment.  A step of kThreads items moves dr rows and dc columns on,
  // and one row more when the column wraps.
  const int64_t r0 = base / kw;
  const int q = static_cast<int>(base - r0 * kw) + static_cast<int>(threadIdx.x);
  int r = q / kw, c = q - r * kw;
  const int dr = kThreads / kw, dc = kThreads - dr * kw;
  int64_t sp = wrap(r0 % seg + r, seg);

  IT x[J], up[J], dn[J], xr[J], dd[J];
  float dg[J];
  bool up_in[J], dn_in[J];  // the row above / below is a row of S
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first_item + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      up_in[j] = sp != 0;
      dn_in[j] = sp != seg - 1;
      x[j] = load_items<Word, NW>(S + idx * NW);
      up[j] = up_in[j] ? load_items<Word, NW>(S + (idx - kw) * NW)
                       : edge_items<Word, NW>(edge, r0 + r == 0, c * NW);
      dn[j] = dn_in[j] ? load_items<Word, NW>(S + (idx + kw) * NW)
                       : edge_items<Word, NW>(edge, r0 + r == n - 1, (kw + c) * NW);
      if constexpr (kFused) dg[j] = C::elem(diag[r0 + r]);
      if constexpr (E == Epilogue::kCheb) {
        xr[j] = load_items<Word, NW>(Xr + idx * NW);
        dd[j] = load_items<Word, NW>(Dr + idx * NW);
      }
    }
    c += dc;
    int inc = dr;
    if (c >= kw) {
      c -= kw;
      ++inc;
    }
    r += inc;
    sp = wrap(sp + inc, seg);
  }
  // y = X / theta of the first Chebyshev step, rounded as the chain stores it.
  auto first_y = [&](float v) {
    return C::round(divide ? __fdiv_rn(v, first) : __fmul_rn(v, first));
  };
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first_item + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      IT out, dout;
#pragma unroll
      for (int e = 0; e < NW; ++e) {
        constexpr int P = C::kPerWord;
        float xf[P], uf[P], df[P], rf[P], qf[P], of[P], odf[P];
        C::unpack(x[j].v[e], xf);
        C::unpack(up[j].v[e], uf);
        C::unpack(dn[j].v[e], df);
        if constexpr (E == Epilogue::kCheb) {
          C::unpack(xr[j].v[e], rf);
          C::unpack(dd[j].v[e], qf);
        }
#pragma unroll
        for (int h = 0; h < P; ++h) {
          float ys = xf[h], ya = uf[h], yb = df[h];
          if constexpr (E == Epilogue::kChebFirst) {
            // Edge rows arrive as y already; the zero padding stays zero.
            ys = first_y(ys);
            if (up_in[j]) ya = first_y(ya);
            if (dn_in[j]) yb = first_y(yb);
          }
          const float st = stencil_value(ys, ya, yb, scale);
          if constexpr (!kFused) {
            of[h] = st;
          } else {
            // A y = post * S(y) + diag * y, each term stored, then the sum.
            const float a = C::round(__fmul_rn(post, C::round(st)));
            const float ay = C::round(__fadd_rn(a, C::round(__fmul_rn(dg[j], ys))));
            if constexpr (E == Epilogue::kDiag) {
              of[h] = ay;
            } else {
              // X - A y; d' = c1 d + c2 (X - A y); y' = y + d'.  The first
              // step's X is the walked value and its d is y.
              const float xv = E == Epilogue::kCheb ? rf[h] : xf[h];
              const float dv = E == Epilogue::kCheb ? qf[h] : ys;
              const float res = C::round(__fsub_rn(xv, ay));
              const float dnew = C::round(__fadd_rn(C::round(__fmul_rn(c1, dv)),
                                                    C::round(__fmul_rn(c2, res))));
              of[h] = C::round(__fadd_rn(ys, dnew));
              odf[h] = dnew;
            }
          }
        }
        out.v[e] = C::pack(of);
        if constexpr (kCheb) dout.v[e] = C::pack(odf);
      }
      store_items<Word, NW>(Y + idx * NW, out);
      if constexpr (kCheb) {
        if (Dout != nullptr) store_items<Word, NW>(Dout + idx * NW, dout);
      }
    }
  }
}

// Items of w elements as NW words of C over `problems` grid rows of
// n / problems rows each.
template <typename C, int NW, Epilogue E>
int start(const void* S, void* Y, const void* edge, float scale, int64_t n, int64_t k,
          int64_t seg, int64_t problems, const Fused& f, cudaStream_t stream) {
  using Word = typename C::Word;
  constexpr int J = ItemsPerThread<sizeof(Items<Word, NW>)>::value;
  constexpr int W = NW * C::kPerWord;
  const int64_t rows = n / problems;  // one problem's
  const int64_t nitems = rows * (k / W);
  const int64_t blocks = (nitems + kThreads * J - 1) / (kThreads * J);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<const Word*>(S);
  const auto e = static_cast<const Word*>(edge);
  const auto y = static_cast<Word*>(Y);
  const int kw = static_cast<int>(k / W);
  stencil1d_kernel<C, NW, E>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(problems)), kThreads, 0,
         stream>>>(s, y, e, scale, rows, kw, seg, nitems, f);
  return static_cast<int>(cudaGetLastError());
}

// The item widths of each element type: f32 items of 1, 2 or 4; bf16 of
// 1 (one 2-byte word), 2, 4 or 8 (bf16 pairs).
template <Epilogue E>
int start_f32(const void* S, void* Y, const void* edge, float scale, int64_t n, int64_t k,
              int64_t seg, int64_t problems, int64_t w, const Fused& f, cudaStream_t s) {
  if (w == 1) return start<F32, 1, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
  if (w == 2) return start<F32, 2, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
  return start<F32, 4, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
}

template <Epilogue E>
int start_bf16(const void* S, void* Y, const void* edge, float scale, int64_t n, int64_t k,
               int64_t seg, int64_t problems, int64_t w, const Fused& f, cudaStream_t s) {
  if (w == 1) return start<Bf16, 1, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
  if (w == 2) return start<Bf16Pair, 1, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
  if (w == 4) return start<Bf16Pair, 2, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
  return start<Bf16Pair, 4, E>(S, Y, edge, scale, n, k, seg, problems, f, s);
}

// bases: the item-loaded pointers OR-ed together (null adds nothing).
bool takes(int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
           size_t itemsize, uintptr_t bases) {
  return n > 0 && k > 0 && k < kMaxK && seg_rows > 0 && batch > 0 && n % batch == 0 &&
         (n / batch) % seg_rows == 0 && batch <= kMaxBatch && w > 0 && w * itemsize <= 16 &&
         (w & (w - 1)) == 0 && k % w == 0 && bases % (w * itemsize) == 0;
}

uintptr_t bits(const void* p) { return reinterpret_cast<uintptr_t>(p); }

// The fused entry points' checks: the diagonal, its stride and the
// per-problem arrays beside their scalars.
bool fused_takes(const void* diag, int64_t diag_stride) {
  return diag != nullptr && diag_stride >= 0;
}

}  // namespace

extern "C" {

// X, Y: [n, k] row-major on the device; edge: [batch, 2, k] or null;
// batch: the problems X holds, n / batch rows each (1: edge is [2, k] for
// the whole block); w: the elements of an item (ops/cuda/stencil.py:
// items_per_load; a power of two up to 16 bytes that divides k, with X, Y
// and edge on w-element boundaries); stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 = ok), or cudaErrorInvalidValue
// for arguments the kernel does not take.
int lobpcg_stencil1d_f32(const void* X, void* Y, const void* edge, float scale,
                         int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!takes(n, k, seg_rows, batch, w, 4, bits(X) | bits(Y) | bits(edge)))
    return static_cast<int>(cudaErrorInvalidValue);
  return start_f32<Epilogue::kStencil>(X, Y, edge, scale, n, k, seg_rows,
                                       edge != nullptr ? batch : 1, w, Fused{}, s);
}

int lobpcg_stencil1d_bf16(const void* X, void* Y, const void* edge, float scale,
                          int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!takes(n, k, seg_rows, batch, w, 2, bits(X) | bits(Y) | bits(edge)))
    return static_cast<int>(cudaErrorInvalidValue);
  return start_bf16<Epilogue::kStencil>(X, Y, edge, scale, n, k, seg_rows,
                                        edge != nullptr ? batch : 1, w, Fused{}, s);
}

// stencil_diag: Y = post * scale * S(X) + diag * X, with X, Y, edge, n,
// k, seg_rows, w as K1's; X holds `batch` problems (always the grid's y
// extent here; edge, if given, [batch, 2, k]); diag: the diagonal of
// problem p starts diag_stride elements after problem p - 1's (0: one
// diagonal for all); post_b: [batch] f32 (post per problem) or null.
int lobpcg_stencil_diag_f32(const void* X, void* Y, const void* edge, const void* diag,
                            int64_t diag_stride, float scale, float post, const void* post_b,
                            int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
                            void* stream) {
  if (!takes(n, k, seg_rows, batch, w, 4, bits(X) | bits(Y) | bits(edge)) ||
      !fused_takes(diag, diag_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  Fused f{};
  f.diag = diag;
  f.diag_stride = diag_stride;
  f.post = post;
  f.post_b = static_cast<const float*>(post_b);
  return start_f32<Epilogue::kDiag>(X, Y, edge, scale, n, k, seg_rows, batch, w, f,
                                    static_cast<cudaStream_t>(stream));
}

int lobpcg_stencil_diag_bf16(const void* X, void* Y, const void* edge, const void* diag,
                             int64_t diag_stride, float scale, float post, const void* post_b,
                             int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
                             void* stream) {
  if (!takes(n, k, seg_rows, batch, w, 2, bits(X) | bits(Y) | bits(edge)) ||
      !fused_takes(diag, diag_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  Fused f{};
  f.diag = diag;
  f.diag_stride = diag_stride;
  f.post = post;
  f.post_b = static_cast<const float*>(post_b);
  return start_bf16<Epilogue::kDiag>(X, Y, edge, scale, n, k, seg_rows, batch, w, f,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"

namespace {

// A Chebyshev step of either element type: y null is the first step (the
// walk reads X; d must be null too), d_out null the last.
template <bool Bf>
int cheb_step(const void* X, const void* y, const void* d, void* y_out, void* d_out,
              const void* edge, const void* diag, int64_t diag_stride, float scale, float post,
              const void* post_b, float c1, const void* c1_b, float c2, const void* c2_b,
              float first, const void* first_b, int64_t n, int64_t k, int64_t seg_rows,
              int64_t batch, int64_t w, cudaStream_t s) {
  const size_t itemsize = Bf ? 2 : 4;
  const uintptr_t bases =
      bits(X) | bits(y) | bits(d) | bits(y_out) | bits(d_out) | bits(edge);
  if (!takes(n, k, seg_rows, batch, w, itemsize, bases) || !fused_takes(diag, diag_stride) ||
      X == nullptr || y_out == nullptr || (y == nullptr) != (d == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Fused f{};
  f.x = X;
  f.d = d;
  f.d_out = d_out;
  f.diag = diag;
  f.diag_stride = diag_stride;
  f.post = post;
  f.c1 = c1;
  f.c2 = c2;
  f.first = first;
  f.post_b = static_cast<const float*>(post_b);
  f.c1_b = static_cast<const float*>(c1_b);
  f.c2_b = static_cast<const float*>(c2_b);
  f.first_b = static_cast<const float*>(first_b);
  if (y == nullptr) {
    return Bf ? start_bf16<Epilogue::kChebFirst>(X, y_out, edge, scale, n, k, seg_rows, batch,
                                                 w, f, s)
              : start_f32<Epilogue::kChebFirst>(X, y_out, edge, scale, n, k, seg_rows, batch,
                                                w, f, s);
  }
  return Bf ? start_bf16<Epilogue::kCheb>(y, y_out, edge, scale, n, k, seg_rows, batch, w, f, s)
            : start_f32<Epilogue::kCheb>(y, y_out, edge, scale, n, k, seg_rows, batch, w, f, s);
}

}  // namespace

extern "C" {

// cheb_step: one step of the Chebyshev filter on [n, k] blocks of
// `batch` problems: Ay = post * scale * S(y) + diag * y (edge: y's rows
// outside each problem, as stencil_diag's), d' = c1 d + c2 (X - Ay),
// y' = y + d' into y_out and d_out (d_out null: not written).  y and d
// null: the first step, y = d = X * first (first_b null) or X / first_b[p].
// c1_b, c2_b, first_b, post_b: [batch] f32 or null.  y_out must not be y.
int lobpcg_cheb_step_f32(const void* X, const void* y, const void* d, void* y_out,
                         void* d_out, const void* edge, const void* diag,
                         int64_t diag_stride, float scale, float post, const void* post_b,
                         float c1, const void* c1_b, float c2, const void* c2_b,
                         float first, const void* first_b, int64_t n, int64_t k,
                         int64_t seg_rows, int64_t batch, int64_t w, void* stream) {
  return cheb_step<false>(X, y, d, y_out, d_out, edge, diag, diag_stride, scale, post, post_b,
                          c1, c1_b, c2, c2_b, first, first_b, n, k, seg_rows, batch, w,
                          static_cast<cudaStream_t>(stream));
}

int lobpcg_cheb_step_bf16(const void* X, const void* y, const void* d, void* y_out,
                          void* d_out, const void* edge, const void* diag,
                          int64_t diag_stride, float scale, float post, const void* post_b,
                          float c1, const void* c1_b, float c2, const void* c2_b,
                          float first, const void* first_b, int64_t n, int64_t k,
                          int64_t seg_rows, int64_t batch, int64_t w, void* stream) {
  return cheb_step<true>(X, y, d, y_out, d_out, edge, diag, diag_stride, scale, post, post_b,
                         c1, c1_b, c2, c2_b, first, first_b, n, k, seg_rows, batch, w,
                         static_cast<cudaStream_t>(stream));
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
