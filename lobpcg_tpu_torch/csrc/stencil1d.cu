// Segmented 1-D Dirichlet stencil SpMM for Hopper (sm_90a).
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
// Bound: device-memory bytes.  Four operations per element against one
// read and one write: at least 2 * n * k * sizeof(T) bytes.
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
// division on the edge path 20% slower.  bf16
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
// the same rounding as two).
struct F32 {
  using Word = float;
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ void unpack(Word w, float* f) { f[0] = w; }
  static __device__ __forceinline__ Word pack(const float* f) { return f[0]; }
};

struct Bf16 {
  using Word = unsigned short;
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ void unpack(Word w, float* f) {
    f[0] = __uint_as_float(static_cast<unsigned>(w) << 16);
  }
  static __device__ __forceinline__ Word pack(const float* f) {
    // Round to nearest even, as torch's .to(bfloat16).
    return __bfloat16_as_ushort(__float2bfloat16(f[0]));
  }
};

struct Bf16Pair {
  using Word = unsigned int;
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

// C: how elements are carried; NW: words an item.  kw: items a row;
// nitems: n * kw.  X and Y hold gridDim.y problems of n rows each and the
// edge table one pair a problem; block (x, y) walks chunk x of problem y
// (without batched edge rows gridDim.y is 1 and the edge table [2, k]).
template <typename C, int NW>
__global__ void __launch_bounds__(kThreads)
stencil1d_kernel(const typename C::Word* __restrict__ X, typename C::Word* __restrict__ Y,
                 const typename C::Word* __restrict__ edge, float scale, int64_t n, int kw,
                 int64_t seg, int64_t nitems) {
  using Word = typename C::Word;
  using IT = Items<Word, NW>;
  constexpr int J = ItemsPerThread<sizeof(IT)>::value;
  constexpr int kChunk = kThreads * J;
  const int64_t p = blockIdx.y;
  X += p * nitems * NW;
  Y += p * nitems * NW;
  if (edge != nullptr) edge += p * 2 * kw * NW;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t first = base + threadIdx.x;
  // This thread's first item: row r0 + r, item column c, place sp in its
  // segment.  A step of kThreads items moves dr rows and dc columns on,
  // and one row more when the column wraps.
  const int64_t r0 = base / kw;
  const int q = static_cast<int>(base - r0 * kw) + static_cast<int>(threadIdx.x);
  int r = q / kw, c = q - r * kw;
  const int dr = kThreads / kw, dc = kThreads - dr * kw;
  int64_t sp = wrap(r0 % seg + r, seg);

  IT x[J], up[J], dn[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      x[j] = load_items<Word, NW>(X + idx * NW);
      up[j] = sp != 0 ? load_items<Word, NW>(X + (idx - kw) * NW)
                      : edge_items<Word, NW>(edge, r0 + r == 0, c * NW);
      dn[j] = sp != seg - 1 ? load_items<Word, NW>(X + (idx + kw) * NW)
                            : edge_items<Word, NW>(edge, r0 + r == n - 1, (kw + c) * NW);
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
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t idx = first + static_cast<int64_t>(j) * kThreads;
    if (idx < nitems) {
      IT out;
#pragma unroll
      for (int e = 0; e < NW; ++e) {
        float xf[C::kPerWord], uf[C::kPerWord], df[C::kPerWord], yf[C::kPerWord];
        C::unpack(x[j].v[e], xf);
        C::unpack(up[j].v[e], uf);
        C::unpack(dn[j].v[e], df);
#pragma unroll
        for (int h = 0; h < C::kPerWord; ++h) {
          const float t = 2.0f * xf[h] - df[h];
          yf[h] = scale * (t - uf[h]);
        }
        out.v[e] = C::pack(yf);
      }
      store_items<Word, NW>(Y + idx * NW, out);
    }
  }
}

// Items of w elements as NW words of C; batch > 1 with edge rows: the
// batched edge form, one grid row a problem.
template <typename C, int NW>
int start(const void* X, void* Y, const void* edge, float scale, int64_t n, int64_t k,
          int64_t seg, int64_t batch, cudaStream_t stream) {
  using Word = typename C::Word;
  constexpr int J = ItemsPerThread<sizeof(Items<Word, NW>)>::value;
  constexpr int W = NW * C::kPerWord;
  const int64_t problems = edge != nullptr ? batch : 1;
  const int64_t rows = n / problems;  // one problem's
  const int64_t nitems = rows * (k / W);
  const int64_t blocks = (nitems + kThreads * J - 1) / (kThreads * J);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto x = static_cast<const Word*>(X);
  const auto e = static_cast<const Word*>(edge);
  const auto y = static_cast<Word*>(Y);
  const int kw = static_cast<int>(k / W);
  stencil1d_kernel<C, NW>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(problems)), kThreads, 0,
         stream>>>(x, y, e, scale, rows, kw, seg, nitems);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
           size_t itemsize, const void* X, const void* Y, const void* edge) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y) |
                          reinterpret_cast<uintptr_t>(edge);
  return n > 0 && k > 0 && k < kMaxK && seg_rows > 0 && batch > 0 && n % batch == 0 &&
         (n / batch) % seg_rows == 0 && batch <= kMaxBatch && w > 0 && w * itemsize <= 16 &&
         (w & (w - 1)) == 0 && k % w == 0 && bases % (w * itemsize) == 0;
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
  if (!takes(n, k, seg_rows, batch, w, 4, X, Y, edge))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w == 1) return start<F32, 1>(X, Y, edge, scale, n, k, seg_rows, batch, s);
  if (w == 2) return start<F32, 2>(X, Y, edge, scale, n, k, seg_rows, batch, s);
  return start<F32, 4>(X, Y, edge, scale, n, k, seg_rows, batch, s);
}

int lobpcg_stencil1d_bf16(const void* X, void* Y, const void* edge, float scale,
                          int64_t n, int64_t k, int64_t seg_rows, int64_t batch, int64_t w,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!takes(n, k, seg_rows, batch, w, 2, X, Y, edge))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w == 1) return start<Bf16, 1>(X, Y, edge, scale, n, k, seg_rows, batch, s);
  if (w == 2) return start<Bf16Pair, 1>(X, Y, edge, scale, n, k, seg_rows, batch, s);
  if (w == 4) return start<Bf16Pair, 2>(X, Y, edge, scale, n, k, seg_rows, batch, s);
  return start<Bf16Pair, 4>(X, Y, edge, scale, n, k, seg_rows, batch, s);
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
