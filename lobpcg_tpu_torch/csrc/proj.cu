// The tall projection Y = live * (U - sum_i V_i C_i) in full f32 for Hopper
// (sm_90a): V_i [n, w_i] with n in the millions, C the coefficients
// [sum_i w_i, m] (term i's rows follow term i - 1's), m at most 168, up to
// four terms; U and the live mask optional (without U, Y = live * sum).
//
// Replaces no Pallas kernel: the JAX package leaves these contractions to
// XLA's dot at Precision.HIGHEST and fuses the sum, the subtraction and
// the mask around them (lobpcg_tpu/ops/gram.py b_mm, lobpcg_tpu/ops/ortho.py
// the projection update, lobpcg_tpu/ops/svqb.py U T and its mask).  The
// port ran one cuBLAS GEMM a term (an sm80 SIMT `nn` kernel at ~45% of the
// card's FFMA peak), each writing a tall block that a csrc/tail.cu combine
// pass then read back.  Here the sum, U - sum and the mask are the
// epilogue, in registers: no term block is written.  Every product is an
// f32 FFMA: no TF32, no tensor core.
//
// Bound: 2 n K m operations (K = sum_i w_i) against (K + m + m_U) n 4 bytes
// (each term and U read once, Y written once; C is small and read from
// L2).  At 67 TFLOP/s f32 and 3.35 TB/s: [4M, 164] x 3 terms 9.63 ms of
// FFMA against 3.13 ms of bytes (compute-bound); [4M, 64] x 3 1.47 ms
// against 1.22 ms (balanced); [4.096M, 16] x 3 0.094 ms against 0.313 ms
// (byte-bound).
//
// Design.  A block owns a slab of bm = 8 tms rows and all m output
// columns, so the contraction over K runs inside it (no split-K, no
// second pass) and each output element is written once.  Its threads are
// tms x hn / 4; thread (tm, tn) keeps an 8 x 8 register tile: rows
// tm + p tms (p < 8), columns tn 4 + 0..3 and hn + tn 4 + 0..3 (2 hn >= m).
// K is cut into chunks that never straddle a term: BK of a term's K each,
// the term's last chunk shorter, or longer by a rest of up to kPad (164 =
// 4 x 32 + 36).  A stage holds the slab's [bm, BK + kPad] chunk as it lies
// in memory and C's matching rows [BK + kPad, 2 hn]; both are copied by
// cp.async, 16 bytes a copy along the rows (8 or 4 where a base, a row
// stride or a width does not hold whole vectors), zero-filled past the
// last row, the chunk's K and column m, kStages stages deep with one
// block-wide barrier a stage.  A thread reads its 8 rows' next 4 K as one
// float4 each and C's row as two float4 for 4 x 64 FFMA; neighbouring
// threads share rows (broadcast) and read neighbouring float4 of C, and
// the row pitch (BK + kPad, an odd count of float4) and the row order
// (tm + p tms) keep the rows of a quarter warp on distinct banks.  Every
// block reads all of C, which stays in L2.
//
// Summation: each term is one FFMA chain over its K in order, from 0, into
// a partial tile; at the next term's first chunk the partial is added to
// the running sum (__fadd_rn, from -0) and starts again: the order of a
// GEMM a term (cuBLAS's SIMT kernels run each output's K in order) and of
// combine's left-to-right adds, so the result has their bits (measured on
// the card at the solves' shapes) and a solve keeps its trajectory.  One
// chain over all of K erred 2-3x more (a host emulation at [4000, 164] x
// 3: 1.3e-6 against 4.4e-7 of the largest entry); a partial a stage erred
// less but moved the 4M x 150 pool's iterations +2.4%; a test for a term's
// start at every 4 K inside the FFMA stream ran 8% slower than a test a
// chunk.  No atomics.
//
// Epilogue: U - sum and the mask as combine computes them (__fsub_rn,
// then a multiply by 1 or 0: a dead column holding Inf or NaN gives NaN);
// the live mask is a count (an int or one int64 on the device) or a byte
// a column.
//
// The host (ops/cuda/proj.py: plan) chooses hn, tms and BK from m alone,
// and the copy's width W from the pointers and strides; the solves'
// widths (164, 64, 16) run instantiations with the tile fixed at compile
// time.  At m 164 a block is 252 threads (8 warps, 2 a scheduler), one
// block an SM, up to 255 registers a thread: the tile, the partial tile
// and the fragments take ~170.  What bounds it at m 164 is shared memory
// as much as the FMA units: an 8 x 8 tile reads 16 floats for 64 FFMA, so
// at the card's 128 FFMA a clock an SM would read 128 bytes a clock, all
// that shared memory delivers (measured ~50% of the FFMA peak; tried and
// slower: a persistent grid, 2 or 4 groups of threads splitting K with
// one sum each, fewer rows of threads, 8 or 16 K a stage).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // ops/cuda/proj.py:MAX_THREADS
constexpr int kStages = 4;        // ops/cuda/proj.py:STAGES
constexpr int kMaxTerms = 4;      // ops/cuda/proj.py:MAX_TERMS
constexpr int kPad = 4;           // ops/cuda/proj.py:PAD, K a stage holds beyond BK
constexpr int kMaxSmem = 227 * 1024;

struct Args {
  const float* V[kMaxTerms];
  int64_t ldv[kMaxTerms];
  int kbeg[kMaxTerms];  // first K of each term
  int cbeg[kMaxTerms];  // first chunk of each term, -1 past the last
  int nterms, K, chunks;
  const float* C;
  int64_t ldc;
  const float* U;  // null: no U
  int64_t ldu;
  float* Y;
  int64_t ldy;
  const unsigned char* mask;  // kind 2: a byte a column
  const int64_t* count_ptr;   // kind 1: the count on the device, or null
  int64_t count;              // kind 1 without count_ptr
  int kind;                   // 0 no mask, 1 a count, 2 a byte mask
  int64_t n;
  int m, hn, tms;
};

template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else if constexpr (W == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The epilogue of one output: live * (u - s), as combine rounds it.
__device__ __forceinline__ float finish(float s, const float* u, float live, bool has_u,
                                        bool masked) {
  float y = has_u ? __fsub_rn(*u, s) : s;
  return masked ? __fmul_rn(y, live) : y;
}

// One block: rows [blockIdx.x bm, + bm) of Y (one block a slab: a
// persistent grid whose next slab's first stages load during this slab's
// epilogue ran 4-11% slower, measured at m 16, 64 and 164).  W: floats a
// copy moves; BK: K a stage; HN, TMS: the tile fixed at compile time (0:
// read from a).
template <int W, int BK, int HN = 0, int TMS = 0>
__global__ void __launch_bounds__(kMaxThreads, 1) lobpcg_proj_sgemm_kernel(const Args a) {
  constexpr int T = 8;  // rows (and columns) of a thread's tile
  constexpr int BKP = BK + kPad;  // K a stage holds at most, and its row pitch
  constexpr int VPR = BK / W;     // copies in a staged row's first BK of V
  constexpr int VPX = kPad / W;   // and in its rest
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // The arguments as locals: the lambdas below then take no address of
  // the kernel's parameter.
  const float* const V0 = a.V[0];
  const float* const V1 = a.V[1];
  const float* const V2 = a.V[2];
  const float* const V3 = a.V[3];
  const int64_t ld0 = a.ldv[0], ld1 = a.ldv[1], ld2 = a.ldv[2], ld3 = a.ldv[3];
  const int kb1 = a.kbeg[1], kb2 = a.kbeg[2], kb3 = a.kbeg[3];
  const int cb1 = a.cbeg[1], cb2 = a.cbeg[2], cb3 = a.cbeg[3];
  const float* const Cp = a.C;
  const int64_t ldc = a.ldc;
  const int64_t n = a.n;
  const int m = a.m, K = a.K, chunks = a.chunks;
  const int hn = HN ? HN : a.hn;
  const int tms = TMS ? TMS : a.tms;
  const int tnc = hn >> 2;
  const int threads = tms * tnc;
  const int tid = threadIdx.x;
  const int tm = tid / tnc;
  const int tn = tid - tm * tnc;
  const int bm = 8 * tms, bn = 2 * hn;
  const int stage = bm * BKP + BKP * bn;  // floats: V's rows, then C's
  const int vc = bn / W;                 // copies in a staged row of C
  const int64_t r0 = (int64_t)blockIdx.x * bm;

  // Chunk c of K lies in one term: term t's chunks are cbeg[t], ..., each
  // BK of its K but the last, which runs to the term's end (BK + kPad at
  // most: a rest of up to kPad joins the chunk before it).  Its term's
  // first K (in C's rows), its first K within the term, its K and its
  // term's V.
  struct Chunk {
    const float* V;
    int64_t ld;
    int kb, k0, len, t;
  };
  auto chunk_of = [&](int c) {
    Chunk h{V0, ld0, 0, c * BK, 0, 0};
    int end = kb1 > 0 ? kb1 : K, cend = cb1 > 0 ? cb1 : chunks;
    if (cb1 > 0 && c >= cb1) {
      h = Chunk{V1, ld1, kb1, (c - cb1) * BK, 0, 1};
      end = kb2 > 0 ? kb2 : K;
      cend = cb2 > 0 ? cb2 : chunks;
    }
    if (cb2 > 0 && c >= cb2) {
      h = Chunk{V2, ld2, kb2, (c - cb2) * BK, 0, 2};
      end = kb3 > 0 ? kb3 : K;
      cend = cb3 > 0 ? cb3 : chunks;
    }
    if (cb3 > 0 && c >= cb3) {
      h = Chunk{V3, ld3, kb3, (c - cb3) * BK, 0, 3};
      end = K;
      cend = chunks;
    }
    h.len = c + 1 < cend ? BK : end - h.kb - h.k0;  // the last: to the term's end
    return h;
  };

  // The copy of chunk c into stage s: vector i of V's part is row i / VPR,
  // K k0 + (i % VPR) W of the chunk's term; vector i of C's part is row
  // kb + k0 + i / vc, column (i % vc) W; zeros past the term's K, the last
  // row and column m.
  auto load = [&](int c, int s) {
    float* const sV = smem + s * stage;
    float* const sC = sV + bm * BKP;
    const Chunk h = chunk_of(c);
    // The first BK of K (zeros past a short chunk's end), then the rest
    // only where the chunk has one.
    for (int i = tid; i < bm * VPR; i += threads) {
      const int r = i / VPR;
      const int kk = (i - r * VPR) * W;
      const int64_t row = r0 + r;
      const bool ok = row < n && kk < h.len;
      cp_async<W>(sV + r * BKP + kk, ok ? h.V + row * h.ld + h.k0 + kk : V0, ok ? 4 * W : 0);
    }
    const int rows_c = h.len > BK ? BKP : BK;
    for (int i = tid; i < rows_c * vc; i += threads) {
      const int kk = i / vc;
      const int col = (i - kk * vc) * W;
      const bool ok = kk < h.len && col < m;
      cp_async<W>(sC + kk * bn + col, ok ? Cp + (int64_t)(h.kb + h.k0 + kk) * ldc + col : Cp,
                  ok ? 4 * W : 0);
    }
    if (h.len <= BK) return;
    for (int i = tid; i < bm * VPX; i += threads) {
      const int r = i / VPX;
      const int kk = BK + (i - r * VPX) * W;
      const int64_t row = r0 + r;
      const bool ok = row < n && kk < h.len;
      cp_async<W>(sV + r * BKP + kk, ok ? h.V + row * h.ld + h.k0 + kk : V0, ok ? 4 * W : 0);
    }
  };

  // acc: the terms' sums added so far (from -0, which adds as nothing, so
  // a lone term keeps its own bits); part: the current term's FFMA chain,
  // added to acc where the next term starts, as combine adds the GEMM
  // outputs.
  float acc[T][T], part[T][T];
#pragma unroll
  for (int p = 0; p < T; ++p)
#pragma unroll
    for (int q = 0; q < T; ++q) {
      acc[p][q] = -0.0f;
      part[p][q] = 0.0f;
    }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  const int off_v = tm * BKP, step_v = tms * BKP;
  const int off_c = bm * BKP + tn * 4;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = c + kStages - 1;
    if (nxt < chunks) load(nxt, nxt % kStages);
    cp_async_commit();

    const Chunk h = chunk_of(c);
    if (h.t > 0 && h.k0 == 0) {
#pragma unroll
      for (int p = 0; p < T; ++p)
#pragma unroll
        for (int q = 0; q < T; ++q) {
          acc[p][q] = __fadd_rn(acc[p][q], part[p][q]);
          part[p][q] = 0.0f;
        }
    }
    const float* sV = smem + (c % kStages) * stage + off_v;
    const float* sC = smem + (c % kStages) * stage + off_c;
    // BK of K, then the 4 more a term's last chunk may hold.  A shorter
    // chunk's zeros past the term's K add nothing: a chain starts at +0,
    // which no zero product turns to -0.
#pragma unroll
    for (int kq = 0; kq < BKP; kq += 4) {
      if (kq == BK && h.len <= BK) break;
      float4 x4[T];
#pragma unroll
      for (int p = 0; p < T; ++p)
        x4[p] = *reinterpret_cast<const float4*>(sV + p * step_v + kq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b0 = *reinterpret_cast<const float4*>(sC + (kq + j) * bn);
        const float4 b1 = *reinterpret_cast<const float4*>(sC + (kq + j) * bn + hn);
        const float y[T] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float x[T];
#pragma unroll
        for (int p = 0; p < T; ++p) x[p] = reinterpret_cast<const float*>(&x4[p])[j];
        // Rows of the tile in turn, the columns of every other row in
        // reverse (csrc/gram.cu: nvcc's schedule of that order issued
        // faster than row order).
#pragma unroll
        for (int p = 0; p < T; ++p)
#pragma unroll
          for (int i = 0; i < T; ++i) {
            const int q = (p & 1) ? T - 1 - i : i;
            part[p][q] = fmaf(x[p], y[q], part[p][q]);
          }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < T; ++p)
#pragma unroll
    for (int q = 0; q < T; ++q) acc[p][q] = __fadd_rn(acc[p][q], part[p][q]);
  cp_async_wait<0>();

  // The epilogue: each output once, its U read and its mask applied here.
  const bool has_u = a.U != nullptr;
  const bool masked = a.kind != 0;
  int64_t count = a.count;
  if (a.kind == 1 && a.count_ptr != nullptr) count = *a.count_ptr;
  float live[T];
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const int col = tn * 4 + (q & 3) + (q >> 2) * hn;
    live[q] = a.kind == 1   ? (col < count ? 1.0f : 0.0f)
              : a.kind == 2 ? (col < m && a.mask[col] ? 1.0f : 0.0f)
                            : 1.0f;
  }
#pragma unroll
  for (int p = 0; p < T; ++p) {
    const int64_t row = r0 + tm + p * tms;
    if (row >= n) continue;
    float* const yrow = a.Y + row * a.ldy;
    const float* const urow = has_u ? a.U + row * a.ldu : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col0 = tn * 4 + h * hn;
      if (col0 >= m) continue;
      if constexpr (W == 4) {
        // m, the row strides and the bases hold whole vectors: all four
        // columns lie before m.
        float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (has_u) u = *reinterpret_cast<const float4*>(urow + col0);
        float4 out;
        out.x = finish(acc[p][4 * h + 0], &u.x, live[4 * h + 0], has_u, masked);
        out.y = finish(acc[p][4 * h + 1], &u.y, live[4 * h + 1], has_u, masked);
        out.z = finish(acc[p][4 * h + 2], &u.z, live[4 * h + 2], has_u, masked);
        out.w = finish(acc[p][4 * h + 3], &u.w, live[4 * h + 3], has_u, masked);
        *reinterpret_cast<float4*>(yrow + col0) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + e;
          if (col < m)
            yrow[col] = finish(acc[p][4 * h + e], has_u ? urow + col : nullptr, live[4 * h + e],
                               has_u, masked);
        }
      }
    }
  }
}


using Kernel = void (*)(Args);

Kernel pick(int64_t w, int64_t bk, int64_t hn, int64_t tms) {
  // The solves' widths: m 164 (4M x 150), 64 (4M x 56), 16 (160^3).
  if (w == 4 && bk == 32 && hn == 84 && tms == 12) return lobpcg_proj_sgemm_kernel<4, 32, 84, 12>;
  if (w == 4 && bk == 32 && hn == 32 && tms == 32) return lobpcg_proj_sgemm_kernel<4, 32, 32, 32>;
  if (w == 4 && bk == 8 && hn == 8 && tms == 128) return lobpcg_proj_sgemm_kernel<4, 8, 8, 128>;
#define LOBPCG_PROJ_PICK(W, B) \
  if (w == W && bk == B) return lobpcg_proj_sgemm_kernel<W, B>;
  LOBPCG_PROJ_PICK(4, 32) LOBPCG_PROJ_PICK(4, 16) LOBPCG_PROJ_PICK(4, 8)
  LOBPCG_PROJ_PICK(2, 32) LOBPCG_PROJ_PICK(2, 16) LOBPCG_PROJ_PICK(2, 8)
  LOBPCG_PROJ_PICK(1, 32) LOBPCG_PROJ_PICK(1, 16) LOBPCG_PROJ_PICK(1, 8)
#undef LOBPCG_PROJ_PICK
  return nullptr;
}

bool aligned(const void* p, int64_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes) == 0;
}

int64_t smem_bytes(int64_t hn, int64_t tms, int64_t bk) {
  return (int64_t)kStages * (8 * tms + 2 * hn) * (bk + kPad) * 4;
}

}  // namespace

extern "C" {

// Y [n, m] at Y + r ldy + j = live * (U - sum_t V_t C[kbeg_t : kbeg_t +
// w_t]) (f32, column stride 1 everywhere): V, ldv, widths: nterms (1-4)
// term pointers, row strides and widths (arrays of kMaxTerms, int64);
// C [sum w, m] at C + k ldc + j; U null for no U; kind 0 no mask, 1 the
// count (count_ptr's int64 on the device, or `count` where count_ptr is
// null), 2 a byte a column at mask.  The plan: tiles of 2 hn columns (2 hn
// - 8 < m <= 2 hn) and 8 tms rows, tms hn / 4 threads, bk of K a stage; w:
// floats a copy moves (4, 2 or 1), dividing every width, row stride and
// base.  Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int lobpcg_proj_sgemm_f32(const void* V, const void* ldv, const void* widths, int64_t nterms,
                          const void* C, int64_t ldc, const void* U, int64_t ldu,
                          const void* mask, const void* count_ptr, int64_t count, int64_t kind,
                          void* Y, int64_t ldy, int64_t n, int64_t m, int64_t hn, int64_t tms,
                          int64_t bk, int64_t w, void* stream) {
  const Kernel fn = pick(w, bk, hn, tms);
  if (fn == nullptr || nterms < 1 || nterms > kMaxTerms || n < 1 || m < 1 || hn < 4 ||
      hn % 4 || 2 * hn < m || 2 * hn - 8 >= m || tms < 1 || tms * (hn / 4) > kMaxThreads ||
      smem_bytes(hn, tms, bk) > kMaxSmem || kind < 0 || kind > 2 ||
      (kind == 2 && mask == nullptr) || C == nullptr || Y == nullptr || ldc < m ||
      ldy < m || (U != nullptr && ldu < m) || m % w || ldc % w || ldy % w ||
      (U != nullptr && ldu % w) || !aligned(C, 4 * w) || !aligned(Y, 4 * w) ||
      (U != nullptr && !aligned(U, 4 * w)) || (n + 8 * tms - 1) / (8 * tms) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const void* const* vp = static_cast<const void* const*>(V);
  const int64_t* lds = static_cast<const int64_t*>(ldv);
  const int64_t* ws = static_cast<const int64_t*>(widths);
  Args a;
  int64_t K = 0, chunks = 0;
  for (int t = 0; t < kMaxTerms; ++t) {
    const bool used = t < nterms;
    if (used && (vp[t] == nullptr || ws[t] < 1 || lds[t] < ws[t] || ws[t] % w || lds[t] % w ||
                 !aligned(vp[t], 4 * w)))
      return (int)cudaErrorInvalidValue;
    a.V[t] = static_cast<const float*>(used ? vp[t] : vp[0]);
    a.ldv[t] = used ? lds[t] : lds[0];
    a.kbeg[t] = used ? (int)K : -1;  // past the last term: never selected
    a.cbeg[t] = used ? (int)chunks : -1;
    if (used) {
      K += ws[t];
      // BK a chunk; a rest of up to kPad joins the chunk before it.
      const int64_t whole = ws[t] / bk, rest = ws[t] % bk;
      chunks += rest == 0 ? whole : rest <= kPad && whole > 0 ? whole : whole + 1;
    }
    if (K > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  }
  a.nterms = (int)nterms;
  a.K = (int)K;
  a.chunks = (int)chunks;
  a.C = static_cast<const float*>(C);
  a.ldc = ldc;
  a.U = static_cast<const float*>(U);
  a.ldu = ldu;
  a.Y = static_cast<float*>(Y);
  a.ldy = ldy;
  a.mask = static_cast<const unsigned char*>(mask);
  a.count_ptr = static_cast<const int64_t*>(count_ptr);
  a.count = count;
  a.kind = (int)kind;
  a.n = n;
  a.m = (int)m;
  a.hn = (int)hn;
  a.tms = (int)tms;
  const int64_t smem = smem_bytes(hn, tms, bk);
  const int threads = (int)(tms * (hn / 4));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchKernel((const void*)fn, dim3((unsigned)((n + 8 * tms - 1) / (8 * tms))),
                       dim3((unsigned)threads), params, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
