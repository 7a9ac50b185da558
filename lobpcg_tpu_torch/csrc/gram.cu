// The tall Gram G = V^T U in full f32 for Hopper (sm_90a): V [n, kv] and
// U [n, ku] with n in the millions and kv, ku at most 256.
//
// Replaces no Pallas kernel: the JAX package leaves these contractions to
// XLA's dot at Precision.HIGHEST (lobpcg_tpu/ops/gram.py), and the port
// gave them to cuBLAS, whose f32 kernel for this shape (an sm80 SIMT GEMM
// with 64 x 64 x 8 tiles) ran the 4M x 150 solve's Grams at about 45% of
// the card's FFMA peak.  Every product is an f32 FFMA: no TF32, no tensor
// core.
//
// Bound: 2 n kv ku operations against (kv + ku) n 4 bytes read once (the
// k x k output is small).  At the solves' shapes, at 67 TFLOP/s f32 and
// 3.35 TB/s: [4M, 164] 3.21 ms of FFMA against 1.57 ms of bytes
// (compute-bound, 2x); [4M, 64] 0.49 ms against 0.61 ms (balanced: the
// FMA units must be ~80% busy while the bytes stream at the bound);
// [4.1M, 16] 0.16 ms of bytes (byte-bound).
//
// Design, for an SM that issues 128 FFMA a clock but reads 32 words of
// shared memory: each thread keeps an 8 x 8 register tile of G (rows
// tm * 4 + 0..3 and hm + tm * 4 + 0..3, columns alike), so a staged row of
// V and U costs it four 16-byte shared loads for 64 FFMA.  The halves at
// hm and hn put neighbouring threads on neighbouring 16-byte words, so a
// quarter warp's load touches 32 distinct banks.  The FFMAs run the
// tile's rows in turn and every other row's columns in reverse: measured
// on the card, nvcc's schedule of that order issued 5-10% faster than row
// order.  A row of V lies in memory as a row of the tile, so stages are
// copied as they are, with no transpose.  A block holds one output tile
// (2 hm x 2 hn; one tile covers the whole Gram up to k 168, so V and U
// are each read once) and one slab of at most 8,192 rows (the row split
// of ops/gram.py: one n-long f32 sum erred by 1.9e-4 at 1M rows); the
// host picks the slab count to fill whole waves of the card.  For small k
// a tile has few threads, so a block runs `groups` copies of it, group g
// taking rows g, g + groups, ... of each stage; the groups' tiles are
// summed in shared memory as a tree.  Each block writes its tile of the
// slab's partial Gram to a scratch buffer [slabs, kv, ku]; a second
// kernel sums the slabs in a fixed order (kReduceLanes running sums, each
// over every kReduceLanes-th slab, then added as a tree).  No float
// atomics: a Gram repeats bit for bit from run to run.
//
// Staging: every thread copies 16 bytes at a time (cp.async; 8 or 4 where
// a base, a row stride or a width does not hold whole 16-byte vectors),
// zero-filled past the last row and column, kStages stages deep, one
// block-wide barrier a stage.  Where the block has a thread for every
// vector of a row, each thread keeps its vector's source and destination
// from stage to stage.  (Measured at [4M, 164]: the copies and the
// barriers cost ~4% each against a kernel without them; a variant that
// staged by bulk copies (TMA) from one extra warp, with mbarriers in
// place of the barrier, ran 3% slower.)
//
// The host (ops/cuda/gram.py: plan, slab_plan) chooses the tile (hm, hn,
// tiles), `groups`, the rows a group takes from a stage (RPG) and the
// copy's width W from the shapes and the pointers; the solves' shapes run
// instantiations with the tile fixed at compile time (measured: 10% faster
// at [4M, 164], the shared-memory offsets then immediates).  At [4M, 164]
// a block is 441 threads, 14 warps on the SM's 4 schedulers (4, 4, 3, 3
// of them), one block an SM at 128 registers a thread: the FFMA issue is
// held to 7/8 of the peak before anything else costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 448;  // ops/cuda/gram.py:MAX_THREADS
constexpr int kStages = 4;        // ops/cuda/gram.py:STAGES
constexpr int kReduceLanes = 32;  // running sums of one output in the second pass
constexpr int kMaxSmem = 227 * 1024;

struct Args {
  const float* V;
  const float* U;
  float* partial;  // [slabs, kv, ku]
  int64_t ldv, ldu, n, rows;
  int kv, ku, hm, hn, tiles_n, groups;
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

// One block: the partial Gram of slab blockIdx.x over output tile
// blockIdx.y, written to a.partial[blockIdx.x].  HM, HN, GR: the tile's
// half widths and the groups fixed at compile time (0: read from a).
template <int W, int RPG, int HM = 0, int HN = 0, int GR = 0>
__global__ void __launch_bounds__(kMaxThreads, 1) lobpcg_gram_sgemm_kernel(const Args a) {
  constexpr int T = 8;  // rows (and columns) of a thread's tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // The arguments as locals: the copy lambda below then takes no
  // address of the kernel's parameter.
  const float* const Vp = a.V;
  const float* const Up = a.U;
  const int64_t ldv = a.ldv, ldu = a.ldu;
  const int kv = a.kv, ku = a.ku;
  const int hm = HM ? HM : a.hm, hn = HN ? HN : a.hn;
  const int tn_count = hn >> 2;
  const int per_group = (hm >> 2) * tn_count;
  const int G = GR ? GR : a.groups;
  const int g = threadIdx.x / per_group;
  const int w = threadIdx.x - g * per_group;
  const int tm = w / tn_count;
  const int tn = w - tm * tn_count;
  const int bm = 2 * hm, bn = 2 * hn;
  const int bk = RPG * G;            // rows of a stage
  const int stage = bk * (bm + bn);  // floats of a stage: V's rows, then U's
  const int tile_m = blockIdx.y / a.tiles_n;
  const int c0m = tile_m * bm;
  const int c0n = (blockIdx.y - tile_m * a.tiles_n) * bn;
  const int64_t r0 = (int64_t)blockIdx.x * a.rows;
  const int64_t r1 = r0 + a.rows < a.n ? r0 + a.rows : a.n;
  const int chunks = (int)((r1 - r0 + bk - 1) / bk);

  // The copy of a stage: vector c of a stage row (V's bm / W vectors,
  // then U's bn / W) in rows lane_r, lane_r + row_lanes, ...  Where the
  // block has a thread for every vector of a row (one_col), each thread
  // keeps its vector's source and destination from stage to stage, and a
  // stage whose rows all lie in the slab copies without a row test.
  const int vm = bm / W;
  const int vpr = vm + bn / W;
  const int threads = G * per_group;
  const int col_lanes = min(threads, vpr);
  const int row_lanes = threads / col_lanes;
  const int lane_c = threadIdx.x % col_lanes;
  const int lane_r = threadIdx.x / col_lanes;
  const bool one_col = vpr <= threads;
  const bool first_v = lane_c < vm;
  const int first_col = (first_v ? lane_c : lane_c - vm) * W;
  const int first_gcol = (first_v ? c0m : c0n) + first_col;
  const bool first_ok = first_gcol < (first_v ? kv : ku);
  const int64_t first_ld = first_ok ? (first_v ? ldv : ldu) : 0;
  const float* const first_src =
      first_ok ? (first_v ? Vp : Up) + (r0 + lane_r) * first_ld + first_gcol : Vp;
  const int first_width = first_v ? bm : bn;
  const int first_dst = (first_v ? 0 : bk * bm) + first_col + lane_r * first_width;
  const int first_bytes = first_ok ? 4 * W : 0;

  auto load = [&](int chunk, int s) {
    if (lane_r >= row_lanes) return;
    float* const sV = smem + s * stage;
    const int64_t row0 = r0 + (int64_t)chunk * bk + lane_r;
    if (one_col) {
      const float* src = first_src + (int64_t)chunk * bk * first_ld;
      float* dst = sV + first_dst;
      if (r0 + (int64_t)(chunk + 1) * bk <= r1) {
#pragma unroll 4
        for (int r = lane_r; r < bk; r += row_lanes) {
          cp_async<W>(dst, src, first_bytes);
          src += row_lanes * first_ld;
          dst += row_lanes * first_width;
        }
      } else {
        int64_t row = row0;
        for (int r = lane_r; r < bk; r += row_lanes) {
          const bool ok = row < r1;
          cp_async<W>(dst, ok ? src : Vp, ok ? first_bytes : 0);
          row += row_lanes;
          src += row_lanes * first_ld;
          dst += row_lanes * first_width;
        }
      }
      return;
    }
    for (int c = lane_c; c < vpr; c += col_lanes) {
      const bool is_v = c < vm;
      const int col = (is_v ? c : c - vm) * W;
      const int gcol = (is_v ? c0m : c0n) + col;
      const bool col_ok = gcol < (is_v ? kv : ku);
      const int64_t ld = is_v ? ldv : ldu;
      const int width = is_v ? bm : bn;
      const float* src = (is_v ? Vp : Up) + row0 * ld + gcol;
      float* dst = sV + (is_v ? 0 : bk * bm) + col + lane_r * width;
      int64_t row = row0;
      for (int r = lane_r; r < bk; r += row_lanes) {
        const bool ok = col_ok && row < r1;
        cp_async<W>(dst, ok ? src : Vp, ok ? 4 * W : 0);
        row += row_lanes;
        src += row_lanes * ld;
        dst += row_lanes * width;
      }
    }
  };

  float acc[T][T];
#pragma unroll
  for (int p = 0; p < T; ++p)
#pragma unroll
    for (int q = 0; q < T; ++q) acc[p][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  const int off_v = g * bm + tm * 4, off_u = g * bn + tn * 4;
  const int step_v = G * bm, step_u = G * bn;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = c + kStages - 1;
    if (nxt < chunks) load(nxt, nxt % kStages);
    cp_async_commit();

    const float* sV = smem + (c % kStages) * stage + off_v;
    const float* sU = smem + (c % kStages) * stage + bk * bm + off_u;
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const float4 a0 = *reinterpret_cast<const float4*>(sV + i * step_v);
      const float4 a1 = *reinterpret_cast<const float4*>(sV + i * step_v + hm);
      const float4 b0 = *reinterpret_cast<const float4*>(sU + i * step_u);
      const float4 b1 = *reinterpret_cast<const float4*>(sU + i * step_u + hn);
      const float x[T] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[T] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      // Rows of the tile in turn, the columns of every other row in
      // reverse (measured: the FFMA stream issued 5-10% faster than in
      // row order).
#pragma unroll
      for (int p = 0; p < T; ++p)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const int q = (p & 1) ? T - 1 - j : j;
          acc[p][q] = fmaf(x[p], y[q], acc[p][q]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (G > 1) {
    // The groups' tiles summed as a tree, in a fixed order: at step s,
    // group g + s hands its tile to group g (g a multiple of 2 s) through
    // its slot of shared memory (output (p, q) of thread w of group h at
    // [(h - 1) T T + T p + q] * per_group + w).
    for (int step = 1; step < G; step *= 2) {
      if (g % (2 * step) == step) {
        float* dst = smem + (g - 1) * T * T * per_group + w;
#pragma unroll
        for (int p = 0; p < T; ++p)
#pragma unroll
          for (int q = 0; q < T; ++q) dst[(T * p + q) * per_group] = acc[p][q];
      }
      __syncthreads();
      if (g % (2 * step) == 0 && g + step < G) {
        const float* src = smem + (g + step - 1) * T * T * per_group + w;
#pragma unroll
        for (int p = 0; p < T; ++p)
#pragma unroll
          for (int q = 0; q < T; ++q) acc[p][q] += src[(T * p + q) * per_group];
      }
    }
  }
  if (g != 0) return;
  float* out = a.partial + (int64_t)blockIdx.x * kv * ku;
#pragma unroll
  for (int p = 0; p < T; ++p) {
    const int m = c0m + tm * 4 + (p & 3) + (p >> 2) * hm;
    if (m >= kv) continue;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int col = c0n + tn * 4 + (q & 3) + (q >> 2) * hn;
      if (col < ku) out[(int64_t)m * ku + col] = acc[p][q];
    }
  }
}

// G[o] = sum over the slabs of partial[slab, o], o < count: lane y of
// the block sums slabs y, y + kReduceLanes, ... in order; the lanes' sums
// are added as a tree (lane y + s into lane y, s = kReduceLanes / 2, ...,
// 1).
__global__ void lobpcg_gram_sgemm_reduce_kernel(const float* __restrict__ partial,
                                                float* __restrict__ G, int64_t slabs,
                                                int64_t count) {
  __shared__ float sums[kReduceLanes][32];
  const int64_t o = (int64_t)blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (o < count)
    for (int64_t p = threadIdx.y; p < slabs; p += kReduceLanes) s += partial[p * count + o];
  sums[threadIdx.y][threadIdx.x] = s;
  for (int step = kReduceLanes / 2; step > 0; step /= 2) {
    __syncthreads();
    if (threadIdx.y < step) {
      s += sums[threadIdx.y + step][threadIdx.x];
      sums[threadIdx.y][threadIdx.x] = s;
    }
  }
  if (threadIdx.y == 0 && o < count) G[o] = s;
}

using Kernel = void (*)(Args);

Kernel pick(int64_t w, int64_t rpg, int64_t hm, int64_t hn, int64_t groups) {
  // The solves' widths: k 164 (4M x 150) and k 64 (4M x 56).
  if (w == 4 && rpg == 16 && hm == 84 && hn == 84 && groups == 1)
    return lobpcg_gram_sgemm_kernel<4, 16, 84, 84, 1>;
  if (w == 4 && rpg == 16 && hm == 32 && hn == 32 && groups == 1)
    return lobpcg_gram_sgemm_kernel<4, 16, 32, 32, 1>;
#define LOBPCG_GRAM_PICK(W, R) \
  if (w == W && rpg == R) return lobpcg_gram_sgemm_kernel<W, R>;
  LOBPCG_GRAM_PICK(4, 16) LOBPCG_GRAM_PICK(4, 8) LOBPCG_GRAM_PICK(4, 4)
  LOBPCG_GRAM_PICK(2, 16) LOBPCG_GRAM_PICK(2, 8) LOBPCG_GRAM_PICK(2, 4)
  LOBPCG_GRAM_PICK(1, 16) LOBPCG_GRAM_PICK(1, 8) LOBPCG_GRAM_PICK(1, 4)
#undef LOBPCG_GRAM_PICK
  return nullptr;
}

bool aligned(const void* p, int64_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes) == 0;
}

// Threads of a block, and its shared memory: the stages, or the groups'
// tiles, the larger.
int64_t block_threads(int64_t hm, int64_t hn, int64_t groups) {
  return groups * (hm / 4) * (hn / 4);
}

int64_t smem_bytes(int64_t hm, int64_t hn, int64_t groups, int64_t rpg) {
  const int64_t stages = (int64_t)kStages * rpg * groups * 2 * (hm + hn) * 4;
  const int64_t tiles = (groups - 1) * (hm / 4) * (hn / 4) * 64 * 4;
  return stages > tiles ? stages : tiles;
}

bool plan_ok(int64_t hm, int64_t hn, int64_t groups, int64_t rpg) {
  return hm >= 4 && hn >= 4 && hm % 4 == 0 && hn % 4 == 0 && groups >= 1 &&
         block_threads(hm, hn, groups) <= kMaxThreads &&
         smem_bytes(hm, hn, groups, rpg) <= kMaxSmem;
}

}  // namespace

extern "C" {

// Shared memory bytes and blocks an SM holds at once for that plan;
// written to out[0] and out[1] (int64).
int lobpcg_gram_sgemm_occupancy(int64_t hm, int64_t hn, int64_t groups, int64_t rpg,
                                int64_t w, void* out) {
  const Kernel fn = pick(w, rpg, hm, hn, groups);
  if (fn == nullptr || !plan_ok(hm, hn, groups, rpg)) return (int)cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(hm, hn, groups, rpg);
  cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                    (int)block_threads(hm, hn, groups),
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  int64_t* res = static_cast<int64_t*>(out);
  res[0] = smem;
  res[1] = blocks;
  return 0;
}

// G [kv, ku] (contiguous) = V^T U, V [n, kv] at V + r ldv + j, U [n, ku]
// at U + r ldu + j (f32, column stride 1); partial: slabs * kv * ku
// floats of scratch.  Slab s holds rows [s rows, (s + 1) rows) (slabs *
// rows >= n); a tile is 2 hm x 2 hn, tiles_m x tiles_n of them cover G; a
// block runs `groups` copies of a tile's hm / 4 x hn / 4 threads, each
// taking rpg rows of a stage; w: floats a copy moves (4, 2 or 1),
// dividing ldv, ldu, kv, ku and the bases.  Returns cudaGetLastError()
// after the two launches (0 = ok), or cudaErrorInvalidValue for a plan
// the kernel does not take.
int lobpcg_gram_sgemm_f32(const void* V, int64_t ldv, const void* U, int64_t ldu,
                          void* partial, void* G, int64_t n, int64_t kv, int64_t ku,
                          int64_t rows, int64_t slabs, int64_t hm, int64_t hn,
                          int64_t tiles_m, int64_t tiles_n, int64_t groups, int64_t rpg,
                          int64_t w, void* stream) {
  const Kernel fn = pick(w, rpg, hm, hn, groups);
  if (fn == nullptr || !plan_ok(hm, hn, groups, rpg) || n < 1 || kv < 1 || ku < 1 ||
      rows < 1 || slabs < 1 || tiles_m < 1 || tiles_n < 1 || tiles_m * 2 * hm < kv ||
      tiles_n * 2 * hn < ku || slabs * rows < n || (slabs - 1) * rows >= n ||
      slabs > INT32_MAX || tiles_m * tiles_n > 65535 || ldv < 1 || ldu < 1 || ldv % w ||
      ldu % w || kv % w || ku % w || !aligned(V, 4 * w) || !aligned(U, 4 * w))
    return (int)cudaErrorInvalidValue;
  const int64_t threads = block_threads(hm, hn, groups);
  const int64_t smem = smem_bytes(hm, hn, groups, rpg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute((const void*)fn,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.V = static_cast<const float*>(V);
  a.U = static_cast<const float*>(U);
  a.partial = static_cast<float*>(partial);
  a.ldv = ldv;
  a.ldu = ldu;
  a.n = n;
  a.rows = rows;
  a.kv = (int)kv;
  a.ku = (int)ku;
  a.hm = (int)hm;
  a.hn = (int)hn;
  a.tiles_n = (int)tiles_n;
  a.groups = (int)groups;
  void* params[] = {&a};
  e = cudaLaunchKernel((const void*)fn, dim3((unsigned)slabs, (unsigned)(tiles_m * tiles_n)),
                       dim3((unsigned)threads), params, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  const int64_t count = kv * ku;
  lobpcg_gram_sgemm_reduce_kernel<<<(unsigned)((count + 31) / 32), dim3(32, kReduceLanes), 0,
                                    s>>>(static_cast<const float*>(partial),
                                         static_cast<float*>(G), slabs, count);
  return (int)cudaGetLastError();
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
