// The k x k stage of the standard Rayleigh-Ritz's Cholesky branch in
// float64 for Hopper (sm_90a): from the Grams GA = S^H A S and GB = S^H B
// S over S = [X | P | W] (k = 3 m columns at most kMaxK, f32 or f64) and
// the live counts of P and W, to the Ritz coefficients Cx, the momentum
// coefficients Cp, the Ritz values and the retry flag: one thread block a
// problem, the whole stage in shared memory, one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the stage to XLA
// (lobpcg_tpu/ops/rayleigh.py rayleigh_ritz_modified, its Cholesky
// branch), whose small ops and eigh it fuses and runs on the TPU.  The
// port ran it as PyTorch's ops (ops/cuda/rr.py: cholesky_stage_reference):
// some 175 launches of k x k elementwise, cat, where and mm, three
// cuSOLVER eigh, each of which reads its status back to the host, and a
// QR.  Each launch is microseconds of work behind 5-15 us of host; the
// device waits on the host through the whole stage.
//
// Bound: the k x k float64 work (the products of H = DiR^T GA DiR, Cx,
// Cp, three symmetric eigensolves at 9 n^3 flops) against one SM's share
// of the card's 34 TFLOP/s of float64: 8 us at k 48 (chip_smoke.py:
// rr_flops).  Measured 0.55 ms there (H100, 700 W): a Jacobi sweep is n - 1
// rounds, each a chain of shared-memory loads, the Gram's shuffles, two
// float64 rsqrt and a barrier (~1,700 cycles), and the three eigensolves
// take ~560 rounds; the latency, not the arithmetic, bounds it.
//
// Design.  The block holds three k x k float64 matrices (B1, B2, B3, a
// pitch of k | 1 doubles a row) and a few vectors in shared memory; kMaxK
// is the widest multiple of 3 for which they fit 227 KB.  Its steps are
// the plain version's, each in float64 (the plain version takes float32
// products at the solver's widths and float64 eigh):
//   1. the live mask from the counts (X all live, P's first np, W's
//      first nw), read from the device per problem or passed as numbers;
//   2. GB with 1 on its dead diagonal (B1);
//   3. the whitening DiR (B3) of GB over [X | P W]: Jacobi-scaled X block,
//      its eigensolve, Fx = D U s^-1/2; E = Fx^T G_xp; the Schur
//      complement G_pp - E^T E, symmetrized, whitened as Fs; DiR =
//      [Fx, -Fx (E Fs); 0, Fs]; def_ok and rcond from the two spectra;
//   4. DiR = I where def_ok fails; GA with 0 on its dead diagonal (B1),
//      H = DiR^T (GA DiR), symmetrized;
//   5. big = 2 max_i sum_j |H_ij| + 1, H + big K^T K over DiR's dead rows;
//   6. the eigensolve of H, ascending;
//   7. Cx = DiR Z[:, :nx], the Ritz values; Cp = DiR Zp Q masked to
//      p_count, Q from a Householder QR of Z1p^T over the live unwanted
//      columns, LAPACK's geqr2 and org2r (beta = -sign(alpha) ||x||, tau
//      0 for a zero x) so that Cp's columns are the plain version's up to
//      rounding; the flag ok = def_ok and rcond >= tol_skip.
// Each eigensolve keeps eigh's contract (ops/cuda/linalg.py): a
// non-finite matrix gives NaN values and vectors, a finite one is
// symmetrized first.
//
// The eigensolver is one-sided (Hestenes) cyclic Jacobi in round-robin
// order on A + sigma I (sigma >= 0 the least Gershgorin shift that makes
// it positive semidefinite): n/2 disjoint column pairs a round (the circle
// method, n - 1 rounds a sweep, an idle player for odd n), kGroup lanes a
// pair.  A group holds its two columns of U in registers, sums their Gram
// [alpha, gamma; gamma, beta] by shuffles, and rotates U's and V's two
// columns when |gamma| > n eps sqrt(alpha beta) (a tighter test never
// stops: gamma's own rounding is n eps); no other thread touches them,
// so a round needs one block-wide barrier.  Before each sweep one pass
// tests every pair at once (a thread a pair, at 3 n eps); the solve ends
// when none is open (at most kMaxSweeps sweeps); each eigenvalue is its
// vector's Rayleigh quotient.
// Sums and reductions run in a fixed order: a launch repeats bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;   // ops/cuda/rr.py:THREADS
constexpr int kMaxK = 96;       // ops/cuda/rr.py:MAX_K
constexpr int kMaxSweeps = 30;  // ops/cuda/rr.py:MAX_SWEEPS
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;  // lanes of a column pair (a warp runs two pairs)
constexpr int kRows = (kMaxK + kGroup - 1) / kGroup;  // rows a lane holds
constexpr int kScalars = 8;
constexpr int kMaxSmem = 227 * 1024;

// Doubles a row of a k x k matrix: odd, so a column's entries spread
// over the banks.
__host__ __device__ inline int pitch(int k) { return k | 1; }

__host__ __device__ inline int64_t smem_bytes(int k) {
  return 8 * (3 * (int64_t)k * pitch(k) + 4 * (int64_t)k + kWarps + kScalars) + 4 * (int64_t)k;
}

struct Smem {
  double *B1, *B2, *B3;  // k x pitch(k) each
  double *d, *w, *tau, *wv;  // k each: scaling, eigenvalues, QR's tau, sums
  double *red;           // kWarps partial reductions
  double *sc;            // kScalars: the whitenings' ok, s_lo, s_hi
  int *perm;             // k: the vector of the r-th eigenvalue
};

__device__ __forceinline__ Smem carve(double* base, int k) {
  const int ld = pitch(k);
  Smem s;
  s.B1 = base;
  s.B2 = s.B1 + k * ld;
  s.B3 = s.B2 + k * ld;
  s.d = s.B3 + k * ld;
  s.w = s.d + k;
  s.tau = s.w + k;
  s.wv = s.tau + k;
  s.red = s.wv + k;
  s.sc = s.red + kWarps;
  s.perm = reinterpret_cast<int*>(s.sc + kScalars);
  return s;
}

struct Args {
  const void* GA;  // [batch, k, k], double where gram_f64, else float
  const void* GB;
  const int64_t* np_ptr;  // per problem on the device, or null: np
  const int64_t* nw_ptr;
  int64_t np, nw;
  double tol_skip;
  void* Cx;  // [batch, k, nx], double where out_f64, else float
  void* Cp;  // [batch, k, nx]
  void* lam;  // [batch, nx], the Grams' type
  unsigned char* ok;  // [batch]
  int k, nx;
  int gram_f64, out_f64;  // the Grams' and lam's type; Cx's and Cp's
};

__device__ __forceinline__ double nanmax(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// The largest v over the block, NaN if any is NaN.
__device__ __forceinline__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double m = red[0];
  for (int i = 1; i < kWarps; ++i) m = nanmax(m, red[i]);
  return m;
}

// put(i, j, sum_l a(i, l) b(l, j)) for the M x N outputs, one FMA chain
// each in l order; a thread runs four outputs of a row (columns j, j + Q,
// j + 2 Q, j + 3 Q) at once.  The caller synchronises.
template <class FA, class FB, class FS>
__device__ __forceinline__ void product(int M, int N, int K, FA a, FB b, FS put) {
  const int Q = (N + 3) / 4;
  for (int e = threadIdx.x; e < M * Q; e += kThreads) {
    const int i = e / Q, j = e - i * Q;
    const bool h1 = j + Q < N, h2 = j + 2 * Q < N, h3 = j + 3 * Q < N;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
    for (int l = 0; l < K; ++l) {
      const double x = a(i, l);
      s0 = fma(x, b(l, j), s0);
      if (h1) s1 = fma(x, b(l, j + Q), s1);
      if (h2) s2 = fma(x, b(l, j + 2 * Q), s2);
      if (h3) s3 = fma(x, b(l, j + 3 * Q), s3);
    }
    put(i, j, s0);
    if (h1) put(i, j + Q, s1);
    if (h2) put(i, j + 2 * Q, s2);
    if (h3) put(i, j + 3 * Q, s3);
  }
}

// A <- (A + A^T) / 2 for the n x n matrix at A (row pitch ld).
__device__ __forceinline__ void symmetrize(double* A, int ld, int n) {
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    if (i < j) {
      const double x = 0.5 * (A[i * ld + j] + A[j * ld + i]);
      A[i * ld + j] = x;
      A[j * ld + i] = x;
    }
  }
  __syncthreads();
}

// The player at position pos (>= 1) of round r: the circle method, player
// 0 fixed at position 0, the others turning.
__device__ __forceinline__ int player(int pos, int r, int N) {
  int x = pos - 1 + r;
  if (x >= N - 1) x -= N - 1;
  return x + 1;
}

// Is any column pair of U (n columns, a column to a row at U, pitch ld)
// short of orthogonal: gamma_ij^2 > tol2 alpha_i alpha_j for some i < j,
// gamma the columns' dot product, alpha their squared norms?  One
// thread a pair, all pairs at once.
__device__ __forceinline__ bool open_pairs(const double* U, int ld, int n, double tol2) {
  bool open = false;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    if (i < j) {
      double a = 0.0, b = 0.0, g = 0.0;
      for (int l = 0; l < n; ++l) {
        const double x = U[i * ld + l], y = U[j * ld + l];
        a = fma(x, x, a);
        b = fma(y, y, b);
        g = fma(x, y, g);
      }
      open |= g * g > tol2 * a * b;
    }
  }
  return __syncthreads_or(open) != 0;
}

// The sums over a group's kGroup lanes of a, b and c, every lane getting
// them: the four values (a, b, c, 0) folded in two exchanges to one a lane
// (the group's two top lane bits pick which), summed over the rest, then
// broadcast: log2(kGroup) + 3 shuffles where three plain butterflies take
// 3 log2(kGroup).
__device__ __forceinline__ void group_sums(double& a, double& b, double& c) {
  static_assert(kGroup >= 4 && (kGroup & (kGroup - 1)) == 0, "a power of 2 >= 4");
  constexpr int H = kGroup / 2, Q = kGroup / 4;
  const int lane = threadIdx.x & 31;
  const bool hiH = lane & H, hiQ = lane & Q;
  double x0 = hiH ? c : a, x1 = hiH ? 0.0 : b;
  const double y0 = hiH ? a : c, y1 = hiH ? b : 0.0;
  x0 += __shfl_xor_sync(0xffffffffu, y0, H);
  x1 += __shfl_xor_sync(0xffffffffu, y1, H);
  double z = hiQ ? x1 : x0;
  z += __shfl_xor_sync(0xffffffffu, hiQ ? x0 : x1, Q);
  for (int o = Q / 2; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
  const int base = lane & ~(kGroup - 1);
  a = __shfl_sync(0xffffffffu, z, base);
  b = __shfl_sync(0xffffffffu, z, base + Q);
  c = __shfl_sync(0xffffffffu, z, base + H);
}

// One sweep of round-robin rounds over U and V's n columns (a column to a
// row, pitch ld), a group of kGroup lanes a pair, R rows of a column a
// lane (R kGroup >= n).
template <int R>
__device__ __forceinline__ void sweep(double* U, int ld, double* V, int n, double tol2) {
  const int N = n + (n & 1), np = N / 2, lane = threadIdx.x % kGroup;
  constexpr int per_warp = 32 / kGroup;
  for (int r = 0; r < N - 1; ++r) {
    // Whole warps take part in the shuffles, a group past the last pair
    // with zeros.
    for (int w = threadIdx.x / 32; w * per_warp < np; w += kWarps) {
      const int t = w * per_warp + (threadIdx.x % 32) / kGroup;
      int p = 0, q = n;
      if (t < np) {
        const int a = t == 0 ? 0 : player(t, r, N), b = player(N - 1 - t, r, N);
        p = min(a, b);
        q = max(a, b);
      }
      const bool pair = q < n;  // not past the last pair, not the idle player
      double up[R], uq[R], alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = lane + kGroup * m;
        up[m] = pair && i < n ? U[p * ld + i] : 0.0;
        uq[m] = pair && i < n ? U[q * ld + i] : 0.0;
        alpha = fma(up[m], up[m], alpha);
        beta = fma(uq[m], uq[m], beta);
        gamma = fma(up[m], uq[m], gamma);
      }
      group_sums(alpha, beta, gamma);
      if (!pair || !(gamma * gamma > tol2 * alpha * beta)) continue;
      // The rotation that diagonalises the columns' Gram [alpha, gamma;
      // gamma, beta] by the smaller angle, by two rsqrt and no division:
      // with d = beta - alpha, h = 1 / sqrt(d^2 + 4 gamma^2), u = (1 + |d|
      // h) / 2 = cos^2, g = 1 / sqrt(u): c = u g, s = sign(d) gamma h g.
      const double d = beta - alpha;
      const double h = rsqrt(fma(d, d, 4.0 * gamma * gamma));
      const double u = fma(0.5 * fabs(d), h, 0.5);
      const double g = rsqrt(u);
      const double c = u * g, sn = copysign(1.0, d) * gamma * h * g;
      double vp[R], vq[R];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = lane + kGroup * m;
        vp[m] = i < n ? V[p * ld + i] : 0.0;
        vq[m] = i < n ? V[q * ld + i] : 0.0;
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = lane + kGroup * m;
        if (i < n) {
          U[p * ld + i] = c * up[m] - sn * uq[m];
          U[q * ld + i] = sn * up[m] + c * uq[m];
          V[p * ld + i] = c * vp[m] - sn * vq[m];
          V[q * ld + i] = sn * vp[m] + c * vq[m];
        }
      }
    }
    __syncthreads();
  }
}

// The eigendecomposition of the symmetric n x n matrix at A (pitch ld) by
// one-sided (Hestenes) cyclic Jacobi.  A + sigma I, sigma >= 0 the least
// shift that makes it diagonally dominant (so positive semidefinite), is
// orthogonalised by column rotations U <- U R, V <- V R, so that U = (A +
// sigma I) V keeps orthogonal columns at the end and V's are the
// eigenvectors.  A holds U and V the vectors, both a column to a row of
// the buffer (A is symmetric).  Leaves in s.wv each column's eigenvalue,
// its Rayleigh quotient v_j^T U_j - sigma.
__device__ __forceinline__ void jacobi(double* A, int ld, double* V, int n, Smem& s) {
  double low = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double off = 0.0;
    for (int j = 0; j < n; ++j) off += j == i ? 0.0 : fabs(A[i * ld + j]);
    low = fmax(low, off - A[i * ld + i]);
  }
  const double sigma = block_max(low, s.red);
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    V[i * ld + j] = i == j ? 1.0 : 0.0;
    if (i == j) A[i * ld + i] += sigma;
  }
  __syncthreads();
  // A pair is orthogonal when |gamma| <= n eps sqrt(alpha beta): the
  // rounding of an n-term dot product, below which gamma is noise.
  // The pass before a sweep asks 3 n eps, so that each pair it finds open
  // passes the sweep's own test whatever the two sums' rounding.
  const double tol2 = (double)n * n * DBL_EPSILON * DBL_EPSILON;
  for (int sw = 0; sw < kMaxSweeps && open_pairs(A, ld, n, 9.0 * tol2); ++sw) {
    // Rows a lane holds, by size class: 16, 32 and 48 columns, then kMaxK.
    if (n <= 16) sweep<(16 + kGroup - 1) / kGroup>(A, ld, V, n, tol2);
    else if (n <= 32) sweep<(32 + kGroup - 1) / kGroup>(A, ld, V, n, tol2);
    else if (n <= 48) sweep<(48 + kGroup - 1) / kGroup>(A, ld, V, n, tol2);
    else sweep<kRows>(A, ld, V, n, tol2);
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    double x = 0.0;
    for (int i = 0; i < n; ++i) x = fma(V[j * ld + i], A[j * ld + i], x);
    s.wv[j] = x - sigma;
  }
  __syncthreads();
}

// eigh's contract for the n x n matrix at A (pitch ld): a non-finite A
// gives NaN values and vectors; a finite one is symmetrized and solved.
// Leaves the values ascending in s.w, the r-th one's vector at row
// s.perm[r] of V (pitch ld); A is destroyed.  Not inlined: one copy for
// its three calls (the code 27% smaller, no slower on the card).
__device__ __noinline__ void eigh(double* A, int ld, double* V, int n, Smem& s) {
  bool bad = false;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    bad |= !isfinite(A[i * ld + j]);
  }
  if (__syncthreads_or(bad)) {
    for (int e = threadIdx.x; e < n * n; e += kThreads) {
      const int i = e / n, j = e - i * n;
      V[i * ld + j] = NAN;
    }
    for (int j = threadIdx.x; j < n; j += kThreads) {
      s.w[j] = NAN;
      s.perm[j] = j;
    }
    __syncthreads();
    return;
  }
  symmetrize(A, ld, n);
  jacobi(A, ld, V, n, s);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const double x = s.wv[j];
    int r = 0;
    for (int i = 0; i < n; ++i) {
      const double y = s.wv[i];
      r += (y < x) || (y == x && i < j);
    }
    s.w[r] = x;
    s.perm[r] = j;
  }
  __syncthreads();
}

// The spectral whitening of the Hermitian n x n block at G (pitch ld,
// destroyed): F = D U s^-1/2 at F (pitch ld), D the guarded Jacobi
// scaling, U s U^T = D G D; out[0..2] = ok (s finite, s_min > 0, s_max >
// 0), s_safe[0], s_safe[n - 1] (s_safe: s where positive, else 1).
__device__ __forceinline__ void whiten(double* G, int ld, int n, double* V, double* F, double* out, Smem& s) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const double g = fabs(G[j * ld + j]);
    s.d[j] = g > 0.0 ? 1.0 / sqrt(g) : 1.0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    G[i * ld + j] = (s.d[i] * G[i * ld + j]) * s.d[j];
  }
  __syncthreads();
  eigh(G, ld, V, n, s);
  if (threadIdx.x == 0) {
    const double lo = s.w[0], hi = s.w[n - 1];
    out[0] = isfinite(lo) && lo > 0.0 && hi > 0.0 ? 1.0 : 0.0;
    out[1] = lo > 0.0 ? lo : 1.0;
    out[2] = hi > 0.0 ? hi : 1.0;
  }
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, r = e - i * n;
    const double sr = s.w[r] > 0.0 ? s.w[r] : 1.0;
    F[i * ld + r] = (s.d[i] * V[s.perm[r] * ld + i]) * (1.0 / sqrt(sr));
  }
  __syncthreads();
}

// v^T A[j:m, c] for each column c in (j, n), v = (1, A[j+1:m, j]): a
// warp a column, its lanes over the rows, into s.wv[c].
__device__ __forceinline__ void reflector_dots(const double* A, int ld, int m, int n, int j, Smem& s) {
  const int lane = threadIdx.x & 31;
  for (int c = j + 1 + (threadIdx.x >> 5); c < n; c += kWarps) {
    double w = 0.0;
    for (int i = j + lane; i < m; i += 32)
      w = fma(i == j ? 1.0 : A[i * ld + j], A[i * ld + c], w);
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    if (lane == 0) s.wv[c] = w;
  }
  __syncthreads();
}

// A[j:m, c] -= t v w_c for c in (j, n): H_j = I - t v v^T from the left.
__device__ __forceinline__ void reflect(double* A, int ld, int m, int n, int j, double t, const Smem& s) {
  const int cols = n - j - 1;
  for (int e = threadIdx.x; e < (m - j) * cols; e += kThreads) {
    const int i = j + e / cols, c = j + 1 + e % cols;
    const double v = i == j ? 1.0 : A[i * ld + j];
    A[i * ld + c] = fma(v, -t * s.wv[c], A[i * ld + c]);
  }
  __syncthreads();
}

// LAPACK's dgeqr2 on the m x n matrix at A (pitch ld), m >= n: R on and
// above the diagonal, each reflector's v below it (v_j = 1 implied), tau;
// dlarfg's beta = -sign(alpha) ||(alpha, x)||, tau 0 where x is 0.
__device__ __forceinline__ void geqr2(double* A, int ld, int m, int n, Smem& s) {
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x < 32) {  // one warp: ||x||, beta, tau, v = x / (alpha - beta)
      const int lane = threadIdx.x;
      double part = 0.0;
      for (int i = j + 1 + lane; i < m; i += 32) part = fma(A[i * ld + j], A[i * ld + j], part);
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      const double alpha = A[j * ld + j];
      __syncwarp();
      double t = 0.0;
      if (part != 0.0) {
        const double beta = -copysign(sqrt(fma(alpha, alpha, part)), alpha);
        const double scale = 1.0 / (alpha - beta);
        t = (beta - alpha) / beta;
        for (int i = j + 1 + lane; i < m; i += 32) A[i * ld + j] *= scale;
        if (lane == 0) A[j * ld + j] = beta;
      }
      if (lane == 0) s.tau[j] = t;
    }
    __syncthreads();
    const double t = s.tau[j];
    if (t != 0.0 && j < n - 1) {
      reflector_dots(A, ld, m, n, j, s);
      reflect(A, ld, m, n, j, t, s);
    }
  }
}

// LAPACK's dorg2r: the m x n Q at A (pitch ld) in place from geqr2's
// reflectors, the last first.
__device__ __forceinline__ void org2r(double* A, int ld, int m, int n, Smem& s) {
  for (int j = n - 1; j >= 0; --j) {
    const double t = s.tau[j];
    if (t != 0.0 && j < n - 1) {
      reflector_dots(A, ld, m, n, j, s);
      reflect(A, ld, m, n, j, t, s);
    }
    for (int i = j + 1 + threadIdx.x; i < m; i += kThreads) A[i * ld + j] *= -t;
    for (int i = threadIdx.x; i < j; i += kThreads) A[i * ld + j] = 0.0;
    if (threadIdx.x == 0) A[j * ld + j] = 1.0 - t;
    __syncthreads();
  }
}

// Element e of a float or double array.
__device__ __forceinline__ double load(const void* p, int64_t e, bool f64) {
  return f64 ? static_cast<const double*>(p)[e] : static_cast<const float*>(p)[e];
}

__device__ __forceinline__ void store(void* p, int64_t e, bool f64, double v) {
  if (f64)
    static_cast<double*>(p)[e] = v;
  else
    static_cast<float*>(p)[e] = static_cast<float>(v);
}

// One problem a block: GA, GB [k, k] to Cx, Cp [k, nx], lam [nx], ok.
__global__ void __launch_bounds__(kThreads, 1) lobpcg_rr_jacobi_kernel(const Args a) {
  extern __shared__ double smem[];
  const int k = a.k, nx = a.nx, nr = k - nx, ld = pitch(k);
  Smem s = carve(smem, k);
  double *B1 = s.B1, *B2 = s.B2, *B3 = s.B3;
  const int64_t b = blockIdx.x, g0 = b * k * k;
  const bool gf = a.gram_f64 != 0, of = a.out_f64 != 0;
  const int64_t np = a.np_ptr != nullptr ? a.np_ptr[b] : a.np;
  const int64_t nw = a.nw_ptr != nullptr ? a.nw_ptr[b] : a.nw;
  // The mask of blocks (nx, nx, k - 2 nx) with counts (nx, np, nw).
  auto live = [&](int j) {
    return j < nx || (j < 2 * nx ? j - nx < np : j - 2 * nx < nw);
  };
  const int64_t above = nx + np + nw - nx;  // n_live - nx
  const int64_t zp_live = above < 0 ? 0 : above > nr ? nr : above;
  const int64_t p_count = above < 0 ? 0 : above > nx ? nx : above;

  // GB, 1 on the dead diagonal (inject_diag: G * keep + 1 * dead).
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k, j = e - i * k;
    const double keep = live(i) && live(j) ? 1.0 : 0.0;
    const double dead = i == j && !live(i) ? 1.0 : 0.0;
    B1[i * ld + j] = load(a.GB, g0 + e, gf) * keep + dead;
  }
  __syncthreads();

  // The whitening DiR (B3): Fx, E, the Schur complement, Fs.
  whiten(B1, ld, nx, B2, B3, s.sc, s);
  product(
      nx, nr, nx, [&](int i, int l) { return B3[l * ld + i]; },
      [&](int l, int j) { return B1[l * ld + nx + j]; },
      [&](int i, int j, double v) { B3[i * ld + nx + j] = v; });
  __syncthreads();
  product(
      nr, nr, nx, [&](int i, int l) { return B3[l * ld + nx + i]; },
      [&](int l, int j) { return B3[l * ld + nx + j]; },
      [&](int i, int j, double v) {
        double* g = &B1[(nx + i) * ld + nx + j];
        *g = *g - v;
      });
  __syncthreads();
  symmetrize(B1 + nx * ld + nx, ld, nr);
  whiten(B1 + nx * ld + nx, ld, nr, B2, B3 + nx * ld + nx, s.sc + 3, s);
  product(
      nx, nr, nr, [&](int i, int l) { return B3[i * ld + nx + l]; },
      [&](int l, int j) { return B3[(nx + l) * ld + nx + j]; },
      [&](int i, int j, double v) { B2[i * ld + j] = v; });
  __syncthreads();
  product(
      nx, nr, nx, [&](int i, int l) { return B3[i * ld + l]; },
      [&](int l, int j) { return B2[l * ld + j]; },
      [&](int i, int j, double v) { B3[i * ld + nx + j] = -v; });
  for (int e = threadIdx.x; e < nr * nx; e += kThreads) {
    const int i = e / nx, j = e - i * nx;
    B3[(nx + i) * ld + j] = 0.0;
  }
  __syncthreads();
  const bool def_ok = s.sc[0] != 0.0 && s.sc[3] != 0.0;
  const double rcond = def_ok ? sqrt(fmin(s.sc[1], s.sc[4]) / fmax(s.sc[2], s.sc[5])) : 0.0;
  const bool ok = def_ok && rcond >= a.tol_skip;
  if (!def_ok) {
    for (int e = threadIdx.x; e < k * k; e += kThreads) {
      const int i = e / k, j = e - i * k;
      B3[i * ld + j] = i == j ? 1.0 : 0.0;
    }
  }

  // GA, 0 on the dead diagonal (B1); H = DiR^T (GA DiR), symmetrized.
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k, j = e - i * k;
    const double keep = live(i) && live(j) ? 1.0 : 0.0;
    const double dead = i == j && !live(i) ? 1.0 : 0.0;
    B1[i * ld + j] = load(a.GA, g0 + e, gf) * keep + 0.0 * dead;
  }
  __syncthreads();
  product(
      k, k, k, [&](int i, int l) { return B1[i * ld + l]; },
      [&](int l, int j) { return B3[l * ld + j]; },
      [&](int i, int j, double v) { B2[i * ld + j] = v; });
  __syncthreads();
  product(
      k, k, k, [&](int i, int l) { return B3[l * ld + i]; },
      [&](int l, int j) { return B2[l * ld + j]; },
      [&](int i, int j, double v) { B1[i * ld + j] = v; });
  __syncthreads();
  symmetrize(B1, ld, k);

  // The dead-row sentinels: H + big K^T K, big a Gershgorin bound.
  double row = 0.0;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    double r = 0.0;
    for (int j = 0; j < k; ++j) r += fabs(B1[i * ld + j]);
    row = nanmax(row, r);
  }
  const double big = 2.0 * block_max(row, s.red) + 1.0;
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k, j = e - i * k;
    double kk = 0.0;
    for (int l = 0; l < k; ++l)
      if (!live(l)) kk = fma(B3[l * ld + i], B3[l * ld + j], kk);
    B1[i * ld + j] = fma(big, kk, B1[i * ld + j]);
  }
  __syncthreads();

  // Its eigensolve; the Ritz values and Cx = DiR Z[:, :nx].
  eigh(B1, ld, B2, k, s);
  for (int r = threadIdx.x; r < nx; r += kThreads) store(a.lam, b * nx + r, gf, s.w[r]);
  product(
      k, nx, k, [&](int i, int l) { return B3[i * ld + l]; },
      [&](int l, int r) { return B2[s.perm[r] * ld + l]; },
      [&](int i, int r, double v) { store(a.Cx, (b * k + i) * nx + r, of, v); });

  // Cp: Zp = Z[:, nx:] over its zp_live live columns, Q from the QR of
  // Zp[:nx]^T (B1, nr x nx), Zp Q (B1's columns nx..2 nx), DiR Zp Q.
  auto zp = [&](int i, int c) {
    return B2[s.perm[nx + c] * ld + i] * (c < zp_live ? 1.0 : 0.0);
  };
  for (int e = threadIdx.x; e < nr * nx; e += kThreads) {
    const int c = e / nx, i = e - c * nx;
    B1[c * ld + i] = zp(i, c);
  }
  __syncthreads();
  geqr2(B1, ld, nr, nx, s);
  org2r(B1, ld, nr, nx, s);
  product(
      k, nx, nr, zp, [&](int c, int j) { return B1[c * ld + j]; },
      [&](int i, int j, double v) { B1[i * ld + nx + j] = v; });
  __syncthreads();
  product(
      k, nx, k, [&](int i, int l) { return B3[i * ld + l]; },
      [&](int l, int j) { return B1[l * ld + nx + j]; },
      [&](int i, int j, double v) {
        store(a.Cp, (b * k + i) * nx + j, of, v * (j < p_count ? 1.0 : 0.0));
      });
  if (threadIdx.x == 0) a.ok[b] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

// The Cholesky branch's k x k stage for `batch` problems: GA, GB
// [batch, k, k] contiguous (gram_bytes 4: float, 8: double); the live
// counts of P and W per problem at np_ptr / nw_ptr (int64 on the device),
// or np_count / nw_count where the pointer is null; tol_skip the rcond
// floor.  Writes Cx, Cp [batch, k, nx] (out_bytes 4 or 8), lam [batch,
// nx] (the Grams' type) and ok [batch] (a byte).  Needs 1 <= nx, 2 nx <=
// k <= kMaxK.  Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int lobpcg_rr_jacobi_f64(const void* GA, const void* GB, int64_t gram_bytes, int64_t batch,
                         int64_t k, int64_t nx, const void* np_ptr, int64_t np_count,
                         const void* nw_ptr, int64_t nw_count, double tol_skip, void* Cx,
                         void* Cp, void* lam, void* ok, int64_t out_bytes, void* stream) {
  const void* fn = (const void*)lobpcg_rr_jacobi_kernel;
  if ((gram_bytes != 4 && gram_bytes != 8) || (out_bytes != 4 && out_bytes != 8) ||
      GA == nullptr || GB == nullptr || Cx == nullptr || Cp == nullptr || lam == nullptr ||
      ok == nullptr || batch < 1 || batch > INT32_MAX || nx < 1 || k < 2 * nx || k > kMaxK ||
      smem_bytes((int)k) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.GA = GA;
  a.GB = GB;
  a.np_ptr = static_cast<const int64_t*>(np_ptr);
  a.nw_ptr = static_cast<const int64_t*>(nw_ptr);
  a.np = np_count;
  a.nw = nw_count;
  a.tol_skip = tol_skip;
  a.Cx = Cx;
  a.Cp = Cp;
  a.lam = lam;
  a.ok = static_cast<unsigned char*>(ok);
  a.k = (int)k;
  a.nx = (int)nx;
  a.gram_f64 = gram_bytes == 8;
  a.out_f64 = out_bytes == 8;
  const int64_t smem = smem_bytes((int)k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(fn,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchKernel(fn, dim3((unsigned)batch), dim3(kThreads), params,
                       (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* lobpcg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
