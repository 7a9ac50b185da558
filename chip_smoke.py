"""GPU smoke run of lobpcg_tpu_torch: its main paths, once, on one card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and the exit code is
non-zero; there is no CPU fallback):

1. device     — requires CUDA; the card's name and power limit.
2. build      — builds the kernels (csrc/stencil1d.cu, stencil3d.cu,
                bsr.cu, copy.cu, tail.cu, gram.cu) with nvcc, one process
                per source, all at once.
3. kernel K1  — the 1-D stencil against its plain version and cuDNN's
                depthwise conv1d (lobpcg_tpu_torch/tools/
                stencil_widths.py) at the BdG solve's shapes, the
                headline gates' widths (160 and 320 columns), the
                lockstep sweeps' folded blocks ([8M, 30] and [8M, 8]
                over 16 segments, [2M, 30] and [2M, 8] over 64), a
                row-sliced X[1:] with edge rows, and f32 widths 1-129
                and bf16 widths 6, 30, 64 at ~256 MiB of X; error, ms,
                GB/s and bound of each; fails if an f32 point with X of
                64 MiB or more runs under half its bound.
   kernel fused — K1's walk with the BdG operator's diagonal
                (stencil_diag: A y of Laplacian1D + DiagonalOperator) and
                with the Chebyshev step (cheb_step: the first step, the
                last, and the degree-3 filter's two together) at [4M, 64]
                and [4M, 16] (the flagship and its Chebyshev chunk),
                [1M, 164] (the 1M x 150 solve), [8, 1M, 30] with [8]
                diagonals and bounds (the lockstep sweep), and the same
                with random edge rows [8, 2, 30] (under a row group): each
                against its plain version and the eager chain it replaces
                (K1 and PyTorch's passes) with 0 difference in f32 and
                bf16, and in f32 timed beside both and its bound.
   kernel tail — the solver's tall tail (csrc/tail.cu): antidiag (B X
                of the anti-diagonal B), residual (W = AX - B X diag(lam)),
                combine (the projection update live * (U - (t0 + t1)), and
                b_mm's sum of three GEMM outputs) and compact (shift_cols)
                at [4M, 64] (the flagship), [1M, 164] (the 1M x 150
                solve), [8, 1M, 30] with per-problem d, lam, shifts and
                counts (the lockstep sweep), [1M, 64] in f64, and [1M, 64]
                with NaN/+-Inf/-0 in every input: each launched once and
                equal to its plain version and to the eager chain it
                replaces, bit for bit; on finite inputs timed beside both
                and its bound.
   kernel gram — the tall Gram V^T U (csrc/gram.cu) at [4M, 164] and
                [4M, 64] (the 4M x 150 and 4M x 56 solves' Grams) and
                [4.1M, 16], its error against the float64 product no worse
                than torch.matmul's, then at widths 1-256 over 4M rows:
                launched once, two launches bit for bit; ms beside its
                bound, the plain version and torch.matmul, and the route
                ops/gram.py takes there.
4. kernel K7  — the streaming copy against its plain version (clone) at
                [4M, 256], [4M, 64] and an odd shape, bit for bit; ms,
                GB/s, bound, and Tensor.copy_ as the library time.
5. quickstart — README: lobpcg on Laplacian1D, n 256, f32.
6. main       — ilobpcg on the BdG quantum-well pencil of
                lobpcg_tpu_torch/benchmarks/solve_bdg.py at n 4,000,000,
                nev 56, size_sub 64, Chebyshev degree 3, f32, against its
                dense well oracle; A must go through stencil_diag, T
                through cheb_step (K1's fused forms) and each tail kernel
                must launch at least once an iteration.  Run under
                gram_precision "highest" and "high" (both TF32-free), and
                once more under "highest" through the eager chain (the
                diagonal as a ChainDiagonal, which the fused route does
                not take: K1 and PyTorch's passes; the solve inside
                tail.eager_chain(): no tail kernel): the same eigenvalues
                (torch.equal) and iterations, as many K1 launches as the
                K1 family made, a peak no higher than the chain's.
7. bench      — the SpMM headline, lobpcg_tpu_torch.bench.measure_spmm
                ([4M, 256] f32 through K1 against K7's copy roofline);
                must launch K1 and K7.
8. sub1M_150  — benchmarks.solve_bdg.solve at n 1,000,000, nev 150,
                size_sub 164, Chebyshev degree 3, tol 1e-5, f32: 150/150
                within 1e-5 of the oracle, K1 at least twice an iteration.
9. realify    — the same pencil specified in complex128 and solved
                through its split-real embedding, n 1,000,000, nev 16:
                16/16 complex pairs within 1e-5; must go through K1.
10. kernel K2  — the fused 3-D stencil against its plain version at the
                160^3 grid (k 16, 48, 128 f32; 16 bf16) and an odd grid;
                then one launch over a batch [4, 160^3, 16] (the
                lockstep_nd block) against its plain version, its 4 lone
                launches (bit for bit) and cuDNN conv3d with N 4.
11. host / kernel K3 — the 160^3 Laplacian's CSR and BSROperator (host
                seconds on their own lines); K3 on its block-ELL at k 16
                and 48, and one launch over a batch of 4 at k 16 against
                its plain version, its 4 lone launches and
                torch.sparse.mm on the block folded to [n, 64].
12. laplacian3d — standard lobpcg at the 160^3 grid (n 4,096,000), nev 10,
                size_sub 16, tol 1e-5, max_iter 2000, f32, twice from one
                X0: through
                LaplacianND (K2) and through BSROperator.from_csr (K3),
                against laplacian_nd_eigs.
    lockstep_nd — 4 problems on that grid as one lockstep lobpcg: A_p =
                the shared LaplacianND + DiagonalOperator [4, n] of the
                separable anisotropic trap c_p ((x-1/2)^2 + 1.3 (y-1/2)^2
                + 1.7 (z-1/2)^2), c_p in TRAP_C (c 0: the laplacian3d
                problem), laplacian3d's config and X0: 10/10 each within
                tol * lam_max of its separable oracle (three 1-D
                tridiagonal spectra), K2 launched once a batch apply (the
                longest problem's applies); problem 0's iterations beside
                the lone solve's, the wall beside it, the peak beside 4 x
                estimate_peak_gb and estimate_peak_gb(batch=4) (a solver
                outside the lockstep term's fit), the host syncs an
                iteration.
    lockstep_bsr — the same sweep through the BSROperator (K3), over the
                first 2 strengths (LOCK3_BSR_PROBLEMS).
    k3_frame  — that BSROperator sharded at world size 1 (no window plan):
                one apply must launch K3 once, on its halo frame; timed
                beside the gather + einsum it replaced and the unsharded
                apply.
13. band       — benchmarks/bsr_spmm.py's banded matrix (n 1,048,576,
                bs 8, band 24, k 128) in its three formats: K3, K4, K5
                against their plain versions, the time of K4's and K5's
                non-finite flag pass beside them, the non-finite pattern
                of all three on an X with NaN and +-Inf, and the SpMM
                path (one apply per format).  Then a symmetric SPD
                variant (M + M^T + shift I) through BSROperator.from_csr,
                whose matmat must launch the kernel its rule names.  The
                SpMM records carry their format's
                floor (format_bound_ms: the stored values, X and Y at the
                HBM rate; dense_ffma_ms: every stored value times k at
                the f32 peak) beside the nonzero bound.
    sweep      — K5 beside K3 at k 16 to 128 on that SPD band (window 384
                rows; torch.sparse.mm beside them) and on the band-72
                matrix (window 512): the crossing behind
                BSROperator.window_pays, with one matmat apply at each
                width that must launch the kernel the rule names; then K5
                over a batch [4, n, 16] on the band-72 matrix against its
                plain version, its 4 lone launches and torch.sparse.mm
                on the folded block, and a batch of 4 through its
                BSROperator.matmat at k 16 and 48 (one K3, one K5 launch:
                the rule asked at one problem's width).
14. k6        — that SPD band cut into 4 virtual row shards by
                parallel.plan_shards (halo 3 blocks, window 384 rows), the
                halos cut from the global X: per shard K6 equal to K5 on
                the concatenated frame (torch.equal) and within tolerance
                of its plain version; all three window sources hit in the
                interior shards; the shards together against the global
                plain product; K6 timed on an interior shard beside
                torch.sparse.mm of that shard's CSR rows.
15. sharded   — the row-sharded layer at world size 1 on NCCL
                (parallel.row_mesh(1)): the flagship well through
                shard_problem and `with mesh: ilobpcg` (56/56, 1e-5, K1),
                beside the unsharded flagship's numbers; then one apply of
                the sharded SPD band, which must launch K6 once and K5
                never.
    blockdiag2 — the flagship well pencil with A written as
                physics.bdg.BlockDiag2Operator(top=L + diag V, bottom=L +
                diag V) through shard_problem on row_mesh(1): it must
                unroll into the well's own A (one two-segment stencil
                plus [V; V]) and take the sharded phase's trajectory (56/56
                within 1e-5, the same iterations, error and K1 launches);
                then one apply of a sharded CallableOperator and two of
                the SPD band gathered at world size 1 (the whole matrix,
                and its block rows through K3 on the gathered block),
                equal to their unsharded products.
16. graft_entry — lobpcg_tpu_torch.graft_entry: entry() (the m 64 BdG
                step, through K1), dryrun_multichip(1) (one sharded
                ilobpcg and lobpcg step and the sharded tridiagonal SpMM,
                K3 on its halo frame), dryrun_headline() (the reference's
                dim-4M BdG pencil, nev 150, size_sub 160, f32, 2
                iterations) and dryrun_headline_complex() (that pencil in
                complex64 at n_complex 2M, cut from 4M to fit one card,
                split-real [4M, 320] f32 with float64 RR, 2 iterations),
                one line each with iterations, max residual, wall time,
                the peak beside estimate_peak_gb, K1's launches (> 0 on
                both gates) and the resolved RR dtype; peak over estimate
                within 0.5-1.5 on the two toy solves and within 1% under
                1.0 on the gates.  K1 alone at the gates' widths, [4M, 160]
                and [4M, 320], is timed in phase 3.
17. examples  — each lobpcg_tpu_torch.examples module's main(device=
                "cuda") against its script's oracle, with the kernels it
                launched (the f64 examples run the plain stencil and the
                plain block-ELL product: K1 and K3 take f32, as the Pallas
                kernels do).
18. wide_pencil — benchmarks.solve_bdg.solve at n 20,000, nev 150,
                size_sub 256 (projected width 768), Jacobi, tol 1e-5, f32,
                with rr_dtype float32 (the reference CPU run's setting)
                and with the default (float64 at this width): each must
                reach 150/150 within 1e-5 of the oracle.
19. batched   — lobpcg_tpu_torch.batched over 8 barrier heights of the well
                (benchmarks.solve_bdg.well_problem(..., barrier=)) at n
                1,000,000, nev 16, size_sub 30, Chebyshev degree 3, tol
                1e-5, f32, one X0: 16/16 within 1e-5 of each barrier's
                oracle, K1 launched, and two of the eight equal to their
                lone solves (eigenvalues bit for bit, iterations equal);
                per-problem iterations and wall, the batch's wall and peak.
20. lockstep  — the same 8 barriers as ONE lockstep ilobpcg (X0 [8, n, 30];
                A = the shared two-segment Laplacian1D + DiagonalOperator
                [8, n], B shared, Chebyshev with [8] upper bounds): 16/16
                within 1e-5 of each oracle, and K1 launched once per batch
                apply: as often as the longest-running problem applies A
                alone (its lone solve's launches, fixed plus per
                iteration); per-problem iterations, the wall beside the
                batched phase's, the peak beside estimate_peak_gb(batch=8)
                (fitted on lockstep_sharded's peaks), the host syncs an
                iteration
                (torch's CUDA sync debug mode), and the tall Gram at its
                shape three ways (split over rows as ops/gram.py runs
                it, one strided-batched GEMM, one GEMM per problem: ms
                and error against float64).  Then 32 barriers in
                [1, 4] at n 65,536 the same way (oracles through the
                tridiagonal eigensolver on well_eigs_oracle's matrix,
                K1 held to the same count; the peak beside the estimate,
                a shape outside its fit), beside lt.batched on 4 of
                them (its wall, and each problem's wall and host syncs
                inside it).
21. lockstep_callable — examples/fft_matrix_free.py's CallableOperator
                (and its Fourier-space preconditioner) over 3 shifts of
                its spectrum (mapped, in_axes (0,)) as one lockstep
                solve, against each shift's lone solve and exact spectrum.
22. lockstep_realify — the realify phase's complex pencil over 4
                barriers at n 262,144 (cut from 1M) through
                realify_problem (RealEmbeddedDiagonalOperator [4, m]) as
                one lockstep split-real ilobpcg: 16/16 pairs each within
                1e-5 of its oracle and of its lone solve.
23. k3_frame_batched — after the K3 kernel phase: the 160^3 BSROperator
                sharded at world size 1 applied to [2, n, 16], one K3
                launch on the frame, equal to its 2 lone applies bit for
                bit; against its gather + einsum, timed beside them and
                torch.sparse.mm on the folded [n, 32].
24. k6_batched — after the k6 phase: K6 on its interior shard at [4,
                262,144, 32], each problem's halos cut from its own global
                X: one launch against its plain version, its 4 lone
                launches (bit for bit) and torch.sparse.mm of the shard's
                CSR rows on the folded frame; the non-finite flag pass's
                own time beside it.
25. k1_edges_batched — after the lockstep phase: K1 on [8, 1M, 30] over
                16 segments with random nonzero edge rows [8, 2, 30]: one
                launch against its plain version (error 0), its 8 lone
                launches with their own edge pairs (bit for bit), the
                unbatched [8M, 30] launch, the plain version and conv1d.
26. lockstep_sharded — the lockstep phase's 8 barriers x 1M x 30 through
                parallel.shard_problem on row_mesh(1) (NCCL), X0
                [8, n_loc, 30]: the lockstep phase's record bit for bit
                (each problem's iterations, the eigenvalues, K1's
                launches); the wall, all-reduces an iteration beside the
                sharded flagship's, halo exchanges, the peak beside
                estimate_peak_gb(batch=8) and the host syncs an iteration.
27. lockstep_sharded_4m — 4 barriers {1, 2, 3, 4} of the well at the
                flagship's n 4,000,000 (nev 16, size_sub 30, Chebyshev 3,
                tol 1e-5, f32) the same way: 16/16 each within 1e-5 of its
                oracle, K1 once a batch apply, the wall and the peak beside
                the estimate.

Every kernel wrapper counts its launches; each path runs with every
count set to 0 just before it and read just after.  A solve of
Laplacian1D + DiagonalOperator launches stencil_diag or cheb_step where
it launched K1 before, so its launch checks read the K1 family's sum
(k1_family); the BdG solves launch the four tail kernels where
PyTorch's elementwise passes ran.  The second-to-last
lines are the kernels summary and the card's `nvidia-smi` name and
power limit; the last line is the ok record.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import time
import types
import warnings

import numpy as np
import scipy.sparse as sp
import torch

import lobpcg_tpu_torch as lt
from lobpcg_tpu_torch import bench, graft_entry, parallel
from lobpcg_tpu_torch.benchmarks import solve_bdg
from lobpcg_tpu_torch.examples import (
    bdg_indefinite,
    checkpoint_resume,
    complex_on_gpu,
    fft_matrix_free,
    laplacian_1d,
    sharded_solve,
    sparse_3d_laplacian,
)
from lobpcg_tpu_torch.ops import gram, masking
from lobpcg_tpu_torch.ops import residual as resid
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.ops.cuda import build as cuda_build
from lobpcg_tpu_torch.ops.cuda import copy as k7
from lobpcg_tpu_torch.ops.cuda import gram as kg
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.ops.cuda import stencil3d as k2
from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.parallel import mesh as pmesh
from lobpcg_tpu_torch.parallel.sharding import (
    BSRRowPanelOperator,
    GatheredOperator,
)
from lobpcg_tpu_torch.physics.bdg import BlockDiag2Operator
from lobpcg_tpu_torch.tools import stencil_widths
from lobpcg_tpu_torch.utils import native

N_MAIN = 4_000_000
NEV, SIZE_SUB = 56, 64
CHEB_DEGREE = 3
TOL, MAX_ITER = 1e-5, 300
ORACLE_RTOL = 1e-5
N_SUB, NEV_SUB, SS_SUB = 1_000_000, 150, 164  # bench.py's sub1M_150 line
NEV_REALIFY = 16

GRID3 = (160, 160, 160)  # benchmarks/README.md's 3-D operator shape
# max_iter 2000: the tenth pair's residual crosses 1e-5 after ~1,460-1,490
# iterations on the H100 (PERF.md); the other nine by ~410.
NEV3, SS3, TOL3, MAX_ITER3 = 10, 16, 1e-5, 2000
BAND_N, BAND_BS, BAND, BAND_K = 1_048_576, 8, 24, 128  # benchmarks/bsr_spmm.py
STRIP = 256  # BSROperator's strip for bs 8
# Widths of the K5/K3 sweep behind BSROperator.matmat's rule (the solver's
# blocks are 16-48 wide), and the wider band it also runs on (+-9 blocks
# at bs 8: a window of 512 rows).
SWEEP_KS = (16, 24, 32, 48, 64, 96, 128)
BAND_WIDE = 72
K6_SHARDS = 4  # virtual row shards of the band for K6 (one card)
# The wide pencil of ROADMAP queue 3 (benchmarks/trace_cpu_postfix.log:
# 150/150 in 10 iterations on the reference's CPU run).
N_WIDE, NEV_WIDE, SS_WIDE = 20_000, 150, 256
# The batched sweep: barrier heights (CHEB_LO 2.0 stays at or under the
# continuum's bottom, SHIFT + barrier) of the well at 1M x 16.
BATCH_BARRIERS = (1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0)
N_BATCH, NEV_BATCH, SS_BATCH = 1_000_000, 16, 30
BATCH_LONE = (0, 7)  # the problems also solved alone
# The lockstep sweeps: the batched phase's 8 barriers as one lockstep
# ilobpcg, and 32 barriers of the same well at n 65,536 (where one problem
# leaves the card idle), 4 of them also through lt.batched.
LOCK_SMALL_N = 65_536
LOCK_SMALL_BARRIERS = tuple(float(b) for b in np.linspace(1.0, 4.0, 32))
LOCK_SMALL_SEQ = 4
NORM_BLOCK = lt.SolverConfig.norm_block  # the norm estimates' block width (default)
WELL_MARGIN = 2048  # solve_bdg.well_eigs_oracle's barrier sites each side
# The lockstep 3-D sweeps: problems on the 160^3 grid, A_p = the shared
# Laplacian (LaplacianND, K2; BSROperator, K3) + the separable anisotropic
# trap c_p ((x-1/2)^2 + 1.3 (y-1/2)^2 + 1.7 (z-1/2)^2); c_0 = 0 is the
# laplacian3d problem.  To first order the trap lifts the lowest
# eigenvalue (29.6 at c 0) by 0.131 c (<(x-1/2)^2> = 1/12 - 1/(2 pi^2)
# on each axis, weighted 1 + 1.3 + 1.7), so each strength moves the low
# spectrum by more than its spacing; the phases print each oracle's.
TRAP_C = (0.0, 300.0, 1000.0, 3000.0)
TRAP_W = (1.0, 1.3, 1.7)
# The lockstep_bsr sweep: the first 2 of TRAP_C.  At 4 it took 95.4 s
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), which put the new phases
# over their ~150 s; problem 0 sets the sweep's length either way.
LOCK3_BSR_PROBLEMS = 2
# The small lockstep runs of the other routes: the FFT example's operator
# over three shifts, and the realify phase's pencil over four barriers at
# n cut from 1M.
FFT_SHIFTS = (0.0, 1.5, 4.0)
REALIFY_BATCH_N = 262_144
REALIFY_BARRIERS = (1.0, 1.5, 2.5, 4.0)
# The lockstep batch under a row group at the flagship's n: 4 barriers.
SHARDED_4M_BARRIERS = (1.0, 2.0, 3.0, 4.0)
K6_BATCH, K6_BATCH_K = 4, 32  # K6 over a batch: problems and columns

# Published H100 SXM peaks, the bound of each kernel's time, its error
# and the card's nvidia-smi line, shared with the K1 width sweep.
HBM_BYTES_PER_S, F32_FLOPS = stencil_widths.HBM_BYTES_PER_S, stencil_widths.F32_FLOPS
bound, max_abs, card_line = (stencil_widths.bound, stencil_widths.max_abs,
                             stencil_widths.card_line)

# (wrapper, source, TPU kernel it replaces) of every kernel of the port.
KERNELS = {
    "stencil1d": (k1.stencil_matmat, "lobpcg_tpu_torch/csrc/stencil1d.cu",
                  "lobpcg_tpu/ops/pallas/stencil.py:75"),
    # K1's walk with the BdG operator's diagonal, and with the Chebyshev
    # step: what XLA fuses around the stencil in the JAX package's solve.
    "stencil_diag": (k1.stencil_diag, "lobpcg_tpu_torch/csrc/stencil1d.cu",
                     "lobpcg_tpu/ops/pallas/stencil.py:75"),
    "cheb_step": (k1.cheb_step, "lobpcg_tpu_torch/csrc/stencil1d.cu",
                  "lobpcg_tpu/ops/pallas/stencil.py:75"),
    "stencil3d": (k2.stencil3d_matmat, "lobpcg_tpu_torch/csrc/stencil3d.cu",
                  "lobpcg_tpu/ops/pallas/stencil3d.py:236"),
    "bsr_ell": (kb.bsr_matmat, "lobpcg_tpu_torch/csrc/bsr.cu",
                "lobpcg_tpu/ops/pallas/bsr.py:47"),
    "bsr_strip": (kb.bsr_strip_matmat, "lobpcg_tpu_torch/csrc/bsr.cu",
                  "lobpcg_tpu/ops/pallas/bsr.py:186"),
    "bsr_window": (kb.bsr_window_matmat, "lobpcg_tpu_torch/csrc/bsr.cu",
                   "lobpcg_tpu/ops/pallas/bsr.py:381"),
    "bsr_window_edges": (kb.bsr_window_matmat_edges,
                         "lobpcg_tpu_torch/csrc/bsr.cu",
                         "lobpcg_tpu/ops/pallas/bsr.py:468"),
    "copy": (k7.stream_copy, "lobpcg_tpu_torch/csrc/copy.cu", "bench.py:65"),
    # The solver's tall tail: what XLA fuses inside the JAX package's
    # jitted solve (no pallas_call; "replaces" names the jnp chain).
    "tail_antidiag": (tail.antidiag, "lobpcg_tpu_torch/csrc/tail.cu",
                      "lobpcg_tpu/operators/linop.py:319"),
    "tail_residual": (tail.residual, "lobpcg_tpu_torch/csrc/tail.cu",
                      "lobpcg_tpu/ops/residual.py:39"),
    "tail_combine": (tail.combine, "lobpcg_tpu_torch/csrc/tail.cu",
                     "lobpcg_tpu/ops/ortho.py:231"),
    "tail_compact": (tail.compact, "lobpcg_tpu_torch/csrc/tail.cu",
                     "lobpcg_tpu/ops/masking.py:60"),
    # The tall Gram V^H U: XLA's dot at HIGHEST in the JAX package (no
    # pallas_call; "replaces" names the contraction).
    "tall_gram": (kg.tall_gram, "lobpcg_tpu_torch/csrc/gram.cu",
                  "lobpcg_tpu/ops/gram.py:_hdot"),
}
TAIL = ("tail_antidiag", "tail_residual", "tail_combine", "tail_compact")

# The collectives of the row-sharded layer, counted as the kernels are.
COLLECTIVES = {"all_reduce": pmesh.all_reduce,
               "halo_exchange": pmesh.halo_exchange,
               "permute_rows": pmesh.permute_rows,
               "all_gather_rows": pmesh.all_gather_rows}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def zero_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    for fn in COLLECTIVES.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


K1_FAMILY = ("stencil1d", "stencil_diag", "cheb_step")


def k1_family(counts: dict) -> int:
    """Launches of K1 and its two fused forms: where a solve of
    Laplacian1D + DiagonalOperator launched K1 alone, it launches one of
    them."""
    return sum(counts[name] for name in K1_FAMILY)


def read_collectives() -> dict:
    return {name: fn.launches for name, fn in COLLECTIVES.items()}


def time_ms(fn) -> float:
    """ms of one fn() on the card, by lobpcg_tpu_torch.bench.time_ms: CUDA
    events around windows of 15 back-to-back calls, the best of three
    windows after a warm-up window (the wrapper's host time overlaps the
    previous call, as on a solve's path)."""
    return bench.time_ms(fn, torch.device("cuda"))


def timed_untracked(fn) -> float:
    """time_ms of a kernel wrapper whose launches must not count."""
    counts = read_counts()
    try:
        return time_ms(fn)
    finally:
        for name, (wrapper, _, _) in KERNELS.items():
            wrapper.launches = counts[name]


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# --- build, K1, quick start and the BdG main path ----------------------------


def build_phase() -> None:
    t0 = time.perf_counter()
    recs = cuda_build.build_all(["stencil1d", "stencil3d", "bsr", "copy",
                                 "tail", "gram"])
    for rec in recs:
        emit({"phase": "build", "kernel": rec["name"], "nvcc_ran": rec["built"],
              "nvcc_s": rec["seconds"],
              "ptxas": [ln for ln in rec["log"].splitlines() if "ptxas" in ln][:16]})
    emit({"phase": "build", "total_s": time.perf_counter() - t0})


def kernel_phase(dev) -> list[dict]:
    """K1 against its plain version and cuDNN's conv1d
    (tools/stencil_widths.py): the main path's shapes, the headline
    gates' widths, the lockstep sweeps' folded blocks, a row-sliced X
    with edge rows and the width sweep at ~256 MiB of X; raises on a
    disagreement, and if an f32 point with X >= 64 MiB runs under half
    its bound."""
    return stencil_widths.sweep(
        dev, emit=lambda line: print(line, flush=True),
        # A batch apply folds [b, n, k] into one [b n, k] block over b * 2
        # segments, at the block width and the norm estimates' width (no
        # operator packs two blocks: every one answers apply_width_ok).
        lockstep=((len(BATCH_BARRIERS), N_BATCH),
                  (len(LOCK_SMALL_BARRIERS), LOCK_SMALL_N)),
        lockstep_widths=(SS_BATCH, NORM_BLOCK))


# The fused kernels' shapes: (name, problems, rows a problem, k, per-problem
# diagonals and Chebyshev bounds, random edge rows [b, 2, k]).  The
# flagship's [4M, 64] and its Chebyshev chunk [4M, 16] (the bench line's),
# the 1M x 150 solve's [1M, 164], the lockstep sweep's [8, 1M, 30] and
# the same under a row group with halos.
FUSED_SHAPES = (
    ("flagship", 1, N_MAIN, SIZE_SUB, False, False),
    ("flagship_chunk", 1, N_MAIN, 16, False, False),
    ("sub1M_150", 1, N_SUB, SS_SUB, False, False),
    ("lockstep", len(BATCH_BARRIERS), N_BATCH, SS_BATCH, True, False),
    ("lockstep_edges", len(BATCH_BARRIERS), N_BATCH, SS_BATCH, True, True),
)


class ChainDiagonal(lt.DiagonalOperator):
    """A DiagonalOperator that the fused route does not take (it reports
    no row scales), so that a tree holding it runs the eager chain of
    operations the fused kernels replace: K1, then d * X, then the add,
    and the Chebyshev recurrence one operation at a time."""

    def row_scales(self):
        return None


def fused_case(dev, name, b, n, k, per_problem, edges, dtype) -> list[dict]:
    """stencil_diag and cheb_step (the first and the last step of the
    degree-3 filter, and the two together) on b problems of [n, k] in
    ``dtype``: each against its plain version and the eager chain (K1 and
    PyTorch's operations; max_abs_err 0 and torch.equal), then, in f32,
    timed beside both and its bound."""
    gen = torch.Generator(device=dev).manual_seed(15)
    rows, segs = b * n, 2 * b
    X = (torch.rand((rows, k), generator=gen, device=dev) - 0.5).to(dtype)
    d = (torch.rand((b, n) if per_problem else (n,), generator=gen, device=dev)
         + 1.0).to(dtype)
    E = ((torch.rand((b, 2, k), generator=gen, device=dev) - 0.5).to(dtype)
         if edges else None)
    hi = (torch.tensor([solve_bdg.cheb_hi(x) for x in BATCH_BARRIERS[:b]],
                       dtype=torch.float64, device=dev)
          if per_problem else solve_bdg.CHEB_HI)
    filt = lt.ChebyshevFilter(op=None, lo=solve_bdg.CHEB_LO, hi=hi,
                              degree=CHEB_DEGREE)
    X3 = X.view(b, n, k)
    theta, ((c1a, c2a), (c1b, c2b)) = filt._coefficients(X3)
    fused = dict(num_segments=segs, problems=b)

    def per(v):
        return v.view(-1, 1, 1) if isinstance(v, torch.Tensor) else v

    # The eager chain: Laplacian1D + DiagonalOperator one operation at a
    # time (K1, the multiply, the add), and ChebyshevFilter._apply's steps.
    def chain_apply(Y):
        return (k1.stencil_matmat(Y, 1.0, E, num_segments=segs).view(b, n, k)
                + d.unsqueeze(-1) * Y.view(b, n, k)).view(rows, k)

    def chain_step(y, dd, c1, c2):
        dd = per(c1) * dd.view(b, n, k) + per(c2) * (
            X3 - chain_apply(y).view(b, n, k))
        return (y.view(b, n, k) + dd).view(rows, k), dd.view(rows, k)

    def chain_first():
        y = (X3 / per(theta)).view(rows, k)
        return chain_step(y, y, c1a, c2a)

    y1, d1 = k1.cheb_step_reference(X, None, None, 1.0, d, c1a, c2a, E,
                                    theta=theta, **fused)

    def first():
        return k1.cheb_step(X, None, None, 1.0, d, c1a, c2a, E, theta=theta,
                            **fused)

    def first_plain():
        return k1.cheb_step_reference(X, None, None, 1.0, d, c1a, c2a, E,
                                      theta=theta, **fused)

    # (kernel, plain version, chain, elements moved, operations a call)
    forms = {
        "stencil_diag": (
            lambda: k1.stencil_diag(X, 1.0, d, E, **fused),
            lambda: k1.stencil_diag_reference(X, 1.0, d, E, **fused),
            lambda: chain_apply(X), 2 * rows * k + d.numel(), 7 * rows * k),
        "cheb_step": (first, first_plain, chain_first,
                      3 * rows * k + d.numel(), 15 * rows * k),
        "cheb_step_last": (
            lambda: k1.cheb_step(X, y1, d1, 1.0, d, c1b, c2b, E, last=True,
                                 **fused)[0],
            lambda: k1.cheb_step_reference(X, y1, d1, 1.0, d, c1b, c2b, E,
                                           last=True, **fused)[0],
            lambda: chain_step(y1, d1, c1b, c2b)[0],
            4 * rows * k + d.numel(), 12 * rows * k),
        "chebyshev_filter": (
            lambda: k1.cheb_step(X, *first(), 1.0, d, c1b, c2b, E, last=True,
                                 **fused)[0],
            lambda: k1.cheb_step_reference(X, *first_plain(), 1.0, d, c1b,
                                           c2b, E, last=True, **fused)[0],
            lambda: chain_step(*chain_first(), c1b, c2b)[0],
            7 * rows * k + 2 * d.numel(), 27 * rows * k),
    }
    size = X.element_size()
    recs = []
    for form, (kernel, plain, chain, nelem, ops) in forms.items():
        got, want, ref = (v if isinstance(v, tuple) else (v,)
                          for v in (kernel(), plain(), chain()))
        err = max(max_abs(g, w) for g, w in zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        chain_equal = all(torch.equal(g, c) for g, c in zip(got, ref))
        torch.cuda.synchronize()
        rec = {"phase": "kernel", "name": form, "case": name, "problems": b,
               "shape": [b, n, k], "dtype": str(dtype).replace("torch.", ""),
               "edge_rows": edges, "per_problem": per_problem,
               "max_abs_err": err, "tol": 0.0, "equal_to_plain": equal,
               "equal_to_chain": chain_equal,
               "max_abs_err_vs_chain": max(max_abs(g, c)
                                           for g, c in zip(got, ref))}
        del got, want, ref
        if not (err == 0.0 and equal and chain_equal):
            emit(rec)
            raise AssertionError(f"fused kernel {form} at {name}: {rec}")
        if dtype == torch.float32:
            rec.update({"ms": timed_untracked(kernel), "plain_ms": time_ms(plain),
                        "chain_ms": time_ms(chain),
                        **bound(nelem * size, ops), "library_ms": None})
        emit(rec)
        recs.append(rec)
        free()
    del X, d, E, y1, d1
    free()
    return recs


def fused_phase(dev) -> list[dict]:
    """K1's fused forms at the main paths' shapes (FUSED_SHAPES), f32 timed
    and bf16 checked: stencil_diag (A y of Laplacian1D + DiagonalOperator)
    and cheb_step, each against its plain version and the eager chain it
    replaces with 0 difference."""
    recs = []
    for case in FUSED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            recs += fused_case(dev, *case, dtype)
    return recs


# The tail kernels' shapes: (name, problems, rows a problem, k, dtype,
# non-finite inputs).  The flagship's [4M, 64], the 1M x 150 solve's
# [1M, 164], the lockstep sweep's [8, 1M, 30] with per-problem data, one
# f64 case, and NaN/+-Inf/-0 in every input at the flagship's width.
TAIL_SHAPES = (
    ("flagship", 1, N_MAIN, SIZE_SUB, torch.float32, False),
    ("sub1M_150", 1, N_SUB, SS_SUB, torch.float32, False),
    ("lockstep", len(BATCH_BARRIERS), N_BATCH, SS_BATCH, torch.float32, False),
    ("f64", 1, N_SUB, SIZE_SUB, torch.float64, False),
    ("nonfinite", 1, N_SUB, SIZE_SUB, torch.float32, True),
)


def same_bits(a, b) -> bool:
    """Equal shape and dtype, NaN where NaN, every other bit equal (-0 is
    not +0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return bool(torch.equal(a.contiguous().view(ints)[~nan],
                            b.contiguous().view(ints)[~nan]))


def tail_case(dev, name, b, n, k, dtype, special) -> list[dict]:
    """The four tail kernels on b problems of [n, k] in ``dtype``: each
    against its plain version and the eager chain it replaces (the call
    sites inside tail.eager_chain(); for combine the chain's adds, the
    subtraction and mask_cols), bit for bit; then, on finite inputs,
    timed beside both and its bound (bytes: every input once, the output
    once)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    lead = () if b == 1 else (b,)
    m = n // 2

    def block(shape):
        x = (torch.rand(shape, generator=gen, device=dev, dtype=dtype) - 0.5)
        if special:
            pick = torch.rand(shape, generator=gen, device=dev) < 0.01
            vals = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 -0.0], dtype=dtype, device=dev)
            idx = torch.randint(0, 4, shape, generator=gen, device=dev)
            x = torch.where(pick, vals[idx], x)
        return x

    X, AX, U = block(lead + (n, k)), block(lead + (n, k)), block(lead + (n, k))
    d = block(lead + (m,)) + 1.0
    lam = (block(lead + (k,)) * 8.0).double()
    B = lt.BlockAntiDiagOperator(d=d)
    terms = [block(lead + (n, k)) for _ in range(3)]
    if b == 1:
        nu, shift, count = k - 3, 3, k - 5
    else:
        nu = torch.arange(b, device=dev) % k
        shift = torch.arange(b, device=dev) % 4
        count = k - 1 - torch.arange(b, device=dev) % k

    def eager(fn):
        def run():
            with tail.eager_chain():
                return fn()
        return run

    size = X.element_size()
    nk = b * n * k
    # name: (kernel, plain, chain, elements moved, operations)
    forms = {
        "tail_antidiag": (
            lambda: tail.antidiag(X, d), lambda: tail.antidiag_reference(X, d),
            eager(lambda: B.matmat(X)), 2 * nk + d.numel(), nk),
        "tail_residual": (
            lambda: resid.get_residual(X, AX, lam, None, B),
            lambda: tail.residual_reference(AX, X, lam, d),
            eager(lambda: resid.get_residual(X, AX, lam, None, B)),
            3 * nk + d.numel(), 3 * nk),
        # The projection update over two GEMM outputs (ops/ortho.py).
        "tail_combine": (
            lambda: tail.combine(terms[:2], U, nu),
            lambda: tail.combine_reference(terms[:2], U, nu),
            eager(lambda: masking.mask_cols(U - (terms[0] + terms[1]), nu)),
            4 * nk, 3 * nk),
        # b_mm's sum of three GEMM outputs (the project-back of [X, P, W]).
        "tail_combine_sum": (
            lambda: tail.combine(terms), lambda: tail.combine_reference(terms),
            lambda: (terms[0] + terms[1]) + terms[2], 4 * nk, 2 * nk),
        "tail_compact": (
            lambda: masking.shift_cols(U, shift, count),
            lambda: tail.compact_reference(U, shift, count),
            eager(lambda: masking.shift_cols(U, shift, count)), 2 * nk, nk),
    }
    recs = []
    for form, (kernel, plain, chain, nelem, ops) in forms.items():
        wrapper = KERNELS[form if form in KERNELS else "tail_combine"][0]
        before = wrapper.launches
        got = kernel()
        launched = wrapper.launches - before
        want, ref = plain(), chain()
        torch.cuda.synchronize()
        rec = {"phase": "kernel", "name": form, "case": name, "problems": b,
               "shape": [b, n, k], "dtype": str(dtype).replace("torch.", ""),
               "nonfinite_inputs": special, "launched": launched,
               "equal_to_plain": same_bits(got, want),
               "equal_to_chain": same_bits(got, ref), "tol": 0.0}
        fin = torch.isfinite(want) & torch.isfinite(got)
        rec["max_abs_err"] = max_abs(got[fin], want[fin]) if fin.any() else 0.0
        del got, want, ref, fin
        if not (launched == 1 and rec["equal_to_plain"]
                and rec["equal_to_chain"]):
            emit(rec)
            raise AssertionError(f"tail kernel {form} at {name}: {rec}")
        if not special:
            rec.update({"ms": timed_untracked(kernel), "plain_ms": time_ms(plain),
                        "chain_ms": time_ms(chain),
                        **bound(nelem * size, ops), "library_ms": None})
        emit(rec)
        recs.append(rec)
        free()
    del X, AX, U, d, lam, terms
    free()
    return recs


def tail_phase(dev) -> list[dict]:
    """The tail kernels at the solves' shapes (TAIL_SHAPES): each equal to
    its plain version and to the eager chain, bit for bit, then timed."""
    recs = []
    for case in TAIL_SHAPES:
        recs += tail_case(dev, *case)
    return recs


# The tall Gram (csrc/gram.cu): the 4M x 150 and 4M x 56 solves' Grams
# and [4.1M, 16] (a Chebyshev chunk's width), then the widths of the
# port's other tall Grams (the 3-D solves' 16 and 48, the lockstep's 30,
# the realify path's 60) and the kernel's range at n 4M, for the dispatch.
GRAM_SHAPES = ((4_000_000, 164), (4_000_000, 64), (4_100_000, 16))
GRAM_WIDTHS = (1, 4, 8, 12, 30, 32, 48, 60, 96, 100, 128, 150, 200, 256)


def gram_case(dev, n, k, strict: bool = True) -> dict:
    """V^T U of V, U [n, k] (uniform [0, 1) and standard normal): the
    kernel launched once, two launches bit for bit, and (``strict``) its
    largest error against the float64 product relative to the largest
    entry no worse than torch.matmul's; then ms beside its bound, the
    plain version and torch.matmul (cuBLAS's nt kernel, which the port no
    longer calls where ops/gram.py dispatches the kernel; the plain
    version is that same call, on the CPU's route) and which of the two
    ops/gram.py runs at this shape."""
    gen = torch.Generator(device=dev).manual_seed(19)
    V = torch.rand((n, k), generator=gen, device=dev)
    U = torch.randn((n, k), generator=gen, device=dev)
    want = torch.matmul(V.double().mT, U.double())
    before = kg.tall_gram.launches
    got = kg.tall_gram(V, U)
    launched = kg.tall_gram.launches - before
    again = kg.tall_gram(V, U)
    lib = torch.matmul(V.mT, U)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    rec = {"phase": "kernel", "name": "tall_gram", "shape": [n, k, k],
           "launched": launched, "repeats": bool(torch.equal(got, again)),
           "max_abs_err": err, "max_rel_err": err / scale,
           "library_max_rel_err":
               float((lib.double() - want).abs().max()) / scale}
    del want, got, again, lib
    rec["route"] = gram._tall_route(V, U)
    if not (launched == 1 and rec["repeats"]) or (
            strict and rec["max_rel_err"] > rec["library_max_rel_err"]):
        emit(rec)
        raise AssertionError(f"tall Gram at [{n}, {k}]: {rec}")
    rec.update({"ms": timed_untracked(lambda: kg.tall_gram(V, U)),
                "plain_ms": time_ms(lambda: kg.tall_gram_reference(V, U)),
                "library_ms": time_ms(lambda: torch.matmul(V.mT, U)),
                **bound(2 * n * k * 4 + k * k * 4, 2 * n * k * k)})
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    del V, U
    free()
    return rec


def gram_phase(dev) -> list[dict]:
    """The tall Gram at GRAM_SHAPES, then at GRAM_WIDTHS over 4M rows."""
    return ([gram_case(dev, n, k) for n, k in GRAM_SHAPES]
            + [gram_case(dev, N_MAIN, k, strict=False) for k in GRAM_WIDTHS])


def quickstart_phase(dev) -> None:
    """README quick start: the standard solver on the 1-D Laplacian."""
    n = 256
    h = 1.0 / (n + 1)
    A = lt.Laplacian1D(scale=1.0 / (h * h), n=n, dtype=torch.float32)
    r = lt.lobpcg(A, nev=3, size_sub=6, tol=1e-6, max_iter=300,
                  generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    lam = r.eigenvalues.double().cpu().numpy()
    exact = (np.arange(1, 4) * np.pi) ** 2
    rel = np.abs(lam - exact) / exact
    emit({"phase": "quickstart", "eigenvalues": lam.tolist(),
          "max_rel_err_vs_continuum": float(rel.max()),
          "converged": r.converged, "iterations": r.iterations})
    if not (np.all(np.isfinite(lam)) and rel.max() < 0.03):
        raise AssertionError(f"quick start eigenvalues off: {lam}")


def copy_phase(dev) -> list[dict]:
    """K7 against its plain version (clone), bit for bit, at the
    headline's [4M, 256], the BdG solve's [4M, 64] and an odd shape
    (n not a multiple of 2048, k odd, numel not a multiple of 4), timed
    beside its plain version and Tensor.copy_ into a preallocated block."""
    gen = torch.Generator(device=dev).manual_seed(4)
    out = []
    for n, k in ((N_MAIN, 256), (N_MAIN, 64), (1_000_003, 77)):
        X = torch.rand((n, k), generator=gen, device=dev) - 0.5
        Y = k7.stream_copy(X)
        Yp = k7.stream_copy_reference(X)
        torch.cuda.synchronize()
        err = max_abs(Y, Yp)
        if not (err == 0.0 and torch.equal(Y, Yp)):
            raise AssertionError(f"copy kernel differs at n={n} k={k}: {err}")
        del Y, Yp
        free()
        dst = torch.empty_like(X)
        ms = timed_untracked(lambda: k7.stream_copy(X))
        plain_ms = time_ms(lambda: k7.stream_copy_reference(X))
        lib_ms = time_ms(lambda: dst.copy_(X))
        nbytes = 2 * n * k * 4
        rec = {"phase": "kernel", "name": "copy", "n": n, "k": k,
               "dtype": "float32", "max_abs_err": err, "tol": 0.0,
               "ms": ms, "gbps": nbytes / ms / 1e6,
               "plain_ms": plain_ms, "plain_gbps": nbytes / plain_ms / 1e6,
               **bound(nbytes, 0), "library_ms": lib_ms,
               "library_gbps": nbytes / lib_ms / 1e6}
        emit(rec)
        out.append(rec)
        del X, dst
        free()
    return out


def main_phase(dev, precision: str, chain: bool = False):
    """ilobpcg on the BdG well pencil at the flagship shape; its record
    and eigenvalues.  ``chain``: A's diagonal as a ChainDiagonal, so that
    A and the filter run the eager chain of operations (K1 and PyTorch's
    elementwise passes) instead of the fused kernels, and the solve
    inside tail.eager_chain(), so that the tall tail (B applies,
    residuals, projection updates, compactions) runs its eager chains
    instead of the tail kernels."""
    A, B, T, X0, _, _ = solve_bdg.well_problem(
        N_MAIN, NEV, SIZE_SUB, dtype=torch.float32, cheb=CHEB_DEGREE,
        precond=True, device=dev, cheb_chunk=0)
    if chain:
        A = A.left + ChainDiagonal(A.right.d)
        T = dataclasses.replace(T, op=A)
    n, ss = N_MAIN, SIZE_SUB
    cfg = lt.SolverConfig(nev=NEV, size_sub=ss, tol=TOL, max_iter=MAX_ITER,
                          gram_precision=precision, use_ax_cache=True,
                          use_b_cache=True, dual_basis=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with tail.eager_chain() if chain else contextlib.nullcontext():
        r = lt.ilobpcg(A, X0, B, T, config=cfg, generator=gen)
        lam32 = r.eigenvalues.cpu()
    wall = time.perf_counter() - t0
    counts = read_counts()
    lam = lam32.double().numpy()

    exact = solve_bdg.well_eigs_oracle(solve_bdg.WELL, NEV, solve_bdg.BARRIER)
    rel = np.abs(lam - exact) / np.abs(exact)
    rec = {
        "phase": "main_chain" if chain else "main", "n": n, "nev": NEV,
        "size_sub": ss,
        "dtype": "float32", "cheb_degree": CHEB_DEGREE, "cheb_chunk": T.chunk,
        "tol": TOL, "gram_precision": precision,
        "converged": r.converged, "iterations": r.iterations,
        "quality5": r.quality5_count, "rr_failed": r.rr_fail_count,
        "wall_s": wall, "launches": counts,
        "max_rel_err": float(rel.max()),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(rec)
    if not np.all(np.isfinite(lam)) or tuple(lam.shape) != (NEV,):
        raise AssertionError("main path returned non-finite eigenvalues")
    if r.converged != NEV:
        raise AssertionError(f"converged {r.converged}/{NEV}")
    if not rel.max() <= ORACLE_RTOL:
        raise AssertionError(f"max rel err {rel.max()} > {ORACLE_RTOL}")
    fused = counts["stencil_diag"] + counts["cheb_step"]
    if k1_family(counts) < 2 * r.iterations or (
            fused != 0 if chain else (counts["stencil_diag"] < 1
                                      or counts["cheb_step"] < 1)):
        raise AssertionError(
            f"the stencil kernels launched {counts} in {r.iterations} "
            f"iterations (fused: A through stencil_diag, T through cheb_step; "
            f"chain: K1 alone)"
        )
    tail_launches = [counts[name] for name in TAIL]
    if (any(tail_launches) if chain else min(tail_launches) < r.iterations):
        raise AssertionError(
            f"the tail kernels launched {dict(zip(TAIL, tail_launches))} in "
            f"{r.iterations} iterations (fused: each at least once an "
            f"iteration; chain: none)")
    return rec, lam32


def chain_check(main_rec, main_lam, chain_rec, chain_lam) -> dict:
    """The flagship through the fused kernels (K1's fused forms and the
    tail kernels) against the fully eager chain: the same eigenvalues
    (torch.equal) and iterations, one K1 launch in the chain for each
    launch of the K1 family, a peak no higher than the chain's; both
    walls and the tail launches."""
    mem = [main_rec["max_memory_allocated_gib"],
           chain_rec["max_memory_allocated_gib"]]
    rec = {"phase": "main_vs_chain",
           "equal_eigenvalues": bool(torch.equal(main_lam, chain_lam)),
           "iterations": [main_rec["iterations"], chain_rec["iterations"]],
           "k1_family_launches": [k1_family(main_rec["launches"]),
                                  chain_rec["launches"]["stencil1d"]],
           "tail_launches": {name: main_rec["launches"][name] for name in TAIL},
           "wall_s": [main_rec["wall_s"], chain_rec["wall_s"]],
           "max_memory_allocated_gib": mem}
    emit(rec)
    if not (rec["equal_eigenvalues"] and len(set(rec["iterations"])) == 1
            and len(set(rec["k1_family_launches"])) == 1
            and mem[0] <= mem[1]):
        raise AssertionError(f"the fused flagship left the chain's "
                             f"trajectory or its peak: {rec}")
    return rec


def bench_phase(dev) -> dict:
    """The SpMM headline through the bench entry point: K1 at [4M, 256]
    f32 against K7's copy roofline on the same block."""
    zero_counts()
    rec = bench.measure_spmm(dev)
    counts = read_counts()
    rec = {"phase": "bench", **rec, "launches": counts}
    emit(rec)
    if counts["copy"] < 1 or counts["stencil1d"] < 1:
        raise AssertionError(f"bench path launched {counts}")
    if not (rec["apply_finite"] and math.isfinite(rec["value"])
            and rec["value"] > 0 and math.isfinite(rec["vs_baseline"])):
        raise AssertionError(f"bench headline not finite: {rec}")
    return rec


def well_solve_phase(dev, phase: str, n: int, nev: int, size_sub: int,
                     realify: bool) -> dict:
    """One solve through benchmarks.solve_bdg.solve (Chebyshev degree 3,
    tol 1e-5, f32, no warm-up), against the dense well oracle."""
    torch.cuda.synchronize()
    zero_counts()
    rec = solve_bdg.solve(n, nev, size_sub, tol=TOL, dtype="float32",
                          cheb=CHEB_DEGREE, check=True, realify=realify,
                          warmup=False, reps=1, device=dev)
    counts = read_counts()
    rec = {"phase": phase, **rec, "launches": counts}
    emit(rec)
    if rec["converged"] != nev:
        raise AssertionError(f"{phase}: converged {rec['converged']}/{nev}")
    if not rec["max_rel_err"] <= ORACLE_RTOL:
        raise AssertionError(f"{phase}: max rel err {rec['max_rel_err']} > "
                             f"{ORACLE_RTOL}")
    if k1_family(counts) < 2 * rec["iterations"]:
        raise AssertionError(f"{phase}: the stencil kernels launched "
                             f"{counts} in {rec['iterations']} iterations")
    return rec


# --- K2: the fused 3-D stencil -----------------------------------------------


def conv3d_stencil(X, scale, grid):
    """The yardstick: one depthwise cuDNN conv3d over the same bytes, X
    ([n, k] or a batch [b, n, k]) viewed as a channels-last
    [b, k, nx, ny, nz] volume (TF32 off)."""
    nx, ny, nz = grid
    k = X.shape[-1]
    w = torch.zeros((k, 1, 3, 3, 3), dtype=X.dtype, device=X.device)
    w[:, 0, 1, 1, 1] = 6.0 * scale
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[(slice(None), 0) + idx] = -scale
    Xc = X.view(-1, nx, ny, nz, k).permute(0, 4, 1, 2, 3)
    return lambda: torch.nn.functional.conv3d(Xc, w, padding=1, groups=k)


def k2_phase(dev) -> list[dict]:
    h = 1.0 / (GRID3[0] + 1)
    scale = 1.0 / (h * h)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(GRID3, 16, torch.float32), (GRID3, 48, torch.float32),
             (GRID3, 128, torch.float32), (GRID3, 16, torch.bfloat16),
             ((5, 7, 9), 3, torch.float32)]
    out = []
    for grid, k, dt in cases:
        n = math.prod(grid)
        X = (torch.rand((n, k), generator=gen, device=dev) - 0.5).to(dt)
        Y = k2.stencil3d_matmat(X, scale, grid)
        Yp = k2.stencil3d_matmat_reference(X, scale, grid)
        torch.cuda.synchronize()
        err = max_abs(Y, Yp)
        # 4 ulp of the storage dtype x the largest output, 12 |scale| max|X|.
        tol = 4 * torch.finfo(dt).eps * 12 * scale * float(X.float().abs().max())
        if not err <= tol:
            raise AssertionError(f"stencil3d kernel disagrees at {grid} k={k} "
                                 f"{dt}: {err} > {tol}")
        del Y, Yp
        free()
        ms = timed_untracked(lambda: k2.stencil3d_matmat(X, scale, grid))
        plain_ms = time_ms(lambda: k2.stencil3d_matmat_reference(X, scale, grid))
        nbytes = 2 * n * k * X.element_size()
        rec = {"phase": "kernel", "name": "stencil3d", "grid": list(grid),
               "k": k, "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": err, "tol": tol, "ms": ms,
               "gbps": nbytes / ms / 1e6, "plain_ms": plain_ms,
               "plain_gbps": nbytes / plain_ms / 1e6,
               # 6x, six subtractions, one scale: 8 operations per element.
               **bound(nbytes, 8 * n * k), "library_ms": None}
        if dt == torch.float32 and grid == GRID3 and k == 16:
            lib = conv3d_stencil(X, scale, grid)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                rec["library_max_abs_err"] = max_abs(
                    lib().permute(0, 2, 3, 4, 1).reshape(n, k),
                    k2.stencil3d_matmat_reference(X, scale, grid))
                rec["library_ms"] = time_ms(lib)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
        emit(rec)
        out.append(rec)
        del X
        free()
    return out


def batched_check(name, b, launch, lone, plain, tol, nbytes, ops, lib,
                  info=None) -> dict:
    """A batched launch [b, n, k] (b problems sharing the grid or the
    matrix) against its plain version (within ``tol``) and against its b
    lone launches (each problem's Y equal to the bit); timed beside the b
    lone launches, the plain version and the library call ``lib``; its
    bound from ``nbytes`` and ``ops``; ``info``: keys added."""
    Y, Yp = launch(), plain()
    L = [lone(i) for i in range(b)]
    torch.cuda.synchronize()
    rec = {"phase": "kernel", "name": name, "batch": b,
           "shape": list(Y.shape), "max_abs_err": max_abs(Y, Yp), "tol": tol,
           "equal_to_lone_launches": all(torch.equal(Y[i], L[i])
                                         for i in range(b)), **(info or {})}
    finite = bool(torch.isfinite(Y).all())
    del Y, Yp, L
    free()
    if not (finite and rec["max_abs_err"] <= tol
            and rec["equal_to_lone_launches"]):
        emit(rec)
        raise AssertionError(f"batched {name}: {rec}")
    rec.update({"ms": timed_untracked(launch),
                "lone_launches_ms": timed_untracked(
                    lambda: [lone(i) for i in range(b)]),
                "plain_ms": time_ms(plain), **bound(nbytes, ops),
                "library_ms": time_ms(lib)})
    emit(rec)
    return rec


def k2_batched_check(dev) -> dict:
    """K2 over the lockstep_nd phase's block, len(TRAP_C) problems on the
    160^3 grid at k 16: one launch against its plain version, the lone
    launches and cuDNN's conv3d over the batch (N 4)."""
    h = 1.0 / (GRID3[0] + 1)
    scale = 1.0 / (h * h)
    b, n, k = len(TRAP_C), math.prod(GRID3), SS3
    gen = torch.Generator(device=dev).manual_seed(7)
    X = torch.rand((b, n, k), generator=gen, device=dev) - 0.5
    lib = conv3d_stencil(X, scale, GRID3)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rec = batched_check(
            "stencil3d", b, lambda: k2.stencil3d_matmat(X, scale, GRID3),
            lambda i: k2.stencil3d_matmat(X[i], scale, GRID3),
            lambda: k2.stencil3d_matmat_reference(X, scale, GRID3),
            # 4 ulp x the largest output, 12 |scale| max|X| (as k2_phase).
            4 * torch.finfo(torch.float32).eps * 12 * scale
            * float(X.abs().max()),
            2 * X.numel() * 4, 8 * X.numel(), lib,
            info={"grid": list(GRID3), "k": k, "dtype": "float32"})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del X, lib
    free()
    return rec


def bsr_batched_check(name, b, idx, vals, X, A_csr, nnz, depth, info) -> dict:
    """K3 (``name`` bsr_ell: idx the block columns, vals the blocks) or K5
    (bsr_window: the window starts and values) over a batch X [b, n, k]:
    one launch against its plain version (spmm_check's tolerance), the b
    lone launches and torch.sparse.mm on the block folded to [n, b k];
    beside the nonzero bound its format's floor (the stored values once,
    each problem's X and Y)."""
    n, k = X.shape[1], X.shape[2]
    if name == "bsr_ell":
        fn = lambda Z: kb.bsr_matmat(idx, vals, Z)
        ref = lambda V, Z: kb.bsr_matmat_reference(idx, V, Z)
    else:
        fn = lambda Z: kb.bsr_window_matmat(idx, vals, Z, bs=BAND_BS)
        ref = lambda V, Z: kb.bsr_window_matmat_reference(idx, V, Z, bs=BAND_BS)
    tol = 2 * depth * torch.finfo(torch.float32).eps * float(
        ref(vals.abs(), X.abs()).max())
    folded = X.permute(1, 0, 2).reshape(n, b * k)
    rec = batched_check(
        name, b, lambda: fn(X), lambda i: fn(X[i]), lambda: ref(vals, X), tol,
        4 * nnz + 2 * 4 * X.numel(), 2 * nnz * k * b,
        lambda: torch.sparse.mm(A_csr, folded),
        info={"n": n, "k": k, "nnz": nnz, "depth": depth, **info,
              **format_floor(vals, b * n, k)})
    del folded
    free()
    return rec


# --- K3/K4/K5: the block-sparse SpMMs -----------------------------------------


def csr_tensor(M, dev):
    """A scipy CSR matrix as a torch f32 CSR tensor on the card."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)),
        torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data.astype(np.float32)), size=M.shape,
    ).to(dev)


def spmm_check(name, fn, plain, abs_plain, depth, nnz, n, k, lib=None,
               extra=None, timed=True, extra_bytes=0, info=None,
               fmt=None) -> dict:
    """One kernel against its plain version on the same inputs, timed
    (unless ``timed`` is False) beside its plain version and the library
    call; tolerance 2 x depth x eps_f32 x max(|A| |X|), the error bound of
    a length-depth f32 dot summed in another order.  ``extra_bytes``:
    inputs the bound counts beyond the nonzeros, X and Y; ``info``: keys
    added to the record.  ``fmt``: the stored values of the kernel's
    format (blocks [nb, R, bs, bs], strip_vals or win_vals [ns, strip,
    W]), whose floor goes beside the nonzero bound: ``format_bound_ms``
    (the stored values, X, Y and ``extra_bytes`` over the HBM rate) and
    ``dense_ffma_ms`` (every stored value of the n output rows times k
    columns, at the f32 peak)."""
    Y, Yp = fn(), plain()
    torch.cuda.synchronize()
    err = max_abs(Y, Yp)
    tol = 2 * depth * torch.finfo(torch.float32).eps * float(abs_plain().max())
    rec = {"phase": "kernel", "name": name, "n": n, "k": k, "nnz": nnz,
           "depth": depth, "max_abs_err": err, "tol": tol, **(info or {})}
    if extra is not None:
        for key, other in extra.items():  # other references, same tolerance
            rec[key] = max_abs(Y, other)
            if not rec[key] <= tol:
                raise AssertionError(f"{name}: {key} {rec[key]} > {tol}")
    if tuple(Y.shape) != (n, k) or not torch.isfinite(Y).all():
        raise AssertionError(f"{name}: bad output {tuple(Y.shape)}")
    if not err <= tol:
        raise AssertionError(f"{name} disagrees at n={n} k={k}: {err} > {tol}")
    del Y, Yp
    free()
    if not timed:
        emit(rec)
        return rec
    ms = timed_untracked(fn)
    plain_ms = time_ms(plain)
    # Least bytes: the nonzeros' f32 values, X once, Y once.
    nbytes = 4 * nnz + 2 * 4 * n * k + extra_bytes
    rec.update({"ms": ms, "gnnz_per_s": nnz * k / ms / 1e6,
                "gbps": nbytes / ms / 1e6, "plain_ms": plain_ms,
                **bound(nbytes, 2 * nnz * k),
                "library_ms": None if lib is None else time_ms(lib)})
    if fmt is not None:
        rec.update(format_floor(fmt, n, k, extra_bytes))
    emit(rec)
    return rec


def format_floor(fmt, n, k, extra_bytes=0) -> dict:
    """A format's floor: its stored values, X and Y (and ``extra_bytes``)
    at the HBM rate, and the product of the stored values of n output
    rows (fmt.numel() over fmt.shape[0] * fmt.shape[-2] rows) at the f32
    peak."""
    per_row = fmt.numel() / (fmt.shape[0] * fmt.shape[-2])
    return {"format_bound_ms": (4 * fmt.numel() + 2 * 4 * n * k + extra_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "dense_ffma_ms": 2 * n * per_row * k / F32_FLOPS * 1e3}


def ell_checks(name, cols, blocks, X, A_csr, nnz, extra=None):
    bs, R = blocks.shape[2], blocks.shape[1]
    absb = blocks.abs()
    return spmm_check(
        name, lambda: kb.bsr_matmat(cols, blocks, X),
        lambda: kb.bsr_matmat_reference(cols, blocks, X),
        lambda: kb.bsr_matmat_reference(cols, absb, X.abs()),
        R * bs, nnz, X.shape[0], X.shape[1],
        lib=lambda: torch.sparse.mm(A_csr, X), extra=extra, fmt=blocks)


def nonfinite_checks(X, kernels) -> None:
    """Each (name, kernel, plain) on X with a NaN and +-Inf placed where,
    in most row tiles, only stored zeros (and padding) meet them: the
    kernel's isnan / isinf pattern must be its plain version's (which is
    the Pallas kernels', tests/test_torch_sparse.py)."""
    Z = X.clone()
    n, k = Z.shape
    Z[0, k // 2] = float("nan")
    Z[n // 2, 0] = float("inf")
    Z[n - 1, k - 1] = -float("inf")
    for name, fn, plain in kernels:
        y, want = fn(Z), plain(Z)
        torch.cuda.synchronize()
        same = (torch.equal(y.isnan(), want.isnan())
                and torch.equal(y.isinf(), want.isinf()))
        emit({"phase": "nonfinite", "name": name, "n": n, "k": k,
              "nan_outputs": int(want.isnan().sum()),
              "inf_outputs": int(want.isinf().sum()), "pattern_equal": same})
        if not same:
            raise AssertionError(f"{name}: non-finite pattern differs from the "
                                 "plain version's")
        del y, want
    del Z
    free()


def laplacian_host_phase(dev):
    """The 160^3 Laplacian's CSR and BSROperator, host seconds apart."""
    t0 = time.perf_counter()
    ip, ix, v = lt.laplacian_3d_csr(*GRID3)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = lt.BSROperator.from_csr(ip, ix, v, block_size=8, device=dev)
    torch.cuda.synchronize()
    t_bsr = time.perf_counter() - t0
    emit({"phase": "host", "what": "laplacian_3d_csr + BSROperator.from_csr",
          "grid": list(GRID3), "nnz": int(len(v)),
          "native_library": native.native_available(),
          "laplacian_3d_csr_s": t_csr, "from_csr_s": t_bsr,
          "ell_R": int(op.blocks.shape[1]),
          "window_built": op.win_vals is not None})
    if op.win_vals is not None:
        raise AssertionError("the 160^3 Laplacian should not be windowable")
    A_csr = csr_tensor(sp.csr_matrix((v, ix, ip), shape=(len(ip) - 1,) * 2), dev)
    return op, A_csr, int(len(v))


def k3_laplacian_phase(dev, op, A_csr, nnz) -> list[dict]:
    """K3 on the 160^3 block-ELL at k 16 and 48, then over the
    lockstep_bsr phase's batch, len(TRAP_C) problems at k 16 (last)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for k in (16, 48):
        X = torch.rand((op.n, k), generator=gen, device=dev) - 0.5
        out.append(ell_checks("bsr_ell", op.block_cols, op.blocks, X, A_csr, nnz))
        out[-1]["matrix"] = "laplacian3d_160"
        del X
        free()
    b = len(TRAP_C)
    X = torch.rand((b, op.n, SS3), generator=gen, device=dev) - 0.5
    R, bs = op.blocks.shape[1], op.blocks.shape[2]
    out.append(bsr_batched_check("bsr_ell", b, op.block_cols, op.blocks, X,
                                 A_csr, nnz, R * bs,
                                 {"matrix": "laplacian3d_160"}))
    del X
    free()
    return out


def k3_frame_batched_check(dev, op, A_csr, nnz) -> dict:
    """The 160^3 block-ELL sharded at world size 1 (no window: K3 on the
    frame) applied to a batch [2, n, 16]: one K3 launch, each problem its
    lone apply's bits, against its gather + einsum (pallas "off") and
    torch.sparse.mm on the block folded to [n, 32]."""
    mesh = parallel.row_mesh(1)
    try:
        sop = parallel.ShardedBSROperator.shard(op, mesh)
        plain = dataclasses.replace(sop, pallas="off")
        b, k = 2, SS3
        gen = torch.Generator(device=dev).manual_seed(8)
        X = torch.rand((b, op.n, k), generator=gen, device=dev) - 0.5
        zero_counts()
        sop.matmat(X)
        counts = read_counts()
        if counts["bsr_ell"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"sharded 160^3 batch apply launched {counts}")
        R, bs = op.blocks.shape[1], op.blocks.shape[2]
        tol = 2 * R * bs * torch.finfo(torch.float32).eps * float(
            kb.bsr_matmat_reference(op.block_cols, op.blocks.abs(),
                                    X.abs()).max())
        folded = X.permute(1, 0, 2).reshape(op.n, b * k)
        rec = batched_check(
            "bsr_ell", b, lambda: sop.matmat(X), lambda i: sop.matmat(X[i]),
            lambda: plain.matmat(X), tol, 4 * nnz + 2 * 4 * X.numel(),
            2 * nnz * k * b, lambda: torch.sparse.mm(A_csr, folded),
            info={"phase_of": "k3_frame_batched", "matrix": "laplacian3d_160",
                  "sharded": True, "window": sop.win_vals is not None,
                  "launches": counts, "n": op.n, "k": k, "nnz": nnz,
                  **format_floor(op.blocks, b * op.n, k)})
        del sop, plain, X, folded
        free()
        return rec
    finally:
        torch.distributed.destroy_process_group()


def laplacian3d_phase(dev, name, A, X0, kernel) -> dict:
    """Standard lobpcg on the 160^3 Laplacian through operator A."""
    h = 1.0 / (GRID3[0] + 1)
    scale = 1.0 / (h * h)
    cfg = lt.SolverConfig(nev=NEV3, size_sub=SS3, tol=TOL3, max_iter=MAX_ITER3,
                          gram_precision="highest")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    r = lt.lobpcg(A, X0, config=cfg, generator=gen)
    lam = r.eigenvalues.double().cpu().numpy()
    wall = time.perf_counter() - t0
    counts = read_counts()
    exact = lt.laplacian_nd_eigs(GRID3, scale, NEV3)
    lam_max = 4 * scale * sum(math.sin(g * math.pi / (2 * (g + 1))) ** 2
                              for g in GRID3)
    err = np.abs(lam - exact)
    rec = {"phase": "laplacian3d", "operator": name, "grid": list(GRID3),
           "n": A.shape[0], "nev": NEV3, "size_sub": SS3, "tol": TOL3,
           "dtype": "float32", "converged": r.converged,
           "iterations": r.iterations, "ortho_retries": r.ortho_retries,
           "wall_s": wall, "launches": counts,
           "max_abs_err": float(err.max()),
           "max_err_over_lam_max": float(err.max() / lam_max),
           "max_rel_err": float((err / exact).max()),
           "lam_max": lam_max,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(rec)
    if not np.all(np.isfinite(lam)) or tuple(lam.shape) != (NEV3,):
        raise AssertionError(f"{name}: non-finite eigenvalues")
    if r.converged != NEV3:
        raise AssertionError(f"{name}: converged {r.converged}/{NEV3}")
    if not err.max() <= TOL3 * lam_max:
        raise AssertionError(f"{name}: max |theta - lambda| {err.max()} > "
                             f"tol * lam_max {TOL3 * lam_max}")
    if counts[kernel] < r.iterations:
        raise AssertionError(f"{name}: {kernel} launched {counts[kernel]} "
                             f"times in {r.iterations} iterations")
    return rec


def k3_frame_phase(dev, op) -> dict:
    """K3 on a shard's frame: the 160^3 block-ELL through
    ShardedBSROperator at world size 1 (halo 3,200 block rows, zeros from
    the missing neighbours; no window plan), once counted (K3 once, on
    the frame), held against and timed beside its gather + einsum
    (pallas "off", the path it replaced) and the unsharded K3 apply."""
    mesh = parallel.row_mesh(1)
    t0 = time.perf_counter()
    sop = parallel.ShardedBSROperator.shard(op, mesh)
    t_plan = time.perf_counter() - t0
    plain = dataclasses.replace(sop, pallas="off")
    gen = torch.Generator(device=dev).manual_seed(5)
    X = torch.rand((op.n, SS3), generator=gen, device=dev) - 0.5
    zero_counts()
    Y = sop.matmat(X)
    counts = read_counts()
    Yp = plain.matmat(X)
    Yabs = kb.bsr_matmat_reference(op.block_cols, op.blocks.abs(), X.abs())
    torch.cuda.synchronize()
    R, bs = op.blocks.shape[1], op.blocks.shape[2]
    tol = 2 * R * bs * torch.finfo(torch.float32).eps * float(Yabs.max())
    err = max_abs(Y, Yp)
    del Y, Yp, Yabs
    rec = {"phase": "k3_frame", "grid": list(GRID3), "k": SS3,
           "halo_blocks": sop.halo, "window": sop.win_vals is not None,
           "plan_s": t_plan, "launches": counts, "max_abs_err": err, "tol": tol,
           "sharded_k3_ms": timed_untracked(lambda: sop.matmat(X)),
           "sharded_plain_ms": time_ms(lambda: plain.matmat(X)),
           "unsharded_k3_ms": timed_untracked(lambda: op.matmat(X))}
    emit(rec)
    del sop, plain, X
    torch.distributed.destroy_process_group()
    if counts["bsr_ell"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"sharded 160^3 apply launched {counts}")
    if not err <= tol:
        raise AssertionError(f"K3 on the frame: {err} > {tol}")
    return rec


def banded_bsr(n: int, bs: int, band: int, seed: int = 0):
    """benchmarks/bsr_spmm.py's banded matrix in block-ELL form: block row
    i couples to block columns i-w..i+w, w = ceil(band/bs), random
    uniform(-0.5, 0.5) blocks from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    nb = n // bs
    w = -(-band // bs)
    R = 2 * w + 1
    cols = np.zeros((nb, R), np.int32)
    vals = np.zeros((nb, R, bs, bs), np.float32)
    for d in range(-w, w + 1):
        r = d + w
        i = np.arange(nb)
        j = i + d
        ok = (j >= 0) & (j < nb)
        cols[ok, r] = j[ok]
        vals[ok, r] = rng.uniform(-0.5, 0.5, (int(ok.sum()), bs, bs))
    return cols, vals


def ell_to_csr(cols, vals):
    """The block-ELL matrix as scipy CSR (padding dropped)."""
    nb, R, bs, _ = vals.shape
    M = sp.bsr_matrix((vals.reshape(-1, bs, bs), cols.reshape(-1),
                       np.arange(0, nb * R + 1, R)), shape=(nb * bs,) * 2)
    M = M.tocsr()
    M.sum_duplicates()
    M.eliminate_zeros()
    return M


def band_phase(dev) -> dict:
    """K3, K4 and K5 on the bench's banded matrix, the SpMM path, and the
    symmetric SPD variant through BSROperator."""
    out = {}
    t0 = time.perf_counter()
    cols, vals = banded_bsr(BAND_N, BAND_BS, BAND)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    M = ell_to_csr(cols, vals)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc, sv = kb.ell_to_strip_ell(cols, vals, strip=STRIP)
    t_strip = time.perf_counter() - t0
    t0 = time.perf_counter()
    lo, wv = kb.ell_to_strip_window(cols, vals, strip=STRIP)
    t_win = time.perf_counter() - t0
    nnz = int(M.nnz)
    emit({"phase": "host", "what": "banded matrix and its formats",
          "n": BAND_N, "bs": BAND_BS, "band": BAND, "nnz": nnz, "strip": STRIP,
          "ell_R": int(cols.shape[1]), "strip_ell_Rs": int(sc.shape[1]),
          "window_W": int(wv.shape[2]), "window_gib": wv.nbytes / 2**30,
          "build_s": t_build, "to_csr_s": t_csr, "ell_to_strip_ell_s": t_strip,
          "ell_to_strip_window_s": t_win})

    to = lambda a: torch.from_numpy(a).to(dev)
    cols_d, vals_d, sc_d, sv_d, lo_d, wv_d = (to(a) for a in (cols, vals, sc, sv, lo, wv))
    del sv, wv
    A_csr = csr_tensor(M, dev)
    X = (torch.rand((BAND_N, BAND_K), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3)) - 0.5)
    lib = lambda: torch.sparse.mm(A_csr, X)
    # K4's and K5's times include the non-finite flag's pass over X; its
    # own time beside them.
    flag_info = {"nonfinite_flag_ms": timed_untracked(lambda: kb.nonfinite_flag(X))}
    ell_ref = kb.bsr_matmat_reference(cols_d, vals_d, X)
    out["bsr_ell"] = ell_checks("bsr_ell", cols_d, vals_d, X, A_csr, nnz)
    svabs, wvabs = sv_d.abs(), wv_d.abs()
    out["bsr_strip"] = spmm_check(
        "bsr_strip", lambda: kb.bsr_strip_matmat(sc_d, sv_d, X, bs=BAND_BS),
        lambda: kb.bsr_strip_matmat_reference(sc_d, sv_d, X, bs=BAND_BS),
        lambda: kb.bsr_strip_matmat_reference(sc_d, svabs, X.abs(), bs=BAND_BS),
        sv_d.shape[2], nnz, BAND_N, BAND_K, lib=lib,
        extra={"max_abs_err_vs_ell": ell_ref}, fmt=sv_d, info=flag_info)
    out["bsr_window"] = spmm_check(
        "bsr_window", lambda: kb.bsr_window_matmat(lo_d, wv_d, X, bs=BAND_BS),
        lambda: kb.bsr_window_matmat_reference(lo_d, wv_d, X, bs=BAND_BS),
        lambda: kb.bsr_window_matmat_reference(lo_d, wvabs, X.abs(), bs=BAND_BS),
        wv_d.shape[2], nnz, BAND_N, BAND_K, lib=lib,
        extra={"max_abs_err_vs_ell": ell_ref}, fmt=wv_d, info=flag_info)
    for rec in out.values():
        rec["matrix"] = "band"
    del svabs, wvabs, ell_ref
    free()
    nonfinite_checks(X, [
        ("bsr_ell", lambda Z: kb.bsr_matmat(cols_d, vals_d, Z),
         lambda Z: kb.bsr_matmat_reference(cols_d, vals_d, Z)),
        ("bsr_strip", lambda Z: kb.bsr_strip_matmat(sc_d, sv_d, Z, bs=BAND_BS),
         lambda Z: kb.bsr_strip_matmat_reference(sc_d, sv_d, Z, bs=BAND_BS)),
        ("bsr_window", lambda Z: kb.bsr_window_matmat(lo_d, wv_d, Z, bs=BAND_BS),
         lambda Z: kb.bsr_window_matmat_reference(lo_d, wv_d, Z, bs=BAND_BS))])

    # The SpMM path (benchmarks/bsr_spmm.py's sequence): one apply per
    # format through its wrapper, counted.
    zero_counts()
    for fn in (lambda: kb.bsr_window_matmat(lo_d, wv_d, X, bs=BAND_BS),
               lambda: kb.bsr_strip_matmat(sc_d, sv_d, X, bs=BAND_BS),
               lambda: kb.bsr_matmat(cols_d, vals_d, X)):
        Y = fn()
        if not torch.isfinite(Y).all():
            raise AssertionError("SpMM path: non-finite output")
    counts = read_counts()
    emit({"phase": "spmm_path", "matrix": "band", "k": BAND_K, "launches": counts})
    out["spmm_path_launches"] = counts
    del cols_d, vals_d, sc_d, sv_d, lo_d, wv_d, A_csr, Y
    free()

    # The symmetric SPD variant: windowable; matmat picks by the rule
    # (BSROperator.window_pays), which sends k 128 on this band to K3.
    t0 = time.perf_counter()
    S = M + M.T
    S = (S + sp.identity(BAND_N, format="csr")
         * (float(abs(S).sum(axis=1).max()) + 1.0)).tocsr()
    S.sort_indices()
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = lt.BSROperator.from_csr(S.indptr, S.indices, S.data, block_size=BAND_BS,
                                 device=dev)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    emit({"phase": "host", "what": "symmetric banded SPD variant",
          "nnz": int(S.nnz), "symmetrise_s": t_sym, "from_csr_s": t_op,
          "window_built": op.win_vals is not None,
          "window_W": None if op.win_vals is None else int(op.win_vals.shape[2])})
    if op.win_vals is None:
        raise AssertionError("the symmetric band should carry the window")
    S_csr = csr_tensor(S, dev)
    Y = dispatch_check(op, X, "band_spd")
    wvabs = op.win_vals.abs()
    out["bsr_window_spd"] = spmm_check(
        "bsr_window",
        lambda: kb.bsr_window_matmat(op.win_lo, op.win_vals, X, bs=BAND_BS),
        lambda: kb.bsr_window_matmat_reference(op.win_lo, op.win_vals, X,
                                               bs=BAND_BS),
        lambda: kb.bsr_window_matmat_reference(op.win_lo, wvabs, X.abs(),
                                               bs=BAND_BS),
        op.win_vals.shape[2], int(S.nnz), BAND_N, BAND_K,
        lib=lambda: torch.sparse.mm(S_csr, X),
        extra={"max_abs_err_vs_ell": kb.bsr_matmat_reference(
            op.block_cols, op.blocks, X),
            "max_abs_err_of_matmat": Y}, fmt=op.win_vals, info=flag_info)
    out["bsr_window_spd"]["matrix"] = "band_spd"
    del Y, S_csr, wvabs
    free()
    return out, op, S, X


def dispatch_check(op, X, matrix):
    """One BSROperator.matmat apply, counted: it must launch the kernel its
    rule (window_pays) names, once, and no other.  Returns the output."""
    want = "bsr_window" if op.window_pays(X.shape[-1]) else "bsr_ell"
    zero_counts()
    Y = op.matmat(X)
    counts = read_counts()
    torch.cuda.synchronize()
    emit({"phase": "dispatch", "matrix": matrix, "k": X.shape[-1],
          "batch": X.shape[0] if X.dim() == 3 else None, "picks": want,
          "launches": counts})
    if counts[want] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"BSROperator.matmat dispatched {counts}, not {want}")
    return Y


def window_sweep_phase(dev, op, S) -> dict:
    """K5 beside K3 at SWEEP_KS on the SPD band (window 384 rows; S its
    CSR, timed through torch.sparse.mm beside them) and on
    benchmarks/bsr_spmm.py's matrix at band BAND_WIDE (window 512 rows):
    the crossing behind BSROperator.matmat's rule.  Both kernels are held
    against the window plain version at spmm_check's tolerance.  Then K5
    over a batch of len(TRAP_C) problems at k 16 on the band-BAND_WIDE
    matrix (its record is returned), and that batch through matmat at
    k 16 and 48."""
    t0 = time.perf_counter()
    cols, vals = banded_bsr(BAND_N, BAND_BS, BAND_WIDE)
    lo, wv = kb.ell_to_strip_window(cols, vals, strip=STRIP)
    to = lambda a: torch.from_numpy(a).to(dev)
    wide = lt.BSROperator(block_cols=to(cols), blocks=to(vals), win_lo=to(lo),
                          win_vals=to(wv), n=BAND_N)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    M_wide = ell_to_csr(cols, vals)
    emit({"phase": "host", "what": f"band {BAND_WIDE} and its window",
          "ell_R": int(cols.shape[1]), "window_W": int(wv.shape[2]),
          "window_gib": wv.nbytes / 2**30, "build_s": t_build,
          "to_csr_s": time.perf_counter() - t0, "nnz": int(M_wide.nnz)})
    del cols, vals, lo, wv
    gen = torch.Generator(device=dev).manual_seed(6)
    eps = torch.finfo(torch.float32).eps
    S_csr = csr_tensor(S, dev)
    for name, A, A_csr in (("band_spd", op, S_csr), (f"band{BAND_WIDE}", wide, None)):
        W = A.win_vals.shape[2]
        wvabs = A.win_vals.abs()
        for k in SWEEP_KS:
            X = torch.rand((BAND_N, k), generator=gen, device=dev) - 0.5
            k5 = lambda: kb.bsr_window_matmat(A.win_lo, A.win_vals, X, bs=BAND_BS)
            k3 = lambda: kb.bsr_matmat(A.block_cols, A.blocks, X)
            want = kb.bsr_window_matmat_reference(A.win_lo, A.win_vals, X, bs=BAND_BS)
            tol = 2 * W * eps * float(kb.bsr_window_matmat_reference(
                A.win_lo, wvabs, X.abs(), bs=BAND_BS).max())
            y5, y3 = k5(), k3()
            torch.cuda.synchronize()
            rec = {"phase": "window_vs_ell", "matrix": name, "k": k, "W": W,
                   "ell_R": int(A.blocks.shape[1]),
                   "k5_err": max_abs(y5, want), "k3_err": max_abs(y3, want),
                   "tol": tol}
            del y5, y3, want
            free()
            if not max(rec["k5_err"], rec["k3_err"]) <= tol:
                raise AssertionError(f"window sweep {name} k={k}: {rec}")
            rec.update({
                "k5_ms": timed_untracked(k5), "k3_ms": timed_untracked(k3),
                "sparse_mm_ms": None if A_csr is None
                else time_ms(lambda: torch.sparse.mm(A_csr, X)),
                "k5_format_bound_ms": format_floor(A.win_vals, BAND_N, k)["format_bound_ms"],
                "k3_format_bound_ms": format_floor(A.blocks, BAND_N, k)["format_bound_ms"]})
            emit(rec)
            dispatch_check(A, X, name)
            del X
            free()
        del wvabs
    del S_csr
    free()
    b = len(TRAP_C)
    X = torch.rand((b, BAND_N, SS3), generator=gen, device=dev) - 0.5
    wide_csr = csr_tensor(M_wide, dev)
    rec = bsr_batched_check("bsr_window", b, wide.win_lo, wide.win_vals, X,
                            wide_csr, int(M_wide.nnz), wide.win_vals.shape[2],
                            {"matrix": f"band{BAND_WIDE}",
                             "matmat_picks": "bsr_window"
                             if wide.window_pays(SS3) else "bsr_ell"})
    del wide_csr, X, M_wide
    free()
    # A batch through BSROperator.matmat: the kernel its rule names at one
    # problem's width (K3 at k 16, K5 at k 48), one launch for the batch.
    for k in (16, 48):
        X = torch.rand((b, BAND_N, k), generator=gen, device=dev) - 0.5
        dispatch_check(wide, X, f"band{BAND_WIDE}")
        del X
        free()
    del wide
    free()
    return rec


# --- K6 and the row-sharded layer ---------------------------------------------


def k6_phase(dev, op, S, X) -> list[dict]:
    """K6 on the symmetric band x 128 cut into K6_SHARDS virtual row
    shards, planned by the sharded operator's own planning
    (parallel.plan_shards); each shard's halos are cut from the global X,
    as the exchange delivers them.  Per shard: K6 equal to K5 on the
    concatenated frame (torch.equal) and within spmm_check's tolerance of
    its plain version; the shards' outputs together against the global
    plain product; an interior shard timed."""
    t0 = time.perf_counter()
    plan = parallel.plan_shards(op, K6_SHARDS)
    t_plan = time.perf_counter() - t0
    bs, H, nd = BAND_BS, plan.halo, K6_SHARDS
    hrows, n_loc, W = H * bs, BAND_N // nd, plan.width * bs
    emit({"phase": "host", "what": "band planned for row shards",
          "shards": nd, "halo_blocks": H, "hrows": hrows, "n_loc": n_loc,
          "strip": plan.strip, "window_W": W,
          "window_gib": sum(w.nbytes for w in plan.win.values()) / 2**30,
          "plan_s": t_plan})
    if W > n_loc or H == 0:
        raise AssertionError(f"K6 needs 0 < H and W <= n_loc: {H}, {W}")
    k = X.shape[1]
    Xabs = X.abs()
    zeros = torch.zeros((hrows, k), device=dev)
    recs, parts = [], []
    for d in range(nd):
        rows = slice(d * n_loc, (d + 1) * n_loc)
        up = X[d * n_loc - hrows : d * n_loc] if d > 0 else zeros
        dn = X[(d + 1) * n_loc : (d + 1) * n_loc + hrows] if d + 1 < nd else zeros
        up_abs, dn_abs = up.abs(), dn.abs()
        xs, xs_abs = X[rows], Xabs[rows]
        top, bot = torch.cat([up, xs[:W]]), torch.cat([xs[-W:], dn])
        top_abs, bot_abs = torch.cat([up_abs, xs_abs[:W]]), torch.cat([xs_abs[-W:], dn_abs])
        lo = torch.from_numpy(plan.lo[d]).to(dev)
        wv = torch.from_numpy(plan.win[d]).to(dev)
        wvabs = wv.abs()
        x_ext = torch.cat([up, xs, dn])
        starts = plan.lo[d].astype(np.int64) * bs
        classes = {"top": int((starts < hrows).sum()),
                   "bottom": int((starts > hrows + n_loc - W).sum())}
        classes["body"] = len(starts) - classes["top"] - classes["bottom"]
        if 0 < d < nd - 1 and min(classes.values()) == 0:
            raise AssertionError(f"interior shard {d} misses a source class: "
                                 f"{classes}")
        y6 = kb.bsr_window_matmat_edges(lo, wv, xs, top, bot, bs=bs, hrows=hrows)
        y5 = kb.bsr_window_matmat(lo, wv, x_ext, bs=bs, out_rows=n_loc)
        torch.cuda.synchronize()
        if not torch.equal(y6, y5):
            raise AssertionError(f"K6 differs from K5 on shard {d}: "
                                 f"{max_abs(y6, y5)}")
        parts.append(y6)
        del y5
        # The shard's nonzeros: its rows of S, over the columns of its
        # frame (the bound counts them; the interior shard's CSR times the
        # concatenated frame is the library product of the same function).
        M = S[rows.start : rows.stop,
              max(0, rows.start - hrows) : rows.stop + hrows].tocsr()
        timed = d == 1
        info = {"matrix": "band_spd", "shard": d, "classes": classes,
                "torch_equal_k5": True}
        lib = None
        if timed:
            M_csr = csr_tensor(M, dev)
            lib = lambda: torch.sparse.mm(M_csr, x_ext)
            info["k5_frame_ms"] = timed_untracked(
                lambda: kb.bsr_window_matmat(lo, wv, x_ext, bs=bs,
                                             out_rows=n_loc))
            # The two choices ShardedBSROperator.matmat has, each with the
            # buffers it builds: the edge buffers and K6, or the frame
            # and K5.
            info["edges_k6_ms"] = timed_untracked(
                lambda: kb.bsr_window_matmat_edges(
                    lo, wv, xs, torch.cat([up, xs[:W]]),
                    torch.cat([xs[-W:], dn]), bs=bs, hrows=hrows))
            info["cat_k5_ms"] = timed_untracked(
                lambda: kb.bsr_window_matmat(lo, wv, torch.cat([up, xs, dn]),
                                             bs=bs, out_rows=n_loc))
            # K6's time includes this pass over the frame's rows.
            info["nonfinite_flag_ms"] = timed_untracked(
                lambda: kb.nonfinite_flag(xs, up, dn))
        recs.append(spmm_check(
            "bsr_window_edges",
            lambda: kb.bsr_window_matmat_edges(lo, wv, xs, top, bot, bs=bs,
                                               hrows=hrows),
            lambda: kb.bsr_window_matmat_edges_reference(lo, wv, xs, top, bot,
                                                         bs=bs, hrows=hrows),
            lambda: kb.bsr_window_matmat_edges_reference(
                lo, wvabs, xs_abs, top_abs, bot_abs, bs=bs, hrows=hrows),
            W, int(M.nnz), n_loc, k, lib=lib, timed=timed,
            extra_bytes=4 * 2 * (hrows + W) * k, info=info, fmt=wv))
        lib = M_csr = None
        del lo, wv, wvabs, x_ext, top, bot, top_abs, bot_abs, up_abs, dn_abs
        free()
    Y = torch.cat(parts)
    del parts
    Yp = kb.bsr_matmat_reference(op.block_cols, op.blocks, X)
    Yabs = kb.bsr_matmat_reference(op.block_cols, op.blocks.abs(), Xabs)
    torch.cuda.synchronize()
    err = max_abs(Y, Yp)
    tol = 2 * W * torch.finfo(torch.float32).eps * float(Yabs.max())
    emit({"phase": "k6_global", "shards": nd, "max_abs_err": err, "tol": tol})
    if not err <= tol:
        raise AssertionError(f"K6 shards against the global product: {err} > {tol}")
    del Y, Yp, Yabs, Xabs
    free()
    return recs, plan


def k6_batched_check(dev, plan, S) -> dict:
    """K6 over a batch: the k6 phase's interior shard 1 of the SPD band at
    [K6_BATCH, 262,144, K6_BATCH_K], each problem's halos cut from its own
    global X: one launch against its plain version, its lone launches (bit
    for bit) and torch.sparse.mm of the shard's CSR rows on the frame
    folded to [rows, b k]; the non-finite flag pass (over X and the edge
    buffers) timed on its own."""
    bs, H, nd, d = BAND_BS, plan.halo, K6_SHARDS, 1
    hrows, n_loc, W = H * bs, BAND_N // nd, plan.width * bs
    b, k = K6_BATCH, K6_BATCH_K
    gen = torch.Generator(device=dev).manual_seed(9)
    Xg = torch.rand((b, BAND_N, k), generator=gen, device=dev) - 0.5
    r0, r1 = d * n_loc, (d + 1) * n_loc
    xs = Xg[:, r0:r1].contiguous()
    x_ext = Xg[:, r0 - hrows : r1 + hrows].contiguous()
    del Xg
    top = torch.cat([x_ext[:, :hrows], xs[:, :W]], dim=1)
    bot = torch.cat([xs[:, -W:], x_ext[:, -hrows:]], dim=1)
    lo = torch.from_numpy(plan.lo[d]).to(dev)
    wv = torch.from_numpy(plan.win[d]).to(dev)
    M = S[r0:r1, r0 - hrows : r1 + hrows].tocsr()
    M_csr = csr_tensor(M, dev)
    nnz = int(M.nnz)
    folded = x_ext.permute(1, 0, 2).reshape(n_loc + 2 * hrows, b * k)
    tol = 2 * W * torch.finfo(torch.float32).eps * float(
        kb.bsr_window_matmat_edges_reference(
            lo, wv.abs(), xs.abs(), top.abs(), bot.abs(), bs=bs,
            hrows=hrows).max())
    flag_ms = time_ms(lambda: kb.nonfinite_flag(xs, top, bot))
    rec = batched_check(
        "bsr_window_edges", b,
        lambda: kb.bsr_window_matmat_edges(lo, wv, xs, top, bot, bs=bs,
                                           hrows=hrows),
        lambda i: kb.bsr_window_matmat_edges(lo, wv, xs[i], top[i], bot[i],
                                             bs=bs, hrows=hrows),
        lambda: kb.bsr_window_matmat_edges_reference(lo, wv, xs, top, bot,
                                                     bs=bs, hrows=hrows),
        tol, 4 * nnz + 4 * x_ext.numel() + 4 * xs.numel(), 2 * nnz * k * b,
        lambda: torch.sparse.mm(M_csr, folded),
        info={"matrix": "band_spd", "shard": d, "n_loc": n_loc, "k": k,
              "hrows": hrows, "window_W": W, "nnz": nnz,
              "nonfinite_flag_ms": flag_ms,
              **format_floor(wv, b * n_loc, k,
                             extra_bytes=4 * 2 * b * (hrows + W) * k)})
    del xs, x_ext, top, bot, lo, wv, M_csr, folded
    free()
    return rec


def sharded_phase(dev, main_rec, op, X) -> dict:
    """The row-sharded layer at world size 1 on NCCL: the flagship well
    through shard_problem and `with mesh: ilobpcg`, then one apply of the
    sharded band operator (which must launch K6 once and K5 never)."""
    t0 = time.perf_counter()
    mesh = parallel.row_mesh(1)
    mesh.all_reduce(torch.zeros(1, device=dev))  # NCCL sets up its communicator
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    A, B, T, X0, _, _ = solve_bdg.well_problem(
        N_MAIN, NEV, SIZE_SUB, dtype=torch.float32, cheb=CHEB_DEGREE,
        precond=True, device=dev, cheb_chunk=0)
    As, X0s, Bs, Ts = parallel.shard_problem(mesh, A, X0, B, T)
    cfg = lt.SolverConfig(nev=NEV, size_sub=SIZE_SUB, tol=TOL, max_iter=MAX_ITER,
                          gram_precision="highest", use_ax_cache=True,
                          use_b_cache=True, dual_basis=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the band operator and its X
    zero_counts()
    t0 = time.perf_counter()
    with mesh:
        r = lt.ilobpcg(As, X0s, Bs, Ts, config=cfg, generator=gen)
    lam = r.eigenvalues.double().cpu().numpy()
    wall = time.perf_counter() - t0
    counts, coll = read_counts(), read_collectives()
    exact = solve_bdg.well_eigs_oracle(solve_bdg.WELL, NEV, solve_bdg.BARRIER)
    rel = np.abs(lam - exact) / np.abs(exact)
    rec = {"phase": "sharded", "world_size": mesh.size,
           "backend": str(torch.distributed.get_backend()),
           "group_setup_s": t_init, "n": N_MAIN, "nev": NEV, "size_sub": SIZE_SUB,
           "converged": r.converged, "iterations": r.iterations, "wall_s": wall,
           "max_rel_err": float(rel.max()), "launches": counts,
           "collectives": coll,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "resident_before_gib": resident / 2**30,
           "solve_peak_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30,
           "unsharded": {key: main_rec[key] for key in (
               "iterations", "wall_s", "max_rel_err", "max_memory_allocated_gib")}}
    emit(rec)
    del As, X0s, Bs, Ts, A, B, T, X0, r
    free()
    if not np.all(np.isfinite(lam)) or tuple(lam.shape) != (NEV,):
        raise AssertionError("sharded solve returned non-finite eigenvalues")
    if rec["converged"] != NEV or not rel.max() <= ORACLE_RTOL:
        raise AssertionError(f"sharded solve: {rec['converged']}/{NEV}, "
                             f"max rel err {rel.max()}")
    if k1_family(counts) < rec["iterations"] or coll["all_reduce"] < 1:
        raise AssertionError(f"sharded solve launched {counts}, {coll}")

    sop = parallel.ShardedBSROperator.shard(op, mesh)
    Yref = op.matmat(X)
    zero_counts()
    Y = sop.matmat(X)
    counts = read_counts()
    torch.cuda.synchronize()
    Yabs = kb.bsr_matmat_reference(op.block_cols, op.blocks.abs(), X.abs())
    W = sop.win_vals.shape[2]
    tol = 2 * W * torch.finfo(torch.float32).eps * float(Yabs.max())
    err = max_abs(Y, Yref)
    brec = {"phase": "sharded_bsr", "world_size": mesh.size, "halo": sop.halo,
            "window_W": W, "launches": counts, "max_abs_err_vs_matmat": err,
            "tol": tol}
    emit(brec)
    if counts["bsr_window_edges"] != 1 or counts["bsr_window"] != 0:
        raise AssertionError(f"sharded BSR apply launched {counts}")
    if not err <= tol:
        raise AssertionError(f"sharded BSR apply: {err} > {tol}")
    del sop, Y, Yref, Yabs
    torch.distributed.destroy_process_group()
    free()
    rec["bsr"] = brec
    return rec


def blockdiag2_phase(dev, sharded_rec, op, X) -> dict:
    """The flagship well with A = BlockDiag2Operator(L + diag V, L + diag
    V) through shard_problem on row_mesh(1): the unrolled operator is the
    well's own A, so the solve must repeat the sharded phase's trajectory.
    Then one apply of a sharded CallableOperator and two of the SPD band
    gathered (a GatheredOperator, and a BSRRowPanelOperator: K3 on the
    gathered block), against their unsharded products."""
    mesh = parallel.row_mesh(1)
    A, B, T, X0, m, _ = solve_bdg.well_problem(
        N_MAIN, NEV, SIZE_SUB, dtype=torch.float32, cheb=CHEB_DEGREE,
        precond=True, device=dev, cheb_chunk=0)
    half = lt.Laplacian1D(scale=1.0, n=m, dtype=torch.float32) \
        + lt.DiagonalOperator(A.right.d[:m])
    A2 = BlockDiag2Operator(top=half, bottom=half)
    T2 = dataclasses.replace(T, op=A2)
    As, X0s, Bs, Ts = parallel.shard_problem(mesh, A2, X0, B, T2)
    if not (isinstance(As.left, parallel.SpmdLaplacian1D)
            and (As.left.n, As.left.segments) == (N_MAIN, 2)
            and torch.equal(As.right.op.d, A.right.d)):
        raise AssertionError(f"BlockDiag2Operator did not unroll into the "
                             f"well's A: {type(As).__name__}")
    cfg = lt.SolverConfig(nev=NEV, size_sub=SIZE_SUB, tol=TOL, max_iter=MAX_ITER,
                          gram_precision="highest", use_ax_cache=True,
                          use_b_cache=True, dual_basis=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with mesh:
        r = lt.ilobpcg(As, X0s, Bs, Ts, config=cfg, generator=gen)
    lam = r.eigenvalues.double().cpu().numpy()
    wall = time.perf_counter() - t0
    counts, coll = read_counts(), read_collectives()
    exact = solve_bdg.well_eigs_oracle(solve_bdg.WELL, NEV, solve_bdg.BARRIER)
    rel = np.abs(lam - exact) / np.abs(exact)
    rec = {"phase": "blockdiag2", "world_size": mesh.size, "n": N_MAIN,
           "nev": NEV, "size_sub": SIZE_SUB, "a_form": "SumOperator("
           "SpmdLaplacian1D(segments 2), LocalRows)",
           "converged": r.converged, "iterations": r.iterations, "wall_s": wall,
           "max_rel_err": float(rel.max()), "launches": counts,
           "collectives": coll,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "sharded": {key: sharded_rec[key] for key in (
               "iterations", "max_rel_err", "wall_s")}
           | {"k1_family": k1_family(sharded_rec["launches"])}}
    emit(rec)
    del As, X0s, Bs, Ts, A, B, T, X0, A2, T2, half, r
    free()
    if rec["converged"] != NEV or not rel.max() <= ORACLE_RTOL:
        raise AssertionError(f"blockdiag2: {rec['converged']}/{NEV}, "
                             f"max rel err {rel.max()}")
    if (rec["iterations"], rec["max_rel_err"], k1_family(counts)) != (
            sharded_rec["iterations"], sharded_rec["max_rel_err"],
            k1_family(sharded_rec["launches"])):
        raise AssertionError(f"blockdiag2 left the sharded phase's "
                             f"trajectory: {rec}")

    d = torch.linspace(1.0, 2.0, X.shape[0], device=dev)
    call = lt.CallableOperator(args=(d,), fn=lambda Y, s: s[:, None] * Y.flip(0),
                               n=X.shape[0])
    gathered = parallel.shard_operator(call, mesh)
    band = GatheredOperator.place(op, mesh)
    panel = BSRRowPanelOperator.shard(op, mesh)
    zero_counts()
    Yc, Yb, Yp = gathered.matmat(X), band.matmat(X), panel.matmat(X)
    counts, coll = read_counts(), read_collectives()
    # At world size 1 the panel holds every block row, so K3 on the whole
    # matrix is its unsharded product, bit for bit.
    ok = (torch.equal(Yc, call.matmat(X)) and torch.equal(Yb, op.matmat(X))
          and torch.equal(Yp, kb.bsr_matmat(op.block_cols, op.blocks, X)))
    grec = {"phase": "gathered", "world_size": mesh.size,
            "forms": [type(gathered).__name__, type(band).__name__,
                      type(panel).__name__],
            "launches": counts, "collectives": coll, "equal_unsharded": ok}
    emit(grec)
    del Yc, Yb, Yp, gathered, band, panel, call, d
    torch.distributed.destroy_process_group()
    free()
    if not ok or coll["all_gather_rows"] != 3 or counts["bsr_ell"] < 1 or \
            counts["bsr_ell"] + counts["bsr_window"] != 2:
        raise AssertionError(f"gathered applies: {grec}")
    rec["gathered"] = grec
    return rec


# --- graft_entry, the examples and the wide pencil ------------------------------


def gate_phase(name, run) -> dict:
    """One function of lobpcg_tpu_torch.graft_entry, counted and timed: its
    record with the wall time, the launches, and the peak over
    estimate_peak_gb where it gives both."""
    free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rec = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, coll = read_counts(), read_collectives()
    rec = {"phase": "graft_entry", "function": name, **rec, "wall_s": wall,
           "launches": counts, "collectives": coll}
    ratio = None
    if rec.get("estimate_peak_gib") and rec.get("max_memory_allocated_gib"):
        ratio = rec["max_memory_allocated_gib"] / rec["estimate_peak_gib"]
        rec["peak_over_estimate"] = ratio
    emit(rec)
    if counts["stencil1d"] < 1:
        raise AssertionError(f"{name}: K1 never launched: {counts}")
    lo, hi = (0.99, 1.0) if name.startswith("dryrun_headline") else (0.5, 1.5)
    if ratio is not None and not lo <= ratio <= hi:
        raise AssertionError(f"{name}: peak over estimate_peak_gb {ratio} "
                             f"outside [{lo}, {hi}]")
    return rec


def graft_entry_phase(dev) -> list[dict]:
    """entry(), dryrun_multichip(1), dryrun_headline() and
    dryrun_headline_complex() on the card (world size 1 on NCCL)."""
    fn, (X0,) = graft_entry.entry(dev)

    def run_entry():
        lam, res = fn(X0)
        r = fn.result
        cfg = lt.SolverConfig(nev=3, size_sub=5, tol=1e-3, max_iter=25)
        return {"eigenvalues": lam.double().cpu().tolist(),
                "max_residual": float(res.max()), "iterations": r.iterations,
                "converged": r.converged,
                "rr_dtype": str(cfg.resolved_rr_dtype(torch.float32)
                                or torch.float32).replace("torch.", ""),
                "estimate_peak_gib": lt.estimate_peak_gb(128, 5, torch.float32, cfg),
                "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}

    recs = [gate_phase("entry", run_entry)]
    exact = (np.arange(1, 4) * np.pi) ** 2
    lam = np.asarray(recs[0]["eigenvalues"])
    if not (np.all(np.isfinite(lam)) and np.abs(lam - exact).max() / exact.min() < 0.03):
        raise AssertionError(f"entry(): eigenvalues off: {lam}")
    recs.append(gate_phase("dryrun_multichip",
                           lambda: graft_entry.dryrun_multichip(1)))
    if recs[-1]["launches"]["bsr_ell"] < 1:
        raise AssertionError("dryrun_multichip: the sharded SpMM did not "
                             f"launch K3: {recs[-1]['launches']}")
    recs.append(gate_phase("dryrun_headline", graft_entry.dryrun_headline))
    recs.append(gate_phase("dryrun_headline_complex",
                           graft_entry.dryrun_headline_complex))
    torch.distributed.destroy_process_group()
    free()
    return recs


def _rel(lam, exact) -> float:
    lam, exact = np.asarray(lam, np.float64), np.asarray(exact, np.float64)
    return float(np.max(np.abs(lam - exact) / np.abs(exact)))


def _discrete_laplacian(n, nev):
    h = 1.0 / (n + 1)
    return 4.0 / h**2 * np.sin(np.arange(1, nev + 1) * np.pi * h / 2) ** 2


# Each example: its module, and its script's oracle as (check, tolerance).
EXAMPLES = {
    "laplacian_1d": (laplacian_1d, lambda o: (
        o["converged"] == 3, _rel(o["eigenvalues"], o["analytic"]), 0.03)),
    "bdg_indefinite": (bdg_indefinite, lambda o: (
        o["converged"] == 3 and o["signatures"] == [1, 1, 1],
        _rel(o["eigenvalues"], _discrete_laplacian(400, 3)), 1e-5)),
    "checkpoint_resume": (checkpoint_resume, lambda o: (
        o["converged"] == 3 and o["snapshot_iterations"] == 10,
        _rel(o["eigenvalues"], _discrete_laplacian(400, 3)), 1e-8)),
    "sparse_3d_laplacian": (sparse_3d_laplacian, lambda o: (
        o["converged"] == 5, _rel(o["eigenvalues"], o["exact"]), 1e-8)),
    "complex_on_gpu": (complex_on_gpu, lambda o: (
        o["converged"] == 6 and o["eigenvector_dtype"] == "complex64",
        _rel(o["eigenvalues"], o["analytic"]), 0.03)),
    "fft_matrix_free": (fft_matrix_free, lambda o: (
        o["converged"] == 8 and o["rr_dtype"] == "complex128",
        _rel(o["eigenvalues"], o["exact"]), 1e-5)),
    "sharded_solve": (sharded_solve, lambda o: (
        o["converged"] == 3, _rel(o["eigenvalues"], o["dense_oracle"]), 1e-9)),
}


def examples_phase(dev) -> None:
    """Each example's main on the card against its script's oracle, with
    the kernels it launched."""
    for name, (module, oracle) in EXAMPLES.items():
        free()
        zero_counts()
        t0 = time.perf_counter()
        out = module.main(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ok, err, tol = oracle(out)
        emit({"phase": "examples", "example": name, **out, "wall_s": wall,
              "max_rel_err_vs_oracle": err, "tol": tol,
              "launched": {k: v for k, v in counts.items() if v}})
        if torch.distributed.is_initialized():  # sharded_solve's group
            torch.distributed.destroy_process_group()
        if not (ok and err <= tol):
            raise AssertionError(f"example {name}: {out}, error {err} > {tol}")


def wide_pencil_phase(dev) -> list[dict]:
    """The wide pencil (projected width 768) under rr_dtype float32 and the
    default (float64 at this width): 150/150 within 1e-5 each."""
    recs = []
    for rr in ("float32", None):
        free()
        zero_counts()
        rec = solve_bdg.solve(N_WIDE, NEV_WIDE, SS_WIDE, tol=TOL,
                              dtype="float32", precond=True, check=True,
                              warmup=False, reps=1, rr_dtype=rr, device=dev)
        counts = read_counts()
        rec = {"phase": "wide_pencil", "rr_dtype_arg": rr, **rec,
               "launches": counts}
        emit(rec)
        if rec["converged"] != NEV_WIDE or not rec["max_rel_err"] <= ORACLE_RTOL:
            raise AssertionError(f"wide pencil (rr_dtype {rr}): "
                                 f"{rec['converged']}/{NEV_WIDE}, max rel err "
                                 f"{rec['max_rel_err']}")
        if k1_family(counts) < rec["iterations"]:
            raise AssertionError(f"wide pencil: the stencil kernels launched "
                                 f"{counts} in {rec['iterations']} iterations")
        recs.append(rec)
    return recs


def batched_phase(dev) -> dict:
    """lt.batched over BATCH_BARRIERS of the well at 1M x 16 (one X0):
    each problem against its barrier's oracle, two against their lone
    solves; K1 launched; per-problem iterations and wall, the batch's wall
    and peak."""
    cfg = lt.SolverConfig(nev=NEV_BATCH, size_sub=SS_BATCH, tol=TOL,
                          max_iter=MAX_ITER, gram_precision="highest")
    gen = torch.Generator(device=dev).manual_seed(0)
    walls = []

    def solve(barrier):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            N_BATCH, NEV_BATCH, SS_BATCH, dtype=torch.float32,
            cheb=CHEB_DEGREE, precond=True, device=dev, barrier=float(barrier))
        r = lt.ilobpcg(A, X0, B, T, config=cfg, generator=gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return r.eigenvalues, r.converged, r.iterations

    barriers = torch.tensor(BATCH_BARRIERS, dtype=torch.float64)
    free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    lam, conv, it = lt.batched(solve, generators=[gen])(barriers)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch_walls = list(walls)

    t0 = time.perf_counter()
    exact = [well_oracle(b) for b in BATCH_BARRIERS]
    emit({"phase": "host", "what": "the 8 barriers' dense well oracles",
          "seconds": time.perf_counter() - t0})
    lam64 = lam.double().cpu().numpy()
    rel = [float(np.max(np.abs(lam64[i] - e) / np.abs(e)))
           for i, e in enumerate(exact)]
    lone = {}
    for i in BATCH_LONE:
        gen.manual_seed(0)
        lam_i, _, it_i = solve(barriers[i])
        lone[i] = {"equal_eigenvalues": bool(torch.equal(lam_i, lam[i])),
                   "iterations": it_i, "wall_s": walls[-1]}
    rec = {"phase": "batched", "n": N_BATCH, "nev": NEV_BATCH,
           "size_sub": SS_BATCH, "cheb_degree": CHEB_DEGREE, "tol": TOL,
           "barriers": list(BATCH_BARRIERS), "converged": conv.tolist(),
           "iterations": it.tolist(), "wall_s_per_problem": batch_walls,
           "max_rel_err": rel, "wall_s": wall, "launches": counts,
           "max_memory_allocated_gib": peak,
           "lone": {str(i): v for i, v in lone.items()}}
    emit(rec)
    if conv.tolist() != [NEV_BATCH] * len(BATCH_BARRIERS) or \
            not max(rel) <= ORACLE_RTOL:
        raise AssertionError(f"batched: converged {conv.tolist()}, max rel "
                             f"err {rel}")
    if k1_family(counts) < 2 * sum(it.tolist()):
        raise AssertionError(f"batched: the stencil kernels launched "
                             f"{counts} in {sum(it.tolist())} iterations")
    for i, v in lone.items():
        if not (v["equal_eigenvalues"] and v["iterations"] == int(it[i])):
            raise AssertionError(f"batched problem {i} is not its lone "
                                 f"solve: {v}, {int(it[i])} iterations")
    return rec


@functools.cache
def well_oracle(barrier: float) -> np.ndarray:
    """solve_bdg.well_eigs_oracle at NEV_BATCH, once per barrier."""
    return solve_bdg.well_eigs_oracle(solve_bdg.WELL, NEV_BATCH, barrier)


def well_oracle_tridiagonal(barrier: float) -> np.ndarray:
    """The low eigenvalues of well_eigs_oracle's matrix (the well in
    WELL_MARGIN barrier sites each side) through LAPACK's tridiagonal
    eigensolver: milliseconds where the dense one takes seconds."""
    import scipy.linalg as sla

    size = solve_bdg.WELL + 2 * WELL_MARGIN
    V = np.full(size, barrier + solve_bdg.SHIFT)
    V[WELL_MARGIN : WELL_MARGIN + solve_bdg.WELL] = solve_bdg.SHIFT
    return sla.eigvalsh_tridiagonal(2.0 + V, -np.ones(size - 1), select="i",
                                    select_range=(0, NEV_BATCH - 1))


class SyncCount:
    """The host syncs of a region, counted through torch's CUDA sync debug
    mode ("warn": one warning per synchronizing call)."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def so_far(self) -> int:
        return sum("synchroniz" in str(w.message) for w in self._seen)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.count = self.so_far()
        return False


def lockstep_problem(n: int, barriers, dev):
    """The well pencil over ``barriers`` as one lockstep problem: the
    shared two-segment Laplacian1D plus a DiagonalOperator [b, n], the
    shared B, a Chebyshev filter with [b] upper bounds, X0 [b, n, 30]."""
    diags, his = [], []
    for barrier in barriers:
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            n, NEV_BATCH, SS_BATCH, dtype=torch.float32, cheb=CHEB_DEGREE,
            precond=True, device=dev, barrier=barrier)
        diags.append(A.right.d)
        his.append(T.hi)
    A = A.left + lt.DiagonalOperator(torch.stack(diags))
    T = dataclasses.replace(T, op=A, hi=torch.tensor(his, dtype=torch.float64,
                                                     device=dev))
    return A, B, T, X0.expand(len(barriers), *X0.shape).contiguous()


def lockstep_sweep(dev, n: int, barriers, cfg, oracle) -> tuple[dict, object]:
    """One lockstep ilobpcg over ``barriers``: its record (converged,
    iterations, errors against ``oracle``, wall, peak, launches, host
    syncs) and the result."""
    A, B, T, X0 = lockstep_problem(n, barriers, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with SyncCount() as syncs:
        r = lt.ilobpcg(A, X0, B, T, config=cfg, generator=gen)
        lam64 = r.eigenvalues.double().cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rel = [float(np.max(np.abs(lam64[i] - e) / np.abs(e)))
           for i, e in enumerate(oracle(b) for b in barriers)]
    lock_iters = int(r.iterations.max())
    return {"n": n, "nev": NEV_BATCH, "size_sub": SS_BATCH,
            "cheb_degree": CHEB_DEGREE, "tol": TOL, "problems": len(barriers),
            "barriers": list(barriers), "converged": r.converged.tolist(),
            "iterations": r.iterations.tolist(),
            "lockstep_iterations": lock_iters, "max_rel_err": rel,
            "quality5": r.quality5_count.tolist(),
            "rr_failed": r.rr_fail_count.tolist(), "wall_s": wall,
            "launches": counts,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "estimate_peak_gib": lt.estimate_peak_gb(
                n, SS_BATCH, torch.float32, cfg, batch=len(barriers)),
            "host_syncs": syncs.count,
            "host_syncs_per_iteration": syncs.count / max(lock_iters, 1)}, r


def lone_solve(dev, n, barrier, cfg, it_cap=None) -> dict:
    """One problem of a sweep alone (the generator seeded as the batch's):
    its iterations, K1 launches, host syncs and wall."""
    A, B, T, X0, _, _ = solve_bdg.well_problem(
        n, NEV_BATCH, SS_BATCH, dtype=torch.float32, cheb=CHEB_DEGREE,
        precond=True, device=dev, barrier=barrier)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with SyncCount() as syncs:
        r = lt.ilobpcg(A, X0, B, T, config=cfg, generator=gen, it_cap=it_cap)
        r.eigenvalues.cpu()  # the result's read, counted as the batch's is
    torch.cuda.synchronize()
    return {"iterations": r.iterations, "k1": k1_family(read_counts()),
            "host_syncs": syncs.count, "wall_s": time.perf_counter() - t0}


def tall_gram_check(dev) -> dict:
    """The tall Gram V^H U at the 8 x 1M sweep's shape ([8, 1M, 30] f32,
    uniform [0, 1) entries: sums of 1M positive terms) three ways: the
    batched contraction of ops/gram.py (split over rows), one
    strided-batched GEMM over all the rows, and one GEMM per problem;
    ms and the largest error of each relative to the largest entry of
    the float64 product."""
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (len(BATCH_BARRIERS), N_BATCH, SS_BATCH)
    V = torch.rand(shape, generator=gen, device=dev)
    U = torch.rand(shape, generator=gen, device=dev)
    ref = torch.matmul(V.double().mH, U.double())
    scale = float(ref.abs().max())
    ways = {
        "split_rows": lambda: gram._local_hdot(V, U),
        "strided_batched": lambda: torch.matmul(V.mH, U),
        "per_problem": lambda: torch.stack(
            [torch.matmul(V[i].mH, U[i]) for i in range(shape[0])]),
    }
    out = {}
    for name, fn in ways.items():
        err = float((fn().double() - ref).abs().max()) / scale
        out[name] = {"ms": time_ms(fn), "max_rel_err": err}
    del V, U, ref
    free()
    return out


def k1_accounting(dev, n, barrier, cfg, lock_iters) -> dict:
    """The K1 launches a lockstep sweep must make, one a batch apply: its
    longest-running problem alone applies A `fixed` times before its loop
    (it_cap 0) and `per_it` times an iteration, so the batch launches K1
    fixed + per_it x its own iterations.  With that lone solve's record."""
    lone = lone_solve(dev, n, barrier, cfg)
    fixed = lone_solve(dev, n, barrier, cfg, it_cap=0)["k1"]
    per_it = (lone["k1"] - fixed) / lone["iterations"]
    return {"lone": {"iterations": lone["iterations"], "k1_launches": lone["k1"],
                     "k1_before_loop": fixed, "k1_per_iteration": per_it,
                     "host_syncs_per_iteration":
                         lone["host_syncs"] / lone["iterations"],
                     "wall_s": lone["wall_s"]},
            "k1_launches_expected": fixed + per_it * lock_iters}


def check_sweep(rec) -> None:
    """A lockstep sweep's checks: 16/16 for every problem within
    ORACLE_RTOL of its oracle, and K1 launched once a batch apply."""
    phase, problems = rec["phase"], rec["problems"]
    if rec["converged"] != [NEV_BATCH] * problems or \
            not max(rec["max_rel_err"]) <= ORACLE_RTOL:
        raise AssertionError(f"{phase}: converged {rec['converged']}, max rel "
                             f"err {rec['max_rel_err']}")
    if k1_family(rec["launches"]) != rec["k1_launches_expected"]:
        raise AssertionError(f"{phase}: the K1 family launched "
                             f"{k1_family(rec['launches'])} times, the "
                             f"longest problem's applies are "
                             f"{rec['k1_launches_expected']}")


def lockstep_phase(dev, batched_rec) -> list[dict]:
    """The batched phase's 8 barriers at 1M x 16 as one lockstep ilobpcg,
    then 32 barriers at n 65,536 beside lt.batched on 4 of them."""
    cfg = lt.SolverConfig(nev=NEV_BATCH, size_sub=SS_BATCH, tol=TOL,
                          max_iter=MAX_ITER, gram_precision="highest")
    rec, r = lockstep_sweep(dev, N_BATCH, BATCH_BARRIERS, cfg, well_oracle)
    longest = int(torch.argmax(r.iterations))
    lam = r.eigenvalues.cpu()
    del r
    free()
    rec = {"phase": "lockstep", **rec,
           "batched_wall_s": batched_rec["wall_s"],
           "batched_iterations": batched_rec["iterations"],
           "batched_k1_launches": k1_family(batched_rec["launches"]),
           "longest_problem": longest,
           **k1_accounting(dev, N_BATCH, BATCH_BARRIERS[longest], cfg,
                           rec["lockstep_iterations"]),
           "tall_gram": tall_gram_check(dev)}
    emit(rec)
    check_sweep(rec)
    recs = [rec]
    free()

    # 32 barriers at n 65,536: the tridiagonal oracle, held against the
    # dense one where the sweeps share a barrier.
    for b in (1.0, 4.0):
        err = float(np.max(np.abs(well_oracle_tridiagonal(b) - well_oracle(b))
                           / np.abs(well_oracle(b))))
        if not err <= 1e-12:
            raise AssertionError(f"tridiagonal oracle off by {err} at {b}")
    rec, r = lockstep_sweep(dev, LOCK_SMALL_N, LOCK_SMALL_BARRIERS, cfg,
                            well_oracle_tridiagonal)
    longest = int(torch.argmax(r.iterations))
    del r
    free()
    acct = k1_accounting(dev, LOCK_SMALL_N, LOCK_SMALL_BARRIERS[longest], cfg,
                         rec["lockstep_iterations"])
    # lt.batched on the first few, one problem after another; each
    # problem's wall and host syncs are read inside the batch's run.
    gen = torch.Generator(device=dev).manual_seed(0)
    walls, syncs_each = [], []

    def one(barrier):
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            LOCK_SMALL_N, NEV_BATCH, SS_BATCH, dtype=torch.float32,
            cheb=CHEB_DEGREE, precond=True, device=dev, barrier=float(barrier))
        torch.cuda.synchronize()
        t0, s0 = time.perf_counter(), syncs.so_far()
        r = lt.ilobpcg(A, X0, B, T, config=cfg, generator=gen)
        r.eigenvalues.cpu()  # the result's read, counted as the batch's is
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        syncs_each.append(syncs.so_far() - s0)
        return r.eigenvalues, r.converged, r.iterations

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SyncCount() as syncs:
        _, seq_conv, seq_it = lt.batched(one, generators=[gen])(
            torch.tensor(LOCK_SMALL_BARRIERS[:LOCK_SMALL_SEQ],
                         dtype=torch.float64))
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    rec = {"phase": "lockstep_small", **rec, "longest_problem": longest,
           **acct,
           "sequential": {"problems": LOCK_SMALL_SEQ, "wall_s": seq_wall,
                          "converged": seq_conv.tolist(),
                          "iterations": seq_it.tolist(),
                          "wall_s_per_problem": walls,
                          "host_syncs_per_iteration": [
                              q / int(it) for q, it in zip(syncs_each, seq_it)]}}
    emit(rec)
    check_sweep(rec)
    recs.append(rec)
    return recs, lam


def k1_edges_batched_check(dev) -> dict:
    """K1's batched edge form at the lockstep_sharded sweep's folded block:
    [8, 1M, 30] as [8M, 30] over 16 segments (two a problem), with random
    nonzero edge rows [8, 2, 30]: one launch against its plain version
    (error 0) and its 8 lone launches with their own edge pairs (bit for
    bit); timed beside them, the unbatched [8M, 30] launch without edge
    rows, the plain version and cuDNN's conv1d over the same bytes."""
    b, n, k = len(BATCH_BARRIERS), N_BATCH, SS_BATCH
    segs = 2 * b
    gen = torch.Generator(device=dev).manual_seed(11)
    X = torch.rand((b * n, k), generator=gen, device=dev) - 0.5
    E = torch.rand((b, 2, k), generator=gen, device=dev) + 0.5
    lib = stencil_widths.conv1d_stencil(X, 1.0, segs)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rec = batched_check(
            "stencil1d", b,
            lambda: k1.stencil_matmat(X, 1.0, E, num_segments=segs).view(b, n, k),
            lambda i: k1.stencil_matmat(X[i * n : (i + 1) * n], 1.0, E[i],
                                        num_segments=2),
            lambda: k1.stencil_matmat_reference(
                X, 1.0, E, num_segments=segs).view(b, n, k),
            0.0, 2 * X.numel() * 4 + E.numel() * 4, 4 * X.numel(), lib,
            info={"edge_rows": list(E.shape), "segments": segs,
                  "dtype": "float32",
                  "unbatched_ms": timed_untracked(
                      lambda: k1.stencil_matmat(X, 1.0, num_segments=segs)),
                  "unbatched_edges_ms": timed_untracked(
                      lambda: k1.stencil_matmat(X, 1.0, E[0],
                                                num_segments=segs))})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del X, E, lib
    free()
    return rec


def sharded_sweep(dev, mesh, n, barriers, cfg, oracle):
    """One lockstep ilobpcg over ``barriers`` through shard_problem on
    ``mesh``, X0 [b, n_loc, 30]: its record (converged, iterations, errors
    against ``oracle``, wall, peak beside estimate_peak_gb, launches,
    collectives, host syncs) and the eigenvalues on the host."""
    A, B, T, X0 = lockstep_problem(n, barriers, dev)
    As, X0s, Bs, Ts = parallel.shard_problem(mesh, A, X0, B, T)
    del A, B, T, X0
    gen = torch.Generator(device=dev).manual_seed(0)
    free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with SyncCount() as syncs, mesh:
        r = lt.ilobpcg(As, X0s, Bs, Ts, config=cfg, generator=gen)
        lam = r.eigenvalues.cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, coll = read_counts(), read_collectives()
    lam64 = lam.double().numpy()
    rel = [float(np.max(np.abs(lam64[i] - e) / np.abs(e)))
           for i, e in enumerate(oracle(b) for b in barriers)]
    lock_iters = int(r.iterations.max())
    b = len(barriers)
    rec = {"world_size": mesh.size, "n": n, "n_loc": X0s.shape[-2],
           "nev": NEV_BATCH, "size_sub": SS_BATCH, "cheb_degree": CHEB_DEGREE,
           "tol": TOL, "problems": b, "barriers": list(barriers),
           "converged": r.converged.tolist(), "iterations": r.iterations.tolist(),
           "lockstep_iterations": lock_iters, "max_rel_err": rel,
           "quality5": r.quality5_count.tolist(),
           "rr_failed": r.rr_fail_count.tolist(), "wall_s": wall,
           "launches": counts, "collectives": coll,
           "all_reduces_per_iteration": coll["all_reduce"] / max(lock_iters, 1),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "estimate_peak_gib": lt.estimate_peak_gb(
               n, SS_BATCH, torch.float32, cfg, batch=b, ranks=mesh.size),
           "host_syncs": syncs.count,
           "host_syncs_per_iteration": syncs.count / max(lock_iters, 1)}
    del As, X0s, Bs, Ts, r
    free()
    return rec, lam


def lockstep_sharded_phase(dev, lock_rec, lock_lam, sharded_rec) -> list[dict]:
    """The lockstep sweep under a row group at world size 1 (NCCL): the
    lockstep phase's 8 x 1M problems, which must take that phase's
    trajectory bit for bit, then SHARDED_4M_BARRIERS at the flagship's n."""
    cfg = lt.SolverConfig(nev=NEV_BATCH, size_sub=SS_BATCH, tol=TOL,
                          max_iter=MAX_ITER, gram_precision="highest")
    mesh = parallel.row_mesh(1)
    mesh.all_reduce(torch.zeros(1, device=dev))  # NCCL sets up its communicator
    recs = []
    try:
        rec, lam = sharded_sweep(dev, mesh, N_BATCH, BATCH_BARRIERS, cfg,
                                 well_oracle)
        flagship_ar = sharded_rec["collectives"]["all_reduce"] \
            / sharded_rec["iterations"]
        rec = {"phase": "lockstep_sharded", **rec,
               "equal_to_lockstep": {
                   "eigenvalues": bool(torch.equal(lam, lock_lam)),
                   "iterations": rec["iterations"] == lock_rec["iterations"],
                   "k1_launches": k1_family(rec["launches"])
                   == k1_family(lock_rec["launches"])},
               "lockstep_wall_s": lock_rec["wall_s"],
               "lockstep_k1_launches": k1_family(lock_rec["launches"]),
               "lockstep_max_memory_allocated_gib":
                   lock_rec["max_memory_allocated_gib"],
               "lockstep_host_syncs_per_iteration":
                   lock_rec["host_syncs_per_iteration"],
               "sharded_flagship_all_reduces_per_iteration": flagship_ar}
        emit(rec)
        recs.append(rec)
        if not np.all(np.isfinite(lam.numpy())) or \
                tuple(lam.shape) != (len(BATCH_BARRIERS), NEV_BATCH):
            raise AssertionError("lockstep_sharded: eigenvalues not finite")
        if not all(rec["equal_to_lockstep"].values()):
            raise AssertionError(f"lockstep_sharded is not the lockstep "
                                 f"phase's run: {rec['equal_to_lockstep']}")
        if rec["converged"] != [NEV_BATCH] * len(BATCH_BARRIERS) or \
                not max(rec["max_rel_err"]) <= ORACLE_RTOL:
            raise AssertionError(f"lockstep_sharded: {rec['converged']}, "
                                 f"{rec['max_rel_err']}")
        free()

        rec, lam = sharded_sweep(dev, mesh, N_MAIN, SHARDED_4M_BARRIERS, cfg,
                                 well_oracle)
        lone = lock_rec["lone"]
        expected = lone["k1_before_loop"] \
            + lone["k1_per_iteration"] * rec["lockstep_iterations"]
        rec = {"phase": "lockstep_sharded_4m", **rec,
               "k1_launches_expected": expected,
               "lockstep_8x1m_max_memory_allocated_gib":
                   lock_rec["max_memory_allocated_gib"]}
        emit(rec)
        recs.append(rec)
        if rec["converged"] != [NEV_BATCH] * len(SHARDED_4M_BARRIERS) or \
                not max(rec["max_rel_err"]) <= ORACLE_RTOL:
            raise AssertionError(f"lockstep_sharded_4m: {rec['converged']}, "
                                 f"{rec['max_rel_err']}")
        # One K1 launch a batch apply: the longest problem's applies, and
        # more only where a problem took a branch that re-applies A (the
        # dual basis or an RR failure, computed for the whole batch).
        k1_count = k1_family(rec["launches"])
        branched = sum(rec["quality5"]) + sum(rec["rr_failed"])
        if k1_count < expected or (branched == 0 and k1_count != expected):
            raise AssertionError(f"lockstep_sharded_4m: K1 launched {k1_count} "
                                 f"times, the longest problem's applies are "
                                 f"{expected}")
    finally:
        torch.distributed.destroy_process_group()
    return recs


# --- The lockstep batch over the other operators that jax.vmap maps ----------


def trap_potential(c: float, dev) -> torch.Tensor:
    """The separable anisotropic trap c ((x-1/2)^2 + 1.3 (y-1/2)^2 +
    1.7 (z-1/2)^2) on the 160^3 grid's interior points (x = (i+1) h), f32,
    flat C-order."""
    x = (torch.arange(GRID3[0], dtype=torch.float64, device=dev) + 1) \
        / (GRID3[0] + 1) - 0.5
    wx, wy, wz = TRAP_W
    V = (wx * x[:, None, None] ** 2 + wy * x[None, :, None] ** 2
         + wz * x[None, None, :] ** 2)
    return (c * V).reshape(-1).to(torch.float32)


def trap_oracle(scale: float, c: float) -> np.ndarray:
    """The NEV3 smallest eigenvalues of scale * (3-D Laplacian) + the trap
    at strength c: the potential is separable, so they are the smallest
    sums of the three 1-D spectra of scale tridiag[-1, 2, -1] +
    diag(c w_a (x - 1/2)^2), from LAPACK's tridiagonal eigensolver,
    combined as laplacian_nd_eigs combines the Laplacian's."""
    import scipy.linalg as sla

    acc = None
    for g, w in zip(GRID3, TRAP_W):
        x = (np.arange(g) + 1.0) / (g + 1) - 0.5
        lam = sla.eigh_tridiagonal(2.0 * scale + c * w * x ** 2,
                                   -scale * np.ones(g - 1), eigvals_only=True,
                                   select="i", select_range=(0, min(g, 64) - 1))
        acc = lam if acc is None else np.sort(
            (acc[:, None] + lam[None, :]).ravel())[: max(NEV3 * 4, 64)]
    return np.sort(acc)[:NEV3]


def lockstep3d_phase(dev, phase, shared, kernel, lone_rec, problems) -> dict:
    """One lockstep lobpcg over the first ``problems`` trap strengths on
    the 160^3 grid: A_p = ``shared`` (LaplacianND or BSROperator) +
    DiagonalOperator [b, n], laplacian3d's config and X0 for every
    problem.  NEV3/NEV3 for each problem within TOL3 * lam_max of its
    separable oracle; ``kernel`` launched once a batch apply, as often as
    the longest problem's applies (the laplacian3d solve ``lone_rec`` of
    problem 0 gives the applies before the loop and an iteration); the
    wall beside the lone solve's, the peak beside b x estimate_peak_gb
    and estimate_peak_gb(batch=b), the host syncs an iteration."""
    h = 1.0 / (GRID3[0] + 1)
    scale = 1.0 / (h * h)
    n = math.prod(GRID3)
    cs = TRAP_C[:problems]
    cfg = lt.SolverConfig(nev=NEV3, size_sub=SS3, tol=TOL3, max_iter=MAX_ITER3,
                          gram_precision="highest")
    V = torch.stack([trap_potential(c, dev) for c in cs])
    X1 = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.5, 0.5, (n, SS3)).astype(np.float32)).to(dev)
    X0 = X1.expand(problems, n, SS3).contiguous()
    # The applies before the loop (norm estimates, the start's RR and
    # residual): problem 0 alone, it_cap 0.
    zero_counts()
    lt.lobpcg(shared + lt.DiagonalOperator(V[0]), X1, config=cfg, it_cap=0,
              generator=torch.Generator(device=dev).manual_seed(0))
    fixed = read_counts()[kernel]
    del X1
    A = shared + lt.DiagonalOperator(V)
    free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with SyncCount() as syncs:
        r = lt.lobpcg(A, X0, config=cfg,
                      generator=torch.Generator(device=dev).manual_seed(0))
        lam = r.eigenvalues.double().cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    exact = [trap_oracle(scale, c) for c in cs]
    t_oracle = time.perf_counter() - t0
    lam_lap = lt.laplacian_nd_eigs(GRID3, scale, NEV3)
    oracle_vs_lap = float(np.max(np.abs(exact[0] - lam_lap) / lam_lap))
    lam_max = [4 * scale * sum(math.sin(g * math.pi / (2 * (g + 1))) ** 2
                               for g in GRID3) + float(V[i].max())
               for i in range(problems)]
    err = [float(np.max(np.abs(lam[i] - exact[i]))) for i in range(problems)]
    # Applies: the longest problem's, fixed + per_it an iteration, plus the
    # RR's applies again (per_it - 1) in each iteration in which a problem
    # retried its RR (between the most retries of one problem and all).
    its = r.iterations.tolist()
    retries = r.ortho_retries.tolist()
    lone_ret = lone_rec["ortho_retries"]
    per_it = (lone_rec["launches"][kernel] - fixed + lone_ret) \
        / (lone_rec["iterations"] + lone_ret)
    loop = fixed + per_it * max(its)
    expect = (loop + (per_it - 1) * max(retries),
              loop + (per_it - 1) * sum(retries))
    cfg_peak = lt.estimate_peak_gb(n, SS3, torch.float32, cfg)
    rec = {"phase": phase, "operator": type(shared).__name__,
           "grid": list(GRID3), "n": n, "problems": problems,
           "trap_c": list(cs), "nev": NEV3, "size_sub": SS3, "tol": TOL3,
           "converged": r.converged.tolist(), "iterations": its,
           "ortho_retries": retries, "oracle_lowest": [float(e[0]) for e in exact],
           "max_abs_err": err,
           "max_err_over_lam_max": [e / m for e, m in zip(err, lam_max)],
           "oracle_s": t_oracle, "oracle0_vs_laplacian_nd_eigs": oracle_vs_lap,
           "lone_problem0": {"iterations": lone_rec["iterations"],
                             "wall_s": lone_rec["wall_s"],
                             "launches": lone_rec["launches"][kernel],
                             "ortho_retries": lone_ret,
                             "peak_gib": lone_rec["max_memory_allocated_gib"]},
           "problem0_iterations_minus_lone": its[0] - lone_rec["iterations"],
           "wall_s": wall, "launches": counts,
           "launches_before_loop": fixed, "launches_per_iteration": per_it,
           "launches_expected": list(expect),
           "max_memory_allocated_gib": peak,
           "estimate_peak_gib": cfg_peak,
           "b_x_estimate_peak_gib": problems * cfg_peak,
           "lockstep_estimate_peak_gib": lt.estimate_peak_gb(
               n, SS3, torch.float32, cfg, batch=problems),
           "host_syncs": syncs.count,
           "host_syncs_per_iteration": syncs.count / max(max(its), 1)}
    emit(rec)
    del r, A, V, X0
    free()
    if not oracle_vs_lap <= 1e-12:
        raise AssertionError(f"{phase}: the trap oracle at c 0 is off the "
                             f"Laplacian's by {oracle_vs_lap}")
    if not np.all(np.isfinite(lam)) or lam.shape != (problems, NEV3):
        raise AssertionError(f"{phase}: bad eigenvalues {lam.shape}")
    if rec["converged"] != [NEV3] * problems:
        raise AssertionError(f"{phase}: converged {rec['converged']}")
    for i in range(problems):
        if not err[i] <= TOL3 * lam_max[i]:
            raise AssertionError(f"{phase} problem {i}: max |theta - lambda| "
                                 f"{err[i]} > tol * lam_max {TOL3 * lam_max[i]}")
    if not expect[0] <= counts[kernel] <= expect[1]:
        raise AssertionError(f"{phase}: {kernel} launched {counts[kernel]} "
                             f"times, the longest problem's applies are "
                             f"{expect}")
    return rec


def lockstep_callable_phase(dev) -> dict:
    """examples/fft_matrix_free.py's operator (A = F^H diag(s) F through
    CallableOperator, T its Fourier-space inverse) over FFT_SHIFTS, the
    spectrum s + shift mapped (in_axes (0,)), as one lockstep solve
    (complex64, rr_dtype float64, one X0), against each shift's lone
    solve and its exact spectrum."""
    n, nev, ss = 2048, 8, 12  # the example's
    s = 0.5 + torch.arange(n, dtype=torch.float32, device=dev)
    S = torch.stack([s + sh for sh in FFT_SHIFTS])
    cfg = lt.SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=200,
                          rr_dtype="float64")
    dt = fft_matrix_free.DTYPE
    gen = torch.Generator(device=dev).manual_seed(1)
    X1 = torch.complex(torch.rand((n, ss), generator=gen, device=dev) - 0.5,
                       torch.rand((n, ss), generator=gen, device=dev) - 0.5)

    def ops(spec, axes):
        return (lt.CallableOperator(args=(spec,), fn=fft_matrix_free.apply_A,
                                    n=n, _dtype=dt, in_axes=axes),
                lt.CallableOperator(args=(spec,), fn=fft_matrix_free.apply_T,
                                    n=n, _dtype=dt, in_axes=axes))

    def solve(spec, X, axes=None):
        A, T = ops(spec, axes)
        return lt.lobpcg(A, X, T=T, config=cfg,
                         generator=torch.Generator(device=dev).manual_seed(0))

    b = len(FFT_SHIFTS)
    lone, lone_wall = [], 0.0
    for i in range(b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ri = solve(S[i], X1)
        lone.append((ri.eigenvalues.double().cpu().numpy(), ri.converged,
                     ri.iterations))
        lone_wall += time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve(S, X1.expand(b, n, ss).contiguous(), axes=(0,))
    lam = r.eigenvalues.double().cpu().numpy()
    wall = time.perf_counter() - t0
    exact = [s[:nev].double().cpu().numpy() + sh for sh in FFT_SHIFTS]
    rel = [float(np.max(np.abs(lam[i] - exact[i]) / exact[i])) for i in range(b)]
    rel_lone = [float(np.max(np.abs(lam[i] - lone[i][0]) / exact[i]))
                for i in range(b)]
    rec = {"phase": "lockstep_callable", "n": n, "nev": nev, "size_sub": ss,
           "dtype": "complex64", "shifts": list(FFT_SHIFTS),
           "converged": r.converged.tolist(), "iterations": r.iterations.tolist(),
           "lone_converged": [x[1] for x in lone],
           "lone_iterations": [x[2] for x in lone],
           "max_rel_err_vs_exact": rel, "max_rel_diff_vs_lone": rel_lone,
           "wall_s": wall, "lone_wall_s": lone_wall}
    emit(rec)
    if rec["converged"] != [nev] * b or rec["lone_converged"] != [nev] * b:
        raise AssertionError(f"lockstep_callable: converged {rec['converged']}")
    if not (max(rel) <= 1e-5 and max(rel_lone) <= 1e-5):
        raise AssertionError(f"lockstep_callable: {rel} / {rel_lone} > 1e-5")
    return rec


def lockstep_realify_phase(dev) -> dict:
    """The realify phase's pencil (the well specified in complex128,
    solved through its split-real embedding in f32, nev 16, Chebyshev
    degree 3) over REALIFY_BARRIERS as one lockstep ilobpcg at n
    REALIFY_BATCH_N (cut from 1M): the complex diagonal [b, m] realifies
    to RealEmbeddedDiagonalOperator ([b, m] dr, di), X0 [b, 2n, 60].  Each
    problem (derealify on its slice) within ORACLE_RTOL of its barrier's
    oracle, and against its lone split-real solve."""
    n, nev = REALIFY_BATCH_N, NEV_REALIFY
    m, ss = n // 2, NEV_REALIFY + 14
    c128, b = torch.complex128, len(REALIFY_BARRIERS)
    V = torch.stack([torch.as_tensor(solve_bdg._well_potential(m, bar)[0],
                                     dtype=c128, device=dev)
                     for bar in REALIFY_BARRIERS])
    lo = solve_bdg._well_potential(m)[1]
    X0c = torch.as_tensor(solve_bdg._well_start(m, ss, lo), device=dev).to(c128)
    cfg = lt.SolverConfig(nev=nev, size_sub=ss, tol=TOL, max_iter=MAX_ITER,
                          gram_precision="highest")
    his = [solve_bdg.cheb_hi(bar) for bar in REALIFY_BARRIERS]

    def problem(d, X, hi):
        Kc = lt.Laplacian1D(scale=1.0, n=m, dtype=c128) + lt.DiagonalOperator(d)
        A, X0, B, _, rcfg = lt.realify_problem(
            lt.BlockDiagOperator(inner=Kc, copies=2), X,
            lt.BlockAntiDiagOperator(d=torch.ones((m,), dtype=c128, device=dev)),
            config=cfg, rdt=torch.float32)
        T = lt.ChebyshevFilter(op=A, lo=solve_bdg.CHEB_LO, hi=hi,
                               degree=CHEB_DEGREE)
        return A, X0, B, T, rcfg

    def solve(d, X, hi):
        A, X0, B, T, rcfg = problem(d, X, hi)
        r = lt.ilobpcg(A, X0, B, T, config=rcfg,
                       generator=torch.Generator(device=dev).manual_seed(0))
        return r, A

    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, A = solve(V, X0c.expand(b, *X0c.shape).contiguous(),
                 torch.tensor(his, dtype=torch.float64, device=dev))
    lams = [lt.derealify(types.SimpleNamespace(
        eigenvalues=r.eigenvalues[i], eigenvectors=r.eigenvectors[i],
        residual_norms=r.residual_norms[i]), nev)[0] for i in range(b)]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    kinds = sorted({type(o).__name__ for o in _operator_tree(A)})
    its, conv = r.iterations.tolist(), r.converged.tolist()
    del r, A
    free()
    lone, lone_wall = [], 0.0
    for i in range(b):
        t0 = time.perf_counter()
        ri, _ = solve(V[i], X0c, his[i])
        lone.append((lt.derealify(ri, nev)[0], ri.converged, ri.iterations))
        lone_wall += time.perf_counter() - t0
        del ri
    exact = [well_oracle(bar) for bar in REALIFY_BARRIERS]
    rel = [float(np.max(np.abs(lams[i] - e) / np.abs(e)))
           for i, e in enumerate(exact)]
    rel_lone = [float(np.max(np.abs(lams[i] - lone[i][0]) / np.abs(exact[i])))
                for i in range(b)]
    rec = {"phase": "lockstep_realify", "n_complex": n, "n_real": 2 * n,
           "nev": nev, "size_sub_real": 2 * ss, "barriers": list(REALIFY_BARRIERS),
           "operators": kinds, "converged_real": conv, "iterations": its,
           "lone_converged_real": [x[1] for x in lone],
           "lone_iterations": [x[2] for x in lone],
           "max_rel_err": rel, "max_rel_diff_vs_lone": rel_lone,
           "wall_s": wall, "lone_wall_s": lone_wall,
           "max_memory_allocated_gib": peak}
    emit(rec)
    if "RealEmbeddedDiagonalOperator" not in kinds:
        raise AssertionError(f"lockstep_realify: operators {kinds}")
    if conv != [2 * nev] * b or not max(rel) <= ORACLE_RTOL:
        raise AssertionError(f"lockstep_realify: converged {conv}, rel {rel}")
    if not max(rel_lone) <= ORACLE_RTOL:
        raise AssertionError(f"lockstep_realify: lone differs by {rel_lone}")
    return rec


def _operator_tree(op):
    """The operators held anywhere in an operator tree."""
    yield op
    if dataclasses.is_dataclass(op):
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, lt.LinearOperator):
                yield from _operator_tree(v)


def kernel_entry(name, launches, recs, at) -> dict:
    """One kernel's record in the kernels line: its launches on its path,
    the largest error over its checks, and the numbers at `at`, the
    record of its path's shape."""
    _, source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at.get("library_ms")}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    card = card_line()
    emit({"phase": "device", "card": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "native_library": "native/libsparse_prep.so"
          if native.native_available() else "numpy/scipy fallbacks"})
    t_start = time.perf_counter()

    build_phase()
    k1_recs = kernel_phase(dev)
    fused_recs = fused_phase(dev)
    tail_recs = tail_phase(dev)
    gram_recs = gram_phase(dev)
    k7_recs = copy_phase(dev)
    quickstart_phase(dev)
    main_rec, main_lam = main_phase(dev, "highest")
    free()
    chain_check(main_rec, main_lam, *main_phase(dev, "highest", chain=True))
    free()
    main_phase(dev, "high")
    free()
    bench_rec = bench_phase(dev)
    free()
    well_solve_phase(dev, "sub1M_150", N_SUB, NEV_SUB, SS_SUB, realify=False)
    free()
    well_solve_phase(dev, "realify", N_SUB, NEV_REALIFY, 0, realify=True)
    free()

    k2_recs = k2_phase(dev) + [k2_batched_check(dev)]
    op3, A_csr3, nnz3 = laplacian_host_phase(dev)
    k3_lap = k3_laplacian_phase(dev, op3, A_csr3, nnz3)
    k3_frame_batch = k3_frame_batched_check(dev, op3, A_csr3, nnz3)
    del A_csr3
    free()
    X0 = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.5, 0.5, (math.prod(GRID3), SS3)).astype(np.float32)).to(dev)
    h = 1.0 / (GRID3[0] + 1)
    st_rec = laplacian3d_phase(dev, "LaplacianND",
                               lt.LaplacianND(scale=1.0 / (h * h), grid=GRID3),
                               X0, "stencil3d")
    free()
    bsr_rec = laplacian3d_phase(dev, "BSROperator", op3, X0, "bsr_ell")
    del X0
    free()
    lockstep3d_phase(dev, "lockstep_nd",
                     lt.LaplacianND(scale=1.0 / (h * h), grid=GRID3),
                     "stencil3d", st_rec, len(TRAP_C))
    lockstep3d_phase(dev, "lockstep_bsr", op3, "bsr_ell", bsr_rec,
                     LOCK3_BSR_PROBLEMS)
    k3_frame_phase(dev, op3)
    del op3
    free()
    band, op_spd, S_spd, X_band = band_phase(dev)
    k5_batch = window_sweep_phase(dev, op_spd, S_spd)
    k6_recs, k6_plan = k6_phase(dev, op_spd, S_spd, X_band)
    k6_batch = k6_batched_check(dev, k6_plan, S_spd)
    del k6_plan
    sharded_rec = sharded_phase(dev, main_rec, op_spd, X_band)
    blockdiag2_phase(dev, sharded_rec, op_spd, X_band)
    del op_spd, S_spd, X_band
    free()
    graft_entry_phase(dev)
    examples_phase(dev)
    wide_pencil_phase(dev)
    free()
    batched_rec = batched_phase(dev)
    free()
    lock_recs, lock_lam = lockstep_phase(dev, batched_rec)
    free()
    k1_batch = k1_edges_batched_check(dev)
    lockstep_sharded_phase(dev, lock_recs[0], lock_lam, sharded_rec)
    del lock_lam
    free()
    lockstep_callable_phase(dev)
    free()
    lockstep_realify_phase(dev)
    free()

    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    fused_at = {r["name"]: r for r in fused_recs
                if r["case"] == "flagship" and r["dtype"] == "float32"}
    tail_at = {r["name"]: r for r in tail_recs if r["case"] == "flagship"}
    kernels = {"kernels": [
        # K1 at the BdG solve's shape, [4M, 64] f32; its launches on the
        # SpMM headline's path (the BdG solve's A carries a diagonal and
        # takes stencil_diag and cheb_step).
        kernel_entry("stencil1d", bench_rec["launches"]["stencil1d"],
                     k1_recs + [k1_batch], k1_recs[0]),
        # K1's walk with the diagonal (A y) and the Chebyshev step (the
        # first step's numbers), at [4M, 64] f32, launched on the BdG solve.
        kernel_entry("stencil_diag", main_rec["launches"]["stencil_diag"],
                     [r for r in fused_recs if r["name"] == "stencil_diag"],
                     fused_at["stencil_diag"]),
        kernel_entry("cheb_step", main_rec["launches"]["cheb_step"],
                     [r for r in fused_recs if r["name"] != "stencil_diag"],
                     fused_at["cheb_step"]),
        # K2 at the 3-D solve's shape, 160^3 x 16 f32 (its batched launch
        # among the checks).
        kernel_entry("stencil3d", st_rec["launches"]["stencil3d"], k2_recs,
                     k2_recs[0]),
        # K3 at the BSR solve's shape, the 160^3 block-ELL x 16 (its
        # batched launch among the checks).
        kernel_entry("bsr_ell", bsr_rec["launches"]["bsr_ell"],
                     k3_lap + [band["bsr_ell"], k3_frame_batch], k3_lap[0]),
        # K4 on the SpMM path's band x 128 (no operator dispatches it).
        kernel_entry("bsr_strip", band["spmm_path_launches"]["bsr_strip"],
                     [band["bsr_strip"]], band["bsr_strip"]),
        # K5 on the SpMM path's band x 128 (BSROperator.matmat sends k 128
        # on the bands of width 24 to K3, on the band-72 matrix to K5).
        kernel_entry("bsr_window", band["spmm_path_launches"]["bsr_window"],
                     [band["bsr_window"], band["bsr_window_spd"], k5_batch],
                     band["bsr_window"]),
        # K6 at an interior shard of the symmetric band x 128 cut in four,
        # launched on the world-size-1 sharded BSR apply.
        kernel_entry("bsr_window_edges",
                     sharded_rec["bsr"]["launches"]["bsr_window_edges"],
                     k6_recs + [k6_batch], k6_recs[1]),
        # K7 at the headline's shape, [4M, 256] f32.
        kernel_entry("copy", bench_rec["launches"]["copy"], k7_recs,
                     k7_recs[0]),
        # The tail kernels at the flagship's [4M, 64] f32 (combine: the
        # projection update), launched on the BdG solve.
        *(kernel_entry(name, main_rec["launches"][name],
                       [r for r in tail_recs if r["name"].startswith(name)],
                       tail_at[name]) for name in TAIL),
        # The tall Gram at the 4M x 150 solve's [4M, 164], launched on the
        # BdG solve (its [4M, 64] Grams).
        kernel_entry("tall_gram", main_rec["launches"]["tall_gram"], gram_recs,
                     gram_recs[0]),
    ]}
    emit(kernels)
    idle = [e["name"] for e in kernels["kernels"] if e["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
