"""The lockstep batched solve (a 3-D X0: one loop and one set of launches
for the batch, per-problem masks) against ``jax.vmap`` of the JAX
package's solvers and against each problem's lone port solve, on the
same numpy inputs (f64, the CPU):

- tests/test_vmap.py's two cases (a dense SPD batch and a diagonal shift
  sweep) at that test's tolerances, converged and iteration counts equal;
- an ilobpcg sweep of the BdG well over 4 barrier heights, n 512,
  Chebyshev degree 3 with a per-problem upper bound: eigenvalues 1e-9
  relative to jax.vmap, converged and iteration counts equal;
- every lockstep problem against its lone solve: eigenvalues 1e-10
  relative, the same iteration count;
- batches in which some problems take a branch and others do not (the
  rr-flag-2 retry, the stall reset, the quality-5 dual basis), each
  problem equal to its lone solve;
- the batched operator applies (Laplacian1D as one K1 launch over
  b*segments segments), and a per-problem P0 and solve_checkpointed
  refusing a batch.  The other operators' lockstep solves are
  test_torch_lockstep_operators.py's; the sharded operators' batched
  applies and solves under a row group are
  test_torch_sharded_lockstep.py's.

The JAX solves draw from their default key, unbatched under vmap: every
problem gets the same draws, and the port's problems get those draws
(``draws=``) too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.ops import gram, masking
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.ops.rayleigh import rayleigh_ritz_modified
from lobpcg_tpu_torch.parallel import RowMesh, shard_operator
from test_torch_batched import (
    BARRIERS,
    CHEB_LO,
    SHIFT,
    WELL,
    draws_for,
    rand_block,
    well_potential,
)

torch.set_num_threads(2)
F64 = torch.float64


def lone_parity(batch, lone_fn, n_problems, rtol=1e-10):
    """Each problem of a lockstep result against its lone solve."""
    for i in range(n_problems):
        r = lone_fn(i)
        np.testing.assert_allclose(batch.eigenvalues[i].numpy(),
                                   r.eigenvalues.numpy(), rtol=rtol)
        assert int(batch.converged[i]) == r.converged
        assert int(batch.iterations[i]) == r.iterations, i


def vmap_parity(batch, want, rtol):
    lam_j, conv_j, it_j = (np.asarray(v) for v in want)
    np.testing.assert_allclose(batch.eigenvalues.numpy(), lam_j, rtol=rtol)
    assert batch.converged.tolist() == conv_j.tolist()
    assert batch.iterations.tolist() == it_j.tolist()


def test_lockstep_dense_batch():
    """test_vmap.py:test_vmap_dense_batch: 4 dense SPD matrices as one
    DenseOperator [4, n, n]; the batch mixes problems that take the
    rr-flag-2 retry with one that does not."""
    rng = np.random.RandomState(0)
    batch, n, nev, ss = 4, 24, 2, 4
    mats = []
    for _ in range(batch):
        M = rng.randn(n, n)
        mats.append(M @ M.T + n * np.eye(n))
    X0 = rand_block(1, n, ss)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-9, max_iter=200)
    d = draws_for(n, ss, cfg)

    def jsolve(A_mat):
        r = jl.lobpcg(jl.DenseOperator(A_mat), jnp.asarray(X0), config=cfg)
        return r.eigenvalues, r.converged, r.iterations

    def tsolve(A, X):
        return tl.lobpcg(A, X, nev=nev, size_sub=ss, tol=1e-9, max_iter=200,
                         draws=d, device="cpu")

    out = tsolve(tl.DenseOperator(torch.from_numpy(np.stack(mats))),
                 torch.from_numpy(np.stack([X0] * batch)))
    assert tuple(out.eigenvectors.shape) == (batch, n, nev)
    vmap_parity(out, jax.vmap(jsolve)(jnp.asarray(np.stack(mats))), 1e-7)
    for b in range(batch):
        exact = np.sort(np.linalg.eigvalsh(mats[b]))[:nev]
        np.testing.assert_allclose(out.eigenvalues[b].numpy(), exact,
                                   rtol=1e-7)
    assert out.converged.tolist() == [nev] * batch
    lone_parity(out, lambda i: tsolve(tl.DenseOperator(torch.from_numpy(
        mats[i])), torch.from_numpy(X0)), batch)
    # The retry fires in some problems only.
    assert 0 < int((out.ortho_retries > 0).sum()) < batch


def test_lockstep_parameter_sweep():
    """test_vmap.py:test_vmap_parameter_sweep: a DiagonalOperator [3, n]
    (a shifted diagonal); the eigenvalues track the shift."""
    n, nev, ss = 30, 2, 4
    base = np.arange(1.0, n + 1)
    shifts = np.asarray([0.0, 5.0, 11.0])
    X0 = rand_block(2, n, ss)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-10, max_iter=200)
    d = draws_for(n, ss, cfg)

    def jsolve(shift):
        r = jl.lobpcg(jl.DiagonalOperator(jnp.asarray(base) + shift),
                      jnp.asarray(X0), config=cfg)
        return r.eigenvalues, r.converged, r.iterations

    def tsolve(diag, X):
        return tl.lobpcg(tl.DiagonalOperator(diag), X, nev=nev, size_sub=ss,
                         tol=1e-10, max_iter=200, draws=d, device="cpu")

    diags = torch.from_numpy(base[None, :] + shifts[:, None])
    out = tsolve(diags, torch.from_numpy(np.stack([X0] * len(shifts))))
    vmap_parity(out, jax.vmap(jsolve)(jnp.asarray(shifts)), 1e-8)
    for i, s in enumerate(shifts):
        np.testing.assert_allclose(out.eigenvalues[i].numpy(),
                                   np.arange(1, nev + 1) + s, rtol=1e-8)
    lone_parity(out, lambda i: tsolve(diags[i], torch.from_numpy(X0)),
                len(shifts))


def well_batch(n, barriers):
    """The port's lockstep well sweep: A = one two-segment Laplacian1D
    (shared) + DiagonalOperator [b, n], B = BlockAntiDiagOperator
    (shared), T = Chebyshev degree 3 with a per-problem upper bound."""
    m = n // 2
    VV = torch.from_numpy(np.stack([
        np.concatenate([well_potential(m, b, np)[0]] * 2) for b in barriers]))
    A = tl.Laplacian1D(1.0, n, segments=2, dtype=F64) + tl.DiagonalOperator(VV)
    hi = torch.tensor([4.0 + b + SHIFT + 0.1 for b in barriers], dtype=F64)
    T = tl.ChebyshevFilter(op=A, lo=CHEB_LO, hi=hi, degree=3)
    B = tl.BlockAntiDiagOperator(torch.ones(m, dtype=F64))
    return A, B, T, VV, hi


def well_x0(n, ss):
    m = n // 2
    _, lo = well_potential(m, 1.0, np)
    u = np.zeros((m, ss))
    u[lo : lo + WELL] = rand_block(42, WELL, ss)
    return np.concatenate([u, u])


def test_lockstep_ilobpcg_well_sweep():
    """ilobpcg on the well pencil over 4 barrier heights at n 512, against
    jax.vmap over the barrier (Chebyshev hi a traced field) and against
    each problem's lone port solve."""
    n, nev, ss = 512, 4, 8
    m = n // 2
    X0 = well_x0(n, ss)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    d = draws_for(n, ss, cfg, indefinite=True)

    def jsolve(barrier):
        V, _ = well_potential(m, barrier, jnp)
        VV = jnp.concatenate([V, V])
        A = jl.Laplacian1D(scale=jnp.asarray(1.0), n=n, segments=2) \
            + jl.DiagonalOperator(VV)
        T = jl.ChebyshevFilter(op=A, lo=jnp.asarray(CHEB_LO),
                               hi=4.0 + barrier + SHIFT + 0.1, degree=3)
        B = jl.BlockAntiDiagOperator(d=jnp.ones((m,), jnp.float64))
        r = jl.ilobpcg(A, jnp.asarray(X0), B, T, config=cfg)
        return r.eigenvalues, r.converged, r.iterations

    tcfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    A, B, T, VV, hi = well_batch(n, BARRIERS)
    out = tl.ilobpcg(A, torch.from_numpy(np.stack([X0] * len(BARRIERS))), B,
                     T, config=tcfg, draws=d, device="cpu")
    assert tuple(out.signature.shape) == (len(BARRIERS), nev)
    vmap_parity(out, jax.vmap(jsolve)(jnp.asarray(BARRIERS)), 1e-9)
    assert out.converged.tolist() == [nev] * len(BARRIERS)
    # The problems stop at different iterations: the early ones froze.
    assert len(set(out.iterations.tolist())) > 1

    def lone(i):
        Ai = tl.Laplacian1D(1.0, n, segments=2, dtype=F64) \
            + tl.DiagonalOperator(VV[i])
        Ti = tl.ChebyshevFilter(op=Ai, lo=CHEB_LO, hi=float(hi[i]), degree=3)
        return tl.ilobpcg(Ai, torch.from_numpy(X0), B, Ti, config=tcfg,
                          draws=d, device="cpu")

    lone_parity(out, lone, len(BARRIERS))


def stall_pencil(ss, max_iter):
    """tests/test_stall.py's pencil (bdg_ops(100): A = diag(K, K),
    B = antidiag(I, I)), its start blocks [u; u] from seeds 3, 4 and 5 at
    width ``ss``, the norm-estimate, refill and stall draws, and the
    lockstep/lone solve at stall_reset=1 (nev 4, tol 1e-8)."""
    m = 100
    n = 2 * m
    h = 1.0 / (m + 1)
    A = tl.BlockDiagOperator(tl.Laplacian1D(1.0 / (h * h), m, dtype=F64), 2)
    B = tl.BlockAntiDiagOperator(torch.ones(m, dtype=F64))
    X0s = []
    for seed in (3, 4, 5):
        u = np.random.RandomState(seed).uniform(-0.5, 0.5, (m, ss))
        X0s.append(np.concatenate([u, u]))
    rng = np.random.RandomState(7)
    d = {"norm_a": rng.uniform(-0.5, 0.5, (n, 8)),
         "norm_b": rng.uniform(-0.5, 0.5, (n, 8)),
         "refill": rng.uniform(-0.5, 0.5, (n, ss))}
    d.update({f"stall{it}": rng.uniform(-0.5, 0.5, (n, ss))
              for it in range(max_iter)})
    cfg = tl.SolverConfig(nev=4, size_sub=ss, tol=1e-8, max_iter=max_iter,
                          stall_reset=1, record_history=True, norm_block=8)

    def solve(X):
        return tl.ilobpcg(A, torch.from_numpy(X), B, config=cfg, draws=d,
                          device="cpu")

    return X0s, cfg, solve


def mixed_stall_iterations(out, problems):
    """Iterations at which the stall reset fired in some problems only."""
    tripped = out.history.flags >= 16
    return [it for it in range(int(out.iterations.min()))
            if 0 < int(tripped[:, it].sum()) < problems]


def test_lockstep_stall_reset_fires_per_problem():
    """tests/test_stall.py's pencil at stall_reset=1 from three start
    blocks: the reset fires in some problems of an iteration and not in
    others, and each problem equals its lone solve (the stall noise given
    as draws), flags row by row.

    size_sub is 8 here for the equality bit for bit; the next test runs
    test_stall.py's own 6.  torch's CPU batched matmul takes a naive
    kernel for products under 400 multiply-adds (a 6 x 6 by 6 x 6
    product), which sums in another order than the unbatched product,
    and the noise that stall_reset=1 adds at nearly every iteration
    turns that last-bit difference into another trajectory.  At
    size_sub 8 every k x k product of the solve runs the per-problem
    gemm, and the lockstep problems are their lone solves bit for bit."""
    X0s, cfg, solve = stall_pencil(8, 300)
    out = solve(np.stack(X0s))
    flags = out.history.flags
    assert mixed_stall_iterations(out, len(X0s)), \
        "the stall reset never fired in some problems only"
    lone = [solve(X) for X in X0s]
    for i, r in enumerate(lone):
        np.testing.assert_allclose(out.eigenvalues[i].numpy(),
                                   r.eigenvalues.numpy(), rtol=1e-10)
        assert int(out.iterations[i]) == r.iterations
        k = r.iterations
        assert torch.equal(flags[i, :k], r.history.flags[:k])
        assert not bool(flags[i, k:].any())  # rows past the freeze stay 0
    assert out.converged.tolist() == [cfg.nev] * len(X0s)


def test_lockstep_stall_reset_at_test_stall_inputs():
    """The same at tests/test_stall.py's own size_sub 6, where the
    batched k x k products round otherwise than the lone ones (see the
    test above) and the trajectories part: the reset still fires in some
    problems only, every problem converges, and its eigenvalues meet its
    lone solve's to the solve's tolerance (1e-8 relative); the iteration
    counts may differ."""
    X0s, cfg, solve = stall_pencil(6, 300)
    out = solve(np.stack(X0s))
    assert mixed_stall_iterations(out, len(X0s)), \
        "the stall reset never fired in some problems only"
    assert out.converged.tolist() == [cfg.nev] * len(X0s)
    assert int(out.iterations.max()) < cfg.max_iter
    for i, X in enumerate(X0s):
        r = solve(X)
        assert r.converged == cfg.nev
        np.testing.assert_allclose(out.eigenvalues[i].numpy(),
                                   r.eigenvalues.numpy(), rtol=cfg.tol)


def test_lockstep_quality5_in_some_problems():
    """tests/test_ilobpcg.py's quality-5 pencil (B = antidiag(D, D),
    D = diag(0.1^i), m 30, nev 2, size_sub 4, tol 1e-3) batched with the
    well-conditioned D = I: the dual basis runs in the first problem
    only, and each problem equals its lone solve."""
    m, nev, ss = 30, 2, 4
    n = 2 * m
    h = 1.0 / (m + 1)
    A = tl.BlockDiagOperator(tl.Laplacian1D(1.0 / (h * h), m, dtype=F64), 2)
    D = torch.from_numpy(np.stack([0.1 ** np.arange(m), np.ones(m)]))
    u = np.random.RandomState(99).uniform(-0.5, 0.5, (m, ss))
    X0 = np.concatenate([u, u])
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-3, max_iter=500)
    d = draws_for(n, ss, jl.SolverConfig(nev=nev, size_sub=ss),
                  indefinite=True)

    def solve(Bd, X):
        return tl.ilobpcg(A, torch.from_numpy(X), tl.BlockAntiDiagOperator(Bd),
                          config=cfg, draws=d, device="cpu")

    out = solve(D, np.stack([X0, X0]))
    assert int(out.quality5_count[0]) > 0 and int(out.quality5_count[1]) == 0
    assert out.rr_fail_count.tolist() == [0, 0]
    assert out.converged.tolist() == [nev, nev]
    for i in range(2):
        r = solve(D[i], X0)
        np.testing.assert_allclose(out.eigenvalues[i].numpy(),
                                   r.eigenvalues.numpy(), rtol=1e-10)
        assert int(out.iterations[i]) == r.iterations
        assert int(out.quality5_count[i]) == r.quality5_count


def test_rayleigh_ritz_retry_flag_per_problem():
    """tests/test_rayleigh.py's rank-deficient S (X = P = W) raises the
    retry flag; stacked with a full-rank S, the batched RR flags [2, 0]
    and each problem's outputs equal its lone RR."""
    n = 9
    A = tl.DenseOperator(torch.eye(n, dtype=F64))
    v = torch.from_numpy(np.random.RandomState(46).uniform(-0.5, 0.5, (n, 1)))
    S_bad = torch.cat([v, v, v], dim=1)
    S_good = torch.from_numpy(np.random.RandomState(5).uniform(-0.5, 0.5,
                                                               (n, 3)))
    rr = rayleigh_ritz_modified(torch.stack([S_bad, S_good]), None, 1, 1, 0,
                                A, None, nx=1)
    assert rr.flag.tolist() == [2, 0]
    for i, S in enumerate((S_bad, S_good)):
        lone = rayleigh_ritz_modified(S, None, 1, 1, 0, A, None, nx=1)
        assert lone.flag == rr.flag[i]
        if lone.flag == 0:
            np.testing.assert_allclose(rr.lam[i].numpy(), lone.lam.numpy(),
                                       rtol=1e-12)
    # use_ortho per problem: the ortho branch for one, Cholesky for the
    # other, each as its lone call.
    rr = rayleigh_ritz_modified(torch.stack([S_good, S_good]), None, 1, 1,
                                torch.tensor([1, 0]), A, None, nx=1)
    assert rr.flag.tolist() == [1, 0]
    for i in range(2):
        lone = rayleigh_ritz_modified(S_good, None, 1, 1, i == 0, A, None,
                                      nx=1)
        np.testing.assert_allclose(rr.lam[i].numpy(), lone.lam.numpy(),
                                   rtol=1e-12)


@pytest.mark.parametrize("n", [512, 6000, 16384, 2 * 8209])
def test_batched_tall_gram_splits_every_n(n):
    """The batched tall Gram V^H U ([b, n, k], ops/gram.py) against each
    problem's unbatched product: up to 8192 rows in one product, 16384
    over 8192-row pieces, and 2 x 8209 (no divisor in [1024, 8192]) over
    8192-row pieces plus the product of the 2 rows left over."""
    rng = np.random.RandomState(n)
    V = torch.from_numpy(rng.randn(3, n, 5))
    U = torch.from_numpy(rng.randn(3, n, 4))
    r = gram._split_rows(n)
    assert r == (n if n <= 8192 else 8192)
    G = gram._local_hdot(V, U)
    for i in range(3):
        want = (V[i].mH @ U[i]).numpy()
        np.testing.assert_allclose(G[i].numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_qz_batch_equals_lone_and_refuses_a_pair_not_finite():
    """The host QZ over a batch: each problem it is asked for equals its
    lone call, the others get NaN and ok False; a pair that is not
    finite raises when it needs QZ, alone or in a batch, and is left
    alone when it does not."""
    from lobpcg_tpu_torch.ops.pencil import pencil_eig_qz

    rng = np.random.RandomState(11)
    GA = torch.from_numpy(rng.randn(3, 5, 5))
    GA = GA + GA.mT
    GB = torch.from_numpy(rng.randn(3, 5, 5))
    GB = GB @ GB.mT + 5 * torch.eye(5, dtype=F64)
    need = torch.tensor([True, False, True])
    lam, V, ok = pencil_eig_qz(GA, GB, 1e-30, need=need)
    assert ok.tolist() == need.tolist()
    assert bool(torch.isnan(lam[1]).all()) and bool(torch.isnan(V[1]).all())
    for i in (0, 2):
        lam_i, V_i, ok_i = pencil_eig_qz(GA[i], GB[i], 1e-30)
        assert bool(ok_i) and lam_i.shape == (5,) and V_i.shape == (5, 5)
        assert torch.equal(lam[i], lam_i) and torch.equal(V[i], V_i)
    GA[1, 0, 0] = float("nan")
    pencil_eig_qz(GA, GB, 1e-30, need=need)  # problem 1 needs no QZ
    with pytest.raises(ValueError):
        pencil_eig_qz(GA[1], GB[1], 1e-30)
    with pytest.raises(ValueError):
        pencil_eig_qz(GA, GB, 1e-30)


def test_masking_per_problem_counts():
    """Counts as [b] lanes: shift_cols gathers per problem, prefix_count
    and compact_by_flag return [b], and each row equals its lone call."""
    rng = np.random.RandomState(3)
    U = torch.from_numpy(rng.randn(3, 5, 6))
    shift, count = torch.tensor([0, 2, 5]), torch.tensor([6, 3, 1])
    out = masking.shift_cols(U, shift, count)
    ok = torch.from_numpy(rng.uniform(size=(3, 6)) < 0.8)
    flags = torch.from_numpy(rng.uniform(size=(3, 6)) < 0.4)
    perm, kept = masking.compact_by_flag(flags)
    pc = masking.prefix_count(ok)
    for i in range(3):
        assert torch.equal(out[i], masking.shift_cols(U[i], int(shift[i]),
                                                      int(count[i])))
        assert int(pc[i]) == masking.prefix_count(ok[i])
        p_i, k_i = masking.compact_by_flag(flags[i])
        assert torch.equal(perm[i], p_i) and int(kept[i]) == k_i


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("scale", ["shared", "per_problem"])
def test_laplacian1d_batched_apply(dtype, scale, monkeypatch):
    """Laplacian1D(segments=2) on [b, n, k] equals b separate applies,
    with one scale for the batch or one per problem; f32 goes through
    stencil_matmat (K1's wrapper) once for the batch, over 2b segments."""
    from lobpcg_tpu_torch.operators import linop

    calls = []

    def counted(X, scale, edge_rows=None, *, num_segments=1):
        calls.append((tuple(X.shape), num_segments))
        return k1.stencil_matmat(X, scale, edge_rows,
                                 num_segments=num_segments)

    monkeypatch.setattr(linop, "stencil_matmat", counted)
    b, n, k = 3, 40, 5
    X = torch.from_numpy(np.random.RandomState(1).randn(b, n, k)).to(dtype)
    scales = [2.5, 0.5, 7.0]
    if scale == "shared":
        op = tl.Laplacian1D(2.5, n, segments=2, dtype=dtype)
        lone = [tl.Laplacian1D(2.5, n, segments=2, dtype=dtype)] * b
    else:
        op = tl.Laplacian1D(torch.tensor(scales, dtype=F64), n, segments=2,
                            dtype=dtype)
        lone = [tl.Laplacian1D(s, n, segments=2, dtype=dtype) for s in scales]
    Y = op.matmat(X)
    if dtype == torch.float32:
        assert calls == [((b * n, k), 2 * b)]
    for i in range(b):
        np.testing.assert_allclose(Y[i].numpy(), lone[i].matmat(X[i]).numpy(),
                                   rtol=1e-6 if dtype == torch.float32 else 1e-15)
    # No coupling across the problems' boundaries or the segment edge.
    Xi = torch.zeros_like(X)
    Xi[1, n // 2 - 1] = 1.0
    Yi = op.matmat(Xi)
    assert float(Yi[0].abs().sum()) == float(Yi[2].abs().sum()) == 0.0
    assert float(Yi[1, n // 2 :].abs().sum()) == 0.0


def test_batched_operator_data():
    """DiagonalOperator / JacobiPreconditioner / BlockAntiDiagOperator with
    [b, n] data, DenseOperator [b, n, n], a Chebyshev filter with [b]
    bounds and BlockDiagOperator over a batch: each problem equals its
    lone apply; shared data broadcasts; the half swap stays inside each
    problem."""
    rng = np.random.RandomState(2)
    b, n, k = 3, 8, 2
    X = torch.from_numpy(rng.randn(b, n, k))
    d = torch.from_numpy(rng.uniform(1, 2, (b, n)))
    dh = torch.from_numpy(rng.uniform(1, 2, (b, n // 2)))
    M = torch.from_numpy(rng.randn(b, n, n))
    lap = tl.Laplacian1D(1.0, n, dtype=F64)
    his = torch.tensor([5.0, 6.0, 9.0], dtype=F64)
    cases = [
        (tl.DiagonalOperator(d), lambda i: tl.DiagonalOperator(d[i])),
        (tl.JacobiPreconditioner(d), lambda i: tl.JacobiPreconditioner(d[i])),
        (tl.BlockAntiDiagOperator(dh),
         lambda i: tl.BlockAntiDiagOperator(dh[i])),
        (tl.DenseOperator(M), lambda i: tl.DenseOperator(M[i])),
        (tl.DenseOperator(M[0]), lambda i: tl.DenseOperator(M[0])),
        (tl.ChebyshevFilter(op=lap + tl.DiagonalOperator(d), lo=1.0, hi=his,
                            degree=4, chunk=1),
         lambda i: tl.ChebyshevFilter(op=lap + tl.DiagonalOperator(d[i]),
                                      lo=1.0, hi=float(his[i]), degree=4)),
        (tl.BlockDiagOperator(tl.DiagonalOperator(dh), 2),
         lambda i: tl.BlockDiagOperator(tl.DiagonalOperator(dh[i]), 2)),
    ]
    for op, lone in cases:
        Y = op.matmat(X)
        for i in range(b):
            np.testing.assert_allclose(Y[i].numpy(),
                                       lone(i).matmat(X[i]).numpy(),
                                       rtol=1e-13, atol=1e-13)


def test_operators_without_a_batched_form_refuse_a_batch():
    """What the lockstep solve still refuses, as jax.vmap of the JAX solve
    refuses it (its _prepare_p0 reads P0 on the host): a per-problem P0
    [b, n, m], unsharded and under a row group (before any collective),
    and solve_checkpointed given a batch.  Every operator has a batched
    form now, the sharded ones included (their batched applies equal
    their lone applies: test_torch_sharded_lockstep.py)."""
    with pytest.raises(NotImplementedError, match="P0"):
        tl.lobpcg(tl.DiagonalOperator(torch.ones(16, dtype=F64)),
                  torch.ones((2, 16, 3), dtype=F64),
                  P0=torch.zeros((2, 16, 3), dtype=F64), nev=2, size_sub=3,
                  device="cpu")
    mesh = RowMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    sharded = shard_operator(tl.DiagonalOperator(torch.ones(16, dtype=F64)),
                             mesh)
    with pytest.raises(NotImplementedError, match="P0"):
        tl.lobpcg(sharded, torch.ones((2, 8, 3), dtype=F64),
                  P0=torch.zeros((2, 8, 3), dtype=F64), nev=2, size_sub=3,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="one problem"):
        tl.solve_checkpointed(
            tl.lobpcg, tl.DiagonalOperator(torch.ones(16, dtype=F64)),
            torch.ones((2, 16, 3), dtype=F64),
            config=tl.SolverConfig(nev=2, size_sub=3), path="unused.npz")
