"""Batched solves (lobpcg_tpu_torch.batched) against jax.vmap of the JAX
package's solvers: tests/test_vmap.py's two cases one to one, and an
ilobpcg sweep of the BdG well over barrier heights, on the same numpy
inputs.  The JAX solves draw from their default key, unbatched under
vmap, so every problem gets the same draws: the port's problems get
those draws (``draws=``) too.

Criteria (f64): eigenvalues 1e-9 relative, ``converged`` and
``iterations`` equal, per problem.  A batch drawn from X0=None (the
generator restored before each problem) equals its problems' lone
solves bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from test_torch_solvers import jax_draws

torch.set_num_threads(2)


def rand_block(seed, n, k):
    """tests/fixtures.py:rand_block's numbers."""
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (n, k))


def draws_for(n, ss, cfg, indefinite=False):
    return jax_draws(jax.random.PRNGKey(0), n, ss, jnp.float64, cfg,
                     indefinite=indefinite, with_b=indefinite, x0_given=True)


def assert_batch_parity(got, want, nev):
    lam, conv, it = got
    lam_j, conv_j, it_j = (np.asarray(v) for v in want)
    assert tuple(lam.shape) == lam_j.shape == (len(lam_j), nev)
    np.testing.assert_allclose(lam.numpy(), lam_j, rtol=1e-9)
    assert conv.tolist() == conv_j.tolist()
    assert it.tolist() == it_j.tolist()


def test_batched_dense_batch():
    """test_vmap.py:test_vmap_dense_batch: 4 dense SPD matrices."""
    rng = np.random.RandomState(0)
    batch, n, nev, ss = 4, 24, 2, 4
    mats = []
    for _ in range(batch):
        M = rng.randn(n, n)
        mats.append(M @ M.T + n * np.eye(n))
    X0 = rand_block(1, n, ss)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-9, max_iter=200)

    def jsolve(A_mat):
        r = jl.lobpcg(jl.DenseOperator(A_mat), jnp.asarray(X0), config=cfg)
        return r.eigenvalues, r.converged, r.iterations

    def tsolve(A_mat):
        r = tl.lobpcg(tl.DenseOperator(A_mat), torch.from_numpy(X0), nev=nev,
                      size_sub=ss, tol=1e-9, max_iter=200,
                      draws=draws_for(n, ss, cfg), device="cpu")
        return r.eigenvalues, r.converged, r.iterations

    got = tl.batched(tsolve)(torch.from_numpy(np.stack(mats)))
    assert_batch_parity(got, jax.vmap(jsolve)(jnp.asarray(np.stack(mats))), nev)
    for b in range(batch):
        exact = np.sort(np.linalg.eigvalsh(mats[b]))[:nev]
        np.testing.assert_allclose(got[0][b].numpy(), exact, rtol=1e-7)
        assert int(got[1][b]) == nev


def test_batched_parameter_sweep():
    """test_vmap.py:test_vmap_parameter_sweep: a diagonal shift; the
    eigenvalues track it."""
    n, nev, ss = 30, 2, 4
    base = np.arange(1.0, n + 1)
    shifts = np.asarray([0.0, 5.0, 11.0])
    X0 = rand_block(2, n, ss)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-10, max_iter=200)

    def jsolve(shift):
        r = jl.lobpcg(jl.DiagonalOperator(jnp.asarray(base) + shift),
                      jnp.asarray(X0), config=cfg)
        return r.eigenvalues, r.converged, r.iterations

    def tsolve(shift):
        r = tl.lobpcg(tl.DiagonalOperator(torch.from_numpy(base) + shift),
                      torch.from_numpy(X0), nev=nev, size_sub=ss, tol=1e-10,
                      max_iter=200, draws=draws_for(n, ss, cfg), device="cpu")
        return r.eigenvalues, r.converged, r.iterations

    got = tl.batched(tsolve)(torch.from_numpy(shifts))
    assert_batch_parity(got, jax.vmap(jsolve)(jnp.asarray(shifts)), nev)
    for i, s in enumerate(shifts):
        np.testing.assert_allclose(got[0][i].numpy(), np.arange(1, nev + 1) + s,
                                   rtol=1e-8)


# The BdG well of benchmarks/solve_bdg.py at a small size: WELL sites at
# potential SHIFT inside a box of m sites at barrier + SHIFT.
WELL, SHIFT, CHEB_LO = 48, 1.0, 2.0
BARRIERS = (1.0, 1.5, 2.0, 3.0)


def well_potential(m, barrier, xp):
    lo = (m - WELL) // 2
    inside = (np.arange(m) >= lo) & (np.arange(m) < lo + WELL)
    return xp.where(xp.asarray(inside), SHIFT, barrier + SHIFT), lo


@pytest.mark.parametrize("n,precond", [(256, "jacobi"), (512, "chebyshev")])
def test_batched_ilobpcg_well_sweep(n, precond):
    """ilobpcg on the well pencil A = diag(K, K) (one two-segment stencil
    plus [V; V]), B = antidiag(I, I), over 4 barrier heights, Jacobi or
    Chebyshev degree 3 on [2, 4 + barrier + SHIFT + 0.1], X0 = [u; u]
    with u inside the well."""
    m, nev, ss = n // 2, 4, 8
    _, lo = well_potential(m, 1.0, np)
    u = np.zeros((m, ss))
    u[lo : lo + WELL] = rand_block(42, WELL, ss)
    X0 = np.concatenate([u, u])
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)

    def jsolve(barrier):
        V, _ = well_potential(m, barrier, jnp)
        VV = jnp.concatenate([V, V])
        A = jl.Laplacian1D(scale=jnp.asarray(1.0), n=n, segments=2) \
            + jl.DiagonalOperator(VV)
        T = jl.JacobiPreconditioner(2.0 + VV) if precond == "jacobi" else \
            jl.ChebyshevFilter(op=A, lo=jnp.asarray(CHEB_LO),
                               hi=4.0 + barrier + SHIFT + 0.1, degree=3)
        B = jl.BlockAntiDiagOperator(d=jnp.ones((m,), jnp.float64))
        r = jl.ilobpcg(A, jnp.asarray(X0), B, T, config=cfg)
        return r.eigenvalues, r.converged, r.iterations

    d = draws_for(n, ss, cfg, indefinite=True)

    def tsolve(barrier):
        b = float(barrier)
        V, _ = well_potential(m, b, np)
        VV = torch.from_numpy(np.concatenate([V, V]))
        A = tl.Laplacian1D(1.0, n, segments=2, dtype=torch.float64) \
            + tl.DiagonalOperator(VV)
        T = tl.JacobiPreconditioner(2.0 + VV) if precond == "jacobi" else \
            tl.ChebyshevFilter(op=A, lo=CHEB_LO, hi=4.0 + b + SHIFT + 0.1,
                               degree=3)
        B = tl.BlockAntiDiagOperator(torch.ones(m, dtype=torch.float64))
        r = tl.ilobpcg(A, torch.from_numpy(X0), B, T, config=tl.SolverConfig(
            nev=nev, size_sub=ss, tol=1e-8, max_iter=300), draws=d,
            device="cpu")
        return r.eigenvalues, r.converged, r.iterations

    got = tl.batched(tsolve)(torch.tensor(BARRIERS, dtype=torch.float64))
    assert_batch_parity(got, jax.vmap(jsolve)(jnp.asarray(BARRIERS)), nev)
    assert got[1].tolist() == [nev] * len(BARRIERS)
    # The bound states rise with the barrier.
    assert bool(torch.all(got[0][1:, 0] > got[0][:-1, 0]))


def test_batch_from_x0_none_equals_lone_solves():
    """X0=None: the generator is restored before each problem, so each
    problem of the batch is its lone solve, bit for bit; the results
    stack field by field (eigenvectors [batch, n, nev], history None)."""
    n, nev, ss = 40, 3, 6
    base = torch.arange(1.0, n + 1, dtype=torch.float64)
    shifts = torch.tensor([0.0, 2.5, 7.0], dtype=torch.float64)
    gen = torch.Generator().manual_seed(11)

    def solve(shift, generator):
        return tl.lobpcg(tl.DiagonalOperator(base + shift), nev=nev,
                         size_sub=ss, tol=1e-9, max_iter=200,
                         generator=generator, device="cpu")

    out = tl.batched(lambda s: solve(s, gen), generators=[gen])(shifts)
    assert isinstance(out, tl.LOBPCGResult)
    assert tuple(out.eigenvectors.shape) == (3, n, nev)
    assert out.history is None
    for i, s in enumerate(shifts):
        lone = solve(s, torch.Generator().manual_seed(11))
        assert torch.equal(out.eigenvalues[i], lone.eigenvalues)
        assert int(out.iterations[i]) == lone.iterations
        assert int(out.converged[i]) == lone.converged == nev
    # Without the restore the second problem starts from other draws.
    gen.manual_seed(11)
    drifted = tl.batched(lambda s: solve(s, gen))(shifts)
    assert not torch.equal(drifted.basis[1], out.basis[1])


def test_batched_argument_checks():
    """Tensor arguments must share one leading size; other arguments go to
    every call unchanged; keyword tensors are batched too."""
    f = tl.batched(lambda a, b, scale=1.0: {"s": a.sum() * scale + b.sum()})
    out = f(torch.ones(3, 2), torch.zeros(3), scale=2.0)
    assert torch.equal(out["s"], torch.full((3,), 4.0))
    out = f(torch.ones(3, 2), b=torch.arange(3.0))
    assert torch.equal(out["s"], torch.tensor([2.0, 3.0, 4.0]))
    with pytest.raises(ValueError, match="leading size"):
        f(torch.ones(3, 2), torch.zeros(2))
