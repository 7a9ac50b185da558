"""The port's split-real embedding (lobpcg_tpu_torch/operators/realify.py)
against the JAX package's (tests/test_realify.py's cases), on the same
numpy inputs, on the CPU.

Criteria (f64): embedded applies agree with the JAX embedding and with
the complex apply to atol 1e-12; realify_x0 is byte-identical; derealify
folds the same result arrays to the same numbers; realified solves agree
with the complex solves (the JAX package's and the port's native complex
solve) to 1e-7 relative, as the JAX test holds its own.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import lobpcg_tpu as jl
from lobpcg_tpu.operators import realify as jr
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.interop import config_from_reference, operator_from_reference
from lobpcg_tpu_torch.operators import realify as tr
from fixtures import bdg_ops, bdg_positive_init, laplacian_exact, rand_block
from test_torch_solvers import jax_draws

torch.set_num_threads(2)


def _hermitian(n, seed):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) + 1j * rng.randn(n, n)
    return (M + M.conj().T) / 2 + n * np.eye(n)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _trees(n):
    """Complex-specified JAX operator trees and their port counterparts."""
    A_np = _hermitian(n, 0)
    d = np.random.RandomState(1).uniform(1.0, 2.0, n)
    c128 = jnp.complex128
    lap = jl.Laplacian1D(scale=jnp.asarray(3.0, c128), n=n, segments=2)
    trees = {
        "dense": jl.DenseOperator(jnp.asarray(A_np, c128)),
        "diag": jl.DiagonalOperator(jnp.asarray(d, c128)),
        "dense_real": jl.DenseOperator(jnp.asarray(A_np.real)),
        "diag_real": jl.DiagonalOperator(jnp.asarray(d)),
        "jacobi": jl.JacobiPreconditioner(jnp.asarray(d, c128)),
        "laplacian": lap,
        "sum": lap + jl.DiagonalOperator(jnp.asarray(d, c128)),
        "shifted": jl.ShiftedOperator(jl.DenseOperator(jnp.asarray(A_np, c128)),
                                      jnp.asarray(0.5 + 0j, c128)),
        "scaled": jl.ScaledOperator(jl.DiagonalOperator(jnp.asarray(d, c128)),
                                    jnp.asarray(2.0 + 0j, c128)),
        "antidiag": jl.BlockAntiDiagOperator(d=jnp.asarray(d[: n // 2], c128)),
        "blockdiag": jl.BlockDiagOperator(
            inner=jl.Laplacian1D(scale=jnp.asarray(1.0, c128), n=n // 2)
            + jl.DiagonalOperator(jnp.asarray(d[: n // 2], c128)), copies=2),
    }
    return trees, A_np


@pytest.mark.parametrize("name", list(_trees(8)[0]))
def test_embedded_applies_match_reference(name):
    """realify_operator of the port's tree against the JAX package's
    realified tree, applied to the same stacked [re; im] block; the JAX
    realified tree carried across (operator_from_reference) too."""
    n, k = 24, 4
    jop = _trees(n)[0][name]
    top = operator_from_reference(jop, device="cpu")
    jr_op = jr.realify_operator(jop)
    tr_op = tr.realify_operator(top)
    assert type(tr_op).__name__ == type(jr_op).__name__
    assert tuple(tr_op.shape) == tuple(jr_op.shape) == (2 * n, 2 * n)
    assert tr_op.dtype == torch.float64
    W = np.random.RandomState(2).uniform(-1, 1, (2 * n, k))
    want = np.asarray(jr_op.matmat(jnp.asarray(W)))
    np.testing.assert_allclose(tr_op.matmat(_t(W)).numpy(), want, atol=1e-12)
    carried = operator_from_reference(jr_op, device="cpu")
    np.testing.assert_allclose(carried.matmat(_t(W)).numpy(), want, atol=1e-12)


def test_embedding_matches_complex_apply():
    n, k = 24, 4
    A_np = _hermitian(n, 0)
    Ar = tr.realify_operator(tl.DenseOperator(torch.from_numpy(A_np)))
    Z = np.asarray(rand_block(1, n, k, jnp.complex128))
    Y = Ar.matmat(_t(np.concatenate([Z.real, Z.imag]))).numpy()
    AZ = A_np @ Z
    np.testing.assert_allclose(Y[:n], AZ.real, atol=1e-12)
    np.testing.assert_allclose(Y[n:], AZ.imag, atol=1e-12)


@pytest.mark.parametrize("dtype,rdt", [(jnp.complex128, None),
                                       (jnp.complex64, None),
                                       (jnp.complex128, "float32"),
                                       (jnp.float64, None)])
def test_realify_x0_byte_identical(dtype, rdt):
    Z = np.asarray(rand_block(1, 10, 3, dtype))
    want = np.asarray(jr.realify_x0(jnp.asarray(Z), rdt))
    got = tr.realify_x0(_t(Z), rdt).numpy()
    assert got.shape == (20, 6) and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_derealify_matches_reference_on_the_same_arrays():
    """A JAX realified lobpcg result, handed to both derealify functions
    (as torch tensors to the port's): the same folded numbers, and the
    same warning for an unpaired eigenvalue."""
    n, nev, ss = 40, 3, 5
    A = jl.DenseOperator(jnp.asarray(_hermitian(n, 1), jnp.complex128))
    X0 = rand_block(2, n, ss, jnp.complex128)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    Ar, X0r, _, _, cfgr = jr.realify_problem(A, X0, config=cfg)
    rr = jl.lobpcg(Ar, X0r, config=cfgr)
    as_t = rr._replace(eigenvalues=_t(rr.eigenvalues),
                       eigenvectors=_t(rr.eigenvectors),
                       residual_norms=_t(rr.residual_norms))
    for got, want in zip(tr.derealify(as_t, nev), jr.derealify(rr, nev)):
        np.testing.assert_array_equal(got, want)
    # Break one pair: both warn and fold the same way.
    lam = np.asarray(rr.eigenvalues).copy()
    lam[1] += 1.0
    broken_j = rr._replace(eigenvalues=jnp.asarray(lam))
    broken_t = as_t._replace(eigenvalues=_t(lam))
    with pytest.warns(UserWarning, match="without their"):
        got = tr.derealify(broken_t, nev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jr.derealify(broken_j, nev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_realified_solve_matches_complex_solves():
    """A dense Hermitian problem (n 40, nev 3, f64, tol 1e-8): the
    port's realified lobpcg against the JAX package's complex lobpcg and
    the port's native complex lobpcg, to 1e-7 relative, and the folded
    eigenvectors satisfy the complex eigen equation."""
    n, nev, ss = 40, 3, 5
    A_np = _hermitian(n, 1)
    X0 = np.array(rand_block(2, n, ss, jnp.complex128))
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    key = jax.random.PRNGKey(0)
    ref = jl.lobpcg(jl.DenseOperator(jnp.asarray(A_np)), jnp.asarray(X0),
                    config=cfg, key=key)
    native = tl.lobpcg(tl.DenseOperator(torch.from_numpy(A_np)),
                       torch.from_numpy(X0), config=config_from_reference(cfg),
                       draws=jax_draws(key, n, ss, jnp.complex128, cfg,
                                       indefinite=False, with_b=False,
                                       x0_given=True))
    assert native.converged == nev and native.eigenvectors.is_complex()
    Ar, X0r, _, _, cfgr = tl.realify_problem(
        tl.DenseOperator(torch.from_numpy(A_np)), torch.from_numpy(X0),
        config=config_from_reference(cfg))
    assert (cfgr.nev, cfgr.size_sub) == (2 * nev, 2 * ss)
    rr = tl.lobpcg(Ar, X0r, config=cfgr, generator=torch.Generator().manual_seed(0))
    lam, vec, res = tl.derealify(rr, nev)
    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-7)
    np.testing.assert_allclose(native.eigenvalues.numpy(), lam, rtol=1e-7)
    for j in range(nev):
        r = A_np @ vec[:, j] - lam[j] * vec[:, j]
        assert np.linalg.norm(r) < 1e-5 * np.linalg.norm(A_np), j
    assert np.all(np.isfinite(res))


def test_realified_generalized_with_diag_b():
    n, nev, ss = 30, 2, 4
    A_np = _hermitian(n, 3)
    b = np.random.RandomState(4).uniform(1.0, 2.0, n)
    X0 = np.array(rand_block(5, n, ss, jnp.complex128))
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    Ar, X0r, Br, _, cfgr = tl.realify_problem(
        tl.DenseOperator(torch.from_numpy(A_np)), torch.from_numpy(X0),
        tl.DiagonalOperator(torch.from_numpy(b.astype(np.complex128))),
        config=cfg)
    rr = tl.lobpcg(Ar, X0r, Br, config=cfgr,
                   generator=torch.Generator().manual_seed(0))
    lam, _, _ = tl.derealify(rr, nev)
    exact = np.sort(sla.eigh(A_np, np.diag(b), eigvals_only=True).real)[:nev]
    np.testing.assert_allclose(lam, exact, rtol=1e-7)


def test_realified_ilobpcg_bdg_matches_reference():
    """The complex BdG pencil (m 100, nev 3, tol 1e-6) through the real
    embedding: the JAX package's realified ilobpcg and the port's, given
    the JAX draws, agree to 1e-9; both near the analytic (k pi)^2."""
    m, nev, ss = 100, 3, 6
    jA, jB = bdg_ops(m, jnp.complex128)
    X0 = bdg_positive_init(42, m, ss, jnp.complex128)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=400)
    jAr, jX0r, jBr, _, jcfgr = jr.realify_problem(jA, X0, jB, config=cfg)
    key = jax.random.PRNGKey(0)
    rj = jl.ilobpcg(jAr, jX0r, jBr, config=jcfgr, key=key)
    tAr, tX0r, tBr, _, tcfgr = tl.realify_problem(
        operator_from_reference(jA, device="cpu"), _t(X0),
        operator_from_reference(jB, device="cpu"),
        config=config_from_reference(cfg))
    assert tAr.dtype == torch.float64
    np.testing.assert_array_equal(tX0r.numpy(), np.asarray(jX0r))
    draws = jax_draws(key, 4 * m, 2 * ss, jnp.float64, jcfgr, indefinite=True,
                      with_b=True, x0_given=True)
    rt = tl.ilobpcg(tAr, tX0r, tBr, config=tcfgr, draws=draws)
    np.testing.assert_allclose(rt.eigenvalues.numpy(),
                               np.asarray(rj.eigenvalues), rtol=1e-9)
    lam, _, _ = tl.derealify(rt, nev)
    rel = np.abs(lam - laplacian_exact(np.arange(1, nev + 1))) \
        / laplacian_exact(np.arange(1, nev + 1))
    assert np.all(rel < 1e-2), rel
    assert np.all(rt.signature.numpy()[: 2 * nev] == 1)


def test_realify_downcast_dtype_and_config_doubles():
    A = tl.DenseOperator(torch.from_numpy(_hermitian(8, 6)))
    assert tr.realify_operator(A, rdt=torch.float32).dtype == torch.float32
    assert tr.realify_operator(A, rdt="float32").Ar.dtype == torch.float32
    c2 = tr.realify_config(tl.SolverConfig(nev=5, size_sub=8, tol=1e-7))
    want = jr.realify_config(jl.SolverConfig(nev=5, size_sub=8, tol=1e-7))
    assert dataclasses.asdict(c2) == dataclasses.asdict(want)


@pytest.mark.parametrize("case", ["callable", "laplacian_scale", "jacobi",
                                  "antidiag", "blockdiag_child",
                                  "scaled_alpha"])
def test_realify_raises_where_the_reference_does(case):
    c128 = torch.complex128
    d = torch.tensor([1.0 + 1.0j, 2.0], dtype=c128)
    op = {
        "callable": tl.CallableOperator(args=(), fn=lambda X: X, n=4,
                                        _dtype=c128),
        "laplacian_scale": tl.Laplacian1D(scale=1.0 + 2.0j, n=4, dtype=c128),
        "jacobi": tl.JacobiPreconditioner(d),
        "antidiag": tl.BlockAntiDiagOperator(d=d),
        "blockdiag_child": tl.BlockDiagOperator(
            inner=tl.DiagonalOperator(d), copies=2),
        "scaled_alpha": tl.ScaledOperator(
            tl.DiagonalOperator(torch.ones(2, dtype=c128)), 1.0 + 1.0j),
    }[case]
    with pytest.raises(NotImplementedError):
        tr.realify_operator(op)
