"""The port's N-D Laplacian (lobpcg_tpu_torch/operators/stencil_nd.py) and
its fused 3-D stencil K2 (lobpcg_tpu_torch/ops/cuda/stencil3d.py)
against the JAX package on the same numpy inputs, on the CPU.

K2's plain version is held against the Pallas kernel in interpret mode
at atol 1e-4 (the JAX package's own tolerance for that kernel against
the separable formula); LaplacianND against the JAX operator in f64 at
atol 1e-10; the 3-D solve through LaplacianND and BSROperator against
the JAX solver at rtol 1e-9 and the analytic spectrum at rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from lobpcg_tpu.operators.sparse import BSROperator as JBSROperator
from lobpcg_tpu.operators.sparse import laplacian_3d_csr as j_laplacian_3d_csr
from lobpcg_tpu.operators.stencil_nd import laplacian_nd_eigs as j_eigs
from lobpcg_tpu.ops.pallas.stencil3d import stencil3d_matmat_pallas
from lobpcg_tpu_torch.interop import config_from_reference, operator_from_reference
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.ops.cuda import stencil3d as k2
from test_torch_solvers import jax_draws

torch.set_num_threads(2)


def _block(seed, n, k, dtype=np.float32):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n, k)).astype(dtype)


# The five shapes of tests/test_stencil_nd.py's interpret-mode test.
PALLAS_CASES = [((6, 16, 4), 32, 16), ((5, 32, 2), 64, 16),
                ((3, 16, 1), 128, 8), ((4, 16, 8), 128, 8),
                ((3, 24, 16), 64, 8)]


@pytest.mark.parametrize("grid,k,By", PALLAS_CASES)
def test_plain_stencil3d_matches_pallas_interpret(grid, k, By):
    X = _block(9, int(np.prod(grid)), k)
    y_jax = np.asarray(stencil3d_matmat_pallas(
        jnp.asarray(X), jnp.float32(1.3), grid_shape=grid, By=By,
        interpret=True))
    y = k2.stencil3d_matmat(torch.from_numpy(X), 1.3, grid)
    assert y.dtype == torch.float32 and tuple(y.shape) == X.shape
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-4)


@pytest.mark.parametrize("grid", [(1, 1, 1), (5, 7, 9), (2, 3, 1), (6, 6, 6)])
def test_plain_stencil3d_matches_csr(grid):
    """The plain K2 on odd grids against the 3-D Laplacian's CSR (f64)."""
    X = _block(3, int(np.prod(grid)), 5, np.float64)
    h = 1.0 / (max(grid) + 1)
    indptr, indices, vals = tl.laplacian_3d_csr(*grid)
    want = sp.csr_matrix((vals, indices, indptr), shape=(X.shape[0],) * 2) @ X
    y = k2.stencil3d_matmat(torch.from_numpy(X), 1.0 / h**2, grid)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-12 * np.abs(want).max())


def test_plain_stencil3d_bf16_rounds_once_from_f32():
    grid = (4, 5, 6)
    X = torch.from_numpy(_block(4, 120, 16)).to(torch.bfloat16)
    y = k2.stencil3d_matmat(X, 2.5, grid)
    want = k2.stencil3d_matmat(X.float(), 2.5, grid).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


@pytest.mark.parametrize("grid", [(40,), (12, 9), (6, 5, 7)])
@pytest.mark.parametrize("force_jnp", [False, True])
def test_laplacian_nd_matches_jax_f64(grid, force_jnp):
    n = int(np.prod(grid))
    X = _block(len(grid), n, 6, np.float64)
    jA = jl.LaplacianND(scale=jnp.asarray(3.7), grid=grid, force_jnp=force_jnp)
    tA = tl.LaplacianND(scale=3.7, grid=grid, force_jnp=force_jnp,
                        dtype=torch.float64)
    assert tA.shape == jA.shape
    np.testing.assert_allclose(tA.matmat(torch.from_numpy(X)).numpy(),
                               np.asarray(jA.matmat(jnp.asarray(X))),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("grid", [(40,), (12, 9), (6, 5, 7)])
def test_laplacian_nd_f32_goes_through_the_kernels(grid, monkeypatch):
    """f32: 1-D and 2-D take one K1 pass per axis, 3-D one K2 call; the
    result matches the JAX operator's separable formula."""
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = k1.stencil_matmat, k2.stencil3d_matmat

    def spy1(*a, **kw):
        calls["k1"] += 1
        return real_k1(*a, **kw)

    def spy2(*a, **kw):
        calls["k2"] += 1
        return real_k2(*a, **kw)

    monkeypatch.setattr("lobpcg_tpu_torch.operators.stencil_nd.stencil_matmat",
                        spy1)
    monkeypatch.setattr(k2, "stencil3d_matmat", spy2)
    n = int(np.prod(grid))
    X = _block(7, n, 8)
    y = tl.LaplacianND(scale=3.7, grid=grid).matmat(torch.from_numpy(X))
    want = np.asarray(jl.LaplacianND(scale=jnp.float32(3.7), grid=grid)
                      .matmat(jnp.asarray(X)))
    assert calls == ({"k1": 0, "k2": 1} if len(grid) == 3
                     else {"k1": len(grid), "k2": 0})
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=4 * np.finfo(np.float32).eps * 12 * 3.7 * 0.5)


def test_laplacian_nd_eigs_matches_jax():
    for grid in [(7,), (9, 4), (5, 6, 7)]:
        np.testing.assert_array_equal(tl.laplacian_nd_eigs(grid, 2.0, 10),
                                      j_eigs(grid, 2.0, 10))


def _solve_both(jA, tA, X0, cfg, key):
    n, m = jA.shape[0], cfg.size_sub
    draws = jax_draws(key, n, m, jnp.float64, cfg, indefinite=False,
                      with_b=False, x0_given=True)
    rj = jl.lobpcg(jA, jnp.asarray(X0), config=cfg, key=key)
    rt = tl.lobpcg(tA, torch.from_numpy(X0), config=config_from_reference(cfg),
                   draws=draws)
    return rt, rj


@pytest.mark.parametrize("operator", ["LaplacianND", "BSROperator"])
def test_3d_laplacian_solve_matches_jax(operator):
    """The slice end to end: lobpcg on the 8^3 Laplacian, f64, nev 3,
    size_sub 6, tol 1e-8 (tests/test_stencil_nd.py's 3-D case), through
    both operators in both packages."""
    nx = 8
    n, h = nx**3, 1.0 / (nx + 1)
    if operator == "LaplacianND":
        jA = jl.LaplacianND(scale=jnp.asarray(1.0 / h**2), grid=(nx, nx, nx))
    else:
        jA = JBSROperator.from_csr(*j_laplacian_3d_csr(nx, nx, nx),
                                   block_size=8, dtype=jnp.float64)
    tA = operator_from_reference(jA, device="cpu")
    assert type(tA).__name__ == operator
    X0 = np.random.RandomState(3).uniform(-0.5, 0.5, (n, 6))
    cfg = jl.SolverConfig(nev=3, size_sub=6, tol=1e-8, max_iter=300)
    rt, rj = _solve_both(jA, tA, X0, cfg, jax.random.PRNGKey(11))
    assert rt.converged == int(rj.converged) == 3
    lam = rt.eigenvalues.numpy()
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), rtol=1e-9)
    np.testing.assert_allclose(lam, tl.laplacian_nd_eigs((nx,) * 3, 1 / h**2, 3),
                               rtol=1e-8)


def test_wrapper_rejects_bad_arguments():
    X = torch.zeros((60, 4))
    with pytest.raises(ValueError):
        k2.stencil3d_matmat(X, 1.0, (3, 4, 6))  # 72 points, 60 rows
    with pytest.raises(ValueError):
        k2.stencil3d_matmat(X, 1.0, (60, 1))
    with pytest.raises(ValueError):
        k2.stencil3d_matmat(X[:, 0], 1.0, (3, 4, 5))


def test_cpu_tensor_never_moves_launch_counter():
    before = k2.stencil3d_matmat.launches
    tl.LaplacianND(scale=1.0, grid=(3, 4, 5)).matmat(torch.ones((60, 4)))
    assert k2.stencil3d_matmat.launches == before
