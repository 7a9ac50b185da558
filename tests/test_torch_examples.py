"""The port's examples (lobpcg_tpu_torch/examples) on the CPU, each
``main(device="cpu")`` against its JAX script's computation (run here on
the JAX package, as the script runs it) or the script's own oracle.

The examples draw their random numbers from a ``torch.Generator`` seeded
as the script's ``PRNGKey`` (another stream), so a solve held against
the JAX script agrees to what its tol and dtype allow, stated at each
test; oracles are the scripts' own (analytic, exact or dense).
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from lobpcg_tpu_torch.examples import (
    bdg_indefinite,
    checkpoint_resume,
    complex_on_gpu,
    fft_matrix_free,
    laplacian_1d,
    sharded_solve,
    sparse_3d_laplacian,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def sharded_run():
    """The 4-rank sharded_solve, started with the module's first test in a
    background thread: its gloo ranks wait on one another most of the
    time, so the other examples run meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(sharded_solve.main, device="cpu", ranks=4)


def discrete_laplacian(n, nev):
    """The 1-D Dirichlet Laplacian's lowest eigenvalues at spacing 1/(n+1)."""
    h = 1.0 / (n + 1)
    return 4.0 / h**2 * np.sin(np.arange(1, nev + 1) * np.pi * h / 2) ** 2


def test_laplacian_1d():
    """Against examples/laplacian_1d.py's f32 solve: both within 3 x
    eps_f32 x ||A|| of each other (||A|| ~ 4/h^2: the f32 rounding of the
    operator, 0.094 here), and the script's oracle (the continuum
    eigenvalues) within its 3%."""
    import jax
    import jax.numpy as jnp
    import lobpcg_tpu as jl

    out = laplacian_1d.main(device="cpu")
    n = 256
    h = 1.0 / (n + 1)
    A = jl.Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.float32), n=n)
    rj = jl.lobpcg(A, nev=3, size_sub=6, tol=1e-6, max_iter=300,
                   key=jax.random.PRNGKey(0))
    lam = np.asarray(out["eigenvalues"])
    assert out["converged"] == int(rj.converged) == 3
    atol = 3 * np.finfo(np.float32).eps * 4 / h**2
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), atol=atol)
    exact = np.asarray(out["analytic"])
    assert np.abs(lam - exact).max() / exact.min() < 0.03


def test_bdg_indefinite():
    """Against examples/bdg_indefinite.py's f64 solve: eigenvalues to
    1e-5 relative (both stop at tol 1e-6, a backward error relative to
    ||A|| ~ 6.4e5, after different draws), the +1 signatures, 3/3, and
    the discrete spectrum within 1e-5 relative."""
    import jax.numpy as jnp
    import lobpcg_tpu as jl

    out = bdg_indefinite.main(device="cpu")
    m = 400
    h = 1.0 / (m + 1)
    K = jl.Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.float64), n=m)
    u = np.random.RandomState(42).uniform(-0.5, 0.5, size=(m, 6))
    rj = jl.ilobpcg(jl.BlockDiagOperator(inner=K, copies=2),
                    jnp.asarray(np.concatenate([u, u], axis=0)),
                    jl.BlockAntiDiagOperator(d=jnp.ones((m,), jnp.float64)),
                    config=jl.SolverConfig(nev=3, size_sub=6, tol=1e-6,
                                           max_iter=300, record_history=True))
    lam = np.asarray(out["eigenvalues"])
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), rtol=1e-5)
    np.testing.assert_allclose(lam, discrete_laplacian(m, 3), rtol=1e-5)
    assert out["signatures"] == np.asarray(rj.signature).tolist() == [1, 1, 1]
    assert out["converged"] == int(rj.converged) == 3
    trace = out["residual_trace_pair0"]
    assert 6 <= len(trace) <= 7 and trace[-1] < trace[0]


def test_checkpoint_resume(tmp_path):
    """Against examples/checkpoint_resume.py: the snapshot after the
    "crash" holds 10 iterations, the resumed f64 solve converges 3/3, and
    its eigenvalues agree with the JAX script's to 1e-8 relative (tol
    1e-8) and with the discrete spectrum to 1e-8."""
    import jax
    import jax.numpy as jnp
    import lobpcg_tpu as jl

    out = checkpoint_resume.main(device="cpu")
    n = 400
    h = 1.0 / (n + 1)
    A = jl.Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.float64), n=n)
    X0 = jax.random.uniform(jax.random.PRNGKey(3), (n, 6), jnp.float64,
                            -0.5, 0.5)
    path = tmp_path / "solve.npz"
    jl.solve_checkpointed(jl.lobpcg, A, X0, config=jl.SolverConfig(
        nev=3, size_sub=6, tol=1e-8, max_iter=10), path=path, every=5)
    assert out["snapshot_iterations"] == int(jl.load_checkpoint(path)["iterations"]) == 10
    rj = jl.solve_checkpointed(jl.lobpcg, A, None, config=jl.SolverConfig(
        nev=3, size_sub=6, tol=1e-8, max_iter=2000), path=path, every=100)
    lam = np.asarray(out["eigenvalues"])
    assert out["converged"] == int(rj.converged) == 3
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), rtol=1e-8)
    np.testing.assert_allclose(lam, discrete_laplacian(n, 3), rtol=1e-8)


def test_sparse_3d_laplacian():
    """The script's oracle, the exact 10^3 spectrum, to 1e-8 relative
    (f64, tol 1e-6), with 5/5 converged."""
    out = sparse_3d_laplacian.main(device="cpu")
    assert out["converged"] == 5
    np.testing.assert_allclose(out["eigenvalues"], out["exact"], rtol=1e-8)


def test_complex_on_gpu():
    """The split-real f32 solve folded back to 3 complex pairs (6 real
    pairs converged) against the script's oracle, (k pi)^2, within 3 x
    eps_f32 x ||A|| (the f32 rounding of the operator) plus the m 256
    discretization's gap to the continuum; complex64 eigenvectors of the
    complex dimension."""
    out = complex_on_gpu.main(device="cpu")
    m = 256
    h = 1.0 / (m + 1)
    assert out["converged"] == 6 and out["device"] == "cpu"
    assert out["eigenvector_dtype"] == "complex64"
    assert out["eigenvector_shape"] == [2 * m, 3]
    atol = 3 * np.finfo(np.float32).eps * 4 / h**2
    np.testing.assert_allclose(out["eigenvalues"], discrete_laplacian(m, 3),
                               atol=atol)
    exact = np.asarray(out["analytic"])
    assert np.abs(np.asarray(out["eigenvalues"]) - exact).max() / exact.min() < 0.03


def test_fft_matrix_free():
    """The exact spectrum s = 0.5 + k to 1e-5 relative (the tol), 8/8,
    complex64 storage with complex128 projected solves and float64
    eigenvalues."""
    out = fft_matrix_free.main(device="cpu")
    assert out["converged"] == 8
    assert (out["rr_dtype"], out["eigenvalue_dtype"]) == ("complex128", "float64")
    np.testing.assert_allclose(out["eigenvalues"], out["exact"], rtol=1e-5)


def test_sharded_solve_on_four_ranks(sharded_run):
    """The well on 4 gloo ranks against the script's dense oracle to 1e-9
    relative (f64, tol 1e-9), the same eigenvalues on every rank, each
    holding n / 4 rows of the eigenvectors."""
    out = sharded_run.result()
    assert out["ranks"] == 4 and out["same_on_every_rank"]
    assert out["converged"] == 3
    assert out["eigenvector_rows"] == [sharded_solve.N // 4, 3]
    np.testing.assert_allclose(out["eigenvalues"], out["dense_oracle"],
                               rtol=1e-9)


@pytest.mark.parametrize("module", [laplacian_1d, sparse_3d_laplacian,
                                    sharded_solve])
def test_examples_run_on_the_card_by_default(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()
