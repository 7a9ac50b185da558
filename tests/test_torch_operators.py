"""The port's operators (lobpcg_tpu_torch/operators: every linop.py class
and ChebyshevFilter) against the JAX package's, in f64 and f32 on the
same numpy inputs.

Tolerances: 1e-13 relative in f64; in f32, 1e-6 relative for single
applications and 1e-5 for the Chebyshev recurrence (its scalar
coefficients are rounded differently: Python floats here, f32 arrays
in the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.interop import operator_from_reference

torch.set_num_threads(2)

N = 64
DT = {"f64": (np.float64, 1e-13, 1e-13), "f32": (np.float32, 1e-6, 1e-5)}


def _x(seed, k, dtype):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (N, k)).astype(dtype)


def _reference_ops(dtype):
    rng = np.random.default_rng(42)
    d = rng.uniform(1.0, 2.0, N).astype(dtype)
    M = rng.uniform(-0.5, 0.5, (N, N)).astype(dtype)
    lap = jl.Laplacian1D(scale=jnp.asarray(dtype(3.0)), n=N, segments=2)
    diag = jl.DiagonalOperator(jnp.asarray(d))
    half = jl.Laplacian1D(scale=jnp.asarray(dtype(2.0)), n=N // 2)
    return {
        "dense": jl.DenseOperator(jnp.asarray(M)),
        "diagonal": diag,
        "jacobi": jl.JacobiPreconditioner(jnp.asarray(d)),
        "laplacian": lap,
        "block_diag": jl.BlockDiagOperator(inner=half, copies=2),
        "block_antidiag": jl.BlockAntiDiagOperator(
            d=jnp.asarray(d[: N // 2])),
        "shifted": jl.ShiftedOperator(lap, jnp.asarray(dtype(0.7))),
        "scaled": jl.ScaledOperator(lap, jnp.asarray(dtype(-1.5))),
        "sum": lap + diag,
        "composed": jl.ComposedOperator(lap, diag),
        "cheb": jl.ChebyshevFilter(op=lap + diag, lo=jnp.asarray(dtype(1.0)),
                                   hi=jnp.asarray(dtype(15.0)), degree=4),
        "cheb_chunked": jl.ChebyshevFilter(
            op=lap + diag, lo=jnp.asarray(dtype(1.0)),
            hi=jnp.asarray(dtype(15.0)), degree=4, chunk=4),
    }


NAMES = list(_reference_ops(np.float64))


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_operator_matches_reference(name, prec):
    dtype, rtol_one, rtol_cheb = DT[prec]
    jop = _reference_ops(dtype)[name]
    top = operator_from_reference(jop, device="cpu")
    X = _x(NAMES.index(name), 12, dtype)
    y_j = np.asarray(jop.matmat(jnp.asarray(X)))
    y_t = top.matmat(torch.from_numpy(X))
    assert y_t.dtype == getattr(torch, np.dtype(dtype).name)
    assert tuple(top.shape) == tuple(jop.shape)
    assert top.dtype == y_t.dtype
    assert top.apply_width_ok(12)
    rtol = rtol_cheb if name.startswith("cheb") else rtol_one
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=rtol * np.abs(y_j).max())


def test_chebyshev_chunked_equals_unchunked():
    ops = _reference_ops(np.float64)
    whole = operator_from_reference(ops["cheb"], device="cpu")
    chunked = operator_from_reference(ops["cheb_chunked"], device="cpu")
    X = torch.from_numpy(_x(5, 12, np.float64))
    torch.testing.assert_close(chunked.matmat(X), whole.matmat(X),
                               rtol=0, atol=1e-14)


def test_callable_operator_and_composition_sugar():
    M = np.random.default_rng(1).uniform(-0.5, 0.5, (N, N))
    X = torch.from_numpy(_x(2, 5, np.float64))
    Mt = torch.from_numpy(M)
    A = tl.CallableOperator(args=(Mt,), fn=lambda X, M: M @ X, n=N,
                            _dtype=torch.float64)
    D = tl.DenseOperator(Mt)
    torch.testing.assert_close(A.matmat(X), Mt @ X)
    assert A.shape == (N, N) and A.dtype == torch.float64
    torch.testing.assert_close((A + D).matmat(X), 2 * (Mt @ X))
    torch.testing.assert_close((2.0 * A).matmat(X), 2 * (Mt @ X))
    torch.testing.assert_close((A @ D).matmat(X), Mt @ (Mt @ X))
    torch.testing.assert_close(A(X), A.matmat(X))


def test_laplacian_pad_lanes_is_accepted_and_ignored():
    X = torch.from_numpy(_x(3, 12, np.float32))
    a = tl.Laplacian1D(scale=2.0, n=N, segments=2, pad_lanes=True)
    b = tl.Laplacian1D(scale=2.0, n=N, segments=2)
    assert torch.equal(a.matmat(X), b.matmat(X))


def test_laplacian_takes_column_slices():
    """A column slice is not contiguous; the operator makes it so."""
    X = torch.from_numpy(_x(4, 12, np.float32))
    A = tl.Laplacian1D(scale=2.0, n=N, segments=2)
    assert torch.equal(A.matmat(X[:, 3:7]), A.matmat(X)[:, 3:7])
