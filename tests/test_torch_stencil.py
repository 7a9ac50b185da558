"""The port's segmented 1-D stencil (lobpcg_tpu_torch/ops/cuda/stencil.py)
against the JAX package's Pallas kernel (interpret mode) and its
Laplacian1D, on the same numpy inputs; plus the wrapper's contract.

Tolerance against the Pallas kernel: 2 ulp of the largest possible
output, 2 * eps_f32 * 4 * |scale| * max|X|.  The Pallas kernel subtracts
the row above first and the plain formula the row below first; the two
f32 orders differ by up to that much.  Against the JAX Laplacian1D
fallback (the same pad/slice formula, same order) the match is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as lt
from lobpcg_tpu.ops.pallas.stencil import stencil_matmat_pallas
from lobpcg_tpu_torch.operators.linop import Laplacian1D
from lobpcg_tpu_torch.ops.cuda import stencil as k1

torch.set_num_threads(2)

N = 256
SCALE = 3.7


def _inputs(seed, k, edges, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.5, 0.5, (N, k)).astype(dtype)
    E = rng.uniform(-0.5, 0.5, (2, k)).astype(dtype) if edges else None
    return X, E


def _tol(X, scale=SCALE):
    return 2 * np.finfo(np.float32).eps * 4 * abs(scale) * np.abs(X).max()


@pytest.mark.parametrize("k", [8, 64, 128])
@pytest.mark.parametrize("segments", [1, 2, 4])
@pytest.mark.parametrize("edges", [False, True])
def test_plain_stencil_matches_pallas_interpret(k, segments, edges):
    X, E = _inputs(100 * segments + k, k, edges)
    y_jax = np.asarray(stencil_matmat_pallas(
        jnp.asarray(X), jnp.asarray(np.float32(SCALE)),
        None if E is None else jnp.asarray(E),
        num_segments=segments, interpret=True,
    ))
    y = k1.stencil_matmat(
        torch.from_numpy(X), SCALE,
        None if E is None else torch.from_numpy(E), num_segments=segments,
    )
    assert y.dtype == torch.float32 and tuple(y.shape) == (N, k)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=0, atol=_tol(X))


@pytest.mark.parametrize("k", [8, 64, 128])
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_laplacian1d_matches_jax_laplacian1d(k, segments):
    X, _ = _inputs(7 * segments + k, k, False)
    A_jax = lt.Laplacian1D(scale=jnp.asarray(np.float32(SCALE)), n=N,
                           segments=segments)
    A = Laplacian1D(scale=SCALE, n=N, segments=segments, dtype=torch.float32)
    y_jax = np.asarray(A_jax.matmat(jnp.asarray(X)))
    np.testing.assert_array_equal(A.matmat(torch.from_numpy(X)).numpy(), y_jax)


@pytest.mark.parametrize("segments", [1, 2])
def test_laplacian1d_f64_plain_formula(segments):
    """f64 takes the plain formula (the kernel has no f64), exactly as
    the JAX package's fallback computes it."""
    X, _ = _inputs(3, 16, False, np.float64)
    A_jax = lt.Laplacian1D(scale=jnp.asarray(SCALE), n=N, segments=segments)
    A = Laplacian1D(scale=SCALE, n=N, segments=segments, dtype=torch.float64)
    np.testing.assert_array_equal(
        A.matmat(torch.from_numpy(X)).numpy(),
        np.asarray(A_jax.matmat(jnp.asarray(X))),
    )


def test_bf16_plain_version_rounds_once_from_f32():
    X, E = _inputs(11, 64, True)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    Eb = torch.from_numpy(E).to(torch.bfloat16)
    y = k1.stencil_matmat(Xb, SCALE, Eb, num_segments=2)
    want = k1.stencil_matmat(Xb.float(), SCALE, Eb.float(), num_segments=2)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want.to(torch.bfloat16))


def test_cpu_tensor_never_moves_launch_counter():
    X, E = _inputs(5, 64, True)
    before = k1.stencil_matmat.launches
    k1.stencil_matmat(torch.from_numpy(X), SCALE, torch.from_numpy(E),
                      num_segments=2)
    Laplacian1D(scale=SCALE, n=N, segments=2).matmat(torch.from_numpy(X))
    assert k1.stencil_matmat.launches == before


@pytest.mark.parametrize("bad", ["segments", "edge_shape", "rank"])
def test_wrapper_rejects_bad_arguments(bad):
    X = torch.zeros((N, 8))
    with pytest.raises(ValueError):
        if bad == "segments":
            k1.stencil_matmat(X, 1.0, num_segments=3)
        elif bad == "edge_shape":
            k1.stencil_matmat(X, 1.0, torch.zeros((2, 7)))
        else:
            k1.stencil_matmat(X[:, 0], 1.0)
