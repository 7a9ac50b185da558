"""Tests of the port that need a CUDA device (marker ``gpu``; each skips
without one).  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The stencil kernel is held against its plain PyTorch version on the
card, and a small BdG solve must go through the kernel.
"""

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.ops.cuda import stencil as k1

SCALE = 3.7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stencil kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 64, 78, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edges", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, k, dtype, edges):
    """Tolerance: 2 ulp of the storage dtype x |scale| x max|X| (the
    kernel and the plain version do the same f32 operations in the same
    order)."""
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (512, k))).to(cuda_device, dtype)
    E = (torch.from_numpy(rng.uniform(-0.5, 0.5, (2, k))).to(cuda_device, dtype)
         if edges else None)
    before = k1.stencil_matmat.launches
    y = k1.stencil_matmat(X, SCALE, E, num_segments=2)
    assert k1.stencil_matmat.launches == before + 1
    want = k1.stencil_matmat_reference(X, SCALE, E, num_segments=2)
    torch.cuda.synchronize()
    tol = 2 * torch.finfo(dtype).eps * SCALE * float(X.float().abs().max())
    assert y.dtype == dtype and y.shape == X.shape
    assert float((y.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    X = torch.zeros((64, 8), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        k1.stencil_matmat(X, 1.0)
    with pytest.raises(ValueError):
        k1.stencil_matmat(X.float()[:, ::2], 1.0)  # not contiguous


@pytest.mark.gpu
def test_small_bdg_solve_runs_through_the_kernel(cuda_device):
    m, well, nev, ss, dt = 512, 64, 4, 8, torch.float32
    lo = (m - well) // 2
    V = np.full(m, 2.0)
    V[lo : lo + well] = 1.0
    Vd = torch.as_tensor(np.concatenate([V, V]), dtype=dt, device=cuda_device)
    A = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt) \
        + tl.DiagonalOperator(Vd)
    B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=cuda_device))
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=6.1, degree=3)
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
    before = k1.stencil_matmat.launches
    r = tl.ilobpcg(A, X0, B, T, nev=nev, size_sub=ss, tol=1e-5, max_iter=300,
                   generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert r.converged == nev
    assert k1.stencil_matmat.launches - before >= 2 * r.iterations
    H = np.diag(2.0 + V) - np.eye(m, k=1) - np.eye(m, k=-1)
    exact = np.linalg.eigvalsh(H)[:nev]
    lam = r.eigenvalues.double().cpu().numpy()
    assert np.abs(lam - exact).max() / exact.min() <= 1e-5
