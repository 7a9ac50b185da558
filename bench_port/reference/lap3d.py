"""Plain reference of the 3-D Laplacian configurations: NumPy and plain
PyTorch in float64, TF32 off, built again from the configuration's
numbers.  It imports nothing of the port and takes nothing the port made:
the program's answers (eigenvalues, eigenvectors, Y) are only judged.

    A = scale * L, L the 7-point Dirichlet Laplacian on grid (N0, N1, N2),
    rows in C order (i0 slowest): (L x)_i = 6 x_i - the sum of x over
    the grid neighbours of i, a neighbour outside the grid counting 0.

Its eigenvalues are the sums over the three axes of
4 scale sin^2(k_d pi / (2 (N_d + 1))), k_d = 1 .. N_d, and its norm is the
largest of them (k_d = N_d on every axis).  Departures from the source
(BLOPEX's test problem in hypre's ``ij`` driver): the same operator,
applied here matrix-free in float64 where hypre assembles it as a sparse
matrix in double, with h = 1 / (N + 1) folded into ``scale``; the
eigenvalues are the closed form, not a solve.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

PLANES = 16  # grid planes along axis 0 a block of the float64 apply
COLUMNS = 16  # columns a block of the residuals


def _grid(cfg: dict) -> tuple:
    return tuple(int(g) for g in cfg["grid"])


def _axis_eigs(cfg: dict, size: int, ks) -> np.ndarray:
    k = np.asarray(ks, dtype=np.float64)
    return 4.0 * float(cfg["scale"]) * np.sin(k * np.pi / (2.0 * (size + 1))) ** 2


def eigenvalues(cfg: dict, nev: int) -> np.ndarray:
    """A's lowest ``nev`` eigenvalues, ascending (float64): every sum of
    the axes' terms with k_d <= nev (no lower one can need more), sorted."""
    axes = [_axis_eigs(cfg, N, range(1, min(N, nev) + 1)) for N in _grid(cfg)]
    sums = sorted(sum(terms) for terms in itertools.product(*axes))
    return np.asarray(sums[:nev])


def norm(cfg: dict) -> float:
    """||A||_2: the largest eigenvalue, k_d = N_d on every axis."""
    return float(sum(_axis_eigs(cfg, N, [N])[0] for N in _grid(cfg)))


def apply(cfg: dict, X: torch.Tensor) -> torch.Tensor:
    """A X in float64 for a float64 block X [n, c], ``PLANES`` grid planes
    of axis 0 at a time."""
    n0, n1, n2 = _grid(cfg)
    if X.shape[0] != n0 * n1 * n2:
        raise ValueError(f"X has {X.shape[0]} rows; the grid has {n0 * n1 * n2}")
    G = X.reshape(n0, n1, n2, -1)
    Y = torch.empty_like(G)
    for a in range(0, n0, PLANES):
        b = min(n0, a + PLANES)
        x = G[a:b]
        y = 6.0 * x
        for axis in range(3):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[axis], hi[axis] = slice(1, None), slice(None, -1)
            y[tuple(lo)] -= x[tuple(hi)]  # the neighbour below
            y[tuple(hi)] -= x[tuple(lo)]  # the neighbour above
        if a > 0:
            y[0] -= G[a - 1]
        if b < n0:
            y[-1] -= G[b]
        Y[a:b] = float(cfg["scale"]) * y
    return Y.reshape(X.shape)


def residuals(cfg: dict, lam: np.ndarray, vecs: torch.Tensor) -> np.ndarray:
    """Backward errors ||A x - lam x|| / ((||A|| + |lam|) ||x||) of the
    pairs (lam_j, vecs[:, j]) in float64, ||A|| exact (NaN where not
    finite): the residual that the solver's tol is stated in
    (``residual_norm`` "2", B the identity)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a_norm = norm(cfg)
    out = []
    for j in range(0, vecs.shape[1], COLUMNS):
        x = vecs[:, j:j + COLUMNS].double()
        lj = torch.as_tensor(np.asarray(lam[j:j + COLUMNS], np.float64),
                             device=x.device)
        r = apply(cfg, x) - x * lj
        den = (a_norm + lj.abs()) * torch.linalg.vector_norm(x, dim=0)
        out.append((torch.linalg.vector_norm(r, dim=0) / den).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)
