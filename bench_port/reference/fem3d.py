"""Plain reference of the Q1 finite-element configurations: NumPy and
plain PyTorch in float64, TF32 off, built again from the configuration's
numbers.  It imports nothing of the port and takes nothing the port made:
the program's answers (eigenvalues, eigenvectors, Y) are only judged.

The pencil K x = lambda M x of order-1 H1 elements on the unit cube
meshed in (N_d + 1) uniform hexahedra along axis d, h_d = 1/(N_d + 1),
the Dirichlet nodes removed, rows in C order (axis 0 slowest):

    K = s (K1 (x) M1 (x) M1 + M1 (x) K1 (x) M1 + M1 (x) M1 (x) K1)
    M = s (M1 (x) M1 (x) M1)
    K1 = (1/h) tridiag(-1, 2, -1), M1 = (h/6) tridiag(1, 4, 1)

with s = 1/(h0 h1 h2) = prod(N_d + 1), applied here matrix-free, each
factor a tridiagonal along one axis of the [N0, N1, N2] array, where the
port's problem assembles CSR.  The
sine modes diagonalize every factor: with t = j pi h, K1 has
kappa_j = (2/h)(1 - cos t), M1 has m_j = (h/3)(2 + cos t), so the pencil's
eigenvalues are mu_i + mu_j + mu_k, mu = kappa / m = (6/h^2)(1 - cos t) /
(2 + cos t), whatever s, and ||K||, ||M|| are the largest eigenvalues of
K and M.
Departures from the source (MFEM's ex11p): the Dirichlet nodes are
removed where ex11p keeps them with a unit diagonal in A, so its spurious
boundary modes are absent; K and M are scaled alike by s; the eigenvalues
are the closed form, not a solve.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

COLUMNS = 16  # columns a block of the residuals


def _grid(cfg: dict) -> tuple:
    return tuple(int(g) for g in cfg["grid"])


def _scale(cfg: dict) -> float:
    """s = 1/(h0 h1 h2): prod(N_d + 1), exact."""
    return float(np.prod([N + 1 for N in _grid(cfg)], dtype=np.float64))


def _axis(N: int):
    """(kappa, m) of the N sine modes of one axis, ascending in j."""
    h = 1.0 / (N + 1)
    c = np.cos(np.arange(1, N + 1, dtype=np.float64) * np.pi * h)
    return (2.0 / h) * (1.0 - c), (h / 3.0) * (2.0 + c)


def eigenvalues(cfg: dict, nev: int) -> np.ndarray:
    """The pencil's lowest ``nev`` eigenvalues, ascending, with
    multiplicity (float64): every sum of the axes' mu_j with j <= nev (no
    lower one can need more), sorted."""
    axes = []
    for N in _grid(cfg):
        kappa, m = _axis(N)
        axes.append((kappa / m)[:min(N, nev)])
    sums = sorted(sum(terms) for terms in itertools.product(*axes))
    return np.asarray(sums[:nev])


def norms(cfg: dict) -> tuple:
    """(||K||_2, ||M||_2): the largest eigenvalue of each, over every
    triple of the axes' modes."""
    (k0, m0), (k1, m1), (k2, m2) = (_axis(N) for N in _grid(cfg))
    m12 = m1[:, None] * m2[None, :]
    km12 = k1[:, None] * m2[None, :] + m1[:, None] * k2[None, :]
    k_norm = float(np.max(k0[:, None, None] * m12 + m0[:, None, None] * km12))
    s = _scale(cfg)
    return s * k_norm, s * float(m0.max() * m1.max() * m2.max())


def _tridiag(x: torch.Tensor, axis: int, diag: float, off: float):
    """diag x + off (x's neighbours along ``axis``), a neighbour outside
    the grid counting 0."""
    y = diag * x
    lo = [slice(None)] * x.dim()
    hi = [slice(None)] * x.dim()
    lo[axis], hi[axis] = slice(1, None), slice(None, -1)
    y[tuple(lo)] += off * x[tuple(hi)]
    y[tuple(hi)] += off * x[tuple(lo)]
    return y


def _apply_both(cfg: dict, X: torch.Tensor) -> tuple:
    """(K X, M X) in float64 for a float64 block X [n, c]."""
    grid = _grid(cfg)
    n = int(np.prod(grid))
    if X.shape[0] != n:
        raise ValueError(f"X has {X.shape[0]} rows; the grid has {n}")
    G = X.reshape(*grid, -1)
    hs = [1.0 / (N + 1) for N in grid]

    def K(d, x):
        return _tridiag(x, d, 2.0 / hs[d], -1.0 / hs[d])

    def M(d, x):
        return _tridiag(x, d, 4.0 * hs[d] / 6.0, hs[d] / 6.0)

    s = _scale(cfg)
    m2 = M(2, G)
    m12 = M(1, m2)
    KX = K(0, m12) + M(0, K(1, m2) + M(1, K(2, G)))
    MX = M(0, m12)
    return (s * KX).reshape(X.shape), (s * MX).reshape(X.shape)


def apply(cfg: dict, X: torch.Tensor) -> torch.Tensor:
    """K X in float64 for a float64 block X [n, c]."""
    return _apply_both(cfg, X)[0]


def apply_mass(cfg: dict, X: torch.Tensor) -> torch.Tensor:
    """M X in float64 for a float64 block X [n, c]."""
    return _apply_both(cfg, X)[1]


def residuals(cfg: dict, lam: np.ndarray, vecs: torch.Tensor) -> np.ndarray:
    """Backward errors ||K x - lam M x|| / ((||K|| + |lam| ||M||) ||x||) of
    the pairs (lam_j, vecs[:, j]) in float64, the norms exact (NaN where
    not finite): the residual that the solver's tol is stated in
    (``residual_norm`` "2")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k_norm, m_norm = norms(cfg)
    out = []
    for j in range(0, vecs.shape[1], COLUMNS):
        x = vecs[:, j:j + COLUMNS].double()
        lj = torch.as_tensor(np.asarray(lam[j:j + COLUMNS], np.float64),
                             device=x.device)
        KX, MX = _apply_both(cfg, x)
        r = KX - MX * lj
        den = (k_norm + lj.abs() * m_norm) * torch.linalg.vector_norm(x, dim=0)
        out.append((torch.linalg.vector_norm(r, dim=0) / den).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)
