"""Plain reference of the BdG well configurations: NumPy, SciPy and plain
PyTorch in float64, TF32 off, built again from the configuration's
numbers.  It imports nothing of the port and takes nothing the port made:
the program's answers (eigenvalues, eigenvectors, Y) are only judged.

    K = tridiag[-1, 2, -1] * scale + V on m = n / 2 sites (Dirichlet ends),
    V = shift on the ``well`` sites from lo = (m - well) // 2, barrier +
    shift elsewhere; A = diag(K, K), B = antidiag(I, I).

The pencil's spectrum is +-eig(K) (x = [u; +-u]), so the solve's nev
positive eigenvalues, ascending, are K's lowest nev.  Those are bound
states of the well, decaying by about exp(-0.86) a site into the barrier
for every nev here: K restricted to the well and ``MARGIN`` sites on each
side has the same lowest eigenvalues to float64 (the port's
``benchmarks/solve_bdg.py:well_eigs_oracle`` truncates so; here the
truncated matrix is tridiagonal and solved as such, in milliseconds).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.linalg import eigvalsh_tridiagonal

MARGIN = 2048  # barrier sites kept on each side of the well
COLUMNS = 32  # columns a block of the float64 passes


def potential(cfg: dict):
    """(V [m] float64, lo, m)."""
    m, w = int(cfg["n"]) // 2, int(cfg["well"])
    lo = (m - w) // 2
    V = np.full(m, float(cfg["barrier"]) + float(cfg["shift"]))
    V[lo:lo + w] = float(cfg["shift"])
    return V, lo, m


def eigenvalues(cfg: dict, nev: int) -> np.ndarray:
    """K's lowest ``nev`` eigenvalues, ascending (float64)."""
    V, lo, m = potential(cfg)
    a, b = max(0, lo - MARGIN), min(m, lo + int(cfg["well"]) + MARGIN)
    s = float(cfg["scale"])
    return eigvalsh_tridiagonal(2.0 * s + V[a:b], np.full(b - a - 1, -s),
                                select="i", select_range=(0, nev - 1))


def norm_bound(cfg: dict) -> float:
    """||A||_2 <= 4 scale + max V (Gershgorin; ||B||_2 = 1)."""
    V, _, _ = potential(cfg)
    return 4.0 * float(cfg["scale"]) + float(V.max())


def _diag(cfg: dict, device) -> torch.Tensor:
    V, _, _ = potential(cfg)
    return torch.as_tensor(V, dtype=torch.float64, device=device)


def apply(cfg: dict, X: torch.Tensor, V: torch.Tensor = None) -> torch.Tensor:
    """A X in float64 for a float64 block X [n, c]."""
    s = float(cfg["scale"])
    V = _diag(cfg, X.device) if V is None else V
    m = X.shape[0] // 2
    xs = X.view(2, m, -1)
    Y = (2.0 * s + V)[None, :, None] * xs
    Y[:, 1:] -= s * xs[:, :-1]
    Y[:, :-1] -= s * xs[:, 1:]
    return Y.view(X.shape)


def _magnitude(cfg: dict, X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """|2 s x_i| + |s x_i-1| + |s x_i+1| + |V_i x_i| a row: the scale of
    the rounding that a float computation of (A X)_i can make."""
    s = float(cfg["scale"])
    m = X.shape[0] // 2
    xs = X.abs().view(2, m, -1)
    M = (2.0 * s + V.abs())[None, :, None] * xs
    M[:, 1:] += s * xs[:, :-1]
    M[:, :-1] += s * xs[:, 1:]
    return M.view(X.shape)


def apply_error(cfg: dict, X: torch.Tensor, Y: torch.Tensor) -> float:
    """max over elements of |Y - A X| / the element's magnitude
    (componentwise, float64, a block of columns at a time); NaN if any Y
    is not finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    V = _diag(cfg, X.device)
    worst = 0.0
    for j in range(0, X.shape[1], COLUMNS):
        x = X[:, j:j + COLUMNS].double()
        y = Y[:, j:j + COLUMNS].double()
        err = (y - apply(cfg, x, V)).abs()
        mag = _magnitude(cfg, x, V)
        rel = torch.where(mag > 0, err / torch.where(mag > 0, mag, 1.0), err)
        worst = max(worst, float(rel.max()))
        if not bool(torch.isfinite(y).all()):
            return float("nan")
    return worst


def residuals(cfg: dict, lam: np.ndarray, vecs: torch.Tensor) -> np.ndarray:
    """Backward errors ||A x - lam B x|| / ((||A|| + |lam| ||B||) ||x||)
    of the pairs (lam_j, vecs[:, j]), in float64 (NaN where not finite)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    V = _diag(cfg, vecs.device)
    a_norm = norm_bound(cfg)
    m = vecs.shape[0] // 2
    out = []
    for j in range(0, vecs.shape[1], COLUMNS):
        x = vecs[:, j:j + COLUMNS].double()
        lj = torch.as_tensor(lam[j:j + COLUMNS], dtype=torch.float64,
                             device=x.device)
        bx = torch.cat([x[m:], x[:m]])
        r = apply(cfg, x, V) - bx * lj
        den = (a_norm + lj.abs()) * torch.linalg.vector_norm(x, dim=0)
        out.append((torch.linalg.vector_norm(r, dim=0) / den).cpu().numpy())
    return np.concatenate(out)


def tf32(X: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = X.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def apply_tf32(cfg: dict, X: torch.Tensor) -> torch.Tensor:
    """The control: A X with every operand rounded to TF32 and float32
    arithmetic, the precision just below the configuration's."""
    s = float(cfg["scale"])
    V = tf32(_diag(cfg, X.device).float())
    m = X.shape[0] // 2
    Y = torch.empty_like(X, dtype=torch.float32)
    for j in range(0, X.shape[1], COLUMNS):
        xs = tf32(X[:, j:j + COLUMNS]).view(2, m, -1)
        y = (2.0 * s + V)[None, :, None] * xs
        y[:, 1:] -= s * xs[:, :-1]
        y[:, :-1] -= s * xs[:, 1:]
        Y[:, j:j + COLUMNS] = y.reshape(-1, xs.shape[-1])
    return Y
