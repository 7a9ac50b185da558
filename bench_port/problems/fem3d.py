"""The port's side of the Q1 finite-element configurations: the stiffness
and mass pencil of MFEM's ex11p assembled on the host and handed to
``lobpcg_tpu_torch``'s ``BSROperator``, the starts, and the generalized
solve through the port's normal entry, ``lt.lobpcg`` with B.

    K = K1 (x) M1 (x) M1 + M1 (x) K1 (x) M1 + M1 (x) M1 (x) K1
    M = M1 (x) M1 (x) M1
    K1 = (1/h) tridiag(-1, 2, -1), M1 = (h/6) tridiag(1, 4, 1) on each axis,
    h = 1/(N + 1): order-1 H1 elements on the unit cube meshed in
    (N + 1)^3 uniform hexahedra, the Dirichlet nodes removed, rows in C
    order (axis 0 slowest); both times s = 1/(h0 h1 h2), the grid's
    (the same pencil, the same eigenvalues; see ``scale``).  Both are
    BSROperators (K3 on the card).  T = None: no preconditioner.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.sparse as sp
import torch

import lobpcg_tpu_torch as lt

OPERATORS = ("BSROperator",)


@dataclasses.dataclass
class Problem:
    A: object  # K
    B: object  # M
    n: int
    dtype: torch.dtype
    device: torch.device


def _grid(cfg: dict) -> tuple:
    return tuple(int(g) for g in cfg["grid"])


def scale(cfg: dict) -> float:
    """s = 1/(h0 h1 h2) = prod(N_d + 1), exact: the factor on K and M.
    Unscaled, the M-normalized eigenvectors have norm ~(h0 h1 h2)^-1/2,
    and the solver's residual ("2": ||K x - lambda M x|| / (||K|| +
    |lambda| ||M||), not divided by ||x||) would ask f32 for a backward
    error that many times below tol."""
    return float(math.prod(N + 1 for N in _grid(cfg)))


def factors(N: int):
    """(K1, M1) of one axis of N interior nodes, h = 1/(N + 1), CSR."""
    h = 1.0 / (N + 1)
    ones = np.ones(N - 1)
    K1 = sp.diags([-ones, np.full(N, 2.0), -ones], [-1, 0, 1]) / h
    M1 = sp.diags([ones, np.full(N, 4.0), ones], [-1, 0, 1]) * (h / 6.0)
    return K1.tocsr(), M1.tocsr()


def assemble(cfg: dict):
    """(K, M) of ``cfg``'s grid times ``scale(cfg)``, float64 SciPy CSR
    matrices with sorted indices, from Kronecker products of the axes'
    factors (axis 0 the outermost, so C order)."""
    (K0, M0), (K1, M1), (K2, M2) = (factors(N) for N in _grid(cfg))

    def kron(a, b):
        return sp.kron(a, b, format="csr")

    MM = kron(M1, M2)
    KM = kron(K1, M2) + kron(M1, K2)
    K = (kron(K0, MM) + kron(M0, KM)).tocsr()
    # K's six face couplings are 0 on a mesh of cubes (the Q1 stencil's):
    # the sum leaves rounding residues of ~1e-17 of the largest entry at
    # some of them, and not at others; drop them all, so K keeps its 21
    # nonzeros a row whatever N.
    K.data[np.abs(K.data) <= 1e-12 * np.abs(K.data).max()] = 0.0
    K.eliminate_zeros()
    M = kron(M0, MM)
    s = scale(cfg)
    for X in (K, M):
        X.data *= s
        X.sort_indices()
    return K, M


def _operator(X, cfg, dtype, device):
    return lt.BSROperator.from_csr(
        X.indptr.astype(np.int64), X.indices.astype(np.int64), X.data,
        block_size=int(cfg["bsr_block_size"]), dtype=dtype, device=device)


def build(cfg: dict, device, operator: str = "BSROperator") -> Problem:
    """K and M of ``cfg`` on ``device``, each a ``BSROperator``."""
    if operator not in OPERATORS:
        raise ValueError(f"operator {operator!r}: not one of {OPERATORS}")
    device = torch.device(device)
    dtype = getattr(torch, cfg["dtype"])
    K, M = assemble(cfg)
    A = _operator(K, cfg, dtype, device)
    del K
    B = _operator(M, cfg, dtype, device)
    return Problem(A=A, B=B, n=math.prod(_grid(cfg)), dtype=dtype,
                   device=device)


def solver_config(cfg: dict, nev: int, size_sub: int):
    return lt.SolverConfig(nev=nev, size_sub=size_sub, **cfg["solver"])


def well_draws(p: Problem, size_sub: int, gen: torch.Generator):
    """u [n, size_sub]: uniform(-0.5, 0.5) from ``gen`` on the device (the
    name is the drivers'; the mesh has no well)."""
    return torch.rand((p.n, size_sub), generator=gen, dtype=p.dtype,
                      device=p.device) - 0.5


def start(p: Problem, u: torch.Tensor) -> torch.Tensor:
    """X0 = u: every node drawn."""
    return u


def solve(p: Problem, X0: torch.Tensor, config, gen: torch.Generator,
          it_cap=None):
    """One generalized ``lobpcg`` solve of K x = lambda M x from X0 (T
    None), stopped after ``it_cap`` iterations when given."""
    return lt.lobpcg(p.A, X0, B=p.B, config=config, generator=gen,
                     it_cap=it_cap)


def apply(p: Problem, X: torch.Tensor) -> torch.Tensor:
    """Y = K X, one apply of the stiffness."""
    return p.A.matmat(X)
