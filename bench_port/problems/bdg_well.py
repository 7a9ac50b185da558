"""The port's side of the BdG well configurations: the pencil built with
``lobpcg_tpu_torch``'s public operators from the configuration's numbers,
the starts, and the solve.  The recipe is that of the port's
``benchmarks/solve_bdg.py`` (``well_problem``), written out here so that
a change to the program cannot change the problem.

    A = diag(K, K), K = tridiag[-1, 2, -1] * scale + V   (one two-segment
        Laplacian1D plus a diagonal: K1's stencil_diag on the card)
    V = shift inside a window of ``well`` sites centred in each half,
        barrier + shift outside it
    B = antidiag(I, I)
    T = ChebyshevFilter of ``cheb_degree`` on [cheb_lo, cheb_hi]
"""

from __future__ import annotations

import dataclasses

import torch

import lobpcg_tpu_torch as lt


@dataclasses.dataclass
class Problem:
    A: object
    B: object
    T: object
    n: int
    m: int
    lo: int  # the well's first site in each half
    well: int
    dtype: torch.dtype
    device: torch.device


def build(cfg: dict, device) -> Problem:
    """The pencil of ``cfg`` on ``device``."""
    device = torch.device(device)
    dtype = getattr(torch, cfg["dtype"])
    n, segments = int(cfg["n"]), int(cfg["segments"])
    if segments != 2 or n % 2:
        raise ValueError("the BdG well is diag(K, K): two segments, n even")
    m, w = n // 2, int(cfg["well"])
    lo = (m - w) // 2
    V = torch.full((m,), cfg["barrier"] + cfg["shift"], dtype=dtype,
                   device=device)
    V[lo:lo + w] = cfg["shift"]
    A = lt.Laplacian1D(scale=cfg["scale"], n=n, segments=2, dtype=dtype) \
        + lt.DiagonalOperator(torch.cat([V, V]))
    B = lt.BlockAntiDiagOperator(d=torch.ones((m,), dtype=dtype,
                                              device=device))
    T = lt.ChebyshevFilter(op=A, lo=cfg["cheb_lo"], hi=cfg["cheb_hi"],
                           degree=cfg["cheb_degree"],
                           chunk=cfg["cheb_chunk"])
    return Problem(A=A, B=B, T=T, n=n, m=m, lo=lo, well=w, dtype=dtype,
                   device=device)


def solver_config(cfg: dict, nev: int, size_sub: int):
    return lt.SolverConfig(nev=nev, size_sub=size_sub, **cfg["solver"])


def well_draws(p: Problem, size_sub: int, gen: torch.Generator):
    """u [well, size_sub]: uniform(-0.5, 0.5) from ``gen`` on the device."""
    return torch.rand((p.well, size_sub), generator=gen, dtype=p.dtype,
                      device=p.device) - 0.5


def start(p: Problem, u: torch.Tensor) -> torch.Tensor:
    """X0 = [u; u], u inside the well and zero outside (bound states live
    there): a B-positive start."""
    X0 = torch.zeros((p.n, u.shape[1]), dtype=p.dtype, device=p.device)
    X0[p.lo:p.lo + p.well] = u
    X0[p.m + p.lo:p.m + p.lo + p.well] = u
    return X0


def solve(p: Problem, X0: torch.Tensor, config, gen: torch.Generator):
    """One ``ilobpcg`` solve of the pencil from X0."""
    return lt.ilobpcg(p.A, X0, p.B, p.T, config=config, generator=gen)


def apply(p: Problem, X: torch.Tensor) -> torch.Tensor:
    """Y = A X, one operator apply."""
    return p.A.matmat(X)
