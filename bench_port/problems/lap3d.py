"""The port's side of the 3-D Laplacian configurations: the operator built
with ``lobpcg_tpu_torch``'s public operators from the configuration's
numbers, the starts, and the standard solve, as ``chip_smoke.py``'s
``laplacian3d_phase`` runs it.

    A = scale * (7-point Dirichlet Laplacian) on ``grid``, flattened in
        C order: ``LaplacianND`` (K2 on the card), or the same matrix
        assembled by ``laplacian_3d_csr`` as a ``BSROperator`` (K3)
    B = None, T = None: the standard problem, no preconditioner
"""

from __future__ import annotations

import dataclasses
import math

import torch

import lobpcg_tpu_torch as lt

OPERATORS = ("LaplacianND", "BSROperator")


@dataclasses.dataclass
class Problem:
    A: object
    n: int
    dtype: torch.dtype
    device: torch.device


def build(cfg: dict, device, operator: str = "LaplacianND") -> Problem:
    """The operator of ``cfg`` on ``device``, by the route ``operator``
    names (one of ``OPERATORS``)."""
    device = torch.device(device)
    dtype = getattr(torch, cfg["dtype"])
    grid = tuple(int(g) for g in cfg["grid"])
    scale = float(cfg["scale"])
    if operator == "LaplacianND":
        A = lt.LaplacianND(scale=scale, grid=grid, dtype=dtype)
    elif operator == "BSROperator":
        indptr, indices, vals = lt.laplacian_3d_csr(*grid, h=1.0)
        A = lt.BSROperator.from_csr(indptr, indices, vals * scale,
                                    block_size=int(cfg["bsr_block_size"]),
                                    dtype=dtype, device=device)
    else:
        raise ValueError(f"operator {operator!r}: not one of {OPERATORS}")
    return Problem(A=A, n=math.prod(grid), dtype=dtype, device=device)


def solver_config(cfg: dict, nev: int, size_sub: int):
    return lt.SolverConfig(nev=nev, size_sub=size_sub, **cfg["solver"])


def well_draws(p: Problem, size_sub: int, gen: torch.Generator):
    """u [n, size_sub]: uniform(-0.5, 0.5) from ``gen`` on the device (the
    name is the drivers'; the grid has no well)."""
    return torch.rand((p.n, size_sub), generator=gen, dtype=p.dtype,
                      device=p.device) - 0.5


def start(p: Problem, u: torch.Tensor) -> torch.Tensor:
    """X0 = u: the whole grid drawn."""
    return u


def solve(p: Problem, X0: torch.Tensor, config, gen: torch.Generator,
          it_cap=None):
    """One standard ``lobpcg`` solve from X0 (B and T None), stopped
    after ``it_cap`` iterations when given."""
    return lt.lobpcg(p.A, X0, config=config, generator=gen, it_cap=it_cap)


def apply(p: Problem, X: torch.Tensor) -> torch.Tensor:
    """Y = A X, one operator apply."""
    return p.A.matmat(X)
