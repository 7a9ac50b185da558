"""Bogoliubov-de Gennes (BdG) operators for condensate excitation spectra
(port of ``lobpcg_tpu/physics/bdg.py``).

For a real condensate wavefunction psi with density n = |psi|^2 and
contact coupling g, the linearized excitations in the f_+/- = u +- v
basis satisfy the generalized indefinite pencil

    A [f+; f-] = omega * B [f+; f-],
    A = diag(M, K),  B = antidiag(I, I),

with  K = H0 + V - mu + g n        ("kinetic + trap + interactions")
      M = K + 2 g n                ("kinetic + 3*interactions")
so that K M f = omega^2 f: for the uniform gas this is the Bogoliubov
dispersion omega = sqrt(eps (eps + 2 g n)).  ``ilobpcg`` solves the
pencil directly; B-positive start vectors [w; w] select the +omega
branch.  The dipolar exchange term of M is any extra LinearOperator,
given as ``dipolar=``.  ``bdg_preconditioner`` builds a Jacobi
inverse-diagonal or a Chebyshev approximate inverse of diag(M, K).
"""

from __future__ import annotations

from typing import Optional

import torch

from lobpcg_tpu_torch.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu_torch.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiag2Operator,
    DiagonalOperator,
    JacobiPreconditioner,
    LinearOperator,
)
from lobpcg_tpu_torch.utils.prng import fill_random


def bdg_operators(
    kinetic: LinearOperator,
    psi: torch.Tensor,
    g: float,
    mu: float,
    v_trap: Optional[torch.Tensor] = None,
    dipolar: Optional[LinearOperator] = None,
):
    """(A, B, K, M) for the BdG pencil from a condensate state.

    kinetic: the single-particle kinetic operator H0 (e.g. -1/2 Lap_h as
        a Laplacian1D / BSROperator / CallableOperator) on the grid.
    psi:     real condensate amplitude on the grid, [m]; the operators'
        tensors live on its device.
    g, mu:   contact coupling and chemical potential.
    v_trap:  optional trap potential on the grid, [m].
    dipolar: optional exchange operator added to M.
    """
    dt = kinetic.dtype
    n_dens = (torch.abs(psi) ** 2).to(dt)
    v = torch.zeros_like(n_dens) if v_trap is None else v_trap.to(dt)
    base = v - mu + g * n_dens

    K = kinetic + DiagonalOperator(base)
    M = kinetic + DiagonalOperator(base + 2.0 * g * n_dens)
    if dipolar is not None:
        M = M + dipolar

    A = BlockDiag2Operator(top=M, bottom=K)
    B = BlockAntiDiagOperator(
        d=torch.ones((psi.shape[0],), dtype=dt, device=psi.device)
    )
    return A, B, K, M


def bdg_preconditioner(
    A: LinearOperator,
    diag_A: torch.Tensor,
    *,
    kind: str = "jacobi",
    hi: Optional[float] = None,
    lo: Optional[float] = None,
    degree: int = 8,
) -> LinearOperator:
    """The BdG preconditioner, two ways:

    - 'jacobi': T = diag(A)^-1 (pass diag_A = the [2m] diagonal).
    - 'chebyshev': T ~ A^-1 on [lo, hi] by `degree` Chebyshev steps
      (requires A's spectrum within (0, hi]; shift A first if needed).
    """
    if kind == "jacobi":
        return JacobiPreconditioner(diag_A)
    if kind == "chebyshev":
        if hi is None:
            raise ValueError("chebyshev preconditioner needs hi (>= ||A||)")
        lo = hi / 30.0 if lo is None else lo
        return ChebyshevFilter(op=A, lo=float(lo), hi=float(hi), degree=degree)
    raise ValueError(f"unknown preconditioner kind {kind!r}")


def bdg_positive_start(generator: Optional[torch.Generator], m: int,
                       size_sub: int, dtype, device=None) -> torch.Tensor:
    """B-positive initialization X = [w; w] (selects the +omega branch),
    w uniform(-0.5, 0.5) from ``generator``, on ``device`` (default: the
    generator's)."""
    if device is None and generator is not None:
        device = generator.device
    w = fill_random(generator, (m, size_sub), dtype, device)
    return torch.cat([w, w], dim=0)
