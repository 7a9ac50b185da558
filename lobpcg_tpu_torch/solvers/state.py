"""Solver result containers (port of ``lobpcg_tpu/solvers/state.py``):
NamedTuples of tensors; counts are Python ints."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SolveHistory(NamedTuple):
    """Per-iteration trace (recorded when SolverConfig.record_history).

    Rows >= `iterations` are zero.  ``flags``: for lobpcg the RR path
    flag (0 Cholesky ok, 1 ortho path, 2 ortho retry fired); for ilobpcg
    the quality flag (1 good / 5 dual-basis) + 8 if the projected pencil
    solve failed + 16 if the stall reset fired.
    """

    eigenvalues: torch.Tensor  # [max_iter, m] real
    residual_norms: torch.Tensor  # [max_iter, nev] real
    converged: torch.Tensor  # [max_iter] i32
    flags: torch.Tensor  # [max_iter] i32


class LOBPCGResult(NamedTuple):
    """Eigenvectors in the first nev columns of the X basis, eigenvalues,
    residual norms, converged count, iterations."""

    eigenvalues: torch.Tensor  # [nev] real
    eigenvectors: torch.Tensor  # [n, nev]
    residual_norms: torch.Tensor  # [nev] real
    converged: int  # number of converged eigenpairs (prefix)
    iterations: int
    basis: Optional[torch.Tensor] = None  # full [n, size_sub] X block
    momentum: Optional[torch.Tensor] = None  # P block (warm restart P0)
    history: Optional[SolveHistory] = None
    ortho_retries: Optional[int] = None  # Cholesky-path RR retries
    live_cols: Optional[int] = None  # sum over iterations of live W + P columns at the RR


class ILOBPCGResult(NamedTuple):
    eigenvalues: torch.Tensor  # [nev] real
    eigenvectors: torch.Tensor  # [n, nev]
    residual_norms: torch.Tensor  # [nev] real
    signature: torch.Tensor  # [nev] i32 (+1/-1 per eigenpair)
    converged: int
    iterations: int
    basis: Optional[torch.Tensor] = None  # full [n, size_sub] X block
    momentum: Optional[torch.Tensor] = None  # P block (warm-restart extra)
    history: Optional[SolveHistory] = None
    quality5_count: Optional[int] = None  # dual-basis iterations
    rr_fail_count: Optional[int] = None  # failed projected pencil solves
