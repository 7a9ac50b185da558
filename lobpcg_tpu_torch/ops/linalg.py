"""k x k Hermitian eigensolve with the JAX package's failure contract.

The JAX package relies on ``jnp.linalg.eigh`` returning NaN for a
non-finite input, and its rr-fail and ladder logic reads ``isfinite`` on
the result.  ``torch.linalg.eigh`` raises instead (on the CPU, LAPACK
reports non-convergence; on CUDA a non-finite input can fail the same
way).  ``eigh`` here checks ``torch.isfinite`` on the input first, runs
the solver on the identity where it is not finite, and poisons the
outputs with NaN there — the same values the JAX package computes with,
with no host synchronisation and no exception hidden.

Single-precision inputs are solved in double precision and the results
rounded back.  On CUDA, torch solves a float32 matrix of order 32 to 512
with cuSOLVER's Jacobi ``syevj``, whose results left every eigenvalue of
the 4M x 56 BdG well solve about 2e-5 (relative) off the dense oracle on
an H100, with 13 rr-fail recoveries in 62 iterations; with the eigensolve
in float64 the same solve converged in 31 iterations with no rr-fail and
a 1.3e-6 error.  The matrices are at most 3 * size_sub wide, so the
widening costs nothing measurable next to the tall contractions.

On CUDA torch reads cuSOLVER's status back to the host after the solve,
so each call waits on the device: a ``lobpcg.sync.eigh`` span.
"""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.utils.profiling import SYNC_EIGH, span

_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def eigh(M: torch.Tensor):
    """(w ascending, V) of Hermitian M (batched over leading dims);
    NaN outputs where M holds a non-finite entry.  M is symmetrized
    first, as ``jnp.linalg.eigh`` does (torch reads one triangle)."""
    finite = torch.isfinite(M).flatten(-2).all(-1)  # [...] bool
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Msafe = torch.where(finite[..., None, None], 0.5 * (M + M.mH), eye)
    rdt = M.dtype.to_real() if M.is_complex() else M.dtype
    Mw = Msafe.to(_WIDER.get(M.dtype, M.dtype))
    with span(SYNC_EIGH):
        w, V = torch.linalg.eigh(Mw)
    w = torch.where(finite[..., None], w.to(rdt), float("nan"))
    V = torch.where(finite[..., None, None], V.to(M.dtype), float("nan"))
    return w, V
