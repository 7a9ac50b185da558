"""Smallest example (port of ``examples/laplacian_1d.py``): the 3 lowest
eigenpairs of the 1-D Dirichlet Laplacian, n 256, f32, against the
continuum eigenvalues (k pi)^2.

Note on f32 and the operator scale: the convergence test is backward
error relative to ||A|| ~ 4/h^2, so at large n a loose tol accepts
eigenvalues far from the spectrum's bottom.  In f32 keep n moderate and
tol tight (or use SolverConfig(rr_dtype="float64"), as fft_matrix_free
does).

Run: python -m lobpcg_tpu_torch.examples.laplacian_1d
"""

import numpy as np
import torch

from lobpcg_tpu_torch import Laplacian1D, lobpcg
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run


def main(device=None) -> dict:
    dev = resolve_device(device)
    n = 256
    h = 1.0 / (n + 1)
    A = Laplacian1D(scale=1.0 / (h * h), n=n, dtype=torch.float32)
    r = lobpcg(A, nev=3, size_sub=6, tol=1e-6, max_iter=300,
               generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    return {"eigenvalues": r.eigenvalues.double().cpu().tolist(),
            "analytic": ((np.arange(1, 4) * np.pi) ** 2).tolist(),
            "iterations": r.iterations, "converged": r.converged}


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0])
