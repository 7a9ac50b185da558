"""Indefinite LOBPCG (Kressner-Pandur-Shao) on a BdG-style pencil (port
of ``examples/bdg_indefinite.py``).

A = diag(K, K), B = antidiag(I, I): the pencil's spectrum is +-(k*pi)^2
and eigenpairs carry a +-1 signature.  ilobpcg returns the eigenvalues
closest to the positive spectral edge (positives ascending), with the
B-positive initialization X0 = [u; u] steering toward the + branch.
m 400, f64, as the script (the K1 stencil kernel takes f32/bf16 only, as
the Pallas stencil does, so this f64 solve runs the plain stencil).

Run: python -m lobpcg_tpu_torch.examples.bdg_indefinite
"""

import numpy as np
import torch

from lobpcg_tpu_torch import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    Laplacian1D,
    SolverConfig,
    ilobpcg,
)
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run


def main(device=None) -> dict:
    dev = resolve_device(device)
    m = 400  # half-dimension; the pencil is 2m x 2m
    h = 1.0 / (m + 1)
    f64 = torch.float64
    K = Laplacian1D(scale=1.0 / (h * h), n=m, dtype=f64)
    A = BlockDiagOperator(inner=K, copies=2)
    B = BlockAntiDiagOperator(d=torch.ones((m,), dtype=f64, device=dev))
    u = np.random.RandomState(42).uniform(-0.5, 0.5, size=(m, 6))
    X0 = torch.from_numpy(np.concatenate([u, u], axis=0)).to(dev)
    cfg = SolverConfig(nev=3, size_sub=6, tol=1e-6, max_iter=300,
                       record_history=True)
    r = ilobpcg(A, X0, B, config=cfg,
                generator=torch.Generator(device=dev).manual_seed(0))
    it = r.iterations
    trace = r.history.residual_norms[:it:max(1, it // 6), 0]
    return {"eigenvalues": r.eigenvalues.cpu().tolist(),
            "analytic": ((np.arange(1, 4) * np.pi) ** 2).tolist(),
            "signatures": r.signature.cpu().tolist(),
            "converged": r.converged, "iterations": it,
            "residual_trace_pair0": trace.cpu().tolist()}


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0])
