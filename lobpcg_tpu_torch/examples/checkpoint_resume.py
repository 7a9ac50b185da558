"""Checkpointed long solve: run in chunks, snapshot, crash, resume (port
of ``examples/checkpoint_resume.py``).

LOBPCG warm-restarts from the X basis alone, so the checkpoint payload
is the [n, size_sub] block (atomic npz snapshots, the JAX package's
format).  The 1-D Laplacian at n 400 in f64; the snapshot goes to a
temporary directory, removed afterwards.

Run: python -m lobpcg_tpu_torch.examples.checkpoint_resume
"""

import pathlib
import tempfile

import numpy as np
import torch

from lobpcg_tpu_torch import (
    Laplacian1D,
    SolverConfig,
    load_checkpoint,
    lobpcg,
    solve_checkpointed,
)
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run


def main(device=None) -> dict:
    dev = resolve_device(device)
    n = 400
    h = 1.0 / (n + 1)
    A = Laplacian1D(scale=1.0 / (h * h), n=n, dtype=torch.float64)
    gen = torch.Generator(device=dev).manual_seed(3)
    X0 = torch.rand((n, 6), generator=gen, dtype=torch.float64,
                    device=dev) - 0.5
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "solve.npz"
        # "Crash" after 2 chunks of 5 iterations.
        cfg_short = SolverConfig(nev=3, size_sub=6, tol=1e-8, max_iter=10)
        solve_checkpointed(lobpcg, A, X0, config=cfg_short, path=path,
                           every=5)
        crashed_at = int(load_checkpoint(path)["iterations"])
        # A fresh run resumes from the snapshot and finishes.
        cfg = SolverConfig(nev=3, size_sub=6, tol=1e-8, max_iter=2000)
        r = solve_checkpointed(lobpcg, A, None, config=cfg, path=path,
                               every=100, device=dev)
    return {"snapshot_iterations": crashed_at, "converged": r.converged,
            "iterations": r.iterations,
            "eigenvalues": r.eigenvalues.cpu().tolist(),
            "analytic": ((np.arange(1, 4) * np.pi) ** 2).tolist()}


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0])
