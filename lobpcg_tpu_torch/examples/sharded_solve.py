"""Row-sharded solve over a row mesh (port of
``examples/sharded_solve.py``).

The operator rows and the tall [n, k] blocks are 1-D partitioned over
the ranks; Gram contractions are local GEMMs plus one all-reduce, the
stencil is local compute plus a halo exchange (``parallel``).  The
solver code is unchanged.  On the CPU this runs on ``ranks`` gloo
processes (8 by default, as the script's virtual mesh); on the card on
a world-size-1 NCCL group.

Quantum-well Hamiltonian: lattice Laplacian plus a barrier outside a
256-site window, n 4096, f64.  Low modes are bound states with O(1)
separations, so the solve converges in tens of iterations; the oracle is
a dense eigh of a truncation around the well.

Run: python -m lobpcg_tpu_torch.examples.sharded_solve [--device cpu --ranks 8]
"""

import numpy as np
import torch

from lobpcg_tpu_torch import DiagonalOperator, Laplacian1D, lobpcg
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run
from lobpcg_tpu_torch.parallel import row_mesh, shard_problem, spawn

N, W = 4096, 256


def _potential() -> tuple[np.ndarray, int]:
    lo = (N - W) // 2
    V = np.ones(N)
    V[lo : lo + W] = 0.0
    return V, lo


def solve_on(mesh) -> dict:
    """One rank's part of the solve on ``mesh``."""
    dev = mesh.device
    V, _ = _potential()
    f64 = torch.float64
    A = Laplacian1D(scale=1.0, n=N, dtype=f64) + DiagonalOperator(
        torch.from_numpy(1.0 + V).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    X0 = torch.rand((N, 6), generator=gen, dtype=f64, device=dev) - 0.5
    As, X0s, _, _ = shard_problem(mesh, A, X0)
    with mesh:
        r = lobpcg(As, X0s, nev=3, size_sub=6, tol=1e-9, max_iter=500,
                   generator=gen)
    return {"eigenvalues": r.eigenvalues.cpu().tolist(),
            "converged": r.converged, "iterations": r.iterations,
            "ranks": mesh.size,
            "eigenvector_rows": list(r.eigenvectors.shape)}


def main(device=None, ranks: int = 0) -> dict:
    """``ranks``: gloo processes on the CPU (0: 8); the card runs one."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        out = solve_on(row_mesh(1, device=dev))
    else:
        results = spawn(solve_on, ranks or 8, device="cpu", timeout_s=600.0)
        out = results[0]
        out["same_on_every_rank"] = all(
            r["eigenvalues"] == out["eigenvalues"] for r in results)
    V, lo = _potential()
    t0, t1 = max(0, lo - 512), min(N, lo + W + 512)
    Ht = (np.diag(2.0 + 1.0 + V[t0:t1]) - np.diag(np.ones(t1 - t0 - 1), 1)
          - np.diag(np.ones(t1 - t0 - 1), -1))
    out["dense_oracle"] = np.linalg.eigvalsh(Ht)[:3].tolist()
    return out


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0], ranks=0)
