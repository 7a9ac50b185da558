"""Sparse operator path (port of ``examples/sparse_3d_laplacian.py``):
the 3-D Laplacian at 10^3 as CSR -> block-ELL (BSR), f64, the 5 lowest
eigenvalues against the discrete spectrum.

Host preprocessing (COO -> CSR -> BSR blocking) runs through the native
C++ library when built (``make -C native``), with NumPy/SciPy fallbacks.
The K3 block-ELL kernel takes f32 only, as the Pallas BSR path does
(``lobpcg_tpu/ops/pallas/bsr.py:622``), so this f64 solve runs the plain
gather + einsum on the card.

Run: python -m lobpcg_tpu_torch.examples.sparse_3d_laplacian
"""

import numpy as np
import torch

from lobpcg_tpu_torch import BSROperator, laplacian_3d_csr, lobpcg
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run
from lobpcg_tpu_torch.utils.native import native_available


def main(device=None) -> dict:
    dev = resolve_device(device)
    nx = 10
    indptr, indices, vals = laplacian_3d_csr(nx, nx, nx)
    A = BSROperator.from_csr(indptr, indices, vals, block_size=8,
                             dtype=torch.float64, device=dev)
    r = lobpcg(A, nev=5, size_sub=10, tol=1e-6, max_iter=300,
               generator=torch.Generator(device=dev).manual_seed(1),
               device=dev)
    h = 1.0 / (nx + 1)
    oned = 4.0 / (h * h) * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    exact = np.sort((oned[:, None, None] + oned[None, :, None]
                     + oned[None, None, :]).ravel())[:5]
    return {"native_library": native_available(),
            "eigenvalues": r.eigenvalues.cpu().tolist(),
            "exact": exact.tolist(), "converged": r.converged,
            "iterations": r.iterations}


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0])
