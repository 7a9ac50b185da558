"""Complex Hermitian pencils through the split-real embedding (the
counterpart of ``examples/complex_on_tpu.py``).

The realification layer embeds a complex Hermitian pencil A z = lambda
B z into a real symmetric pencil of twice the dimension with a doubled
spectrum, solves it in f32 real arithmetic (the K1 stencil kernel on the
card), and folds the duplicated pairs back into complex eigenpairs on
the host.  As the script keeps the complex data on the host, the complex
operators are built on the CPU and only the realified problem moves to
the card.  (Torch has complex dtypes on the card too: this path is the
API's parity and cross-check.)

Run: python -m lobpcg_tpu_torch.examples.complex_on_gpu
"""

import dataclasses

import numpy as np
import torch

from lobpcg_tpu_torch import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    Laplacian1D,
    SolverConfig,
    derealify,
    ilobpcg,
    realify_problem,
)
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run


def moved(op, device):
    """A copy of an operator tree with every tensor on ``device``."""
    if isinstance(op, torch.Tensor):
        return op.to(device)
    if dataclasses.is_dataclass(op):
        return dataclasses.replace(op, **{
            f.name: moved(getattr(op, f.name), device)
            for f in dataclasses.fields(op)})
    return op


def main(device=None) -> dict:
    dev = resolve_device(device)
    m, nev, ss = 256, 3, 6
    cpu, c128 = torch.device("cpu"), torch.complex128
    h = 1.0 / (m + 1)
    K = Laplacian1D(scale=1.0 / (h * h), n=m, dtype=c128)
    A = BlockDiagOperator(inner=K, copies=2)
    B = BlockAntiDiagOperator(d=torch.ones((m,), dtype=c128, device=cpu))
    u = np.random.RandomState(42).uniform(-0.5, 0.5, size=(m, ss))
    X0 = torch.from_numpy(np.concatenate([u, u], axis=0)).to(c128)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=400)
    # Embed into the real pencil, downcast to f32 for the card.
    Ar, X0r, Br, _, cfgr = realify_problem(A, X0, B, config=cfg,
                                           rdt=torch.float32)
    r = ilobpcg(moved(Ar, dev), X0r.to(dev), moved(Br, dev), config=cfgr,
                generator=torch.Generator(device=dev).manual_seed(0))
    lam, vec, _ = derealify(r, nev)
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
            "eigenvalues": lam.tolist(),
            "analytic": ((np.arange(1, nev + 1) * np.pi) ** 2).tolist(),
            "eigenvector_dtype": str(vec.dtype),
            "eigenvector_shape": list(vec.shape),
            "converged": r.converged, "iterations": r.iterations}


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0])
