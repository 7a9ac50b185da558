"""Matrix-free operators (port of ``examples/fft_matrix_free.py``): a
complex Hermitian circulant applied through the FFT, with a
Fourier-space preconditioner and mixed-precision Rayleigh-Ritz.

A = F^H diag(s) F is never formed: ``CallableOperator`` wraps the block
function (the analog of the reference's opaque ``linop_ctx_t``).
complex64 storage with rr_dtype "float64", which
``SolverConfig.resolved_rr_dtype`` turns into complex128 for the
projected solves.

Run: python -m lobpcg_tpu_torch.examples.fft_matrix_free
"""

import torch

from lobpcg_tpu_torch import CallableOperator, SolverConfig, lobpcg
from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.examples import run

DTYPE = torch.complex64


def apply_A(X, s):
    return torch.fft.ifft(s[:, None] * torch.fft.fft(X, dim=0), dim=0).to(DTYPE)


def apply_T(X, s):  # (A + I)^-1, also circulant
    return torch.fft.ifft(torch.fft.fft(X, dim=0) / (s[:, None] + 1.0),
                          dim=0).to(DTYPE)


def main(device=None) -> dict:
    dev = resolve_device(device)
    n, nev = 2048, 8
    s = 0.5 + torch.arange(n, dtype=torch.float32, device=dev)  # the spectrum
    A = CallableOperator(args=(s,), fn=apply_A, n=n, _dtype=DTYPE)
    T = CallableOperator(args=(s,), fn=apply_T, n=n, _dtype=DTYPE)
    cfg = SolverConfig(nev=nev, size_sub=12, tol=1e-5, max_iter=200,
                       rr_dtype="float64")
    r = lobpcg(A, T=T, config=cfg, device=dev,
               generator=torch.Generator(device=dev).manual_seed(0))
    return {"eigenvalues": r.eigenvalues[:nev].cpu().tolist(),
            "exact": s[:nev].cpu().tolist(),
            "eigenvalue_dtype": str(r.eigenvalues.dtype).replace("torch.", ""),
            "rr_dtype": str(cfg.resolved_rr_dtype(DTYPE)).replace("torch.", ""),
            "converged": r.converged, "iterations": r.iterations}


if __name__ == "__main__":
    run(main, __doc__.split("\n\n")[0])
