"""k x k dense (ops/pencil.py, ops/rayleigh.py, ops/svqb.py, ops/linalg.py):
device ms an iteration of the projected pencil's float64 work: cuSOLVER's
kernels (eigh's sytrd, stedc and ormtr, QR, Cholesky), the float64 GEMMs
inside and around them, and PyTorch's float64 kernels.  The solve's tall
blocks are float32, so float64 marks the k x k layer."""

import pathlib

from bench_port.trace import claimed_per_iteration

KERNELS = ("syevj", "syevd", "sytrd", "stedc", "steqr", "sterf", "ormtr", "orgtr",
           "geqrf", "orgqr", "ormqr", "potrf", "trsm", "cusolver", "jacobi",
           "_info_ker", "_f64f64_", "d884gemm", "dgemm", "<double")


def read(obs):
    return claimed_per_iteration(obs, pathlib.Path(__file__).stem)
