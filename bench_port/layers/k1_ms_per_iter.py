"""Operator applies (operators/linop.py, operators/chebyshev.py,
ops/cuda/stencil.py): device ms an iteration of K1 and its fused forms
(stencil_diag, cheb_step), one kernel template in csrc/stencil1d.cu."""

import pathlib

from bench_port.trace import claimed_per_iteration

KERNELS = ("stencil1d_kernel",)


def read(obs):
    return claimed_per_iteration(obs, pathlib.Path(__file__).stem)
