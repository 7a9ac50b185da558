"""Operator applies (operators/stencil_nd.py, ops/cuda/stencil3d.py):
device ms an iteration of K2, the 7-point 3-D stencil of
csrc/stencil3d.cu, over the traced (capped) solve's iterations."""

import pathlib

from bench_port.trace import claimed_per_iteration

KERNELS = ("stencil3d_kernel",)


def read(obs):
    return claimed_per_iteration(obs, pathlib.Path(__file__).stem)
