"""Tall tail (ops/cuda/tail.py, ops/residual.py, ops/masking.py): device
ms an iteration of the four tail kernels of csrc/tail.cu."""

import pathlib

from bench_port.trace import claimed_per_iteration

KERNELS = ("tail_antidiag_kernel", "tail_residual_kernel", "tail_combine_kernel",
           "tail_compact_kernel")


def read(obs):
    return claimed_per_iteration(obs, pathlib.Path(__file__).stem)
