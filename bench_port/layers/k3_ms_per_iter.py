"""Operator applies (operators/sparse.py, ops/cuda/bsr.py): device ms an
iteration of K3, the block-ELL SpMM of csrc/bsr.cu (ell_tile_kernel,
every BSROperator apply at the cells' widths), over the traced (capped)
solve's iterations: A and B both, where B is a BSROperator."""

import pathlib

from bench_port.trace import claimed_per_iteration

KERNELS = ("ell_tile_kernel",)


def read(obs):
    return claimed_per_iteration(obs, pathlib.Path(__file__).stem)
