"""Tall contractions (ops/gram.py, ops/ortho.py): device ms an iteration
of cuBLAS's float32 GEMMs (the tall SGEMMs of the Grams and the basis
updates, their split-K reductions, and the few small float32 products).
The float64 GEMMs of the k x k work are cusolver_ms_per_iter's."""

import pathlib

from bench_port.trace import claimed_per_iteration

KERNELS = ("_f32f32_", "sgemm", "splitKreduce_kernel<32, 16, int, float")


def read(obs):
    return claimed_per_iteration(obs, pathlib.Path(__file__).stem)
