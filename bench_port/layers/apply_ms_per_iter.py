"""Operator applies (lobpcg.apply.A, .B and .T spans: operators/linop.py,
operators/chebyshev.py, ops/cuda/stencil.py): device ms an iteration of
the work the host launched inside an operator apply, the Chebyshev filter
and every B apply of the orthogonalization among it.
The program's own spans (bench_port/spans.py); no KERNELS."""

import pathlib

from bench_port import spans
from bench_port.trace import ms_per_iteration

ROOT = pathlib.Path(__file__).resolve().parents[2]


def read(obs):
    found = spans.read(ROOT, obs)
    return None if found is None else ms_per_iteration(
        obs, found.phase_s["apply"])
