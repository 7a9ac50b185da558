"""Update and residual (lobpcg.update spans: solvers/ilobpcg.py,
solvers/lobpcg.py, ops/residual.py, ops/masking.py): device ms an
iteration of the work the host launched inside the projection, residual
and convergence block but outside its operator applies: b_mm, the
residual, its norms, the compaction.
The program's own spans (bench_port/spans.py); no KERNELS."""

import pathlib

from bench_port import spans
from bench_port.trace import ms_per_iteration

ROOT = pathlib.Path(__file__).resolve().parents[2]


def read(obs):
    found = spans.read(ROOT, obs)
    return None if found is None else ms_per_iteration(
        obs, found.phase_s["update"])
