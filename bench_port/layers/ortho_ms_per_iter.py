"""Orthogonalization (lobpcg.ortho spans: ops/ortho.py, ops/svqb.py):
device ms an iteration of the work the host launched inside an
orthogonalization but outside its operator applies: its Grams, SVQB
(the k x k eigh among it), projections and masks.
The program's own spans (bench_port/spans.py); no KERNELS."""

import pathlib

from bench_port import spans
from bench_port.trace import ms_per_iteration

ROOT = pathlib.Path(__file__).resolve().parents[2]


def read(obs):
    found = spans.read(ROOT, obs)
    return None if found is None else ms_per_iteration(
        obs, found.phase_s["ortho"])
