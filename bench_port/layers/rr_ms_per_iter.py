"""Rayleigh-Ritz (lobpcg.rr spans: ops/indefinite.py, ops/rayleigh.py,
ops/pencil.py): device ms an iteration of the work the host launched
inside a Rayleigh-Ritz but outside its operator applies and its
coefficient-space orthogonalization: the tall Grams and the projected
k x k solve.
The program's own spans (bench_port/spans.py); no KERNELS."""

import pathlib

from bench_port import spans
from bench_port.trace import ms_per_iteration

ROOT = pathlib.Path(__file__).resolve().parents[2]


def read(obs):
    found = spans.read(ROOT, obs)
    return None if found is None else ms_per_iteration(
        obs, found.phase_s["rr"])
