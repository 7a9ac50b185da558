"""Tall tail, what is left of it: device ms an iteration of every kernel
that no per-layer metric of BENCHMARK.json claims by name (PyTorch's
elementwise, reduction, cat, index and copy kernels, memcpy and memset).
A new kernel lands here until a metric of its own claims it."""

from bench_port.trace import ms_per_iteration


def read(obs):
    return ms_per_iteration(obs, obs.unclaimed_s)
