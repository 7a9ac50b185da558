"""Host loop (ops/lanes.py, ops/linalg.py, ops/pencil.py): the points
an iteration where the host waits on the device, the lobpcg.sync.* spans
inside lobpcg.solve over the traced solve's iterations (the program's
own spans, bench_port/spans.py)."""

import pathlib

from bench_port import spans

ROOT = pathlib.Path(__file__).resolve().parents[2]


def read(obs):
    found = spans.read(ROOT, obs)
    if found is None or not obs.traced_iterations:
        return None
    return found.syncs / obs.traced_iterations
