"""Device: the part of device_idle_share spent in gaps that opened while
the host waited on the device inside a lobpcg.sync.* span,
device_idle_share x (sync-bound idle / all idle inside lobpcg.solve) on
the trace's clock (bench_port/spans.py).  The rest of device_idle_share
is launch-bound: the host was in Python or launching."""

import pathlib

from bench_port import spans
from bench_port.spec import load_module

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[2]


def read(obs):
    found = spans.read(ROOT, obs)
    share = load_module(HERE.with_name("device_idle_share.py")).read(obs)
    if found is None or share is None or found.idle_s <= 0:
        return None
    return share * found.sync_idle_s / found.idle_s
