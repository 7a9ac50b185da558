"""Profiling / timing helpers (port of ``lobpcg_tpu/utils/profiling.py``).

``trace`` is ``torch.profiler`` over the CPU and, where there is a card,
its CUDA kernels, exported as a Chrome trace; ``timed`` times whole calls
with the card synchronised around the timed window.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler.profile`` around a block; yields the profiler
    (``key_averages()`` for sums by kernel) and writes
    ``<logdir>/trace.json`` for chrome://tracing or Perfetto on exit."""
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(logdir / "trace.json"))


def timed(fn, *args, warmup: int = 1, reps: int = 3):
    """Run ``fn(*args)`` ``warmup`` times (kernel builds, library
    handles, allocator), then time ``reps`` calls, with the card
    synchronised before and after the timed window.  Returns
    (last_output, seconds_per_call)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(max(reps, 1)):
        out = fn(*args)
    _sync()
    return out, (time.perf_counter() - t0) / max(reps, 1)
