"""Profiling / timing helpers (port of ``lobpcg_tpu/utils/profiling.py``).

``trace`` is ``torch.profiler`` over the CPU and, where there is a card,
its CUDA kernels, exported as a Chrome trace; ``timed`` times whole calls
with the card synchronised around the timed window.

``span(name)`` marks a phase of a solve.  Run a solve under
``torch.profiler`` (or ``trace``) to see them: each span is a
``record_function`` range, on the host thread and clock of the
operations it holds, so each kernel can be traced to the span open when
the host launched it.  With no profiler recording, ``span`` returns one
shared no-op context (no range, no allocation, no clock read); the
program keeps no buffer or flag of its own.  The names are fixed:

    lobpcg.solve                one solve, from entry to result
    lobpcg.iter                 one (lockstep) iteration of the host loop
    lobpcg.apply.{A,B,T}        one operator apply (the filter in apply.T)
    lobpcg.ortho                orthogonalization, its Grams and SVQB
    lobpcg.rr                   Rayleigh-Ritz: the Grams and the k x k solve
    lobpcg.update               projection, residual, convergence, stall
    lobpcg.sync.{read,eigh,copy}  one point where the host waits on the
                                device: a read, eigh's check, a copy
"""

from __future__ import annotations

import contextlib
import functools
import pathlib
import time

import torch

SOLVE = "lobpcg.solve"
ITER = "lobpcg.iter"
APPLY = {"A": "lobpcg.apply.A", "B": "lobpcg.apply.B", "T": "lobpcg.apply.T"}
ORTHO = "lobpcg.ortho"
RR = "lobpcg.rr"
UPDATE = "lobpcg.update"
SYNC_READ = "lobpcg.sync.read"
SYNC_EIGH = "lobpcg.sync.eigh"
SYNC_COPY = "lobpcg.sync.copy"

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared no-op context."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: run the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
