"""Device time from a ``torch.profiler`` trace, and what the per-layer
readers read.

``profile(fn, path)`` runs ``fn`` once under the profiler (CPU and CUDA
activities), writes the Chrome trace to ``path`` (inside the checkout,
``bench_port/.traces/``, git-ignored; one file a cell, overwritten) and
reduces it to a ``Trace``: device seconds and launches by kernel name,
the busy time (the union of every kernel, copy and set on the device),
and the idle gaps between device work, each named by the host operation
running when it opened.  The categories by kernel name and the idle
share against an untraced wall are those of the port's
``tools/convergence_trace.py`` (``CATEGORIES``, ``device_breakdown``),
frozen here and split over ``bench_port/layers/``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # kernel names are C++ templates; keep their head
TOP = 10


@dataclasses.dataclass
class Trace:
    kernels: dict  # name -> [device seconds, launches]
    busy_s: float  # union of device activity
    window_s: float  # host wall of the traced call
    idle_gaps: list  # [[host operation, seconds], ...], longest first

    def device_ops(self, top: int = TOP) -> list:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return [[name[:NAME_CHARS], sec] for name, (sec, _) in ops]


@dataclasses.dataclass
class Observation:
    """What one run gives its per-layer readers.  Fields a run could not
    fill stay None, and a reader that finds nothing returns None."""

    iterations: list | None = None  # the window's solves, the program's count
    trace: Trace | None = None
    traced_iterations: int | None = None  # iterations of the traced solve
    untraced_wall_s: float | None = None  # the same start, untraced
    launch_bytes: int | None = None  # least bytes of one operator launch
    peak_bytes_per_s: float | None = None
    claimed_s: dict | None = None  # per_layer metric -> its kernels' seconds
    unclaimed_s: float | None = None  # kernels no metric claims


def profile(fn, path: pathlib.Path, device) -> tuple:
    """(fn(), Trace) of one call of ``fn`` under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    del prof
    return out, reduce(json.loads(path.read_text()), wall)


def _union(intervals):
    """Merged [start, end] intervals of a list sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_names(host, gaps):
    """The innermost host event (main thread) open at each gap's start;
    host: (ts, end, name) sorted by ts then longest first, nested."""
    names, stack, j = [], [], 0
    for start, _ in gaps:
        while j < len(host) and host[j][0] <= start:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= start:
            stack.pop()
        names.append(" > ".join(h[2] for h in stack[-2:]) if stack
                     else "(no host operation)")
    return names


def reduce(chrome: dict, wall: float) -> Trace:
    """A Trace of one Chrome trace from torch.profiler (times in us)."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events if e.get("cat") in DEVICE_CATS))
    kernels: dict = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    merged = _union([[s, e] for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    host_ev = [e for e in events if e.get("cat") in HOST_CATS]
    tids = {}
    for e in host_ev:
        if e.get("cat") == "cpu_op":
            tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    main = max(tids, key=tids.get) if tids else None
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in host_ev if e.get("tid") == main),
                  key=lambda h: (h[0], -h[1]))
    by_name: dict = {}
    for (s, e), name in zip(gaps, _host_names(host, gaps)):
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    idle = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])
    return Trace(kernels=kernels, busy_s=busy, window_s=wall,
                 idle_gaps=idle[:TOP])


def claim(trace: Trace, partition: list) -> tuple:
    """({metric: seconds}, unclaimed seconds): each kernel goes to the
    first (metric, name patterns) of ``partition`` with a pattern in its
    name, in BENCHMARK.json's order; what none claims is unclaimed.  A
    metric that claims no kernel, and an empty rest, are left out (None)."""
    claimed, rest = {}, None
    for name, (sec, _) in trace.kernels.items():
        owner = next((m for m, pats in partition
                      if any(p in name for p in pats)), None)
        if owner is None:
            rest = (rest or 0.0) + sec
        else:
            claimed[owner] = claimed.get(owner, 0.0) + sec
    return claimed, rest


def ms_per_iteration(obs: Observation, seconds):
    """Seconds of the traced solve as ms an iteration (None without a
    traced solve)."""
    if seconds is None or obs.trace is None or not obs.traced_iterations:
        return None
    return seconds * 1e3 / obs.traced_iterations



def claimed_per_iteration(obs: Observation, metric: str):
    """The seconds of the kernels that ``metric`` claims, as ms an
    iteration of the traced solve."""
    return ms_per_iteration(obs, (obs.claimed_s or {}).get(metric))
