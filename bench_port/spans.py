"""The program's own spans in the Chrome trace of a ``--trace 1`` run.

``lobpcg_tpu_torch`` marks the phases of a solve with ``record_function``
ranges while a profiler records (``lobpcg_tpu_torch/utils/profiling.py``):
``lobpcg.solve``, ``lobpcg.iter``, ``lobpcg.apply.{A,B,T}``,
``lobpcg.ortho``, ``lobpcg.rr``, ``lobpcg.update``, and
``lobpcg.sync.{read,eigh,copy}`` around each point where the host waits
on the device.  They lie on the host thread and clock of the operations
they hold, so:

- each device operation (kernel, copy, set) goes to the host runtime or
  driver call with the same ``correlation``, and that call to the
  innermost phase span (``apply``, ``ortho``, ``rr``, ``update``) open on
  its thread when it was made; launched inside ``lobpcg.solve`` but
  outside every phase, it is "unphased";
- each idle gap inside ``lobpcg.solve`` (between merged device
  intervals, as ``trace.reduce`` computes them) is sync-bound when the
  host was inside a ``lobpcg.sync.*`` span as the gap opened, otherwise
  launch-bound.

The profiler's device times are not on the host's clock to better than
milliseconds (torch 2.11 on an H100: in some profiles most device
operations appear to start 8 to 290 ms before the call that launched
them, by an amount that moves within one profile), so no device time
is compared with a host time.  A gap is placed on the host's clock by
the operation that ends it: an idle device starts what it is given at
once, so the gap of d seconds ended when the host launched that
operation, and opened d seconds before (to within the launch latency,
microseconds).  Attribution to phases reads host times alone.

``python3 -m bench_port.spans <trace.json>`` prints what one trace says
(device seconds by phase and by operation, the idle split by phase).
``read(root, obs)`` finds the trace this process wrote under
``<root>/bench_port/.traces/`` (the newest file written after the
process started), checks that it is the trace ``obs.trace`` reduced (the
same busy time), and parses it once.  Without a trace, or with a trace
of a program that has no spans, it returns None and raises nothing.  The
readers of these spans declare no ``KERNELS``: the split of kernels by
name is left as it is.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
import sys
import time

from bench_port.trace import DEVICE_CATS, reduce

PREFIX = "lobpcg."
SOLVE = "lobpcg.solve"
SYNC = "lobpcg.sync."
PHASES = {"apply": "lobpcg.apply.", "ortho": "lobpcg.ortho",
          "rr": "lobpcg.rr", "update": "lobpcg.update"}
UNPHASED = "unphased"
SPAN_CATS = ("user_annotation", "cpu_op")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRACES = "bench_port/.traces"


@dataclasses.dataclass
class Spans:
    """What the spans of the traced solves say, in seconds."""

    phase_s: dict  # apply / ortho / rr / update / unphased -> device s
    syncs: int  # lobpcg.sync.* spans inside lobpcg.solve
    idle_s: float  # idle inside lobpcg.solve
    sync_idle_s: float  # of which the host was in a lobpcg.sync.* span
    kernels: dict  # phase -> {device operation name: s}
    idle_by_phase: dict  # phase -> [sync-bound s, launch-bound s]


def _phase(name: str):
    return next((p for p, pre in PHASES.items() if name.startswith(pre)),
                None)


def _innermost(spans, times) -> list:
    """The innermost of ``spans`` ((start, end, label) sorted by start,
    then longest first, nested) open at each of ``times`` (ascending);
    None where none is."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _opener(spans):
    """A test of whether one of ``spans`` ((start, end) sorted by start)
    is open at a time t."""
    starts, reach, far = [], [], float("-inf")
    for s, e in spans:
        far = max(far, e)
        starts.append(s)
        reach.append(far)

    def open_at(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and reach[i] > t
    return open_at


def attribute(chrome: dict):
    """The Spans of one Chrome trace from torch.profiler, or None when
    it holds no ``lobpcg.solve`` span."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    solves = [e for e in events if e.get("name") == SOLVE
              and e.get("cat") in SPAN_CATS]
    if not solves:
        return None
    tid = solves[0].get("tid")

    def interval(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))

    host = [e for e in events if e.get("tid") == tid]
    solve_iv = sorted(interval(e) for e in solves if e.get("tid") == tid)

    def in_solve(t):
        return any(s <= t < e for s, e in solve_iv)

    ours = [e for e in host if e.get("cat") in SPAN_CATS
            and str(e.get("name", "")).startswith(PREFIX)]
    phases = sorted(((*interval(e), _phase(e["name"])) for e in ours
                     if _phase(e["name"])), key=lambda s: (s[0], -s[1]))
    syncs = sorted(interval(e) for e in ours if e["name"].startswith(SYNC))
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in host
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}

    dev = sorted(((*interval(e), e["name"],
                   e.get("args", {}).get("correlation"))
                  for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda d: d[0])
    launched = sorted(((launch_at[c], s, e, name) for s, e, name, c in dev
                       if c in launch_at and in_solve(launch_at[c])),
                      key=lambda d: d[0])
    owners = _innermost(phases, [t for t, _, _, _ in launched])
    phase_s = {p: 0.0 for p in (*PHASES, UNPHASED)}
    kernels = {p: {} for p in phase_s}
    for (_, s, e, name), owner in zip(launched, owners):
        owner = owner or UNPHASED
        phase_s[owner] += (e - s) / 1e6
        kernels[owner][name] = kernels[owner].get(name, 0.0) + (e - s) / 1e6

    # Busy runs (as trace.reduce merges them), each with the launch call
    # of the operation that opened it; a gap ends at that call.
    runs = []
    for s, e, _, c in dev:
        if runs and s <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], e)
        else:
            runs.append([s, e, launch_at.get(c)])
    gaps = []
    for (_, g0, _), (g1, _, end) in zip(runs, runs[1:]):
        if end is None:  # no launch call to place the gap by
            continue
        for s, e in solve_iv:
            lo, hi = max(end - (g1 - g0), s), min(end, e)
            if g1 > g0 and hi > lo:
                gaps.append((lo, hi))
    gaps.sort()
    at_gap = _innermost(phases, [lo for lo, _ in gaps])
    in_sync = _opener(syncs)
    idle = sync_idle = 0.0
    idle_by_phase = {p: [0.0, 0.0] for p in phase_s}
    for (lo, hi), owner in zip(gaps, at_gap):
        sec = (hi - lo) / 1e6
        bound = in_sync(lo)
        idle += sec
        sync_idle += sec if bound else 0.0
        idle_by_phase[owner or UNPHASED][0 if bound else 1] += sec
    return Spans(phase_s=phase_s,
                 syncs=sum(1 for s, _ in syncs if in_solve(s)),
                 idle_s=idle, sync_idle_s=sync_idle, kernels=kernels,
                 idle_by_phase=idle_by_phase)


_CACHE: dict = {}


def read(root, obs):
    """The Spans of the trace this process wrote under ``root`` (the
    root its caller was loaded from), or None: no trace, not the trace
    of ``obs.trace`` (another busy time), or no spans in it."""
    if obs.trace is None:
        return None
    from bench_port.run import process_age

    folder = pathlib.Path(root) / TRACES
    started = time.time() - process_age()
    try:
        found = [(p.stat().st_mtime, p) for p in folder.glob("*.json")]
    except OSError:
        return None
    found = [(t, p) for t, p in found if t >= started]
    if not found:
        return None
    path = max(found)[1]
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        try:
            chrome = json.loads(path.read_text())
        except (OSError, ValueError):
            return None
        _CACHE.clear()
        _CACHE[key] = (reduce(chrome, 0.0).busy_s, attribute(chrome))
        del chrome
    busy, spans = _CACHE[key]
    return spans if busy == obs.trace.busy_s else None


if __name__ == "__main__":
    found = attribute(json.loads(pathlib.Path(sys.argv[1]).read_text()))
    print(json.dumps(None if found is None else dataclasses.asdict(found)))
