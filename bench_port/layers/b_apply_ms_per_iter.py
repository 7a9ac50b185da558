"""Operator applies, B's share (lobpcg.apply.B spans: ops/gram.py's
apply_block_op and apply_block_op_pair, ops/residual.py, the solvers' B
applies): device ms an iteration of the work the host launched inside a
``lobpcg.apply.B`` span, over the traced solve's iterations.  Every B
apply of the generalized path runs in one: the norm estimate, the start
basis, the B-orthogonalization, the B-Grams and the residual's B X.

``apply_ms_per_iter`` holds this time with A's and T's, since
``bench_port/spans.py`` attributes by phase; here each device operation
goes to the innermost program span open at its launch, read by its full
name, so B's applies are told from A's.  None without a trace, for a
trace with no ``lobpcg.solve``, or for a solve with no B apply."""

import json
import pathlib
import time

from bench_port import spans
from bench_port.trace import DEVICE_CATS, ms_per_iteration, reduce

ROOT = pathlib.Path(__file__).resolve().parents[2]
B_SPAN = "lobpcg.apply.B"


def b_seconds(chrome: dict):
    """Device seconds launched inside ``lobpcg.apply.B`` (innermost) within
    ``lobpcg.solve``, or None when the trace holds no solve or no such
    span."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    solves = [e for e in events if e.get("name") == spans.SOLVE
              and e.get("cat") in spans.SPAN_CATS]
    if not solves:
        return None
    tid = solves[0].get("tid")

    def interval(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))

    host = [e for e in events if e.get("tid") == tid]
    solve_iv = sorted(interval(e) for e in solves if e.get("tid") == tid)
    named = sorted(((*interval(e), e["name"]) for e in host
                    if e.get("cat") in spans.SPAN_CATS
                    and spans._phase(str(e.get("name", "")))),
                   key=lambda s: (s[0], -s[1]))
    if not any(name == B_SPAN for _, _, name in named):
        return None
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in host
                 if e.get("cat") in spans.LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    launched = sorted(
        (launch_at[c], s, e) for s, e, c in (
            (*interval(d), d.get("args", {}).get("correlation"))
            for d in events if d.get("cat") in DEVICE_CATS)
        if c in launch_at
        and any(a <= launch_at[c] < b for a, b in solve_iv))
    owners = spans._innermost(named, [t for t, _, _ in launched])
    return sum((e - s) / 1e6 for (_, s, e), owner in zip(launched, owners)
               if owner == B_SPAN)


def _chrome(obs):
    """The Chrome trace this process wrote (as ``spans.read`` finds it),
    or None: no trace, or not the one ``obs.trace`` reduced."""
    from bench_port.run import process_age

    started = time.time() - process_age()
    try:
        found = [(p.stat().st_mtime, p)
                 for p in (ROOT / spans.TRACES).glob("*.json")]
    except OSError:
        return None
    found = [(t, p) for t, p in found if t >= started]
    if not found:
        return None
    try:
        chrome = json.loads(max(found)[1].read_text())
    except (OSError, ValueError):
        return None
    return chrome if reduce(chrome, 0.0).busy_s == obs.trace.busy_s else None


def read(obs):
    if obs.trace is None or not obs.traced_iterations:
        return None
    chrome = _chrome(obs)
    return None if chrome is None else ms_per_iteration(obs, b_seconds(chrome))
