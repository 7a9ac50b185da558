"""Where the device time of one BdG well solve goes.

    python -m lobpcg_tpu_torch.tools.profile_well --n 1000000 --nev 150 \
        --size-sub 164 [--cheb 3] [--sites 30]

Builds the pencil of ``benchmarks/solve_bdg.py`` (f32, Chebyshev
preconditioner, the JAX script's column chunk), solves it once to warm
up (kernel build, library handles), once untraced and once under
torch.profiler in one process, and prints one JSON line:
iterations and wall-clock of both solves, device seconds and launches by
kernel category (in all and an iteration), the device busy time, the
idle share against the untraced wall, and the kernels with the most
device time.  ``--sites N`` wraps the package's functions in profiler
ranges (``annotate_package``) and adds the N call sites with the most
device time in PyTorch's own elementwise, reduction, ``cat``, index and
copy kernels: each launch goes to the
innermost functions of ``lobpcg_tpu_torch`` around the operation that
launched it (that function and its two callers), with its ms and
launches an iteration by operation, and the same summed by innermost
function.  Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import pathlib
import sys
import time

import torch

from lobpcg_tpu_torch.benchmarks.solve_bdg import well_problem
from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg
from lobpcg_tpu_torch.tools.stencil_widths import card_line
from lobpcg_tpu_torch.tools.convergence_trace import (
    ELEMENTWISE,
    category,
    device_breakdown,
)

PACKAGE = "lobpcg_tpu_torch/"


def annotate_package() -> int:
    """Wrap every function and method defined in the package's modules
    (``tools`` and the kernel wrappers of ``ops/cuda`` excepted) in a
    ``torch.profiler.record_function`` range named after it,
    ``lobpcg_tpu_torch/ops/masking.py(41): mask_cols``, in this process;
    returns how many.  A trace then says which functions enclose each
    operation, whatever Python tracing the installed profiler offers.
    The module attributes that name a wrapped function (its own module's
    and those that imported it) are all replaced."""
    root = pathlib.Path(__file__).resolve().parents[1]

    def ours(fn) -> bool:
        return inspect.isfunction(fn) and pathlib.Path(
            fn.__code__.co_filename).resolve().is_relative_to(root)

    def label(fn):
        rel = pathlib.Path(fn.__code__.co_filename).resolve().relative_to(root)
        return f"{PACKAGE}{rel.as_posix()}({fn.__code__.co_firstlineno}): " \
               f"{fn.__qualname__}"

    def wrap(fn):
        name = label(fn)

        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return ranged

    mods = [m for n, m in sorted(sys.modules.items())
            if n.startswith("lobpcg_tpu_torch.") and m is not None
            and not n.startswith(("lobpcg_tpu_torch.tools",
                                  "lobpcg_tpu_torch.ops.cuda"))]
    wrapped = {}
    for mod in mods:
        for val in list(vars(mod).values()):
            if ours(val) and val.__module__ == mod.__name__ \
                    and not hasattr(val, "launches"):
                wrapped.setdefault(val, wrap(val))
            elif inspect.isclass(val) and val.__module__ == mod.__name__:
                for key, meth in list(vars(val).items()):
                    if ours(meth) and not key.startswith("__"):
                        setattr(val, key, wrap(meth))
    for mod in mods:
        for key, val in list(vars(mod).items()):
            if inspect.isfunction(val) and val in wrapped:
                setattr(mod, key, wrapped[val])
    return len(wrapped)


def _frame(name: str) -> str:
    """A frame inside the package, as ``ops/masking.py(41): mask_cols``."""
    return name[name.rindex(PACKAGE) + len(PACKAGE):]


def _in_package(name: str) -> bool:
    return PACKAGE in name and PACKAGE + "tools/" not in name


def _enclosing_frames(events) -> dict:
    """For each operation that launched kernels (by ``id()``), the
    package's function ranges (``annotate_package``) that enclose it in
    time, innermost first: nested in time around the operations each
    function runs.  Time is used, not the profiler's parent links, which
    are not set across threads on every version."""
    py = sorted((e for e in events if _in_package(e.name) and "): " in e.name),
                key=lambda e: e.time_range.start)
    ops = sorted((e for e in events if getattr(e, "kernels", None)),
                 key=lambda e: e.time_range.start)
    out, open_, i = {}, [], 0
    for op in ops:
        t0, t1 = op.time_range.start, op.time_range.end
        while i < len(py) and py[i].time_range.start <= t0:
            while open_ and open_[-1].time_range.end <= py[i].time_range.start:
                open_.pop()
            open_.append(py[i])
            i += 1
        while open_ and open_[-1].time_range.end < t0:
            open_.pop()
        out[id(op)] = [_frame(e.name) for e in reversed(open_)
                       if e.time_range.end >= t1]
    return out


def call_sites(prof, iterations: int, top: int, depth: int = 3) -> dict:
    """Device ms and launches an iteration of PyTorch's own kernels
    (ELEMENTWISE) by call site: the ``depth`` innermost package functions
    (``annotate_package``'s ranges) around the operation that launched
    each, with the split by operation, and the same summed by innermost
    function."""
    events = prof.events()
    enclosing = _enclosing_frames(events)
    sites = {}
    for evt in events:
        kernels = [k for k in getattr(evt, "kernels", ())
                   if category(k.name) == ELEMENTWISE]
        if not kernels:
            continue
        frames = enclosing.get(id(evt), [])
        site = " <- ".join(frames[:depth]) or "(outside the package)"
        rec = sites.setdefault(site, {"us": 0.0, "launches": 0, "ops": {}})
        op = rec["ops"].setdefault(evt.name, [0.0, 0])
        for k in kernels:
            rec["us"] += k.duration
            rec["launches"] += 1
            op[0] += k.duration
            op[1] += 1
    ranked = sorted(sites.items(), key=lambda kv: -kv[1]["us"])
    functions = {}
    for site, r in sites.items():
        f = functions.setdefault(site.split(" <- ")[0], [0.0, 0])
        f[0] += r["us"]
        f[1] += r["launches"]
    return {
        "by_function": {name: [us / 1e3 / iterations, cnt / iterations]
                        for name, (us, cnt) in sorted(
                            functions.items(), key=lambda kv: -kv[1][0])[:top]},
        "function_ranges": sum(1 for e in events if _in_package(e.name)
                               and "): " in e.name),
        "sites": [{"site": site, "ms_per_iteration": r["us"] / 1e3 / iterations,
                   "launches_per_iteration": r["launches"] / iterations,
                   "ops": {name: [us / 1e3 / iterations, cnt / iterations]
                           for name, (us, cnt) in sorted(
                               r["ops"].items(), key=lambda kv: -kv[1][0])}}
                  for site, r in ranked[:top]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nev", type=int, default=150)
    ap.add_argument("--size-sub", type=int, default=164)
    ap.add_argument("--cheb", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--sites", type=int, default=0)
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    A, B, T, X0, _, _ = well_problem(a.n, a.nev, a.size_sub, dtype=torch.float32,
                                     cheb=a.cheb, precond=True, device=dev)
    cfg = SolverConfig(nev=a.nev, size_sub=a.size_sub, tol=a.tol, max_iter=300)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ilobpcg(A, X0, B, T, config=cfg,
                    generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    solve()
    r, wall = solve()
    rec = {"n": a.n, "nev": a.nev, "size_sub": a.size_sub, "cheb": a.cheb,
           "device_name": torch.cuda.get_device_name(dev), "card": card_line(),
           "iterations": r.iterations, "converged": r.converged,
           "rr_failed": r.rr_fail_count, "wall_s": wall}
    del r
    if a.sites:  # after the untraced solve, whose wall sets the idle share
        annotate_package()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        r, traced_wall = solve()
    rec["traced_iterations"] = r.iterations
    rec.update(device_breakdown(prof, wall, traced_wall))
    rec["per_iteration"] = {
        cat: {"device_ms": 1e3 * sec / r.iterations,
              "launches": rec["launches_by_category"][cat] / r.iterations}
        for cat, sec in rec["device_s_by_category"].items()}
    kernels = sorted(
        ((getattr(e, "device_time_total", None) or e.cuda_time_total, e)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and "): " not in e.key),  # not annotate_package's ranges
        key=lambda t: -t[0])
    rec["top_kernels"] = [
        {"name": e.key[:120], "device_s": us / 1e6, "count": e.count}
        for us, e in kernels[: a.top]]
    if a.sites:
        rec["elementwise_by_call_site"] = call_sites(prof, r.iterations,
                                                     a.sites)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
