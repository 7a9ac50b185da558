"""Benchmark of lobpcg_tpu_torch on NVIDIA cards: one run of one cell of
BENCHMARK.json.

    python3 bench_port/run.py --workload bdg_well_4M.nev56 --seed 7 \
        --seconds 30 --trace 0

Set-up (process start to the window: imports, kernels from the cache in
``lobpcg_tpu_torch/_build/``, the problem on the device, one warm-up at
the cell's own shapes), then the timed window of the cell's mix (its
driver, ``bench_port/drivers/<kind>.py``), then with ``--trace 1`` one
traced request after the window, then the comparison with the plain
reference that decides ``correct``.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error).  Without a CUDA card, with fewer cards than the cell asks for, or
with JAX loaded once the window has closed, it exits non-zero and prints
no result.  ``BENCH_RUN`` in the environment is not read.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port import roofline, spec  # noqa: E402
from bench_port.trace import Observation, claim  # noqa: E402

# Top-level module names that must not be loaded in the process that
# prints a result: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "lobpcg_tpu")
TRACES = "bench_port/.traces"


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv=None, *, root=ROOT, device=None, patch=None) -> int:
    """One run; returns the exit code.  ``device`` (tests only) skips the
    look for a card and runs there; ``patch(run)`` (tests and the
    control) may replace parts of the timed path before set-up."""
    args = parse(argv)
    root = pathlib.Path(root)
    cell = spec.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # every configuration
    torch.backends.cudnn.allow_tf32 = False  # states float32 without TF32

    obs = Observation()
    r = cell.driver().Run(cell, args.seed, device, obs)
    if patch is not None:
        patch(r)
    before_setup = process_age()
    r.setup()
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    print(f"set-up: {before_setup:.2f} s before the mix's own (interpreter, "
          f"imports), {setup_s - before_setup:.2f} s in it (CUDA context, "
          f"problem, warm-up)", file=sys.stderr)

    values = r.window(args.seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    values["peak_gib"] = window_peak / 2**30
    values["setup_s"] = setup_s

    device_rec = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda
                  else device.type,
                  "count": cell.chips,
                  "memory_peak_bytes": max(setup_peak, window_peak)
                  if cuda else 0}
    breakdown = None
    notes = {}
    if args.trace:
        trace_path = root / TRACES / f"{cell.name}.json"
        notes = r.traced(trace_path) or {}
        layers = {m["name"]: cell.layer(m["name"]) for m in cell.all_per_layer}
        if obs.trace is not None:
            partition = [(name, mod.KERNELS) for name, mod in layers.items()
                         if hasattr(mod, "KERNELS")]
            obs.claimed_s, obs.unclaimed_s = claim(obs.trace, partition)
            device_rec["busy_s"] = obs.trace.busy_s
            device_rec["window_s"] = obs.trace.window_s
            breakdown = {"device_ops": obs.trace.device_ops(),
                         "idle_gaps": obs.trace.idle_gaps}
        metrics = {}
        for m in cell.per_layer:
            v = layers[m["name"]].read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    r.release()
    obs.trace = None
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = r.check()

    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3

    correct = all(limit is not None and v == v and v <= limit
                  for _, v, limit in checks)
    result = {"correct": correct, "attempted": r.attempted, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if cuda:
        result["power_limit"] = roofline.power_limit(device.index or 0)
    if notes:
        result["notes"] = notes
    result["checks"] = {name: {"value": _number(v), "limit": limit}
                        for name, v, limit in checks}
    for name, v, limit in checks:
        print(f"check {name} {v!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
