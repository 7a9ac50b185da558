"""Where the device time of one BdG well solve goes.

    python -m lobpcg_tpu_torch.tools.profile_well --n 1000000 --nev 150 \
        --size-sub 164 [--cheb 3]

Builds the pencil of ``benchmarks/solve_bdg.py`` (f32, Chebyshev
preconditioner, the JAX script's column chunk), solves it once to warm
up (kernel build, library handles), once untraced and once under
torch.profiler in one process, and prints one JSON line:
iterations and wall-clock of both solves, device seconds and launches by
kernel category (in all and an iteration), the device busy time, the
idle share against the untraced wall, and the kernels with the most
device time.  Runs on the
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from lobpcg_tpu_torch.benchmarks.solve_bdg import well_problem
from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg
from lobpcg_tpu_torch.tools.convergence_trace import device_breakdown


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nev", type=int, default=150)
    ap.add_argument("--size-sub", type=int, default=164)
    ap.add_argument("--cheb", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--top", type=int, default=12)
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
           "device_name": torch.cuda.get_device_name(dev),
           "iterations": r.iterations, "converged": r.converged,
           "rr_failed": r.rr_fail_count, "wall_s": wall}
    del r
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
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda t: -t[0])
    rec["top_kernels"] = [
        {"name": e.key[:120], "device_s": us / 1e6, "count": e.count}
        for us, e in kernels[: a.top]]
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
