"""Convergence trace of the standard solver on the 3-D Dirichlet
Laplacian: which iteration each eigenpair converged at, and the last
pair's residual over the iterations.

    python -m lobpcg_tpu_torch.tools.convergence_trace --grid 160 160 160 \
        [--operator nd|bsr] [--dtype float32|float64] [--rr-dtype float64] \
        [--max-iter 2500] [--profile]

Runs on the CUDA card, with chip_smoke.py's laplacian3d settings: nev 10,
size_sub 16, tol 1e-5, X0 uniform(-0.5, 0.5) from RandomState(0).  Prints
one JSON line.  ``--profile`` then solves the same problem again under
torch.profiler and adds the device time by kernel category, the device
busy time, and the idle share against the untraced solve's wall-clock
(tracing ~700k launches slows the host, so the traced wall overstates
the idle share; both walls are printed).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

import lobpcg_tpu_torch as lt

NEV, SIZE_SUB, TOL = 10, 16, 1e-5


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, nargs=3, default=(160, 160, 160))
    ap.add_argument("--operator", choices=("nd", "bsr"), default="nd")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--rr-dtype", default=None)
    ap.add_argument("--max-iter", type=int, default=2500)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    grid = tuple(args.grid)
    n = math.prod(grid)
    h = 1.0 / (max(grid) + 1)
    scale = 1.0 / (h * h)
    if args.operator == "nd":
        A = lt.LaplacianND(scale=scale, grid=grid, dtype=dt)
    else:
        A = lt.BSROperator.from_csr(*lt.laplacian_3d_csr(*grid), block_size=8,
                                    dtype=dt, device=dev)
    X0 = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.5, 0.5, (n, SIZE_SUB))).to(dev, dt)
    cfg = lt.SolverConfig(nev=NEV, size_sub=SIZE_SUB, tol=TOL,
                          max_iter=args.max_iter, rr_dtype=args.rr_dtype,
                          record_history=True)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = lt.lobpcg(A, X0, config=cfg,
                      generator=torch.Generator(device=dev).manual_seed(0))
        lam = r.eigenvalues.double().cpu().numpy()
        return r, lam, time.perf_counter() - t0

    r, lam, wall = solve()
    it = r.iterations
    conv = r.history.converged[:it].cpu().numpy()
    res_last = r.history.residual_norms[:it, NEV - 1].double().cpu().numpy()
    exact = lt.laplacian_nd_eigs(grid, scale, NEV)
    lam_max = 4 * scale * sum(math.sin(g * math.pi / (2 * (g + 1))) ** 2
                              for g in grid)
    rec = {
        "grid": list(grid), "operator": args.operator, "dtype": args.dtype,
        "rr_dtype": args.rr_dtype, "nev": NEV, "size_sub": SIZE_SUB,
        "tol": TOL, "device_name": torch.cuda.get_device_name(dev),
        "iterations": it, "converged": r.converged, "wall_s": wall,
        "first_iteration_with_c_converged": {
            c: int(np.argmax(conv >= c)) for c in range(1, NEV + 1)
            if (conv >= c).any()},
        "last_pair_residual_every_100": res_last[::100].tolist(),
        "max_err_over_lam_max": float(np.abs(lam - exact).max() / lam_max),
    }
    if args.profile:
        del r
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            r, _, traced_wall = solve()
        rec.update(traced_iterations=r.iterations,
                   **device_breakdown(prof, wall, traced_wall))
    print(json.dumps(rec), flush=True)


# Kernel-name substrings of each category of device time.
CATEGORIES = (
    ("K2 stencil3d", ("stencil3d_kernel",)),
    ("K3 bsr_ell", ("bsr_ell_kernel",)),
    # K1 and its fused forms (stencil_diag, cheb_step): one kernel template.
    ("K1 family (stencil1d_kernel)", ("stencil1d_kernel",)),
    # The solver's tall tail (csrc/tail.cu).
    ("tail (antidiag, residual, combine, compact)",
     ("tail_antidiag_kernel", "tail_residual_kernel", "tail_combine_kernel",
      "tail_compact_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "gemv", "cutlass", "sm90_xmma", "Kernel2")),
    ("eigh / QR (cuSOLVER)", ("syevj", "syevd", "sytrd", "stedc", "steqr",
                              "sterf", "ormtr", "orgtr", "geqrf", "orgqr",
                              "ormqr", "potrf", "trsm", "cusolver", "jacobi")),
    ("memcpy / memset", ("Memcpy", "Memset")),
)


ELEMENTWISE = "elementwise / reductions / other"


def category(kernel_name: str) -> str:
    """The category of CATEGORIES a kernel name falls in (ELEMENTWISE:
    PyTorch's own elementwise, reduction, cat, index and copy kernels)."""
    return next((c for c, keys in CATEGORIES
                 if any(k in kernel_name for k in keys)), ELEMENTWISE)


def device_breakdown(prof, wall: float, traced_wall: float) -> dict:
    """Device seconds by category (CUDA events of the trace), device busy
    seconds, and the idle share of the untraced and the traced wall."""
    sums, counts = {}, {}
    for evt in prof.key_averages():
        # The solver's spans (utils/profiling.py) also appear on the
        # device timeline, spanning the kernels they hold.
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False) or evt.key.startswith(
                    "lobpcg."):
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        cat = category(evt.key)
        sums[cat] = sums.get(cat, 0.0) + us / 1e6
        counts[cat] = counts.get(cat, 0) + evt.count
    busy = sum(sums.values())
    return {"device_s_by_category": sums, "launches_by_category": counts,
            "device_busy_s": busy, "traced_wall_s": traced_wall,
            "idle_share": 1.0 - busy / wall,
            "traced_idle_share": 1.0 - busy / traced_wall}


if __name__ == "__main__":
    main()
