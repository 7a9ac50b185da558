"""GPU smoke run of lobpcg_tpu_torch: its main path, once, on one card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and the exit code is
non-zero):

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — builds the stencil kernel (csrc/stencil1d.cu) with nvcc.
3. kernel   — the kernel against its plain PyTorch version on the card
              at the main path's shapes; error, ms and GB/s of both.
4. quickstart — README: lobpcg on Laplacian1D, n 256, f32.
5. main     — ilobpcg on the BdG quantum-well pencil at n 4,000,000,
              nev 56, size_sub 64, Chebyshev degree 3, f32, checked
              against the dense well oracle; the stencil launch counter
              must show the solve went through the kernel.

The second-to-last lines are the kernels summary and the card's
`nvidia-smi` name and power limit; the last line is the ok record.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

import lobpcg_tpu_torch as lt
from lobpcg_tpu_torch.ops.cuda import stencil as k1

N_MAIN = 4_000_000
NEV, SIZE_SUB = 56, 64
WELL, BARRIER, SHIFT = 1024, 1.0, 1.0  # benchmarks/solve_bdg.py's well
CHEB_DEGREE = 3
TOL, MAX_ITER = 1e-5, 300
ORACLE_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def kernel_phase(dev) -> list[dict]:
    """K1 against its plain version at the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [
        # (n, k, dtype, segments, edge_rows?)
        (N_MAIN, 64, torch.float32, 2, False),
        (N_MAIN, 64, torch.float32, 2, True),
        (N_MAIN, 256, torch.float32, 2, False),
        (N_MAIN, 256, torch.float32, 2, True),
        (N_MAIN, 64, torch.bfloat16, 2, False),
        (N_MAIN, 78, torch.float32, 2, True),
    ]
    scale = 1.0
    out = []
    for n, k, dt, seg, with_edges in cases:
        X = (torch.rand((n, k), generator=gen, device=dev) - 0.5).to(dt)
        E = (
            (torch.rand((2, k), generator=gen, device=dev) - 0.5).to(dt)
            if with_edges else None
        )
        Y = k1.stencil_matmat(X, scale, E, num_segments=seg)
        Yp = k1.stencil_matmat_reference(X, scale, E, num_segments=seg)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(Y.float() - Yp.float())))
        # 2 ulp of the storage dtype x |scale| x max|X|.
        tol = 2 * torch.finfo(dt).eps * abs(scale) * float(
            torch.max(torch.abs(X.float()))
        )
        if not err <= tol:
            raise AssertionError(
                f"stencil kernel disagrees at n={n} k={k} {dt}: "
                f"max_abs_err {err} > {tol}"
            )
        del Y, Yp
        ms = time_ms(lambda: k1.stencil_matmat(X, scale, E, num_segments=seg))
        plain_ms = time_ms(
            lambda: k1.stencil_matmat_reference(X, scale, E, num_segments=seg)
        )
        nbytes = 2 * n * k * X.element_size()
        rec = {
            "phase": "kernel", "name": "stencil1d", "n": n, "k": k,
            "dtype": str(dt).replace("torch.", ""), "segments": seg,
            "edge_rows": with_edges, "max_abs_err": err, "tol": tol,
            "ms": ms, "gbps": nbytes / ms / 1e6,
            "plain_ms": plain_ms, "plain_gbps": nbytes / plain_ms / 1e6,
        }
        emit(rec)
        out.append(rec)
        del X, E
        torch.cuda.empty_cache()
    return out


def quickstart_phase(dev) -> None:
    """README quick start: the standard solver on the 1-D Laplacian."""
    n = 256
    h = 1.0 / (n + 1)
    A = lt.Laplacian1D(scale=1.0 / (h * h), n=n, dtype=torch.float32)
    r = lt.lobpcg(A, nev=3, size_sub=6, tol=1e-6, max_iter=300,
                  generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    lam = r.eigenvalues.double().cpu().numpy()
    exact = (np.arange(1, 4) * np.pi) ** 2
    rel = np.abs(lam - exact) / exact
    emit({"phase": "quickstart", "eigenvalues": lam.tolist(),
          "max_rel_err_vs_continuum": float(rel.max()),
          "converged": r.converged, "iterations": r.iterations})
    if not (np.all(np.isfinite(lam)) and rel.max() < 0.03):
        raise AssertionError(f"quick start eigenvalues off: {lam}")


def well_eigs_oracle(w: int, nev: int, barrier: float, margin: int = 2048):
    """Low eigenvalues of the truncated well Hamiltonian (dense, host);
    the formula of benchmarks/solve_bdg.py."""
    size = w + 2 * margin
    V = np.full(size, barrier + SHIFT)
    V[margin : margin + w] = SHIFT
    H = (
        np.diag(2.0 + V)
        - np.diag(np.ones(size - 1), 1)
        - np.diag(np.ones(size - 1), -1)
    )
    return np.linalg.eigvalsh(H)[:nev]


def main_phase(dev) -> dict:
    """ilobpcg on the BdG well pencil at the flagship shape."""
    n, m, ss, dt = N_MAIN, N_MAIN // 2, SIZE_SUB, torch.float32
    lo = (m - WELL) // 2
    V = np.full(m, BARRIER + SHIFT, np.float64)
    V[lo : lo + WELL] = SHIFT
    Vd = torch.as_tensor(np.concatenate([V, V]), dtype=dt, device=dev)
    A = lt.Laplacian1D(scale=1.0, n=n, segments=2, dtype=dt) \
        + lt.DiagonalOperator(Vd)
    B = lt.BlockAntiDiagOperator(d=torch.ones((m,), dtype=dt, device=dev))
    T = lt.ChebyshevFilter(op=A, lo=2.0, hi=4.0 + BARRIER + SHIFT + 0.1,
                           degree=CHEB_DEGREE, chunk=0)
    rng = np.random.RandomState(42)
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + WELL] = rng.uniform(-0.5, 0.5, size=(WELL, ss))
    X0 = torch.as_tensor(np.concatenate([u, u], axis=0), device=dev)
    cfg = lt.SolverConfig(nev=NEV, size_sub=ss, tol=TOL, max_iter=MAX_ITER,
                          gram_precision="highest", use_ax_cache=True,
                          use_b_cache=True, dual_basis=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.stencil_matmat.launches = 0
    t0 = time.perf_counter()
    r = lt.ilobpcg(A, X0, B, T, config=cfg, generator=gen)
    lam = r.eigenvalues.double().cpu().numpy()
    wall = time.perf_counter() - t0
    launches = k1.stencil_matmat.launches

    exact = well_eigs_oracle(WELL, NEV, BARRIER)
    rel = np.abs(lam - exact) / np.abs(exact)
    rec = {
        "phase": "main", "n": n, "nev": NEV, "size_sub": ss,
        "dtype": "float32", "cheb_degree": CHEB_DEGREE, "tol": TOL,
        "converged": r.converged, "iterations": r.iterations,
        "quality5": r.quality5_count, "rr_failed": r.rr_fail_count,
        "wall_s": wall, "stencil_launches": launches,
        "max_rel_err": float(rel.max()),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(rec)
    if not np.all(np.isfinite(lam)) or tuple(lam.shape) != (NEV,):
        raise AssertionError("main path returned non-finite eigenvalues")
    if r.converged != NEV:
        raise AssertionError(f"converged {r.converged}/{NEV}")
    if not rel.max() <= ORACLE_RTOL:
        raise AssertionError(f"max rel err {rel.max()} > {ORACLE_RTOL}")
    if launches < 2 * r.iterations:
        raise AssertionError(
            f"stencil kernel launched {launches} times in "
            f"{r.iterations} iterations"
        )
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "card": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    rec = k1.build()
    emit({"phase": "build", "kernel": "stencil1d", "nvcc_ran": rec["built"],
          "nvcc_s": rec["seconds"], "total_s": time.perf_counter() - t0,
          "ptxas": [ln for ln in rec["log"].splitlines() if "ptxas" in ln][:12]})

    kernel_recs = kernel_phase(dev)
    quickstart_phase(dev)
    main_rec = main_phase(dev)

    at_main = kernel_recs[0]  # [4M, 64] f32, 2 segments: the solve's shape
    emit({"kernels": [{
        "name": "stencil1d",
        "route": "cuda",
        "source": "lobpcg_tpu_torch/csrc/stencil1d.cu",
        "replaces": "lobpcg_tpu/ops/pallas/stencil.py:75",
        "launches": main_rec["stencil_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_recs),
        "ms": at_main["ms"],
        "plain_ms": at_main["plain_ms"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
