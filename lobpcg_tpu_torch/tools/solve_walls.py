"""Walls of the BdG well solves whose operator chain runs through K1's
fused forms, on the card: the flagship 4M x 56 (the chip smoke's main
phase: Chebyshev 3, column chunk 0), the 1M x 150 solve and the 8 x 1M
lockstep sweep (X0 [8, 1M, 30], per-problem diagonals and bounds).

    python -m lobpcg_tpu_torch.tools.solve_walls            # this tree
    python -m lobpcg_tpu_torch.tools.solve_walls --ab DIR   # DIR, this, this, DIR

Each solve runs once to warm up (kernel build, library handles) and once
timed, host clock around a synchronised solve; its record holds the
wall, iterations, the launches of K1 and its fused forms and of the
tail kernels (``csrc/tail.cu``), the peak device memory and the
eigenvalues (f32 values as floats, so that two trees' runs can be
compared bit for bit).  ``--ab DIR`` runs the solves
in four processes, each importing ``lobpcg_tpu_torch`` from its tree
(DIR, a checkout of another commit, e.g. from ``git archive``; this
tree; this tree; DIR), and prints one line a solve with the four runs.
Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

from lobpcg_tpu_torch.benchmarks import solve_bdg
from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.operators.linop import DiagonalOperator
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg

try:
    from lobpcg_tpu_torch.ops.cuda import tail
except ImportError:  # a tree before the tail kernels
    tail = None

BARRIERS = (1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0)  # chip_smoke's sweep
# K1 and its fused forms (a tree before the fused forms has K1 alone).
WRAPPERS = ("stencil_matmat", "stencil_diag", "cheb_step")


def _problem(name: str, dev):
    """(A, B, T, X0, config) of one solve of SOLVES."""
    if name == "flagship":
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            4_000_000, 56, 64, dtype=torch.float32, cheb=3, precond=True,
            device=dev, cheb_chunk=0)
        return A, B, T, X0, SolverConfig(
            nev=56, size_sub=64, tol=1e-5, max_iter=300, use_ax_cache=True,
            use_b_cache=True, dual_basis=True)
    if name == "sub1M_150":
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            1_000_000, 150, 164, dtype=torch.float32, cheb=3, precond=True,
            device=dev)
        return A, B, T, X0, SolverConfig(nev=150, size_sub=164, tol=1e-5,
                                         max_iter=300)
    assert name == "lockstep_8x1M", name
    diags, his = [], []
    for barrier in BARRIERS:
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            1_000_000, 16, 30, dtype=torch.float32, cheb=3, precond=True,
            device=dev, barrier=barrier)
        diags.append(A.right.d)
        his.append(T.hi)
    A = A.left + DiagonalOperator(torch.stack(diags))
    T = dataclasses.replace(T, op=A, hi=torch.tensor(his, dtype=torch.float64,
                                                     device=dev))
    X0 = X0.expand(len(BARRIERS), *X0.shape).contiguous()
    return A, B, T, X0, SolverConfig(nev=16, size_sub=30, tol=1e-5,
                                     max_iter=300)


# The tail kernels (csrc/tail.cu; none in a tree before them).
TAIL = ("antidiag", "residual", "combine", "compact")


def _launches() -> dict:
    return {w: getattr(k1, w).launches for w in WRAPPERS if hasattr(k1, w)}


def _tail_launches() -> dict:
    return {} if tail is None else {w: getattr(tail, w).launches for w in TAIL}


def run(name: str, dev) -> dict:
    A, B, T, X0, cfg = _problem(name, dev)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ilobpcg(A, X0, B, T, config=cfg,
                    generator=torch.Generator(device=dev).manual_seed(0))
        lam = r.eigenvalues.cpu()
        return r, lam, time.perf_counter() - t0

    solve()
    torch.cuda.reset_peak_memory_stats()
    before, tail_before = _launches(), _tail_launches()
    r, lam, wall = solve()
    after, tail_after = _launches(), _tail_launches()
    return {"solve": name, "wall_s": wall,
            "iterations": torch.as_tensor(r.iterations).tolist(),
            "launches": {w: after[w] - before[w] for w in after},
            "k1_family": sum(after[w] - before[w] for w in after),
            "tail_launches": {w: tail_after[w] - tail_before[w]
                              for w in tail_after},
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "eigenvalues": lam.double().tolist()}


SOLVES = ("flagship", "sub1M_150", "lockstep_8x1M")


def _ab(other: str) -> None:
    this = str(pathlib.Path(__file__).resolve().parents[2])
    other = str(pathlib.Path(other).resolve())
    trees = [("other", other), ("this", this), ("this", this), ("other", other)]
    runs = []
    for label, tree in trees:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, __file__], env=env, cwd=tree,
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({tree}) failed:\n{proc.stderr[-4000:]}")
        recs = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        runs.append((label, {rec["solve"]: rec for rec in recs}))
    for name in SOLVES:
        recs = [(label, by[name]) for label, by in runs]
        first = recs[0][1]["eigenvalues"]
        print(json.dumps({
            "phase": "ab", "solve": name,
            "wall_s": [[label, r["wall_s"]] for label, r in recs],
            "iterations": [[label, r["iterations"]] for label, r in recs],
            "k1_family": [[label, r["k1_family"]] for label, r in recs],
            "launches": [[label, r["launches"]] for label, r in recs],
            "tail_launches": [[label, r["tail_launches"]] for label, r in recs],
            "max_memory_allocated_gib": [[label, r["max_memory_allocated_gib"]]
                                         for label, r in recs],
            "equal_eigenvalues": all(r["eigenvalues"] == first
                                     for _, r in recs)}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", metavar="DIR",
                        help="another tree: its solves and this one's in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("solve_walls: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ab:
        _ab(args.ab)
    else:
        dev = torch.device("cuda", 0)
        for name in SOLVES:
            print(json.dumps({"phase": "solve", **run(name, dev)}), flush=True)
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)


if __name__ == "__main__":
    main()
