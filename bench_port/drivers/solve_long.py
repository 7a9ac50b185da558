"""The ``solve_long`` mix: the ``solve`` mix's window for solves of
thousands of iterations, with the warm-up and the traced request capped
in iterations.

The window, its whole passes over a pool of starts and the comparison
are ``drivers/solve.py``'s (its ``Run``, subclassed):

    solve_s   the window's whole time over the solves it completed

A whole solve of such a mix would make a trace of gigabytes and a
warm-up as long as the window, so both are cut to the first
``trace_iterations`` iterations (the solver's ``it_cap``):

- set-up builds the operator the mix names and runs one capped solve
  from draws outside the pool;
- the traced request solves the window's first start, capped, once
  untraced (its wall is what ``device_idle_share`` divides by) and once
  under the profiler, so every ``_per_iter`` reader divides the same
  work by the capped count.

The traced slice is the head of a solve, before most pairs lock, where
most of a whole solve is the soft-locked tail.  The program's count of
live search columns (``LOBPCGResult.live_cols``, read by
``search_live_share``) speaks for the whole window's solves; a program
without that count leaves the metric out.
"""

from __future__ import annotations

import pathlib
import sys
import time

from bench_port import seeds
from bench_port.spec import load_module

solve = load_module(pathlib.Path(__file__).with_name("solve.py"))


class Run(solve.Run):
    def __init__(self, cell, seed: int, device, obs):
        super().__init__(cell, seed, device, obs)
        self.cap = int(self.mix["trace_iterations"])
        self.counts = []  # (iterations, live_cols or None) of each solve

    def _solve(self, j: int, it_cap=None):
        """One request: pool start j solved, stopped after ``it_cap``
        iterations when given; (result, eigenvalues, wall)."""
        self._sync()
        t0 = time.perf_counter()
        u = self.problem.well_draws(self.p, self.size_sub, seeds.generator(
            self.pool_seed, j, seeds.START, self.device))
        X0 = self.problem.start(self.p, u)
        gen = seeds.generator(self.pool_seed, j, seeds.SOLVER, self.device)
        # Uncapped, the call a ``solve`` mix makes (its controls and faults
        # replace a solve of four arguments).
        r = self.problem.solve(self.p, X0, self.config, gen) \
            if it_cap is None else \
            self.problem.solve(self.p, X0, self.config, gen, it_cap=it_cap)
        lam = r.eigenvalues.double().cpu().numpy()
        self._sync()
        wall = time.perf_counter() - t0
        self.counts.append((int(r.iterations), getattr(r, "live_cols", None)))
        return r, lam, wall

    def setup(self):
        self.p = self.problem.build(self.cfg, self.device,
                                    operator=self.mix["operator"])
        self.config = self.problem.solver_config(self.cfg, self.nev,
                                                 self.size_sub)
        self._solve(seeds.WARMUP, self.cap)

    def window(self, seconds: float) -> dict:
        self.counts = []
        values = super().window(seconds)
        live = [c for _, c in self.counts]
        if all(c is not None for c in live):
            self.obs.live_cols = [int(c) for c in live]
            self.obs.search_cols = [2 * self.size_sub * it
                                    for it, _ in self.counts]
        return values

    def traced(self, path):
        """The window's first start capped at ``trace_iterations``:
        untraced, then the same under the profiler."""
        from bench_port.trace import profile
        first = self.answers[0][0]
        r, _, wall = self._solve(first, self.cap)
        untraced = int(r.iterations)
        del r
        (r, _, _), tr = profile(lambda: self._solve(first, self.cap), path,
                                self.device)
        self.obs.trace = tr
        self.obs.traced_iterations = int(r.iterations)
        self.obs.untraced_wall_s = wall
        print(f"traced: start {first} capped at {self.cap}, "
              f"{r.iterations} iterations, untraced wall {wall:.4f} s",
              file=sys.stderr)
        return {"traced_iterations": int(r.iterations),
                "untraced_iterations": untraced}
