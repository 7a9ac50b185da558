"""The ``solve`` mix: a closed loop of whole passes over a pool of starts.

One caller solves, waits for the answer, and solves again from the next
start.  The starts are a pool of ``pool`` problems, each a start and the
solver's own draws from (``pool_seed``, j), the same pool for every seed:
the iterations a start needs differ from start to start (28 to 39 at
4M x 56), so the seed only orders the pool (a new order each pass) and
the window ends at a pass's end, the one nearest ``seconds`` (at least
one pass): every run does the same work, whole passes over the same
starts.  Distinct starts average out the swing in iterations that
float32 shows between bit-different programs.

    solve_s   the window's whole time over the solves it completed

Set-up builds the problem on the device and runs one warm-up solve from
draws outside the pool.  After the window every answer's eigenvalues are
held against the reference's, and the last answer's eigenvectors are
handed to the reference, which works out their residuals itself.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from bench_port import seeds


class Run:
    def __init__(self, cell, seed: int, device, obs):
        self.cell, self.seed, self.device, self.obs = cell, seed, device, obs
        self.cfg, self.mix = cell.config, cell.mix
        self.nev, self.size_sub = int(self.mix["nev"]), int(self.mix["size_sub"])
        self.problem, self.reference = cell.problem(), cell.reference()
        self.pool, self.pool_seed = int(self.mix["pool"]), int(self.mix["pool_seed"])
        self.per_pass = self.pool
        self.answers = []  # (start, eigenvalues, converged, iterations, wall)
        self.last = None  # (eigenvalues, eigenvectors) of the last solve

    def _solve(self, j: int):
        """One request: pool start j solved; (result, eigenvalues, wall)."""
        sync = self._sync
        sync()
        t0 = time.perf_counter()
        u = self.problem.well_draws(self.p, self.size_sub, seeds.generator(
            self.pool_seed, j, seeds.START, self.device))
        X0 = self.problem.start(self.p, u)
        r = self.problem.solve(self.p, X0, self.config, seeds.generator(
            self.pool_seed, j, seeds.SOLVER, self.device))
        lam = r.eigenvalues.double().cpu().numpy()
        sync()
        return r, lam, time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        self.p = self.problem.build(self.cfg, self.device)
        self.config = self.problem.solver_config(self.cfg, self.nev,
                                                 self.size_sub)
        self._solve(seeds.WARMUP)

    def window(self, seconds: float) -> dict:
        order = self._passes()
        t0 = time.perf_counter()
        passes = 0
        while True:
            for j in next(order):
                self.last = None  # the previous answer, freed first
                r, lam, wall = self._solve(j)
                self.answers.append((j, lam, int(r.converged),
                                     int(r.iterations), wall))
                print(f"solve of start {j}: {r.iterations} iterations, "
                      f"{r.converged} converged, {wall:.4f} s",
                      file=sys.stderr)
                self.last = (lam, r.eigenvectors)
                del r
            passes += 1
            elapsed = time.perf_counter() - t0
            # The next pass's end would lie farther from the deadline.
            if elapsed + 0.5 * elapsed / passes >= seconds:
                break
        print(f"window: {passes} pass(es), {len(self.answers)} solves, "
              f"{elapsed:.4f} s", file=sys.stderr)
        self.obs.iterations = [a[3] for a in self.answers]
        return {"solve_s": elapsed / len(self.answers)}

    def _passes(self):
        """Each pass: the pool's starts in an order of its own from the
        seed; the first ``per_pass`` of it (the whole pool, but one start
        in the control)."""
        rng = np.random.default_rng(seeds.derive(self.seed, 0, seeds.ORDER))
        while True:
            yield [int(j) for j in rng.permutation(self.pool)[:self.per_pass]]

    def traced(self, path):
        """Solve the window's first start again under the profiler; its
        untraced wall is that of the window's first solve."""
        from bench_port.trace import profile
        first = self.answers[0][0]
        (r, _, _), tr = profile(lambda: self._solve(first), path, self.device)
        self.obs.trace = tr
        self.obs.traced_iterations = int(r.iterations)
        self.obs.untraced_wall_s = self.answers[0][4]
        return {"traced_iterations": int(r.iterations),
                "untraced_iterations": self.answers[0][3]}

    def release(self):
        """Free the program's state but the last answer."""
        self.p = self.config = None

    @property
    def attempted(self) -> int:
        return len(self.answers)

    def check(self) -> tuple:
        """(checks, failed answers): checks as (name, value, limit)."""
        exact = self.reference.eigenvalues(self.cfg, self.nev)
        errs = [float(np.max(np.abs(lam - exact) / np.abs(exact)))
                if lam.shape == exact.shape and np.isfinite(lam).all()
                else float("nan") for _, lam, _, _, _ in self.answers]
        lam, vecs = self.last
        res = self.reference.residuals(self.cfg, lam, vecs)
        resid = float(np.max(res)) if np.isfinite(res).all() else float("nan")
        limit_eig = self.mix["limits"]["eig_rel_err"]
        tol = float(self.cfg["solver"]["tol"])
        bad = [conv < self.nev or not _within(e, limit_eig)
               for (_, _, conv, _, _), e in zip(self.answers, errs)]
        bad[-1] = bad[-1] or not _within(resid, tol)
        unconverged = sum(self.nev - a[2] for a in self.answers)
        return [("unconverged", unconverged, 0),
                ("eig_rel_err", _worst(errs), limit_eig),
                ("resid", resid, tol)], sum(bad)


def _worst(values):
    return float("nan") if any(np.isnan(values)) else max(values)


def _within(value, limit) -> bool:
    return limit is not None and value == value and value <= limit
