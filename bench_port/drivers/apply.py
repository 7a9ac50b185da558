"""The ``apply`` mix: one operator apply after another on one X.

``A.matmat(X)`` back to back for ``seconds`` (the host enqueues them; one
synchronise closes the window), every apply reading the same X: chaining
Y = A X would overflow float32 within a few steps.  X [n, k] is drawn on
the device from the seed.

    apply_nnz_per_s   nnz(A) * k * applies over the window's whole time

Set-up draws X and runs one warm-up apply.  After the window the last
apply's Y is held against the reference's A X, worked out in float64.
"""

from __future__ import annotations

import time

import torch

from bench_port import roofline, seeds

TRACED_APPLIES = 200  # launches in the traced window (~0.55 s at [4M, 256])


class Run:
    def __init__(self, cell, seed: int, device, obs):
        self.cell, self.seed, self.device, self.obs = cell, seed, device, obs
        self.cfg, self.k = cell.config, int(cell.mix["k"])
        self.problem, self.reference = cell.problem(), cell.reference()
        self.count = 0
        self.Y = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        self.p = self.problem.build(self.cfg, self.device)
        gen = seeds.generator(self.seed, 0, seeds.BLOCK, self.device)
        self.X = torch.rand((self.p.n, self.k), generator=gen,
                            dtype=self.p.dtype, device=self.device) - 0.5
        self.problem.apply(self.p, self.X)
        self._sync()

    def window(self, seconds: float) -> dict:
        apply, p, X = self.problem.apply, self.p, self.X
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        Y, count = None, 0
        while time.perf_counter() < deadline:
            Y = apply(p, X)
            count += 1
        self._sync()
        total = time.perf_counter() - t0
        self.Y, self.count = Y, count
        nnz = roofline.stencil_nnz(p.n, int(self.cfg["segments"]))
        return {"apply_nnz_per_s": nnz * self.k * count / total}

    def traced(self, path):
        from bench_port.trace import profile

        def applies():
            for _ in range(TRACED_APPLIES):
                self.problem.apply(self.p, self.X)

        _, tr = profile(applies, path, self.device)
        self.obs.trace = tr
        self.obs.launch_bytes = roofline.stencil_diag_bytes(
            self.p.n, self.k, self.X.element_size())
        if self.device.type == "cuda":
            self.obs.peak_bytes_per_s = roofline.hbm_bytes_per_s(
                torch.cuda.get_device_name(self.device))
        return {}

    def release(self):
        self.p = None

    @property
    def attempted(self) -> int:
        return self.count

    def check(self) -> tuple:
        err = self.reference.apply_error(self.cfg, self.X, self.Y)
        limit = self.cell.mix["limits"]["y_err"]
        ok = limit is not None and err == err and err <= limit
        return [("y_err", err, limit)], 0 if ok else 1
