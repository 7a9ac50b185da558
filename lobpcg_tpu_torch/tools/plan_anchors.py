"""Peak device memory of short well solves for each memory knob
combination: the anchors of ``utils/plan.py``'s ``PEAK_BLOCKS_H100``.

    python -m lobpcg_tpu_torch.tools.plan_anchors [--n 4000000] \
        [--size-sub 64] [--iters 5]

For each (dual_basis, use_b_cache, use_ax_cache) it builds the BdG well
pencil of ``benchmarks/solve_bdg.py`` (nev 56, f32, Chebyshev degree 3
with the JAX script's column chunk), resets the card's peak statistics,
runs ``ilobpcg`` for ``--iters`` iterations and reads
``torch.cuda.max_memory_allocated``: the peak of everything live during
the solve, the problem's own tensors included.  ``pack_applies`` is not
varied: the port never packs two applies into one (every operator takes
any width), so it cannot change the allocations.

The well never trips the quality-5 test, so with dual_basis on each
combination runs twice: as it comes, and with quality 5 forced on every
iteration (``forced_quality5``: the Rayleigh-Ritz result reports quality
5 with Cx_ortho = Cx, so ilobpcg takes its dual-basis branch, which holds
the accurate and the stable basis at once).  This forcing lives in this
tool only; the solver has no such option.  Prints one JSON line per run
(peak GiB, and peak in [n, size_sub] f32 blocks) and a last line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json

import torch

from lobpcg_tpu_torch.bench import power_limit
from lobpcg_tpu_torch.benchmarks.solve_bdg import well_problem
from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.solvers import ilobpcg as ilobpcg_module
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg

NEV, CHEB = 56, 3


@contextlib.contextmanager
def forced_quality5():
    """Make every projected solve of ilobpcg report quality 5 (Cx_ortho =
    Cx), so that the dual-basis branch runs on every iteration."""
    real = ilobpcg_module.indefinite_rayleigh_ritz_modified

    def forced(*args, **kwargs):
        rr = real(*args, **kwargs)
        return rr._replace(quality=5, Cx_ortho=rr.Cx)

    ilobpcg_module.indefinite_rayleigh_ritz_modified = forced
    try:
        yield
    finally:
        ilobpcg_module.indefinite_rayleigh_ritz_modified = real


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--size-sub", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    block_gib = a.n * a.size_sub * 4 / 2**30
    runs = [(dual, b_cache, ax_cache, forced)
            for dual, b_cache, ax_cache in itertools.product((True, False), repeat=3)
            for forced in ((False, True) if dual else (False,))]
    for dual, b_cache, ax_cache, forced in runs:
        A, B, T, X0, _, _ = well_problem(a.n, NEV, a.size_sub,
                                         dtype=torch.float32, cheb=CHEB,
                                         precond=True, device=dev)
        cfg = SolverConfig(nev=NEV, size_sub=a.size_sub, tol=1e-5,
                           max_iter=a.iters, dual_basis=dual,
                           use_b_cache=b_cache, use_ax_cache=ax_cache)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with forced_quality5() if forced else contextlib.nullcontext():
            r = ilobpcg(A, X0, B, T, config=cfg,
                        generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(json.dumps({
            "dual_basis": dual, "use_b_cache": b_cache,
            "use_ax_cache": ax_cache, "forced_quality5": forced,
            "n": a.n, "size_sub": a.size_sub, "iterations": r.iterations,
            "quality5_iterations": r.quality5_count, "peak_gib": peak,
            "peak_blocks": peak / block_gib,
        }), flush=True)
        del A, B, T, X0, r
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "power_limit": power_limit(dev)}), flush=True)


if __name__ == "__main__":
    main()
