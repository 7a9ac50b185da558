"""Peak device memory of short well solves for each memory knob
combination: the anchors of ``utils/plan.py``'s ``PEAK_BLOCKS_H100``,
and with ``--fixed`` its ``FIXED_GB_H100``.

    python -m lobpcg_tpu_torch.tools.plan_anchors [--n 4000000] \
        [--size-sub 64] [--iters 5] [--precond cheb|none]
    python -m lobpcg_tpu_torch.tools.plan_anchors --fixed

For each (dual_basis, use_b_cache, use_ax_cache) it builds the BdG well
pencil of ``benchmarks/solve_bdg.py`` (nev 56, f32, Chebyshev degree 3
with the JAX script's column chunk; ``--precond none``: no
preconditioner, the headline gates' form), resets the card's peak
statistics, runs ``ilobpcg`` for ``--iters`` iterations and reads
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
(peak GiB, and the peak less ``FIXED_GB_H100`` in [n, size_sub] f32
blocks) and a last line with the card's name and power limit.

``--fixed`` itemises the part of a peak that no block accounts for: in
a fresh process it runs ``graft_entry.entry()``'s toy solve (n 128,
size_sub 5, f32) with the allocator's history on, drops every tensor of
the solve, and prints the solve's peak, what stays allocated, and each
allocation still live with its size and the first frames of its stack.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json

import torch

from lobpcg_tpu_torch import graft_entry
from lobpcg_tpu_torch.bench import power_limit
from lobpcg_tpu_torch.benchmarks.solve_bdg import well_problem
from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.solvers import ilobpcg as ilobpcg_module
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg
from lobpcg_tpu_torch.utils.plan import FIXED_GB_H100

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


def _frames(block) -> list:
    """The first frames of an allocation's recorded stack, as text."""
    frames = block.get("frames") or []
    return [f"{f.get('filename', '?')}:{f.get('line', '?')} {f.get('name', '?')}"
            for f in frames[:12]]


def fixed_term(dev) -> dict:
    """The toy solve's peak, the bytes that stay allocated once its
    tensors are gone, and those allocations with their stacks."""
    torch.cuda.memory._record_memory_history(max_entries=200_000)
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn, (X0,) = graft_entry.entry(dev)
        lam, res = fn(X0)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        lam_host = lam.double().cpu().tolist()
        del fn, X0, lam, res
        gc.collect()
        torch.cuda.synchronize(dev)
        live = torch.cuda.memory_allocated(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    blocks = [{"bytes": b["size"], "frames": _frames(b)}
              for seg in snap["segments"] for b in seg["blocks"]
              if b["state"] == "active_allocated"]
    return {"toy_peak_bytes": peak, "toy_peak_gib": peak / 2**30,
            "live_after_bytes": live, "live_after_gib": live / 2**30,
            "live_blocks": sorted(blocks, key=lambda b: -b["bytes"]),
            "eigenvalues": lam_host, "fixed_gb_h100": FIXED_GB_H100}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--size-sub", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--precond", choices=("cheb", "none"), default="cheb")
    ap.add_argument("--fixed", action="store_true",
                    help="itemise the fixed term on a toy solve instead")
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    if a.fixed:
        print(json.dumps(fixed_term(dev)), flush=True)
        print(json.dumps({"device": torch.cuda.get_device_name(dev),
                          "power_limit": power_limit(dev)}), flush=True)
        return
    block_gib = a.n * a.size_sub * 4 / 2**30
    runs = [(dual, b_cache, ax_cache, forced)
            for dual, b_cache, ax_cache in itertools.product((True, False), repeat=3)
            for forced in ((False, True) if dual else (False,))]
    cheb = a.precond == "cheb"
    for dual, b_cache, ax_cache, forced in runs:
        A, B, T, X0, _, _ = well_problem(a.n, NEV, a.size_sub,
                                         dtype=torch.float32,
                                         cheb=CHEB if cheb else 0,
                                         precond=cheb, device=dev)
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
            "precond": a.precond,
            "n": a.n, "size_sub": a.size_sub, "iterations": r.iterations,
            "quality5_iterations": r.quality5_count, "peak_gib": peak,
            "peak_blocks": (peak - FIXED_GB_H100) / block_gib,
        }), flush=True)
        del A, B, T, X0, r
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "power_limit": power_limit(dev)}), flush=True)


if __name__ == "__main__":
    main()
