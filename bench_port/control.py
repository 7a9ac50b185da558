"""The control of each cell's comparison: a run whose timed path computes
one precision below what the configuration states, which the comparison
has to find not correct.  The benchmark's own runs never run it.

    python3 bench_port/control.py --workload bdg_well_4M.nev56 \
        --seeds 11 12 13

The configurations state float32 with TF32 off, so the control is TF32:
  solve cells  the program itself with TF32 turned on for its contractions
               (its precision context, which turns TF32 off for a solve,
               turns it on instead; the tall SGEMMs and Grams run in TF32);
  apply cells  the reference's apply with every operand rounded to TF32,
               put in the program's place.
Each seed is one run (set-up, window, comparison) in this process, and
prints its result line as ``run.py`` does.  A solve cell's window there
is one solve, of the first start in the seed's order: a TF32 solve runs
to ``max_iter`` without converging, and one fails the comparison.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port import run  # noqa: E402


def _replace(r, **fns):
    """Give run ``r`` a problem whose functions ``fns`` replace its own."""
    r.problem = types.SimpleNamespace(**{**vars(r.problem), **fns})


def tf32_solve(r):
    solve = r.problem.solve

    def solve_tf32(p, X0, config, gen):
        from lobpcg_tpu_torch.ops import gram
        enter = gram.precision_ctx.__enter__

        def enter_tf32(self):
            out = enter(self)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            return out

        gram.precision_ctx.__enter__ = enter_tf32
        try:
            return solve(p, X0, config, gen)
        finally:
            gram.precision_ctx.__enter__ = enter

    _replace(r, solve=solve_tf32)


def tf32_apply(r):
    ref, cfg = r.reference, r.cfg
    _replace(r, apply=lambda p, X: ref.apply_tf32(cfg, X))


CONTROLS = {"solve": tf32_solve, "apply": tf32_apply}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    from bench_port import spec
    kind = spec.load_cell(ROOT, a.workload).mix["kind"]

    def patch(r):
        CONTROLS[kind](r)
        if kind == "solve":
            r.per_pass = 1

    code = 0
    for seed in a.seeds:
        code |= run.run(["--workload", a.workload, "--seed", str(seed),
                         "--seconds", str(a.seconds)], patch=patch)
    return code


if __name__ == "__main__":
    sys.exit(main())
