"""The control of the ``solve_long`` cells whose operators are
``BSROperator``s (``lap3d_160.bsr``, ``fem3d_q1.nev10``): a run whose
operators compute one precision below what the configuration states,
which the comparison has to find not correct.  The benchmark's own runs
never run it.

    python3 bench_port/control_bsr.py --workload fem3d_q1.nev10 \
        --seeds 11 12 13

The configurations state float32 with TF32 off.  K3 and the tall kernels
run FFMA and do not take PyTorch's TF32 switch, so ``control.py``'s patch
reaches nothing of these solves; here TF32's precision is put into the
operators themselves, as a TF32 product reads both of its inputs: every
stored value of every BSROperator of the problem (K and M, or A) is
rounded to 10 mantissa bits, to nearest, once at set-up, and every block
X an operator is applied to is rounded the same way before the product.

Each seed is one run (set-up, window, comparison) in this process, and
prints its result line as ``run.py`` does.  The window there is one solve,
of the first start in the seed's order (``per_pass`` 1); set-up's warm-up
and the traced request stay capped.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port import control, run  # noqa: E402


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to 10 mantissa bits, to nearest, ties to
    even (finite values)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class RoundedOperands:
    """``op`` applied to its operand rounded by ``round_tf32``; every
    other attribute is ``op``'s."""

    def __init__(self, op):
        self.op = op

    def __getattr__(self, name):
        return getattr(self.op, name)

    def matmat(self, X):
        return self.op.matmat(round_tf32(X))


def _rounded_values(op):
    """A BSROperator like ``op`` with its stored values rounded."""
    fields = {"blocks": round_tf32(op.blocks)}
    if op.win_vals is not None:
        fields["win_vals"] = round_tf32(op.win_vals)
    return dataclasses.replace(op, **fields)


def rounded(r):
    """Give run ``r`` a problem whose BSROperators hold rounded values
    and round what they are applied to, one solve a window."""
    import lobpcg_tpu_torch as lt

    build = r.problem.build

    def build_rounded(cfg, device, operator=None):
        p = build(cfg, device, **({} if operator is None
                                  else {"operator": operator}))
        swap = {}
        for f in dataclasses.fields(p):
            op = getattr(p, f.name)
            if isinstance(op, lt.BSROperator):
                swap[f.name] = RoundedOperands(_rounded_values(op))
        if not swap:
            raise ValueError("the problem holds no BSROperator")
        return dataclasses.replace(p, **swap)

    control._replace(r, build=build_rounded)
    r.per_pass = 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    code = 0
    for seed in a.seeds:
        code |= run.run(["--workload", a.workload, "--seed", str(seed),
                         "--seconds", str(a.seconds)], patch=rounded)
    return code


if __name__ == "__main__":
    sys.exit(main())
