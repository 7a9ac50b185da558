"""The tall projection kernel ``csrc/proj.cu`` against the route it
replaces (a cuBLAS GEMM a term and a ``tail.combine`` pass) over widths,
on the card.

    python -m lobpcg_tpu_torch.tools.proj_widths           # the width sweep
    python -m lobpcg_tpu_torch.tools.proj_widths --tune    # plans at the solves' widths

The sweep runs ``b_mm``'s form (three terms of width m, no U, no mask) at
n 4,000,000 for each m of WIDTHS: ms of the kernel (``proj.launch``) and
of ``proj.library`` (the cuBLAS route), the bound (the larger of 2 n K m
operations over 67 TFLOP/s and (K + m) n 4 bytes over 3.35 TB/s, K = 3 m)
and the route ``proj.project`` takes there: the table behind
``proj._widths``.  ``--tune`` times other launch plans (the K a
stage and the rows of threads) at m 164, 64 and 16 beside the one
``plan`` picks; a plan the source does not fix at compile time runs the
generic instantiation.  Prints one JSON line a point, then the card's
name and power limit.

Nothing here is imported by the package; ``chip_smoke.py`` uses
``operands`` and ``bound`` in its projection phase.
"""

from __future__ import annotations

import argparse
import json

import torch

from lobpcg_tpu_torch import bench
from lobpcg_tpu_torch.ops.cuda import proj as kp
from lobpcg_tpu_torch.tools.stencil_widths import bound, card_line

N_MAIN = 4_000_000
WIDTHS = (4, 8, 12, 16, 24, 30, 32, 48, 60, 64, 80, 96, 100, 112, 128, 129,
          150, 164, 168)
TUNE_WIDTHS = (164, 64, 16)


def operands(n: int, widths, m: int, with_u: bool, device, seed: int):
    """Terms [n, w] uniform [0, 1), C [sum w, m] and U [n, m] standard
    normal, from a seeded generator on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    blocks = [torch.rand((n, w), generator=gen, device=device) for w in widths]
    C = torch.randn((sum(widths), m), generator=gen, device=device)
    U = torch.randn((n, m), generator=gen, device=device) if with_u else None
    return blocks, C, U


def proj_bound(n: int, K: int, m: int, with_u: bool) -> dict:
    """bound_ms and bound_by of a projection: each term and U read once,
    Y written once, C once."""
    return bound((K + m * (2 if with_u else 1)) * n * 4 + K * m * 4, 2 * n * K * m)


def sweep_point(dev, m: int, n: int = N_MAIN) -> dict:
    blocks, C, _ = operands(n, (m, m, m), m, False, dev, seed=m)
    out = torch.empty((n, m), device=dev)
    rec = {"m": m, "n": n, "terms": 3,
           "route": "kernel" if kp.takes(blocks, C) else "cublas",
           "ms": bench.time_ms(lambda: kp.launch(blocks, C, out=out), dev),
           "library_ms": bench.time_ms(lambda: kp.library(blocks, C), dev),
           **proj_bound(n, 3 * m, m, False)}
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def tune_plans(m: int):
    """The plan ``plan`` picks first, then each K a stage with the rows
    of threads it allows and half of them."""
    first = kp.plan(m)
    plans = [first]
    for bk in (8, 16, 32):
        tms = kp.MAX_THREADS // (first.hn // 4)
        for t in (tms, tms // 2):
            p = kp.Plan(first.hn, t, bk)
            if t >= 1 and p.stage_bytes() * kp.STAGES <= 227 * 1024 and p not in plans:
                plans.append(p)
    return plans


def tune_point(dev, m: int, n: int = N_MAIN) -> list[dict]:
    blocks, C, _ = operands(n, (m, m, m), m, False, dev, seed=m)
    out = torch.empty((n, m), device=dev)
    want = kp.launch(blocks, C)
    recs = []
    for p in tune_plans(m):
        kp._launch(blocks, C, None, None, out, p)
        rec = {"m": m, "n": n, "plan": [p.hn, p.tms, p.bk], "threads": p.threads,
               "picked": p == kp.plan(m),
               "max_abs_diff": float((out - want).abs().max()),
               "ms": bench.time_ms(
                   lambda: kp._launch(blocks, C, None, None, out, p), dev),
               **proj_bound(n, 3 * m, m, False)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        recs.append(rec)
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--n", type=int, default=N_MAIN)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("proj_widths: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    kp.build()
    if args.tune:
        for m in TUNE_WIDTHS:
            for rec in tune_point(dev, m, args.n):
                print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    else:
        for m in WIDTHS:
            print(json.dumps(sweep_point(dev, m, args.n)), flush=True)
            torch.cuda.empty_cache()
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
