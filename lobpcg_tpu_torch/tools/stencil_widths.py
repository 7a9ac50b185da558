"""K1, the segmented 1-D stencil kernel, against its plain version and
cuDNN's depthwise ``conv1d`` over a sweep of widths, on the card.

    python -m lobpcg_tpu_torch.tools.stencil_widths            # this tree
    python -m lobpcg_tpu_torch.tools.stencil_widths --ab DIR   # DIR, this, this, DIR

Each point builds X (and edge rows) from a seeded generator on the card,
holds ``stencil_matmat`` to ``stencil_matmat_reference`` within 2 ulp of
the storage dtype x |scale| x max|X|, and times the kernel, the plain
version and, for f32, ``conv1d`` (TF32 off) with ``bench.time_ms``.  The
bound is the larger of 2 n k itemsize bytes over 3.35 TB/s and 4 n k
operations over 67 TFLOP/s (f32, outside the tensor cores).  Prints one
JSON line a point, then the card's name and power limit.

``--tune`` times the kernel's one choice at a few of these shapes: the
elements it loads at once, from 1 up to what ``ops/cuda/stencil.py:
items_per_load`` picks there.

``--ab DIR`` times the same points in turns in four processes: the
package of DIR (a checkout of another commit, e.g. from ``git archive``),
this tree's, this tree's, DIR's; each process imports ``lobpcg_tpu_torch``
from its tree, so the two kernels meet on one card in one call.  It
prints one line a point with the four times.

Nothing here is imported by the package; ``chip_smoke.py`` runs
``sweep`` in its K1 phase.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import torch

from lobpcg_tpu_torch import bench
from lobpcg_tpu_torch.ops.cuda import stencil as k1

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SWEEP_BYTES = 256 << 20  # X's bytes at each point of the width sweep
FLOOR_SHARE = 0.5  # least share of bound for an f32 point whose X >= 64 MiB
FLOOR_BYTES = 64 << 20

F32_WIDTHS = (1, 2, 3, 6, 7, 8, 15, 16, 30, 31, 33, 64, 78, 129)
BF16_WIDTHS = (6, 30, 64)
N_MAIN = 4_000_000


def sweep_cases(lockstep=((8, 1_000_000), (32, 65_536)),
                lockstep_widths=(30, 8)) -> list[dict]:
    """The points: the BdG solve's and the headline gates' shapes, the
    lockstep sweeps' folded blocks (b problems of n rows at the block's
    and the norm estimates' widths, over 2b segments), the other solves'
    blocks (one problem of the batched sweep, the 1M x 150 solve, the
    realified solve), a row-sliced X
    (X[1:] of an [n + 1, 30] block: 120 bytes past a 16-byte boundary)
    with edge rows, and the widths at ~256 MiB of X over 2 segments."""
    f32, bf16 = torch.float32, torch.bfloat16

    def case(n, k, dtype=f32, segments=2, edges=False, sliced=False):
        return {"n": n, "k": k, "dtype": dtype, "segments": segments,
                "edges": edges, "sliced": sliced}

    def sized(k, dtype):
        n = SWEEP_BYTES // (k * torch.finfo(dtype).bits // 8)
        return case(n - n % 2, k, dtype)

    return [
        case(N_MAIN, 64), case(N_MAIN, 64, edges=True),
        case(N_MAIN, 256), case(N_MAIN, 256, edges=True),
        case(N_MAIN, 64, bf16), case(N_MAIN, 78, edges=True),
        case(N_MAIN, 16),  # the flagship's Chebyshev column chunk
        case(N_MAIN, 160), case(N_MAIN, 320, segments=4),  # the gates
        *(case(b * n, k, segments=2 * b)
          for b, n in lockstep for k in lockstep_widths),
        # One problem of the batched sweep (lt.batched), the 1M x 150
        # solve's block and the realified solve's (n 2M over 4 segments).
        *(case(1_000_000, k) for k in lockstep_widths),
        case(1_000_000, 164), case(2_000_000, 60, segments=4),
        case(N_MAIN, 30, edges=True, sliced=True),
        *(sized(k, f32) for k in F32_WIDTHS),
        *(sized(k, bf16) for k in BF16_WIDTHS),
    ]


def time_untracked(fn) -> float:
    """bench.time_ms of fn on the card; K1's launches made here do not
    count."""
    launches = k1.stencil_matmat.launches
    try:
        return bench.time_ms(fn, torch.device("cuda"))
    finally:
        k1.stencil_matmat.launches = launches


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the f32 (non-tensor) peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def conv1d_stencil(X, scale, seg):
    """K1's yardstick: one depthwise cuDNN conv1d over the same bytes, X
    viewed as a channels-last [segments, k, n / segments] batch (no edge
    rows)."""
    n, k = X.shape
    w = torch.tensor([-scale, 2.0 * scale, -scale], dtype=X.dtype,
                     device=X.device).repeat(k, 1, 1)
    Xc = X.view(seg, n // seg, k).permute(0, 2, 1)
    return lambda: torch.nn.functional.conv1d(Xc, w, padding=1, groups=k)


def max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a.float() - b.float())))


def measure(c: dict, gen, scale: float = 1.0, library: bool = True,
            plain: bool = True) -> dict:
    """One point: the kernel held to its plain version, then timed."""
    dev = gen.device
    n, k, dt, seg = c["n"], c["k"], c["dtype"], c["segments"]
    if c["sliced"]:
        X = (torch.rand((n + 1, k), generator=gen, device=dev) - 0.5).to(dt)[1:]
    else:
        X = (torch.rand((n, k), generator=gen, device=dev) - 0.5).to(dt)
    E = ((torch.rand((2, k), generator=gen, device=dev) - 0.5).to(dt)
         if c["edges"] else None)
    Y = k1.stencil_matmat(X, scale, E, num_segments=seg)
    Yp = k1.stencil_matmat_reference(X, scale, E, num_segments=seg)
    torch.cuda.synchronize()
    err = max_abs(Y, Yp)
    tol = 2 * torch.finfo(dt).eps * abs(scale) * float(X.float().abs().max())
    if not err <= tol:
        raise AssertionError(f"stencil kernel disagrees at n={n} k={k} {dt} "
                             f"segments={seg} sliced={c['sliced']}: "
                             f"max_abs_err {err} > {tol}")
    del Y, Yp
    nbytes = 2 * n * k * X.element_size()
    ms = time_untracked(lambda: k1.stencil_matmat(X, scale, E, num_segments=seg))
    rec = {"phase": "kernel", "name": "stencil1d", "n": n, "k": k,
           "dtype": str(dt).replace("torch.", ""), "segments": seg,
           "edge_rows": c["edges"], "x_offset_bytes": X.data_ptr() % 16,
           "x_mib": n * k * X.element_size() / 2**20,
           "max_abs_err": err, "tol": tol, "ms": ms, "gbps": nbytes / ms / 1e6,
           # 2x, two subtractions, one scale: 4 operations an element.
           **bound(nbytes, 4 * n * k), "plain_ms": None, "library_ms": None}
    rec["share_of_bound"] = rec["bound_ms"] / ms
    if plain:
        rec["plain_ms"] = time_untracked(
            lambda: k1.stencil_matmat_reference(X, scale, E, num_segments=seg))
    if library and dt == torch.float32:
        lib = conv1d_stencil(X, scale, seg)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib_err = max_abs(lib().permute(0, 2, 1).reshape(n, k),
                              k1.stencil_matmat_reference(X, scale, None,
                                                          num_segments=seg))
            # 8 ulp of the largest output, 4 |scale| max|X|.
            if not lib_err <= 16 * tol:
                raise AssertionError(f"conv1d yardstick computes another "
                                     f"function: {lib_err} > {16 * tol}")
            rec["library_max_abs_err"] = lib_err
            rec["library_ms"] = time_untracked(lib)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    del X, E
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def check_floor(rec: dict) -> None:
    """Raise if an f32 point whose X holds at least 64 MiB runs under half
    its bound."""
    if (rec["dtype"] == "float32" and rec["x_mib"] * 2**20 >= FLOOR_BYTES
            and rec["share_of_bound"] < FLOOR_SHARE):
        raise AssertionError(
            f"stencil kernel at [{rec['n']}, {rec['k']}] f32 runs at "
            f"{rec['share_of_bound']:.1%} of its bound, under "
            f"{FLOOR_SHARE:.0%}: {rec['ms']} ms against {rec['bound_ms']}")


def sweep(dev, emit=print, **kw) -> list[dict]:
    """Every point of ``sweep_cases(**kw)``: checked, timed, emitted as a
    JSON line, and held to the floor share of its bound."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for c in sweep_cases(**kw):
        rec = measure(c, gen)
        emit(json.dumps(rec))
        check_floor(rec)
        out.append(rec)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _times_only() -> None:
    """Child of --ab: the kernel's ms at every point, as one JSON list."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(json.dumps([measure(c, gen, library=False, plain=False)["ms"]
                      for c in sweep_cases()]), flush=True)


TUNE_SHAPES = ((N_MAIN, 64, torch.float32), (N_MAIN, 320, torch.float32),
               (8_000_000, 8, torch.float32), (8_000_000, 30, torch.float32),
               (N_MAIN, 64, torch.bfloat16), (N_MAIN, 30, torch.bfloat16))


def tune(dev, emit=print) -> None:
    """The kernel at each TUNE_SHAPES point (2 segments) in items of every
    width it takes there, from one element up to the one
    ``items_per_load`` picks; each checked against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, k, dt in TUNE_SHAPES:
        X = (torch.rand((n, k), generator=gen, device=dev) - 0.5).to(dt)
        Y = torch.empty_like(X)
        want = k1.stencil_matmat_reference(X, 1.0, None, num_segments=2)
        chosen = k1.items_per_load(k, X.element_size(), X.data_ptr(), Y.data_ptr())
        w = 1
        while w <= chosen:
            def run():
                return k1.launch(X, Y, 1.0, None, n // 2, w)
            if run() != 0:
                raise RuntimeError(f"stencil1d launch failed at {n, k, dt, w}")
            err = max_abs(Y, want)
            if err != 0.0:
                raise AssertionError(f"tune: error {err} at {n, k, dt, w}")
            ms = bench.time_ms(run, dev)
            emit(json.dumps({
                "phase": "tune", "n": n, "k": k,
                "dtype": str(dt).replace("torch.", ""), "items": w,
                "chosen": w == chosen, "ms": ms,
                "share_of_bound": 2 * n * k * X.element_size()
                / HBM_BYTES_PER_S * 1e3 / ms}))
            w *= 2
        del X, Y, want
        torch.cuda.empty_cache()


def _ab(other: str) -> None:
    this = str(pathlib.Path(__file__).resolve().parents[2])
    other = str(pathlib.Path(other).resolve())
    trees = [("other", other), ("this", this), ("this", this), ("other", other)]
    runs = []
    for label, tree in trees:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, __file__, "--times-only"], env=env, cwd=tree,
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({tree}) failed:\n{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    for i, c in enumerate(sweep_cases()):
        print(json.dumps({
            "phase": "ab", "n": c["n"], "k": c["k"],
            "dtype": str(c["dtype"]).replace("torch.", ""),
            "segments": c["segments"], "edge_rows": c["edges"],
            "sliced": c["sliced"],
            "ms": [[label, ms[i]] for label, ms in runs]}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", metavar="DIR",
                        help="another tree: time its K1 and this one's in turns")
    parser.add_argument("--tune", action="store_true",
                        help="time the kernel at each item width it takes")
    parser.add_argument("--times-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stencil_widths: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.times_only:
        _times_only()
        return
    if args.tune:
        tune(torch.device("cuda", 0), emit=lambda line: print(line, flush=True))
    elif args.ab:
        _ab(args.ab)
    else:
        sweep(torch.device("cuda", 0), emit=lambda s: print(s, flush=True))
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
