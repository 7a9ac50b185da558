"""A root laid out like the repository's, holding the harness and two
small cells on the well pencil (on the CPU n 800, a well of 48 sites),
so that a whole run can be rehearsed in a second or two."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY_CONFIG = {"n": 800, "well": 48, "cheb_chunk": 4}
SOLVE_MIX = {"kind": "solve", "nev": 4, "size_sub": 8, "pool": 4, "pool_seed": 0,
             "limits": {"eig_rel_err": 1e-5}}
APPLY_MIX = {"kind": "apply", "k": 8, "limits": {"y_err": 1e-6}}


def make_root(tmp, config=TINY_CONFIG, solve_mix=SOLVE_MIX,
              apply_mix=APPLY_MIX) -> pathlib.Path:
    """``tmp`` with BENCHMARK.json (the repository's cells plus
    ``tiny_well.solve`` and ``tiny_well.apply``) and a copy of the
    harness with the tiny configuration (the 4M one with ``config``'s
    keys changed) and mixes added as new files."""
    root = pathlib.Path(tmp)
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("tests", ".traces",
                                                  "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads(
        (REPO / "bench_port/configs/bdg_well_4M.json").read_text())
    cfg.update(config, name="tiny_well")
    write(root / "bench_port/configs/tiny_well.json", cfg)
    write(root / "bench_port/mixes/tiny_solve.json", solve_mix)
    write(root / "bench_port/mixes/tiny_apply.json", apply_mix)
    bench["configs"].append({
        "name": "tiny_well", "source": "https://github.com/pstuermer/LOBPCG",
        "file": "bench_port/configs/tiny_well.json", "reduced": ["n", "well"],
        "why": "a CPU rehearsal"})
    for traffic, metric in (("solve", "solve_s"), ("apply", "apply_nnz_per_s")):
        name = f"tiny_well.{traffic}"
        bench["workloads"].append({
            "name": name, "config": "tiny_well", "traffic": f"tiny_{traffic}",
            "chips": 1, "why": "a CPU rehearsal"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m.get("moves", m["name"]) == metric and "workloads" in m:
                m["workloads"].append(name)
    write(root / "BENCHMARK.json", bench)
    return root


def write(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))
