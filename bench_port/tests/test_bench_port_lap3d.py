"""Whole runs of a small cell of the 3-D Laplacian (grid 10^3 on the CPU)
through the ``solve_long`` driver: sound, with the capped traced request,
and with each fault a solve cell can have, which has to read not
correct; on the card the TF32 control at a reduced grid.

    python3 -m pytest bench_port/tests/test_bench_port_lap3d.py -q
    python3 -m pytest bench_port/tests/test_bench_port_lap3d.py -m gpu -q   # on the card
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from bench_port import control, run
from bench_port.tests import tiny

CELL = "lap3d_160.nd"
TINY_CONFIG = {"grid": [10, 10, 10], "scale": 121.0}
TINY_MIX = {"pool": 2, "trace_iterations": 8, "limits": {"eig_rel_err": 1e-5}}
GPU_CONFIG = {"grid": [48, 48, 48], "scale": 49.0 ** 2}
GPU_MIX = {"pool": 1, "trace_iterations": 16, "limits": {"eig_rel_err": 1e-4}}


def make_root(tmp, config=TINY_CONFIG, mix=TINY_MIX):
    """``tiny.make_root`` plus the cell ``tiny_lap.nd``: lap3d_160 with
    ``config``'s keys changed, run by solve_long_nd with ``mix``'s,
    reporting every metric that lap3d_160.nd reports."""
    root = tiny.make_root(tmp)
    cfg = json.loads((tiny.REPO / "bench_port/configs/lap3d_160.json").read_text())
    cfg.update(config, name="tiny_lap")
    tiny.write(root / "bench_port/configs/tiny_lap.json", cfg)
    m = json.loads((tiny.REPO / "bench_port/mixes/solve_long_nd.json").read_text())
    m.update(mix)
    tiny.write(root / "bench_port/mixes/tiny_long.json", m)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny_lap", "source": "x", "file": "bench_port/configs/tiny_lap.json",
        "reduced": sorted(config), "why": "a rehearsal"})
    bench["workloads"].append({"name": "tiny_lap.nd", "config": "tiny_lap",
                               "traffic": "tiny_long", "chips": 1,
                               "why": "a rehearsal"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("tiny_lap.nd")
    tiny.write(root / "BENCHMARK.json", bench)
    return root


def _replace_solve(r, make):
    """Give run ``r`` the solve ``make(solve)``, where ``solve`` is the
    problem's own (its ``it_cap`` passed through)."""
    control._replace(r, solve=make(r.problem.solve))


def solve_unchanged(r):
    """Every apply of A returns its state unchanged (A X = X)."""
    class Identity:
        def __init__(self, like):
            self.like = like

        def __getattr__(self, name):
            return getattr(self.like, name)

        def matmat(self, X):
            return X.clone()

    _replace_solve(r, lambda solve: lambda p, X0, config, gen, **kw: solve(
        dataclasses.replace(p, A=Identity(p.A)), X0, config, gen, **kw))


def solve_half(r):
    """Half of the answer's pairs left out, the rest repeated in their place."""
    def make(solve):
        def broken(p, X0, config, gen, **kw):
            res = solve(p, X0, config, gen, **kw)
            k = res.eigenvalues.shape[0]
            h = k // 2
            return res._replace(
                eigenvalues=torch.cat([res.eigenvalues[:h]] * 3)[:k],
                eigenvectors=torch.cat([res.eigenvectors[:, :h]] * 3, 1)[:, :k])
        return broken
    _replace_solve(r, make)


def solve_altered(r):
    """One eigenvalue altered by a part in 10^4 where it is produced."""
    def make(solve):
        def broken(p, X0, config, gen, **kw):
            res = solve(p, X0, config, gen, **kw)
            lam = res.eigenvalues.clone()
            lam[-1] *= 1 + 1e-4
            return res._replace(eigenvalues=lam)
        return broken
    _replace_solve(r, make)


def tf32_capped(r):
    """``control.tf32_solve`` (TF32 on inside the solve's precision
    context), the capped solves of set-up and the traced request kept
    capped, and one solve a window (``per_pass`` 1), as the control runs
    a solve cell."""
    cap = [None]
    _replace_solve(r, lambda solve: lambda p, X0, config, gen: solve(
        p, X0, config, gen, it_cap=cap[0]))
    control.tf32_solve(r)

    def make(tf32):
        def capped(p, X0, config, gen, it_cap=None):
            cap[0] = it_cap
            return tf32(p, X0, config, gen)
        return capped

    _replace_solve(r, make)
    r.per_pass = 1


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _run(root, capsys, trace=0, patch=None, seed=2**31 + 77, device="cpu"):
    code = run.run(["--workload", "tiny_lap.nd", "--seed", str(seed),
                    "--seconds", "0.3", "--trace", str(trace)], root=root,
                   device=device, patch=patch)
    out = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(out[-1]) if out else None


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(root, capsys):
    code, res = _run(root, capsys)
    assert code == 0 and res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"solve_s", "peak_gib", "setup_s"}
    assert res["checks"]["unconverged"]["value"] == 0


def test_the_traced_request_is_capped(root, capsys):
    """--trace 1: the capped slice traced, K2's metric absent on the CPU
    (the plain stencil launches no stencil3d_kernel), the program's live
    count present and below 100%, iterations those of the whole solves."""
    runs = []
    code, res = _run(root, capsys, trace=1, patch=runs.append)
    assert code == 0 and res["correct"] is True
    assert res["notes"] == {"traced_iterations": 8, "untraced_iterations": 8}
    metrics = res["metrics"]
    assert "k2_ms_per_iter" not in metrics and "k1_ms_per_iter" not in metrics
    assert 0 < metrics["search_live_share"]["value"] < 100
    assert metrics["iterations"]["value"] > 8
    r = runs[0]
    assert r.obs.traced_iterations == 8 and r.obs.untraced_wall_s > 0
    assert len(r.obs.live_cols) == len(r.answers)
    assert r.obs.search_cols == [2 * r.size_sub * a[3] for a in r.answers]


def test_a_program_without_the_count_leaves_the_share_out(root, capsys):
    """A program whose result has no live_cols (the parent's) runs the
    cell as well, and the share is left out of the line."""
    code, res = _run(root, capsys, trace=1, patch=lambda r: _replace_solve(
        r, lambda solve: lambda *a, **kw: solve(*a, **kw)._replace(
            live_cols=None)))
    assert code == 0 and res["correct"] is True
    assert "search_live_share" not in res["metrics"]
    assert "iterations" in res["metrics"]


@pytest.mark.parametrize("fault", [solve_unchanged, solve_half, solve_altered])
def test_each_fault_is_not_correct(root, capsys, fault):
    code, res = _run(root, capsys, patch=fault)
    assert code == 0 and res["correct"] is False and res["failed"] >= 1


def test_the_bsr_route_runs_the_same_cell(tmp_path, capsys):
    """The mix's operator "BSROperator" (K3 on the card) answers the
    same cell correctly."""
    bsr = make_root(tmp_path, mix={**TINY_MIX, "operator": "BSROperator"})
    code, res = _run(bsr, capsys)
    assert code == 0 and res["correct"] is True


@pytest.mark.gpu
def test_tf32_control_is_not_correct(tmp_path, capsys):
    """On the card, a 48^3 grid: sound is correct, the TF32 control not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = make_root(tmp_path, config=GPU_CONFIG, mix=GPU_MIX)
    code, res = _run(card, capsys, trace=1, device=None, seed=5)
    assert code == 0 and res["correct"] is True, res["checks"]
    assert res["metrics"]["k2_ms_per_iter"]["value"] > 0
    code, res = _run(card, capsys, patch=tf32_capped, device=None, seed=5)
    assert code == 0 and res["correct"] is False
