"""Whole runs of a small cell of the Q1 pencil (10^3 interior nodes on the
CPU) through the ``solve_long`` driver: sound, with the capped traced
request, with each fault a generalized solve cell can have, which has to
read not correct, and under ``control_bsr.py``'s control; the B-apply
reader on a trace made by hand; on the card a reduced grid, sound and
under the control.

    python3 -m pytest bench_port/tests/test_bench_port_fem3d.py -q
    python3 -m pytest bench_port/tests/test_bench_port_fem3d.py -m gpu -q   # on the card
"""

from __future__ import annotations

import dataclasses
import json
import types

import pytest
import torch

from bench_port import control, control_bsr, run, spec, trace
from bench_port.tests import test_bench_port_lap3d as lap3d
from bench_port.tests import tiny

CELL = "fem3d_q1.nev10"
_SOLVER = json.loads((tiny.REPO / "bench_port/configs/fem3d_q1.json")
                     .read_text())["solver"]
# 10^3 nodes converge in ~30 iterations; a solve that cannot stops at 300.
TINY_CONFIG = {"grid": [10, 10, 10], "solver": {**_SOLVER, "max_iter": 300}}
TINY_MIX = {"pool": 2, "trace_iterations": 8, "limits": {"eig_rel_err": 1e-5}}
# 32^3 converges in a few hundred iterations; the control stops at 2,000.
GPU_CONFIG = {"grid": [32, 32, 32], "solver": {**_SOLVER, "max_iter": 2000}}
GPU_MIX = {"pool": 1, "trace_iterations": 16, "limits": {"eig_rel_err": 1e-4}}


def make_root(tmp, config=TINY_CONFIG, mix=TINY_MIX):
    """``tiny.make_root`` plus the cell ``tiny_fem.nev10``: fem3d_q1 with
    ``config``'s keys changed, run by solve_long_fem with ``mix``'s,
    reporting every metric that fem3d_q1.nev10 reports."""
    root = tiny.make_root(tmp)
    cfg = json.loads((tiny.REPO / "bench_port/configs/fem3d_q1.json").read_text())
    cfg.update(config, name="tiny_fem")
    tiny.write(root / "bench_port/configs/tiny_fem.json", cfg)
    m = json.loads((tiny.REPO / "bench_port/mixes/solve_long_fem.json").read_text())
    m.update(mix)
    tiny.write(root / "bench_port/mixes/tiny_fem.json", m)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny_fem", "source": "x", "file": "bench_port/configs/tiny_fem.json",
        "reduced": sorted(config), "why": "a rehearsal"})
    bench["workloads"].append({"name": "tiny_fem.nev10", "config": "tiny_fem",
                               "traffic": "tiny_fem", "chips": 1,
                               "why": "a rehearsal"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("tiny_fem.nev10")
    tiny.write(root / "BENCHMARK.json", bench)
    return root


def _replace_solve(r, make):
    control._replace(r, solve=make(r.problem.solve))


def solve_without_m(r):
    """The solve hands lobpcg no B: K x = lambda x, M dropped."""
    _replace_solve(r, lambda solve: lambda p, X0, config, gen, **kw: solve(
        dataclasses.replace(p, B=None), X0, config, gen, **kw))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _run(root, capsys, trace=0, patch=None, seed=2**31 + 91, device="cpu",
         cell="tiny_fem.nev10"):
    code = run.run(["--workload", cell, "--seed", str(seed),
                    "--seconds", "0.3", "--trace", str(trace)], root=root,
                   device=device, patch=patch)
    out = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(out[-1]) if out else None


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(root, capsys):
    code, res = _run(root, capsys)
    assert code == 0 and res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"solve_s", "peak_gib", "setup_s"}
    assert res["checks"]["unconverged"]["value"] == 0
    assert res["checks"]["resid"]["value"] <= 1e-5


def test_the_traced_request_is_capped_and_reads_b(root, capsys):
    """--trace 1: the capped slice traced; K3's metric absent on the CPU
    (the plain gather launches no ell_tile_kernel); the B-apply reader
    finds the solve's lobpcg.apply.B spans (no device work on the CPU)."""
    code, res = _run(root, capsys, trace=1)
    assert code == 0 and res["correct"] is True
    assert res["notes"] == {"traced_iterations": 8, "untraced_iterations": 8}
    metrics = res["metrics"]
    assert "k3_ms_per_iter" not in metrics and "k2_ms_per_iter" not in metrics
    assert metrics["b_apply_ms_per_iter"]["value"] == 0.0
    assert 0 < metrics["search_live_share"]["value"] < 100
    assert metrics["iterations"]["value"] > 8


@pytest.mark.parametrize("fault", [lap3d.solve_unchanged, lap3d.solve_half,
                                   lap3d.solve_altered, solve_without_m])
def test_each_fault_is_not_correct(root, capsys, fault):
    code, res = _run(root, capsys, patch=fault)
    assert code == 0 and res["correct"] is False and res["failed"] >= 1


def test_the_rounded_control_is_not_correct(root, capsys):
    """K's and M's stored values and their operands rounded to TF32's 10
    mantissa bits: the pencil moves, and the comparison sees it."""
    code, res = _run(root, capsys, patch=control_bsr.rounded)
    assert code == 0 and res["correct"] is False
    assert res["checks"]["eig_rel_err"]["value"] > 1e-5


def test_the_control_rounds_values_and_operands():
    """The control's operators hold K's and M's values rounded and apply
    them to the operand rounded: their product is the plain product of
    the two rounded factors; the problem's other fields stay."""
    cfg = json.loads((tiny.REPO / "bench_port/configs/fem3d_q1.json").read_text())
    cfg = {**cfg, **TINY_CONFIG}
    r = types.SimpleNamespace(problem=spec.load_module(
        tiny.REPO / "bench_port/problems/fem3d.py"))
    control_bsr.rounded(r)
    assert r.per_pass == 1
    p = r.problem.build(cfg, "cpu", operator="BSROperator")
    plain = spec.load_module(tiny.REPO / "bench_port/problems/fem3d.py").build(
        cfg, "cpu")
    assert p.n == plain.n and p.dtype == plain.dtype
    X = torch.rand((p.n, 16), generator=torch.Generator().manual_seed(6)) - 0.5
    Xr = control_bsr.round_tf32(X)
    assert not torch.equal(Xr, X)
    for got, op in ((p.A, plain.A), (p.B, plain.B)):
        assert torch.equal(got.blocks, control_bsr.round_tf32(op.blocks))
        assert not torch.equal(got.blocks, op.blocks)
        want = dataclasses.replace(op, blocks=got.blocks,
                                   win_vals=got.win_vals).matmat(Xr)
        assert torch.equal(got.matmat(X), want)


def test_the_bsr_cells_control_is_not_correct(tmp_path, capsys):
    """lap3d through BSROperator: its stored values are whole multiples of
    the scale, so the rounding moves A by a scalar factor alone; the
    operands rounded leave the solve short of tol."""
    bsr = lap3d.make_root(tmp_path, mix={**lap3d.TINY_MIX,
                                         "operator": "BSROperator"})
    code, res = _run(bsr, capsys, cell="tiny_lap.nd", patch=control_bsr.rounded)
    assert code == 0 and res["correct"] is False


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -25921.0, 155526.0, 3.0e-7], dtype=torch.float32)
    got = control_bsr.round_tf32(x)
    assert got.tolist()[:6] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9,
                                -25920.0, 155520.0]
    assert abs(float(got[6]) / 3.0e-7 - 1) <= 2**-11
    assert torch.equal(control_bsr.round_tf32(got), got)


@pytest.mark.parametrize("cell", ["fem3d_q1.nev10", "lap3d_160.bsr"])
def test_k3_goes_to_its_own_metric(cell):
    """K3's kernel, as the profiler names it, is claimed by k3_ms_per_iter
    and by no metric earlier in per_layer's order."""
    c = spec.load_cell(tiny.REPO, cell)
    partition = [(m["name"], c.layer(m["name"]).KERNELS)
                 for m in c.all_per_layer
                 if hasattr(c.layer(m["name"]), "KERNELS")]
    name = ("void (anonymous namespace)::ell_tile_kernel<16, true>(int const*, "
            "float const*, float const*, float*, long, long, long, long, int, "
            "int, int, int, long, long, long)")
    tr = trace.Trace(kernels={name: [1.0, 1]}, busy_s=1.0, window_s=1.0,
                     idle_gaps=[])
    assert trace.claim(tr, partition) == ({"k3_ms_per_iter": 1.0}, None)
    assert "k3_ms_per_iter" in {m["name"] for m in c.per_layer}


def _event(name, ts, dur, cat="user_annotation", tid=1, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}
    if args:
        e["args"] = args
    return e


def test_b_seconds_attributes_by_the_innermost_span():
    """Device work launched inside lobpcg.apply.B counts, wherever that
    span lies (an orthogonalization, a Rayleigh-Ritz); work launched in
    lobpcg.apply.A, in a phase outside any apply, or outside the solve
    does not."""
    reader = spec.load_module(tiny.REPO / "bench_port/layers/b_apply_ms_per_iter.py")
    launches = [(11, 1), (21, 2), (31, 3), (41, 4), (205, 5)]
    chrome = {"traceEvents": [
        _event("lobpcg.solve", 0, 200),
        _event("lobpcg.apply.B", 10, 5),
        _event("lobpcg.ortho", 20, 30),
        _event("lobpcg.apply.B", 30, 5),
        _event("lobpcg.apply.A", 40, 5),
        *[_event("cudaLaunchKernel", t, 1, cat="cuda_runtime", correlation=c)
          for t, c in launches],
        _event("ell_tile_kernel", 100, 10, cat="kernel", tid=7, correlation=1),
        _event("gram", 120, 20, cat="kernel", tid=7, correlation=2),
        _event("ell_tile_kernel", 150, 30, cat="kernel", tid=7, correlation=3),
        _event("ell_tile_kernel", 190, 7, cat="kernel", tid=7, correlation=4),
        _event("ell_tile_kernel", 300, 9, cat="kernel", tid=7, correlation=5),
    ]}
    assert reader.b_seconds(chrome) == pytest.approx(40e-6)
    no_b = {"traceEvents": [e for e in chrome["traceEvents"]
                            if e["name"] != "lobpcg.apply.B"]}
    assert reader.b_seconds(no_b) is None
    assert reader.b_seconds({"traceEvents": []}) is None


@pytest.mark.gpu
def test_on_the_card_sound_is_correct_and_the_control_not(tmp_path, capsys):
    """On the card, a 32^3 grid: sound is correct and reads K3 and B's
    applies; the rounded control is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = make_root(tmp_path, config=GPU_CONFIG, mix=GPU_MIX)
    code, res = _run(card, capsys, trace=1, device=None, seed=5)
    assert code == 0 and res["correct"] is True, res["checks"]
    assert res["metrics"]["k3_ms_per_iter"]["value"] > 0
    assert 0 < res["metrics"]["b_apply_ms_per_iter"]["value"] < \
        res["metrics"]["apply_ms_per_iter"]["value"]
    code, res = _run(card, capsys, device=None, seed=5,
                     patch=control_bsr.rounded)
    assert code == 0 and res["correct"] is False
