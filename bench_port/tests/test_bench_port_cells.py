"""BENCHMARK.json against the contract, every cell found by name, a new
cell made of new files only, and the yardstick's arithmetic."""

from __future__ import annotations

import hashlib
import json
import math
import pathlib
import re

import pytest

from bench_port import roofline, run, seeds, spec, trace
from bench_port.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"][1].startswith("bench_port/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith(
            "bench_port/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert w in CELLS and w in reports


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = spec.load_cell(REPO, name)
    assert hasattr(cell.driver(), "Run")
    problem, reference = cell.problem(), cell.reference()
    for fn in ("build", "solver_config", "well_draws", "start", "solve",
               "apply"):
        assert callable(getattr(problem, fn))
    assert callable(reference.eigenvalues) and callable(reference.apply)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.all_per_layer:
        assert callable(cell.layer(m["name"]).read)
    for key in cell.mix["limits"]:
        assert cell.mix["limits"][key] is not None


def _digest(folder: pathlib.Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".traces" not in p.parts}


def test_a_new_cell_of_new_files_only_is_found(tmp_path, capsys):
    """A configuration, a mix, a per-layer metric and a cell added as new
    files and entries: found by name, run, and reported, while every file
    that was there is unchanged."""
    root = tiny.make_root(tmp_path)
    before = _digest(root / "bench_port")
    tiny.write(root / "bench_port/configs/dummy_well.json",
               dict(json.loads((root / "bench_port/configs/tiny_well.json")
                               .read_text()), name="dummy_well", n=1000))
    tiny.write(root / "bench_port/mixes/dummy_mix.json",
               dict(tiny.SOLVE_MIX, nev=3, size_sub=6))
    (root / "bench_port/layers/slowest_iterations.py").write_text(
        '"""Host loop: the most iterations a solve of the window took."""\n\n\n'
        "def read(obs):\n"
        "    return max(obs.iterations) if obs.iterations else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_well", "source": "x",
                             "file": "bench_port/configs/dummy_well.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_well.dummy", "chips": 1,
                               "config": "dummy_well", "traffic": "dummy_mix",
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append("dummy_well.dummy")
    bench["per_layer"].append({
        "name": "slowest_iterations", "unit": "iter", "better": "lower",
        "source": "program_counter", "layer": "host loop",
        "moves": "solve_s", "workloads": ["dummy_well.dummy"]})
    tiny.write(root / "BENCHMARK.json", bench)
    added = set(_digest(root / "bench_port")) - set(before)
    assert all(_digest(root / "bench_port")[f] == h for f, h in before.items())
    assert added == {"configs/dummy_well.json", "mixes/dummy_mix.json",
                     "layers/slowest_iterations.py"}

    cell = spec.load_cell(root, "dummy_well.dummy")
    assert cell.config["n"] == 1000 and cell.mix["nev"] == 3
    assert run.run(["--workload", "dummy_well.dummy", "--seed", "9",
                    "--seconds", "0.2", "--trace", "1"], root=root,
                   device="cpu") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"slowest_iterations"}
    assert res["metrics"]["slowest_iterations"]["value"] > 0


def test_nnz_and_bytes_of_the_well_operator():
    n, k = 4_000_000, 256
    m = n // 2
    assert roofline.stencil_nnz(n, 2) == 2 * (3 * m - 2) == 11_999_996
    assert roofline.stencil_diag_bytes(n, k) == 2 * n * k * 4 + n * 4 \
        == 8_208_000_000
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert roofline.hbm_bytes_per_s("some other card") is None


def test_seeds_are_reproducible_and_apart():
    big = 2**31 + 12345
    assert seeds.derive(big, 3, seeds.START) == seeds.derive(big, 3, seeds.START)
    drawn = {seeds.derive(s, i, st) for s in (0, 1, big, -big)
             for i in (-1, 0, 1) for st in (seeds.START, seeds.SOLVER)}
    assert len(drawn) == 24 and all(0 <= d < 2**63 for d in drawn)


def _chrome(events):
    return {"traceEvents": [dict(ph="X", pid=1, **e) for e in events]}


def test_trace_reduce_busy_gaps_and_claims():
    """Busy is the union of device work; each idle gap is named by the
    innermost host operation open when it began; each kernel goes to the
    first metric whose pattern it holds, the rest to no metric."""
    chrome = _chrome([
        {"cat": "cpu_op", "name": "aten::eigh", "ts": 0, "dur": 100, "tid": 7},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 25,
         "dur": 20, "tid": 7},
        {"cat": "cpu_op", "name": "aten::empty", "ts": 101, "dur": 1, "tid": 7},
        {"cat": "cpu_op", "name": "side", "ts": 0, "dur": 100, "tid": 8},
        {"cat": "kernel", "name": "stencil1d_kernel<F32>", "ts": 0, "dur": 20},
        {"cat": "kernel", "name": "gemm_a", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "syevj_b", "ts": 50, "dur": 10},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 5},
        {"cat": "kernel", "name": "vectorized_elementwise", "ts": 80,
         "dur": 5},
    ])
    tr = trace.reduce(chrome, wall=1e-4)
    assert math.isclose(tr.busy_s, 50e-6)
    names = dict(tr.idle_gaps)
    assert math.isclose(names["aten::eigh > cudaMemcpyAsync"], 20e-6)
    assert math.isclose(names["aten::eigh"], 15e-6)
    assert tr.device_ops()[0][0] in ("stencil1d_kernel<F32>", "gemm_a")
    partition = [("k1_ms_per_iter", ("stencil1d_kernel",)),
                 ("gemm_ms_per_iter", ("gemm", "syevj")),
                 ("cusolver_ms_per_iter", ("syevj",)),
                 ("tail_kernels_ms_per_iter", ("tail_",))]
    claimed, rest = trace.claim(tr, partition)
    assert claimed == pytest.approx({"k1_ms_per_iter": 20e-6,
                                     "gemm_ms_per_iter": 30e-6})
    assert rest == pytest.approx(10e-6)
    obs = trace.Observation(trace=tr, traced_iterations=2, claimed_s=claimed,
                            unclaimed_s=rest)
    cell = spec.load_cell(REPO, CELLS[0])
    assert cell.layer("k1_ms_per_iter").read(obs) == pytest.approx(0.01)
    assert cell.layer("tail_kernels_ms_per_iter").read(obs) is None
    assert cell.layer("elementwise_ms_per_iter").read(obs) == \
        pytest.approx(0.005)


@pytest.mark.parametrize("kernel, metric", [
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_stage3_warpsize1x4x1"
     "_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "gemm_ms_per_iter"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nt_align1>"
     "(cutlass_80_simt_sgemm_64x64_8x5_nt_align1::Params)", "gemm_ms_per_iter"),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_tn_n_tilesize32x32x32_stage5_warpsize2x2x1"
     "_tensor16x8x16_aligna8_alignc8_execute_kernel__5x_cublas", "cusolver_ms_per_iter"),
    ("sm90_xmma_syr2k_l_f64f64_f64f64_f64_nt_n_tilesize32x32x32_stage5_warpsize2x2x1"
     "_tensor16x8x16_execute_kernel__5x_cublas", "cusolver_ms_per_iter"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_d884gemm_32x32_16x5_tn_align1>"
     "(cutlass_80_tensorop_d884gemm_32x32_16x5_tn_align1::Params)", "cusolver_ms_per_iter"),
    ("void ormtr_gemv_c<double, 4>(long, long, double const*, long, long, double const*, "
     "long, int, double*, long)", "cusolver_ms_per_iter"),
    ("void sytrd4_gpu<sytrd_params<double, 32, 8, 512, 32, 16, 1, 2> >(int)",
     "cusolver_ms_per_iter"),
    ("void (anonymous namespace)::tail_combine_kernel<float, 4>((anonymous namespace)"
     "::Terms<float>)", "tail_kernels_ms_per_iter"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)"
     "::pow_tensor_scalar_kernel_impl<float, float>", None),
])
def test_kernels_go_to_their_layer(kernel, metric):
    """Float32 GEMMs are the tall contractions'; float64 GEMMs (cuSOLVER's
    own among them) the k x k layer's; PyTorch's float32 elementwise no
    metric's, so elementwise_ms_per_iter."""
    cell = spec.load_cell(REPO, "bdg_well_4M.nev56")
    partition = [(m["name"], cell.layer(m["name"]).KERNELS)
                 for m in cell.all_per_layer
                 if hasattr(cell.layer(m["name"]), "KERNELS")]
    tr = trace.Trace(kernels={kernel: [1.0, 1]}, busy_s=1.0, window_s=1.0,
                     idle_gaps=[])
    claimed, rest = trace.claim(tr, partition)
    assert claimed == ({metric: 1.0} if metric else {})
    assert rest == (None if metric else 1.0)
