"""The per-layer metrics that read the program's spans (``spans.py``):
their arithmetic on a trace made by hand, a whole ``--trace 1`` rehearsal
with and without them (the metrics that were there read the same), and
on the card a small cell that reports all six.

    python3 -m pytest bench_port/tests/test_bench_port_spans.py -q
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import shutil

import pytest
import torch

from bench_port import run, spans, spec, trace
from bench_port.tests import tiny

SPAN_METRICS = ("apply_ms_per_iter", "ortho_ms_per_iter", "rr_ms_per_iter",
                "update_ms_per_iter", "host_syncs_per_iter",
                "sync_idle_share")
NEW_FILES = ["spans.py"] + [f"layers/{m}.py" for m in SPAN_METRICS]


def _chrome(events):
    return {"traceEvents": [dict(ph="X", pid=1, **e) for e in events]}


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": 7}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": 7, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# One solve of two iterations on a made-up clock (us): launches inside
# apply.T, ortho (and an apply.B inside it), rr, update, one between
# phases and one outside the solve; a read that waits on the device.
EVENTS = [
    _span("lobpcg.solve", 0, 200),
    _span("lobpcg.iter", 10, 90),
    _span("lobpcg.apply.T", 11, 9),
    _launch(12, 1), _kernel("stencil1d_kernel", 13, 20, 1),
    _span("lobpcg.ortho", 21, 29),
    _launch(22, 2), _kernel("gemm_a", 33, 10, 2),
    _span("lobpcg.apply.B", 23, 4),
    _launch(24, 3), _kernel("tail_antidiag_kernel", 43, 5, 3),
    _span("lobpcg.sync.read", 30, 19),  # the device drains at 48: waits
    _span("lobpcg.rr", 50, 20),
    _launch(60, 4), _kernel("syevd", 61, 4, 4),
    _span("lobpcg.sync.eigh", 62, 5),
    _launch(80, 5), _kernel("elementwise", 81, 2, 5),  # between phases
    _span("lobpcg.iter", 100, 90),
    _span("lobpcg.update", 101, 40),
    _launch(102, 6), _kernel("tail_residual_kernel", 103, 7, 6),
    _launch(300, 7), _kernel("outside", 301, 9, 7),  # after the solve
    {"cat": "cpu_op", "name": "aten::mm", "ts": 22, "dur": 2, "tid": 7},
]


def test_attribution_on_a_trace_made_by_hand():
    """Each kernel to the innermost phase open at its launch (apply.B
    inside ortho counts as apply); the launch between phases is unphased,
    the one after the solve counted nowhere; gaps inside the solve split
    by whether a sync span was open as each opened."""
    s = spans.attribute(_chrome(EVENTS))
    assert s.phase_s == pytest.approx({"apply": 25e-6, "ortho": 10e-6,
                                       "rr": 4e-6, "update": 7e-6,
                                       "unphased": 2e-6})
    assert s.syncs == 2
    # Device busy 13-48, 61-65, 81-83, 103-110, 301-310: gaps of 13, 16,
    # 20 and 191 us, each ending at the launch of the operation after it
    # (60, 80, 102, 300 on the host's clock): 47-60 (in ortho, sync.read
    # open), 64-80 (in rr, sync.eigh open), 82-102 (between phases) and
    # 109-300, of which 109-200 lies in the solve (in update).
    assert s.idle_s == pytest.approx((13 + 16 + 20 + 91) * 1e-6)
    assert s.sync_idle_s == pytest.approx(29e-6)
    want = {"apply": [0.0, 0.0], "ortho": [13e-6, 0.0], "rr": [16e-6, 0.0],
            "update": [0.0, 91e-6], "unphased": [0.0, 20e-6]}
    assert set(s.idle_by_phase) == set(want)
    for phase, split in want.items():
        assert s.idle_by_phase[phase] == pytest.approx(split)
    assert s.kernels["apply"] == pytest.approx(
        {"stencil1d_kernel": 20e-6, "tail_antidiag_kernel": 5e-6})
    assert spans.attribute(_chrome([e for e in EVENTS if not e["name"]
                                    .startswith("lobpcg.")])) is None


@pytest.mark.parametrize("skew", [-24000.0, 500.0])
def test_the_device_clock_is_not_read_against_the_host(skew):
    """Device times off the host's (as the profiler gives them in some
    profiles, by milliseconds): attribution and the idle split are the
    same, each gap placed by the launch of the operation that ends it."""
    skewed = [dict(e, ts=e["ts"] + skew) if e["cat"] == "kernel" else e
              for e in EVENTS]
    assert spans.attribute(_chrome(skewed)) == spans.attribute(
        _chrome(EVENTS))


def _readers_root(tmp_path, events) -> tuple:
    """A root with this folder's harness and a trace written now, and
    the Observation a run would hold for it."""
    root = tiny.make_root(tmp_path)
    path = root / spans.TRACES / "tiny_well.solve.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(_chrome(events)))
    tr = trace.reduce(_chrome(events), wall=2e-4)
    obs = trace.Observation(trace=tr, traced_iterations=2,
                            untraced_wall_s=1e-4)
    return root, obs


def test_the_six_readers_on_a_trace_made_by_hand(tmp_path):
    root, obs = _readers_root(tmp_path, EVENTS)
    cell = spec.load_cell(root, "tiny_well.solve")
    got = {m: cell.layer(m).read(obs) for m in SPAN_METRICS}
    busy = obs.trace.busy_s
    idle_share = 100.0 * (1.0 - busy / 1e-4)
    assert got == pytest.approx({
        "apply_ms_per_iter": 25e-3 / 2, "ortho_ms_per_iter": 10e-3 / 2,
        "rr_ms_per_iter": 4e-3 / 2, "update_ms_per_iter": 7e-3 / 2,
        "host_syncs_per_iter": 1.0,
        "sync_idle_share": idle_share * 29 / 140})
    # Another trace than the one the run reduced: every reader is silent.
    other = trace.Observation(trace=dataclass_busy(obs.trace, 1.0),
                              traced_iterations=2, untraced_wall_s=1e-4)
    assert all(cell.layer(m).read(other) is None for m in SPAN_METRICS)


def dataclass_busy(tr, busy):
    return trace.Trace(kernels=tr.kernels, busy_s=busy, window_s=tr.window_s,
                       idle_gaps=tr.idle_gaps)


def test_readers_are_silent_on_a_program_without_spans(tmp_path):
    """The parent of this harness has no spans: a trace without them, or
    no trace written by this process, gives None and raises nothing."""
    events = [e for e in EVENTS if not e["name"].startswith("lobpcg.")]
    root, obs = _readers_root(tmp_path, events)
    cell = spec.load_cell(root, "tiny_well.solve")
    assert all(cell.layer(m).read(obs) is None for m in SPAN_METRICS)
    path = root / spans.TRACES / "tiny_well.solve.json"
    os.utime(path, (1.0, 1.0))  # written before this process started
    root2, obs2 = _readers_root(tmp_path / "b", EVENTS)
    os.utime(root2 / spans.TRACES / "tiny_well.solve.json", (1.0, 1.0))
    assert all(spec.load_cell(root2, "tiny_well.solve").layer(m).read(obs2)
               is None for m in SPAN_METRICS)


def _without_span_metrics(root: pathlib.Path) -> None:
    """The root as the harness was before these metrics: their files and
    their entries taken out."""
    for f in NEW_FILES:
        (root / "bench_port" / f).unlink()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] not in SPAN_METRICS]
    tiny.write(root / "BENCHMARK.json", bench)


def _rehearse(root, capsys) -> dict:
    assert run.run(["--workload", "tiny_well.solve", "--seed", str(2**31 + 9),
                    "--seconds", "0.2", "--trace", "1"], root=root,
                   device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rehearsal_with_and_without_the_span_metrics(tmp_path, capsys):
    """A whole --trace 1 run of the tiny cell on the CPU: the span
    readers report (the four phases at 0 ms, the CPU has no device work;
    sync_idle_share needs device_idle_share, which the CPU leaves out),
    and every metric that was there reads the same without them."""
    with_root = tiny.make_root(tmp_path / "with")
    without_root = tiny.make_root(tmp_path / "without")
    _without_span_metrics(without_root)
    shutil.rmtree(without_root / "bench_port" / ".traces", ignore_errors=True)
    got = _rehearse(with_root, capsys)
    base = _rehearse(without_root, capsys)
    assert got["correct"] and base["correct"]
    new = {m: got["metrics"][m]["value"] for m in SPAN_METRICS
           if m in got["metrics"]}
    assert set(new) == set(SPAN_METRICS) - {"sync_idle_share"}
    assert all(isinstance(v, float) and math.isfinite(v) for v in new.values())
    assert new["host_syncs_per_iter"] > 0
    assert all(new[m] == 0.0 for m in SPAN_METRICS[:4])
    assert {m: v for m, v in got["metrics"].items()
            if m not in SPAN_METRICS} == base["metrics"]
    assert got["breakdown"]["device_ops"] == base["breakdown"]["device_ops"]


@pytest.mark.gpu
def test_span_metrics_on_the_card(tmp_path, capsys):
    """A small solve cell on the card reports all six, and the phases
    plus the unphased work make up the traced solve's device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny.make_root(tmp_path, config={"n": 40_000, "well": 1024,
                                            "cheb_chunk": 0},
                          solve_mix={"kind": "solve", "nev": 16,
                                     "size_sub": 24, "pool": 4, "pool_seed": 0,
                                     "limits": {"eig_rel_err": 2e-5}})
    assert run.run(["--workload", "tiny_well.solve", "--seed", "5",
                    "--seconds", "1", "--trace", "1"], root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    got = {m: res["metrics"][m]["value"] for m in SPAN_METRICS}
    assert all(math.isfinite(v) and v >= 0 for v in got.values())
    assert got["host_syncs_per_iter"] > 0
    assert got["sync_idle_share"] <= res["metrics"]["device_idle_share"][
        "value"]
    assert got["rr_ms_per_iter"] >= res["metrics"]["cusolver_ms_per_iter"][
        "value"]
    assert got["apply_ms_per_iter"] >= res["metrics"]["k1_ms_per_iter"][
        "value"]
