"""On the card: whole runs of small cells of the well pencil, sound and
under the control (TF32, one precision below the configuration's), and
the comparison has to tell them apart.  The control at the cells' own
sizes is ``bench_port/control.py``; these tests hold it at a size a test
run can hold (n 40,000 with the real well of 1,024 sites).

    python3 -m pytest bench_port/tests -m gpu -q
"""

from __future__ import annotations

import json

import pytest
import torch

from bench_port import control, run
from bench_port.tests import tiny

GPU_CONFIG = {"n": 40_000, "well": 1024, "cheb_chunk": 0}
GPU_SOLVE = {"kind": "solve", "nev": 16, "size_sub": 24, "pool": 4,
             "pool_seed": 0, "limits": {"eig_rel_err": 2e-5}}
GPU_APPLY = {"kind": "apply", "k": 64, "limits": {"y_err": 3e-6}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path, config=GPU_CONFIG, solve_mix=GPU_SOLVE,
                          apply_mix=GPU_APPLY)


def _result(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("traffic", ["solve", "apply"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_sound_run_is_correct(card, root, capsys, traffic, seed):
    assert run.run(["--workload", f"tiny_well.{traffic}", "--seed", str(seed),
                    "--seconds", "1", "--trace", "1"], root=root) == 0
    res = _result(capsys)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("traffic", ["solve", "apply"])
def test_tf32_control_is_not_correct(card, root, capsys, traffic):
    assert run.run(["--workload", f"tiny_well.{traffic}", "--seed", "11",
                    "--seconds", "1"], root=root,
                   patch=control.CONTROLS[traffic]) == 0
    assert _result(capsys)["correct"] is False
