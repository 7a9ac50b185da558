"""Whole runs on the CPU, past the look for a card, with the timed path
broken underneath: each fault a cell can have has to make ``correct``
come out false.  The cells run on one card, so there is no exchange
between cards to leave out.  Also: a run that finds JAX loaded prints no
result, and without a card the command prints none."""

from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import types

import pytest
import torch

from bench_port import control, run
from bench_port.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def _run(root, capsys, traffic, patch=None, seed=17):
    code = run.run(["--workload", f"tiny_well.{traffic}", "--seed", str(seed),
                    "--seconds", "0.3"], root=root, device="cpu", patch=patch)
    out = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(out[-1]) if out else None


class _Identity:
    """An operator whose apply returns its input."""

    def __init__(self, like):
        self.like = like

    def __getattr__(self, name):
        return getattr(self.like, name)

    def matmat(self, X):
        return X.clone()


def solve_unchanged(r):
    """Every apply of A returns its state unchanged (A X = X)."""
    solve = r.problem.solve
    control._replace(r, solve=lambda p, X0, config, gen: solve(
        dataclasses.replace(p, A=_Identity(p.A)), X0, config, gen))


def solve_half(r):
    """Half of the answer's pairs left out, the rest repeated in their place."""
    solve = r.problem.solve

    def broken(p, X0, config, gen):
        res = solve(p, X0, config, gen)
        h = res.eigenvalues.shape[0] // 2
        return res._replace(
            eigenvalues=torch.cat([res.eigenvalues[:h]] * 2)[:res.eigenvalues.shape[0]],
            eigenvectors=torch.cat([res.eigenvectors[:, :h]] * 2, 1)[:, :res.eigenvalues.shape[0]])

    control._replace(r, solve=broken)


def solve_altered(r):
    """One eigenvalue altered by a part in 10^4 where it is produced."""
    solve = r.problem.solve

    def broken(p, X0, config, gen):
        res = solve(p, X0, config, gen)
        lam = res.eigenvalues.clone()
        lam[-1] *= 1 + 1e-4
        return res._replace(eigenvalues=lam)

    control._replace(r, solve=broken)


def apply_unchanged(r):
    control._replace(r, apply=lambda p, X: X.clone())


def apply_half(r):
    apply = r.problem.apply

    def broken(p, X):
        h = X.shape[1] // 2
        return torch.cat([apply(p, X[:, :h]), torch.zeros_like(X[:, h:])], 1)

    control._replace(r, apply=broken)


def apply_altered(r):
    apply = r.problem.apply

    def broken(p, X):
        Y = apply(p, X)
        Y[Y.shape[0] // 3, 1] *= 1 + 1e-3
        return Y

    control._replace(r, apply=broken)


@pytest.mark.parametrize("traffic", ["solve", "apply"])
def test_sound_runs_are_correct(root, capsys, traffic):
    code, res = _run(root, capsys, traffic)
    assert code == 0 and res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"


def test_the_window_ends_at_a_whole_pass(root, capsys):
    """Each run solves every start of the pool equally often, in an order
    of its seed's: the seed orders the work and never changes it."""
    runs = []
    for seed in (3, 2**31 + 7):
        code, res = _run(root, capsys, "solve", patch=runs.append, seed=seed)
        assert code == 0 and res["correct"] is True
    for r in runs:
        counts = collections.Counter(a[0] for a in r.answers)
        assert set(counts) == set(range(r.pool))
        assert len(set(counts.values())) == 1
    assert [a[0] for a in runs[0].answers] != [a[0] for a in runs[1].answers]


@pytest.mark.parametrize("traffic, fault", [
    ("solve", solve_unchanged), ("solve", solve_half), ("solve", solve_altered),
    ("apply", apply_unchanged), ("apply", apply_half), ("apply", apply_altered),
])
def test_each_fault_is_not_correct(root, capsys, traffic, fault):
    code, res = _run(root, capsys, traffic, patch=fault)
    assert code == 0 and res["correct"] is False and res["failed"] >= 1


def test_jax_loaded_means_no_result(root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, res = _run(root, capsys, "apply")
    assert code != 0 and res is None
    assert run.forbidden_modules() == ["jax"]


def test_the_command_needs_a_card_and_the_port(tmp_path):
    """Without a card (this CPU sandbox), and in a directory holding only
    BENCHMARK.json and the harness, the command exits non-zero and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for where in (tiny.REPO, tiny.make_root(tmp_path)):
        p = subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload",
             "bdg_well_4M.apply_k256", "--seed", "1", "--seconds", "1"],
            cwd=where, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_rehearsal_loads_no_jax(root):
    """A whole CPU run in a fresh process: no module whose top-level name
    is jax, jaxlib, flax or lobpcg_tpu (compared whole; lobpcg_tpu_torch
    is the port), and the reference alone loads nothing of the port."""
    code = f"""
import sys, json
sys.path.insert(0, {str(tiny.REPO)!r})
from bench_port import run, spec
rc = run.run(["--workload", "tiny_well.solve", "--seed", "5", "--seconds",
              "0.2", "--trace", "1"], root={str(root)!r}, device="cpu")
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"rc": rc, "top": top}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tiny.REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and "lobpcg_tpu_torch" in got["top"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "lobpcg_tpu"}
    ref = f"""
import sys
sys.path.insert(0, {str(tiny.REPO)!r})
from bench_port import spec
spec.load_module({str(tiny.REPO / "bench_port/reference/bdg_well.py")!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", ref], capture_output=True,
                       text=True, timeout=300, cwd=tiny.REPO)
    assert "lobpcg_tpu_torch" not in p.stdout and "'jax'" not in p.stdout
