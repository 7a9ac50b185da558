"""The benchmark's 3-D Laplacian cell (``bench_port``'s ``lap3d``
problem) against its plain reference, on the CPU at small grids: the
port's operators against the reference's float64 stencil, the port's
solve judged by the reference's closed-form eigenvalues and backward
errors under the cell's own limits, and the solver's count of live
search columns against a count rebuilt from the solve's history."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as lt
from lobpcg_tpu_torch.solvers import lobpcg as lobpcg_mod

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from bench_port import spec  # noqa: E402

torch.set_num_threads(2)

REF = spec.load_module(REPO / "bench_port/reference/lap3d.py")
PROBLEM = spec.load_module(REPO / "bench_port/problems/lap3d.py")
CFG = json.loads((REPO / "bench_port/configs/lap3d_160.json").read_text())
MIX = json.loads((REPO / "bench_port/mixes/solve_long_nd.json").read_text())
SMALL = {**CFG, "grid": [10, 10, 10], "scale": 121.0}  # h = 1/11
NEV, SIZE_SUB = int(MIX["nev"]), int(MIX["size_sub"])


def _cfg(grid, scale=7.0, dtype="float32"):
    return {**CFG, "grid": list(grid), "scale": scale, "dtype": dtype}


def _dense(cfg) -> np.ndarray:
    n = int(np.prod(cfg["grid"]))
    return REF.apply(cfg, torch.eye(n, dtype=torch.float64)).numpy()


@pytest.mark.parametrize("grid", [(6, 7, 9), (9, 6, 7), (3, 4, 5)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_laplacian_nd_matches_the_reference_apply(grid, dtype):
    """LaplacianND (K2's plain version in float32, the pad/slice formula in
    float64) is the reference's stencil on the same C-order grid; a
    non-cubic grid catches an axis-order mismatch."""
    cfg = _cfg(grid, dtype=dtype)
    p = PROBLEM.build(cfg, "cpu")
    X = (torch.rand((p.n, 5), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64) - 0.5).to(p.dtype)
    got = PROBLEM.apply(p, X).double()
    want = REF.apply(cfg, X.double())
    eps = torch.finfo(p.dtype).eps
    tol = 16 * eps * 12 * cfg["scale"] * float(X.abs().max())
    assert float((got - want).abs().max()) <= tol
    other = REF.apply(_cfg(grid[::-1], dtype=dtype), X.double())
    assert float((other - want).abs().max()) > 1e3 * tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_bsr_route_matches_the_reference_apply(dtype):
    """build's BSROperator branch (laplacian_3d_csr -> BSROperator, K3's
    plain gather on the CPU) at the 10^3 grid of the solve test."""
    cfg = {**SMALL, "dtype": dtype}
    p = PROBLEM.build(cfg, "cpu", operator="BSROperator")
    assert isinstance(p.A, lt.BSROperator)
    X = (torch.rand((p.n, 16), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64) - 0.5).to(p.dtype)
    got = PROBLEM.apply(p, X).double()
    want = REF.apply(cfg, X.double())
    tol = 16 * torch.finfo(p.dtype).eps * 12 * cfg["scale"] * float(X.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_build_refuses_an_unknown_operator():
    with pytest.raises(ValueError, match="operator"):
        PROBLEM.build(SMALL, "cpu", operator="Dense")


def test_reference_eigenvalues_and_norm_are_the_dense_spectrum():
    """The closed form against numpy's dense solver of the reference's own
    stencil on a non-cubic grid."""
    cfg = _cfg((3, 4, 5), scale=2.5)
    spectrum = np.linalg.eigvalsh(_dense(cfg))
    np.testing.assert_allclose(REF.eigenvalues(cfg, 12), spectrum[:12],
                               rtol=1e-12)
    np.testing.assert_allclose(REF.norm(cfg), spectrum[-1], rtol=1e-12)


def test_reference_residuals_judge_eigenpairs():
    cfg = _cfg((4, 5, 3), scale=3.0)
    lam, U = np.linalg.eigh(_dense(cfg))
    res = REF.residuals(cfg, lam[:4], torch.from_numpy(U[:, :4]))
    assert res.shape == (4,) and res.max() < 1e-14
    off = REF.residuals(cfg, lam[:4] * (1 + 1e-3), torch.from_numpy(U[:, :4]))
    assert off.min() > 1e-5


def test_the_cell_solve_meets_the_cells_limits():
    """The cell's solve (LaplacianND, float32, the cell's solver
    configuration) at a 10^3 grid, from a start drawn as the cell draws
    it, judged by the reference as the cell judges it: every pair
    converged, eigenvalues within the mix's eig_rel_err of the closed
    form, backward errors within the configuration's tol."""
    p = PROBLEM.build(SMALL, "cpu")
    config = PROBLEM.solver_config(SMALL, NEV, SIZE_SUB)
    X0 = PROBLEM.start(p, PROBLEM.well_draws(
        p, SIZE_SUB, torch.Generator().manual_seed(11)))
    r = PROBLEM.solve(p, X0, config, torch.Generator().manual_seed(12))
    assert r.converged == NEV
    lam = r.eigenvalues.double().numpy()
    exact = REF.eigenvalues(SMALL, NEV)
    assert float(np.max(np.abs(lam - exact) / exact)) <= \
        MIX["limits"]["eig_rel_err"]
    assert float(REF.residuals(SMALL, lam, r.eigenvectors).max()) <= \
        CFG["solver"]["tol"]
    capped = PROBLEM.solve(p, X0, config, torch.Generator().manual_seed(12),
                           it_cap=5)
    assert capped.iterations == 5 and capped.converged < NEV


def _count_p(monkeypatch):
    """rr.p_count ([b] in a batch) of the Rayleigh-Ritz each iteration
    keeps: where a call's flag is 2 (the Cholesky path failed) its retry's
    count replaces it."""
    counts, retried = [], [None]
    rr = lobpcg_mod.rayleigh_ritz_modified

    def recording(*args, **kwargs):
        out = rr(*args, **kwargs)
        if retried[0] is not None:
            counts[-1] = torch.where(retried[0], out.p_count, counts[-1])
            retried[0] = None
        else:
            counts.append(torch.as_tensor(out.p_count))
            flag = torch.as_tensor(out.flag) == 2
            retried[0] = flag if bool(flag.any()) else None
        return out

    monkeypatch.setattr(lobpcg_mod, "rayleigh_ritz_modified", recording)
    return counts


def _rebuilt(conv, p_counts, iterations, m):
    """Σ over a problem's own iterations of its live W columns (m on the
    first, m - converged after) and live P columns (the previous RR's
    p_count less the newly converged, within m - converged)."""
    want, p_next = 0, 0
    for i in range(iterations):
        want += (m - conv[i - 1] if i else m) + p_next
        p_next = min(max(int(p_counts[i]) - conv[i], 0), m - conv[i])
    return want


def _f64_history(cfg):
    cfg = {**cfg, "dtype": "float64"}
    cfg["solver"] = {**cfg["solver"], "record_history": True}
    p = PROBLEM.build(cfg, "cpu")
    return p, PROBLEM.solver_config(cfg, NEV, SIZE_SUB)


@pytest.mark.parametrize("grid, scale, seed", [((10, 10, 10), 121.0, 11),
                                               ((6, 7, 9), 100.0, 5)])
def test_live_cols_is_the_count_of_live_w_and_p(monkeypatch, grid, scale,
                                                seed):
    """live_cols against a count rebuilt from outside: W's live columns
    from the converged counts a record_history run records, P's from
    each RR's p_count compacted as the solver compacts it (float64, where
    no column of these problems drops); a Python int."""
    p, config = _f64_history(_cfg(grid, scale=scale))
    X0 = PROBLEM.well_draws(p, SIZE_SUB, torch.Generator().manual_seed(seed))
    p_counts = _count_p(monkeypatch)
    r = PROBLEM.solve(p, X0, config, torch.Generator().manual_seed(seed + 1))
    assert len(p_counts) == r.iterations
    conv = r.history.converged[:r.iterations].tolist()
    assert isinstance(r.live_cols, int)
    assert r.live_cols == _rebuilt(conv, p_counts, r.iterations, SIZE_SUB)
    assert SIZE_SUB * r.iterations < r.live_cols < 2 * SIZE_SUB * r.iterations


def test_live_cols_in_a_lockstep_batch_is_per_problem(monkeypatch):
    """Two problems in lockstep: each problem's count is rebuilt from its
    own history over its own iterations, so the one that finishes first
    stays frozen at its count while the other runs on."""
    p, config = _f64_history(SMALL)
    X0 = torch.stack([PROBLEM.well_draws(
        p, SIZE_SUB, torch.Generator().manual_seed(s)) for s in (21, 22)])
    p_counts = _count_p(monkeypatch)
    r = lt.lobpcg(p.A, X0, config=config,
                  generator=torch.Generator().manual_seed(1))
    its = r.iterations.tolist()
    assert its[0] != its[1] and len(p_counts) == max(its)
    for i in range(2):
        conv = r.history.converged[i, :its[i]].tolist()
        assert int(r.live_cols[i]) == _rebuilt(
            conv, [c[i] for c in p_counts], its[i], SIZE_SUB)


def test_the_reference_loads_nothing_of_the_port_or_jax():
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from bench_port import spec
spec.load_module({str(REPO / "bench_port/reference/lap3d.py")!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    top = p.stdout.strip().splitlines()[-1]
    for name in ("'lobpcg_tpu_torch'", "'lobpcg_tpu'", "'jax'", "'jaxlib'"):
        assert name not in top
