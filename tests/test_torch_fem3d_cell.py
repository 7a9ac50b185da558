"""The benchmark's Q1 finite-element cell (``bench_port``'s ``fem3d``
problem) against its plain reference, on the CPU at small grids: the
problem's Kronecker-sum pencil against an element-by-element assembly of
the trilinear element matrices (ex11p's discretisation), the reference's
closed forms against a dense solve, the port's BSROperators against the
reference's matrix-free applies, the port's generalized solve judged by
the reference under the cell's own limits, and every B apply of that
solve inside its ``lobpcg.apply.B`` span."""

from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.linalg
import torch

import lobpcg_tpu_torch as lt

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from bench_port import spec  # noqa: E402

torch.set_num_threads(2)

REF = spec.load_module(REPO / "bench_port/reference/fem3d.py")
PROBLEM = spec.load_module(REPO / "bench_port/problems/fem3d.py")
CFG = json.loads((REPO / "bench_port/configs/fem3d_q1.json").read_text())
MIX = json.loads((REPO / "bench_port/mixes/solve_long_fem.json").read_text())
NEV, SIZE_SUB = int(MIX["nev"]), int(MIX["size_sub"])


def _cfg(grid, dtype="float32"):
    """The cell's configuration on ``grid``."""
    return {**CFG, "grid": list(grid), "dtype": dtype}


SMALL = _cfg((8, 8, 8))  # h = 1/9


def _element(hs):
    """(Ke, Me), 8 x 8, of the trilinear element on the box of sides
    ``hs``, by 2-point Gauss quadrature (exact for Q1): local node
    (a0, a1, a2) in C order, a_d = 0 at the box's low face."""
    g = (1.0 - 1.0 / np.sqrt(3.0)) / 2.0
    pts = (g, 1.0 - g)
    corners = list(itertools.product((0, 1), repeat=3))
    Ke, Me = np.zeros((8, 8)), np.zeros((8, 8))
    for q in itertools.product(pts, repeat=3):
        w = np.prod(hs) / 8.0
        phi = np.array([np.prod([q[d] if c[d] else 1 - q[d] for d in range(3)])
                        for c in corners])
        grad = np.array([[(1.0 if c[e] else -1.0) / hs[e] * np.prod(
            [q[d] if c[d] else 1 - q[d] for d in range(3) if d != e])
            for e in range(3)] for c in corners])
        Ke += w * grad @ grad.T
        Me += w * np.outer(phi, phi)
    return Ke, Me


def _assembled(grid):
    """(K, M) dense, element by element over the mesh of (N_d + 1)
    elements along axis d, restricted to the interior nodes (C order)."""
    hs = [1.0 / (N + 1) for N in grid]
    Ke, Me = _element(hs)
    nodes = [N + 2 for N in grid]
    total = int(np.prod(nodes))
    K, M = np.zeros((total, total)), np.zeros((total, total))
    corners = list(itertools.product((0, 1), repeat=3))
    for e in itertools.product(*(range(N + 1) for N in grid)):
        idx = [np.ravel_multi_index(tuple(e[d] + c[d] for d in range(3)), nodes)
               for c in corners]
        K[np.ix_(idx, idx)] += Ke
        M[np.ix_(idx, idx)] += Me
    inner = np.ravel_multi_index(np.meshgrid(
        *(np.arange(1, N + 1) for N in grid), indexing="ij"), nodes).ravel()
    return K[np.ix_(inner, inner)], M[np.ix_(inner, inner)]


@pytest.mark.parametrize("grid", [(6, 6, 6), (4, 5, 6)])
def test_the_kronecker_pencil_is_the_element_assembly(grid):
    """The problem's K and M (Kronecker sums) equal the sums of the 8 x 8
    trilinear element matrices, the Dirichlet nodes removed; a non-cubic
    grid catches an axis-order mismatch."""
    K, M = PROBLEM.assemble(_cfg(grid))
    s = float(np.prod([N + 1 for N in grid]))  # 1/(h0 h1 h2)
    assert PROBLEM.scale(_cfg(grid)) == s
    Ka, Ma = (s * X for X in _assembled(grid))
    np.testing.assert_allclose(K.toarray(), Ka, rtol=0, atol=1e-13 * abs(Ka).max())
    np.testing.assert_allclose(M.toarray(), Ma, rtol=0, atol=1e-13 * abs(Ma).max())
    assert np.diff(M.indptr).max() == 27
    # On cubes K's six face couplings are 0, on other boxes not.
    cubes = len(set(grid)) == 1
    assert np.diff(K.indptr).max() == (21 if cubes else 27)


@pytest.mark.parametrize("grid", [(6, 6, 6), (3, 4, 5)])
def test_reference_eigenvalues_and_norms_are_the_dense_pencils(grid):
    K, M = PROBLEM.assemble(_cfg(grid))
    K, M = K.toarray(), M.toarray()
    w = scipy.linalg.eigh(K, M, eigvals_only=True)
    np.testing.assert_allclose(REF.eigenvalues(_cfg(grid), 12), w[:12],
                               rtol=1e-12)
    k_norm, m_norm = REF.norms(_cfg(grid))
    np.testing.assert_allclose(k_norm, np.linalg.eigvalsh(K)[-1], rtol=1e-12)
    np.testing.assert_allclose(m_norm, np.linalg.eigvalsh(M)[-1], rtol=1e-12)


@pytest.mark.parametrize("grid", [(6, 7, 9), (9, 6, 7)])
def test_reference_applies_are_the_assembled_matrices(grid):
    """The reference's matrix-free K X and M X (tridiagonals along each
    axis) against the problem's CSR, built apart."""
    cfg = _cfg(grid)
    K, M = PROBLEM.assemble(cfg)
    X = torch.rand((K.shape[0], 5), generator=torch.Generator().manual_seed(2),
                   dtype=torch.float64) - 0.5
    for got, want in ((REF.apply(cfg, X), K @ X.numpy()),
                      (REF.apply_mass(cfg, X), M @ X.numpy())):
        assert np.abs(got.numpy() - want).max() <= 1e-14 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_bsr_operators_match_the_reference_applies(dtype):
    """build's two BSROperators (K3's plain gather on the CPU) at the
    grid of the solve test."""
    cfg = {**SMALL, "dtype": dtype}
    p = PROBLEM.build(cfg, "cpu")
    assert isinstance(p.A, lt.BSROperator) and isinstance(p.B, lt.BSROperator)
    X = (torch.rand((p.n, 16), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64) - 0.5).to(p.dtype)
    eps = torch.finfo(p.dtype).eps
    for op, ref in ((p.A, REF.apply), (p.B, REF.apply_mass)):
        want = ref(cfg, X.double())
        got = op.matmat(X).double()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 64 * eps * scale
    assert torch.equal(PROBLEM.apply(p, X), p.A.matmat(X))


def test_build_refuses_an_unknown_operator():
    with pytest.raises(ValueError, match="operator"):
        PROBLEM.build(SMALL, "cpu", operator="LaplacianND")


def test_reference_residuals_judge_eigenpairs():
    cfg = _cfg((4, 5, 3))
    K, M = (X.toarray() for X in PROBLEM.assemble(cfg))
    lam, U = scipy.linalg.eigh(K, M)
    res = REF.residuals(cfg, lam[:4], torch.from_numpy(U[:, :4]))
    assert res.shape == (4,) and res.max() < 1e-14
    off = REF.residuals(cfg, lam[:4] * (1 + 1e-3), torch.from_numpy(U[:, :4]))
    assert off.min() > 1e-5
    swapped = REF.residuals(cfg, lam[:4], torch.from_numpy(U[:, 4:8]))
    assert swapped.min() > 1e-3


def test_the_cell_solve_meets_the_cells_limits():
    """The cell's generalized solve (K and M as BSROperators, float32,
    the cell's solver configuration) at 8^3, from a start drawn as the
    cell draws it, judged by the reference as the cell judges it: every
    pair converged, eigenvalues within the mix's eig_rel_err of the closed
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


class _Counting:
    """``op`` with each ``matmat`` call counted and marked by a profiler
    range of its own."""

    def __init__(self, op):
        self.op, self.calls = op, 0

    def __getattr__(self, name):
        return getattr(self.op, name)

    def matmat(self, X):
        self.calls += 1
        with torch.profiler.record_function("probe.B"):
            return self.op.matmat(X)


@pytest.mark.parametrize("use_b_cache, residual_norm",
                         [(True, "2"), (False, "2"), (True, "b")])
def test_every_b_apply_lies_inside_its_span(use_b_cache, residual_norm):
    """Under the profiler, each B.matmat of a generalized solve (the norm
    estimate, the start basis, the B-orthogonalization, the B-Grams, the
    residual's B X) runs with lobpcg.apply.B its innermost range."""
    p = PROBLEM.build(SMALL, "cpu")
    cfg = {**CFG["solver"], "use_b_cache": use_b_cache,
           "residual_norm": residual_norm, "max_iter": 12}
    config = lt.SolverConfig(nev=NEV, size_sub=SIZE_SUB, **cfg)
    B = _Counting(p.B)
    X0 = PROBLEM.well_draws(p, SIZE_SUB, torch.Generator().manual_seed(3))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lt.lobpcg(p.A, X0, B=B, config=config,
                  generator=torch.Generator().manual_seed(4))
    probes = [e for e in prof.events() if e.name == "probe.B"]
    assert B.calls > 12 and len(probes) == B.calls
    parents = {e.cpu_parent.name if e.cpu_parent else None for e in probes}
    assert parents == {"lobpcg.apply.B"}


def test_the_reference_loads_nothing_of_the_port_or_jax():
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from bench_port import spec
spec.load_module({str(REPO / "bench_port/reference/fem3d.py")!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    top = p.stdout.strip().splitlines()[-1]
    for name in ("'lobpcg_tpu_torch'", "'lobpcg_tpu'", "'jax'", "'jaxlib'"):
        assert name not in top
