"""The plain reference of the well pencil against dense linear algebra
and a small CPU solve, and the TF32 rounding of the control."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_port import spec
from bench_port.tests import tiny

CFG = json.loads((tiny.REPO / "bench_port/configs/bdg_well_4M.json").read_text())
REF = spec.load_module(tiny.REPO / "bench_port/reference/bdg_well.py")
PROBLEM = spec.load_module(tiny.REPO / "bench_port/problems/bdg_well.py")


def _cfg(**kw):
    return {**CFG, **kw}


def _dense_K(cfg):
    V, _, m = REF.potential(cfg)
    s = cfg["scale"]
    return np.diag(2 * s + V) - s * np.eye(m, k=1) - s * np.eye(m, k=-1)


def test_eigenvalues_are_the_low_spectrum_of_K():
    """Whole (the window covers every site) against numpy's dense solver."""
    cfg = _cfg(n=2 * 700, well=64, barrier=0.7)
    got = REF.eigenvalues(cfg, 12)
    want = np.linalg.eigvalsh(_dense_K(cfg))[:12]
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_the_truncated_window_keeps_the_bound_states():
    """At 1M sites a side, the window of MARGIN barrier sites gives the
    whole tridiagonal's lowest eigenvalues to float64."""
    from scipy.linalg import eigvalsh_tridiagonal
    cfg = _cfg(n=2_000_000)
    V, _, m = REF.potential(cfg)
    whole = eigvalsh_tridiagonal(2.0 + V, -np.ones(m - 1), select="i",
                                 select_range=(0, 149))
    np.testing.assert_allclose(REF.eigenvalues(cfg, 150), whole, rtol=1e-13)
    assert whole[-1] < CFG["barrier"] + CFG["shift"]  # bound, below the barrier


def test_apply_is_A_and_residuals_judge_eigenpairs():
    cfg = _cfg(n=2 * 300, well=40)
    K = _dense_K(cfg)
    m = K.shape[0]
    A = np.block([[K, np.zeros_like(K)], [np.zeros_like(K), K]])
    X = np.random.default_rng(0).uniform(-0.5, 0.5, (2 * m, 5))
    got = REF.apply(cfg, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, A @ X, rtol=0, atol=1e-14)
    lam, U = np.linalg.eigh(K)
    pairs = np.concatenate([U[:, :4], U[:, :4]]) / np.sqrt(2.0)
    res = REF.residuals(cfg, lam[:4], torch.from_numpy(pairs).float())
    assert res.max() < 1e-7  # float32 vectors of the exact pairs
    off = REF.residuals(cfg, lam[:4] * (1 + 1e-3), torch.from_numpy(pairs))
    assert off.min() > 1e-4
    Y = torch.from_numpy(A @ X)
    assert REF.apply_error(cfg, torch.from_numpy(X), Y) < 1e-15
    Y[3, 2] *= 1 + 1e-4
    assert REF.apply_error(cfg, torch.from_numpy(X), Y) > 1e-5


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(10_000, dtype=torch.float32)
    t = REF.tf32(x)
    assert torch.all(t.view(torch.int32) & 0x1FFF == 0)
    rel = ((t - x).abs() / x.abs()).max().item()
    assert 2**-13 < rel <= 2**-11


def test_the_port_solves_what_the_reference_says():
    """A small CPU solve through the harness's problem (the port's plain
    versions) gives the reference's eigenvalues."""
    cfg = _cfg(n=2 * 400, well=48, cheb_chunk=4)
    p = PROBLEM.build(cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    X0 = PROBLEM.start(p, PROBLEM.well_draws(p, 8, gen))
    r = PROBLEM.solve(p, X0, PROBLEM.solver_config(cfg, 5, 8),
                      torch.Generator().manual_seed(2))
    assert r.converged == 5
    lam = r.eigenvalues.double().numpy()
    np.testing.assert_allclose(lam, REF.eigenvalues(cfg, 5), rtol=1e-5)
    Y = PROBLEM.apply(p, X0)
    assert REF.apply_error(cfg, X0, Y) < 1e-6


@pytest.mark.parametrize("nev", [56, 150])
def test_the_oracle_is_cheap_at_the_cells_sizes(nev):
    import time
    t0 = time.perf_counter()
    lam = REF.eigenvalues(_cfg(n=1_000_000), nev)
    assert time.perf_counter() - t0 < 2.0 and lam.shape == (nev,)
    assert np.all(np.diff(lam) > 0) and 1.0 < lam[0] < lam[-1] < 2.0
