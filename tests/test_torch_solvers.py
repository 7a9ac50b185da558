"""The port's solvers (lobpcg_tpu_torch/solvers) against the JAX
package's, end to end, on the same numpy inputs — the slice as a whole.

The JAX solvers draw random blocks from a key even when X0 is given
(power-iteration starts, the basis refill).  Each test reproduces the
JAX key split with ``lobpcg_tpu.utils.prng.fill_random`` and hands the
same arrays to the port through ``draws=``.

Criteria (f64): eigenvalues agree to 1e-9 relative, converged counts are
equal, iteration counts differ by at most 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from lobpcg_tpu.utils.prng import fill_random
from lobpcg_tpu_torch.interop import config_from_reference, operator_from_reference

torch.set_num_threads(2)

WELL_BARRIER, WELL_SHIFT = 1.0, 1.0  # benchmarks/solve_bdg.py


def jax_draws(key, n, m, dtype, cfg, *, indefinite, with_b, x0_given,
              stall_iters=0):
    """The JAX solvers' random blocks for `key`, by the port's names."""
    keys = jax.random.split(key, 5 if indefinite else 4)
    k_a, k_b, k_x, k_r = keys[:4]
    d = {
        "norm_a": fill_random(k_a, (n, cfg.norm_block), dtype),
        "refill": fill_random(k_r, (n, m), dtype),
    }
    if with_b:
        d["norm_b"] = fill_random(k_b, (n, cfg.norm_block), dtype)
    if not x0_given:
        d["x0"] = fill_random(k_x, (n, m), dtype)
    for it in range(stall_iters):
        d[f"stall{it}"] = fill_random(jax.random.fold_in(keys[4], it),
                                      (n, m), dtype)
    return {k: np.asarray(v) for k, v in d.items()}


def port(op):
    return None if op is None else operator_from_reference(op, device="cpu")


def assert_parity(rt, rj, nev, rtol=1e-9):
    lam_j = np.asarray(rj.eigenvalues)
    lam_t = rt.eigenvalues.numpy()
    assert lam_t.shape == (nev,)
    np.testing.assert_allclose(lam_t, lam_j, rtol=rtol)
    assert rt.converged == int(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    # The exit bases span the same space (columns may differ in sign, and
    # a dual-basis exit holds a stabilized rotation of the eigenvectors):
    # the cosines of the principal angles between the two are all ~1.
    Qt = np.linalg.qr(rt.basis.numpy())[0]
    Qj = np.linalg.qr(np.asarray(rj.basis))[0]
    assert np.linalg.svd(Qj.T @ Qt, compute_uv=False).min() > 1 - 1e3 * rtol


def run_both(solver, jA, X0, jB, jT, cfg, key, **kw):
    n, m = jA.shape[0], cfg.size_sub
    draws = jax_draws(key, n, m, jnp.float64 if X0 is None else X0.dtype,
                      cfg, indefinite=solver == "ilobpcg",
                      with_b=jB is not None, x0_given=X0 is not None,
                      stall_iters=cfg.max_iter if cfg.stall_reset else 0)
    rj = getattr(jl, solver)(jA, None if X0 is None else jnp.asarray(X0),
                             jB, jT, config=cfg, key=key, **kw)
    P0 = kw.pop("P0", None)
    rt = getattr(tl, solver)(
        port(jA), None if X0 is None else torch.from_numpy(np.array(X0)),
        port(jB),
        port(jT), config=config_from_reference(cfg), draws=draws,
        P0=None if P0 is None else torch.from_numpy(np.array(P0)),
        device="cpu", **kw)
    return rt, rj


def laplacian(n):
    h = 1.0 / (n + 1)
    return jl.Laplacian1D(scale=jnp.float64(1 / h / h), n=n)


@pytest.mark.parametrize("tol,rtol", [(1e-8, 1e-9), (1e-5, 1e-6)])
def test_lobpcg_laplacian_matches_reference(tol, rtol):
    """The 1-D Laplacian at n 100, nev 3, size_sub 5, f64.  At
    tol 1e-5 the last convergence test is a near tie (residual
    within round-off of tol), so the two runs may stop one iteration
    apart and their eigenvalues agree only to the tolerance's level;
    at tol 1e-8 they agree to 1e-9."""
    n, nev, ss = 100, 3, 5
    X0 = np.random.RandomState(0).uniform(-0.5, 0.5, (n, ss))
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=500)
    rt, rj = run_both("lobpcg", laplacian(n), X0, None, None, cfg,
                      jax.random.PRNGKey(7))
    assert_parity(rt, rj, nev, rtol)
    assert rt.converged == nev
    exact = (np.arange(1, nev + 1) * np.pi) ** 2
    assert np.abs(rt.eigenvalues.numpy() - exact).max() / exact.min() < 0.03


def test_lobpcg_generalized_preconditioned_matches_reference():
    n, nev, ss = 60, 3, 4
    rng = np.random.RandomState(1)
    M = rng.uniform(-0.5, 0.5, (n, n))
    jB = jl.DenseOperator(jnp.asarray(M @ M.T / n + np.eye(n)))
    jA = laplacian(n)
    h = 1.0 / (n + 1)
    jT = jl.JacobiPreconditioner(jnp.full((n,), 2.0 / h / h))
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300,
                          record_history=True)
    rt, rj = run_both("lobpcg", jA, None, jB, jT, cfg, jax.random.PRNGKey(3))
    assert_parity(rt, rj, nev)
    it = rt.iterations
    np.testing.assert_array_equal(rt.history.flags[:it].numpy(),
                                  np.asarray(rj.history.flags)[:it])
    np.testing.assert_array_equal(rt.history.converged[:it].numpy(),
                                  np.asarray(rj.history.converged)[:it])


def bdg_well(m, well, dtype):
    """The BdG quantum-well pencil of benchmarks/solve_bdg.py, small:
    A = 2-segment Laplacian + well potential, B = antidiag(I, I),
    X0 = [u; u] from RandomState(42)."""
    lo = (m - well) // 2
    V = np.full(m, WELL_BARRIER + WELL_SHIFT)
    V[lo : lo + well] = WELL_SHIFT
    jA = jl.Laplacian1D(scale=jnp.asarray(1.0, dtype), n=2 * m, segments=2) \
        + jl.DiagonalOperator(jnp.asarray(np.concatenate([V, V]), dtype))
    jB = jl.BlockAntiDiagOperator(d=jnp.ones((m,), dtype))
    jT = jl.ChebyshevFilter(op=jA, lo=jnp.asarray(2.0, dtype),
                            hi=jnp.asarray(4.0 + WELL_BARRIER + WELL_SHIFT
                                           + 0.1, dtype), degree=3)
    return jA, jB, jT, lo


def bdg_x0(m, well, ss, lo, dtype):
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(
        -0.5, 0.5, size=(well, ss))
    return np.concatenate([u, u], axis=0).astype(dtype)


def test_ilobpcg_bdg_well_matches_reference():
    """The main path, small: m 512, well 64, nev 4, size_sub 8,
    Chebyshev degree 3, tol 1e-8, f64."""
    m, well, nev, ss = 512, 64, 4, 8
    jA, jB, jT, lo = bdg_well(m, well, jnp.float64)
    X0 = bdg_x0(m, well, ss, lo, np.float64)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    rt, rj = run_both("ilobpcg", jA, X0, jB, jT, cfg, jax.random.PRNGKey(0))
    assert_parity(rt, rj, nev)
    assert rt.converged == nev
    np.testing.assert_array_equal(rt.signature.numpy(),
                                  np.asarray(rj.signature))
    assert rt.quality5_count == int(rj.quality5_count)
    assert rt.rr_fail_count == int(rj.rr_fail_count)


@pytest.mark.parametrize("knobs", [
    dict(use_b_cache=False, use_ax_cache=False),
    dict(dual_basis=False, pack_applies=False, ortho_skip=True),
    dict(rr_method="auto", residual_norm="b"),
    dict(stall_reset=2, record_history=True),
])
def test_ilobpcg_knobs_match_reference(knobs):
    m, well, nev, ss = 128, 32, 3, 6
    jA, jB, jT, lo = bdg_well(m, well, jnp.float64)
    X0 = bdg_x0(m, well, ss, lo, np.float64)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=200,
                          **knobs)
    rt, rj = run_both("ilobpcg", jA, X0, jB, jT, cfg, jax.random.PRNGKey(1))
    assert_parity(rt, rj, nev)
    if cfg.record_history:
        it = rt.iterations
        np.testing.assert_array_equal(rt.history.flags[:it].numpy(),
                                      np.asarray(rj.history.flags)[:it])


def test_ilobpcg_quality5_dual_basis_matches_reference():
    """Ill-conditioned B = antidiag(D, D), D = diag(0.1^i): the quality=5
    dual-basis path (tests/test_ilobpcg.py's stress case)."""
    m, nev, ss = 30, 2, 4
    h = 1.0 / (m + 1)
    jK = jl.Laplacian1D(scale=jnp.float64(1 / h / h), n=m)
    jA = jl.BlockDiagOperator(inner=jK, copies=2)
    jB = jl.BlockAntiDiagOperator(d=jnp.asarray(0.1 ** np.arange(m)))
    u = np.random.RandomState(99).uniform(-0.5, 0.5, size=(m, ss))
    X0 = np.concatenate([u, u], axis=0)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-3, max_iter=500)
    rt, rj = run_both("ilobpcg", jA, X0, jB, None, cfg, jax.random.PRNGKey(0))
    assert rt.quality5_count > 0
    assert rt.quality5_count == int(rj.quality5_count)
    assert_parity(rt, rj, nev)


def test_warm_restart_p0_matches_reference():
    m, well, nev, ss = 128, 32, 3, 6
    jA, jB, jT, lo = bdg_well(m, well, jnp.float64)
    X0 = bdg_x0(m, well, ss, lo, np.float64)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=200)
    first = jl.ilobpcg(jA, jnp.asarray(X0), jB, jT, config=cfg,
                       key=jax.random.PRNGKey(2), it_cap=4)
    # A user-assembled momentum block whose live columns are not a prefix.
    P0 = np.asarray(first.momentum)[:, ::-1].copy()
    rt, rj = run_both("ilobpcg", jA, np.asarray(first.basis), jB, jT, cfg,
                      jax.random.PRNGKey(2), P0=jnp.asarray(P0))
    assert_parity(rt, rj, nev)


def test_ilobpcg_f32_well_against_dense_oracle():
    """f32 storage, the small well, against the dense well Hamiltonian
    (benchmarks/solve_bdg.py's oracle with the well's actual margin).
    Tolerance 1e-5 relative: the flagship's oracle bound."""
    m, well, nev, ss = 512, 64, 4, 8
    jA, jB, jT, lo = bdg_well(m, well, jnp.float32)
    X0 = bdg_x0(m, well, ss, lo, np.float32)
    r = tl.ilobpcg(port(jA), torch.from_numpy(X0), port(jB), port(jT),
                   nev=nev, size_sub=ss, tol=1e-5, max_iter=300,
                   generator=torch.Generator().manual_seed(0))
    V = np.full(m, WELL_BARRIER + WELL_SHIFT)
    V[lo : lo + well] = WELL_SHIFT
    H = np.diag(2.0 + V) - np.eye(m, k=1) - np.eye(m, k=-1)
    exact = np.linalg.eigvalsh(H)[:nev]
    lam = r.eigenvalues.double().numpy()
    assert r.eigenvalues.dtype == torch.float32
    assert r.converged == nev
    assert np.all(np.isfinite(lam))
    assert np.abs(lam - exact).max() / exact.min() <= 1e-5
    assert np.array_equal(r.signature.numpy(), np.ones(nev, np.int32))


def test_klobpcg_alias_and_entry_validation():
    assert tl.klobpcg is tl.lobpcg
    A = tl.Laplacian1D(scale=1.0, n=30, dtype=torch.float64)
    X0 = torch.zeros((30, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tl.lobpcg(A, X0, nev=2, size_sub=5)  # X0 width != size_sub
    with pytest.raises(ValueError):
        tl.lobpcg(A, X0, nev=2, size_sub=4, device="meta")  # X0 elsewhere
    with pytest.raises(ValueError):
        tl.ilobpcg(A, X0, None, nev=2, size_sub=4)  # B required
    with pytest.raises(ValueError):
        tl.lobpcg(A, nev=4, size_sub=11)  # 3 * size_sub > n


@pytest.mark.parametrize("solver", ["lobpcg", "ilobpcg"])
def test_entry_points_without_x0_or_device_need_the_card(solver, monkeypatch):
    """With neither X0 nor device the solve runs on the CUDA card; without
    one it raises instead of solving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = tl.Laplacian1D(scale=1.0, n=64, dtype=torch.float64)
    B = tl.BlockAntiDiagOperator(d=torch.ones(32, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tl, solver)(A, None, B if solver == "ilobpcg" else None,
                            nev=2, size_sub=4)
    r = getattr(tl, solver)(A, None, B if solver == "ilobpcg" else None,
                            nev=2, size_sub=4, max_iter=2, device="cpu")
    assert r.eigenvalues.device.type == "cpu"
