"""The port's BdG physics layer (lobpcg_tpu_torch/physics/bdg.py) against
the JAX package's (tests/test_bdg_physics.py's cases), on the same numpy
inputs, on the CPU.

Criteria (f64): the K, M and A applies agree to atol 1e-10; the
dispersion solves agree with the JAX ilobpcg (given its random draws) to
1e-9 relative and with the analytic omega to 1e-6 (1e-5 with the
preconditioners, as the JAX tests); the dipolar term lands in M only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lobpcg_tpu import Laplacian1D as JLaplacian1D
from lobpcg_tpu import SolverConfig as JSolverConfig
from lobpcg_tpu import ilobpcg as jilobpcg
from lobpcg_tpu.physics import bdg as jbdg
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.interop import config_from_reference, operator_from_reference
from lobpcg_tpu_torch.physics import bdg as tbdg
from test_torch_solvers import jax_draws

torch.set_num_threads(2)


def _kinetic(m):
    h = 1.0 / (m + 1)
    return (JLaplacian1D(scale=jnp.asarray(0.5 / (h * h), jnp.float64), n=m),
            tl.Laplacian1D(scale=0.5 / (h * h), n=m, dtype=torch.float64))


def _uniform(m, g):
    """Uniform condensate in a Dirichlet box (psi = 1, mu = g): the
    discrete Bogoliubov dispersion omega_k = sqrt(eps_k (eps_k + 2 g))."""
    jkin, tkin = _kinetic(m)
    jops = jbdg.bdg_operators(jkin, jnp.ones((m,), jnp.float64), g=g, mu=g)
    tops = tbdg.bdg_operators(tkin, torch.ones(m, dtype=torch.float64), g=g,
                              mu=g)
    h = 1.0 / (m + 1)
    eps = 2.0 / h**2 * np.sin(np.arange(1, m + 1) * np.pi * h / 2) ** 2
    return jops, tops, np.sort(np.sqrt(eps * (eps + 2 * g)))


def test_k_m_and_a_applies_match_reference():
    """K = H0 + V - mu + g n and M = K + 2 g n, with a trap and a
    non-uniform psi; A = diag(M, K), B = antidiag(I, I)."""
    m, g, mu = 32, 5.0, 3.0
    psi = np.linspace(0.5, 1.5, m)
    vt = np.linspace(0.0, 2.0, m)
    jkin, tkin = _kinetic(m)
    jA, jB, jK, jM = jbdg.bdg_operators(jkin, jnp.asarray(psi), g=g, mu=mu,
                                        v_trap=jnp.asarray(vt))
    tA, tB, tK, tM = tbdg.bdg_operators(tkin, torch.from_numpy(psi), g=g,
                                        mu=mu, v_trap=torch.from_numpy(vt))
    rng = np.random.RandomState(0)
    X = rng.randn(m, 3)
    X2 = rng.randn(2 * m, 3)
    for top, jop, Z in ((tK, jK, X), (tM, jM, X), (tA, jA, X2), (tB, jB, X2)):
        np.testing.assert_allclose(top.matmat(torch.from_numpy(Z)).numpy(),
                                   np.asarray(jop.matmat(jnp.asarray(Z))),
                                   atol=1e-10)
    assert tA.shape == (2 * m, 2 * m) and tA.dtype == torch.float64
    # The JAX tree carried across is the same operator.
    pA = operator_from_reference(jA, device="cpu")
    assert type(pA).__name__ == "BlockDiag2Operator"
    np.testing.assert_allclose(pA.matmat(torch.from_numpy(X2)).numpy(),
                               tA.matmat(torch.from_numpy(X2)).numpy(),
                               atol=1e-10)


def _solve_both(jA, jB, jT, tA, tB, tT, m, ss, nev, tol, key):
    X0 = np.array(jbdg.bdg_positive_start(key, m, ss, jnp.float64))
    cfg = JSolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=400)
    rj = jilobpcg(jA, jnp.asarray(X0), jB, jT, config=cfg, key=key)
    draws = jax_draws(key, 2 * m, ss, jnp.float64, cfg, indefinite=True,
                      with_b=True, x0_given=True)
    rt = tl.ilobpcg(tA, torch.from_numpy(X0), tB, tT,
                    config=config_from_reference(cfg), draws=draws)
    return rt, rj


def test_bogoliubov_dispersion_matches_reference():
    """ilobpcg on the uniform-gas pencil: both packages, m 128, g 50,
    nev 4, size_sub 8, tol 1e-8."""
    m, g, nev, ss = 128, 50.0, 4, 8
    (jA, jB, _, _), (tA, tB, _, _), omega = _uniform(m, g)
    rt, rj = _solve_both(jA, jB, None, tA, tB, None, m, ss, nev, 1e-8,
                         jax.random.PRNGKey(42))
    assert rt.converged == int(rj.converged) == nev
    got = rt.eigenvalues.numpy()
    np.testing.assert_allclose(got, np.asarray(rj.eigenvalues), rtol=1e-9)
    np.testing.assert_allclose(got, omega[:nev], rtol=1e-6)
    assert np.all(rt.signature.numpy() == 1)


@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
def test_preconditioners_match_reference(kind):
    m, g, nev, ss = 128, 50.0, 3, 6
    (jA, jB, _, _), (tA, tB, _, _), omega = _uniform(m, g)
    h = 1.0 / (m + 1)
    diag_k = 1.0 / h**2 + g  # diag of kinetic + g n (mu = g)
    diag_A = np.concatenate([np.full(m, diag_k + 2 * g), np.full(m, diag_k)])
    kw = dict(kind=kind, hi=2.0 / h**2 + 3 * g, degree=6) \
        if kind == "chebyshev" else dict(kind=kind)
    jT = jbdg.bdg_preconditioner(jA, jnp.asarray(diag_A), **kw)
    tT = tbdg.bdg_preconditioner(tA, torch.from_numpy(diag_A), **kw)
    Z = np.random.RandomState(3).randn(2 * m, 2)
    np.testing.assert_allclose(tT.matmat(torch.from_numpy(Z)).numpy(),
                               np.asarray(jT.matmat(jnp.asarray(Z))),
                               atol=1e-10)
    rt, rj = _solve_both(jA, jB, jT, tA, tB, tT, m, ss, nev, 1e-7,
                         jax.random.PRNGKey(7))
    got = rt.eigenvalues.numpy()
    np.testing.assert_allclose(got, np.asarray(rj.eigenvalues), rtol=1e-9)
    np.testing.assert_allclose(got, omega[:nev], rtol=1e-5)


def test_preconditioner_arguments_validated():
    (_, _, _, _), (tA, _, _, _), _ = _uniform(16, 1.0)
    d = torch.ones(32, dtype=torch.float64)
    with pytest.raises(ValueError, match="hi"):
        tbdg.bdg_preconditioner(tA, d, kind="chebyshev")
    with pytest.raises(ValueError, match="unknown"):
        tbdg.bdg_preconditioner(tA, d, kind="ilu")
    cheb = tbdg.bdg_preconditioner(tA, d, kind="chebyshev", hi=30.0)
    assert (cheb.lo, cheb.hi, cheb.degree) == (1.0, 30.0, 8)


def test_dipolar_hook():
    """An extra exchange operator lands in M only, as in the JAX package."""
    m, g = 16, 1.0
    jkin, tkin = _kinetic(m)
    _, _, jK, jM = jbdg.bdg_operators(
        jkin, jnp.ones((m,), jnp.float64), g=g, mu=g,
        dipolar=jbdg.DiagonalOperator(jnp.full((m,), 7.0)))
    _, _, tK, tM = tbdg.bdg_operators(
        tkin, torch.ones(m, dtype=torch.float64), g=g, mu=g,
        dipolar=tl.DiagonalOperator(torch.full((m,), 7.0, dtype=torch.float64)))
    X = torch.ones((m, 1), dtype=torch.float64)
    diff = (tM.matmat(X) - tK.matmat(X)).numpy()
    np.testing.assert_allclose(diff, 2 * g + 7.0, atol=1e-12)
    np.testing.assert_allclose(
        tM.matmat(X).numpy(), np.asarray(jM.matmat(jnp.ones((m, 1)))),
        atol=1e-10)


def test_bdg_positive_start():
    gen = torch.Generator().manual_seed(3)
    X = tbdg.bdg_positive_start(gen, 10, 4, torch.float32)
    assert X.shape == (20, 4) and X.dtype == torch.float32
    assert X.device.type == "cpu"
    assert torch.equal(X[:10], X[10:])
    assert float(X.abs().max()) <= 0.5
    again = tbdg.bdg_positive_start(torch.Generator().manual_seed(3), 10, 4,
                                    torch.float32)
    assert torch.equal(X, again)
    Xc = tbdg.bdg_positive_start(gen, 5, 2, torch.complex128, device="cpu")
    assert Xc.dtype == torch.complex128 and torch.equal(Xc[:5], Xc[5:])
