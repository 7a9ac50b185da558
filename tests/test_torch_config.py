"""The port's config (lobpcg_tpu_torch/config.py) and random fills
(utils/prng.py) against the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu.config as jcfg
import lobpcg_tpu_torch.config as tcfg
from lobpcg_tpu_torch.utils.prng import Draws, fill_random

torch.set_num_threads(2)

DTYPES = [
    (jnp.float32, torch.float32),
    (jnp.float64, torch.float64),
    (jnp.complex64, torch.complex64),
    (jnp.complex128, torch.complex128),
]


def test_solver_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SolverConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SolverConfig)]
    assert jf == tf


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_dtype_tables_match(jdt, tdt):
    jd = jnp.dtype(jdt)
    assert tcfg.EPS_TOL[tdt] == jcfg.EPS_TOL[jd]
    assert tcfg.TINY[tdt] == jcfg.TINY[jd]
    assert tcfg.QUALITY_TOL[tdt] == jcfg.QUALITY_TOL[jd]
    assert tcfg.RR_WIDTH_ESCALATE.get(tdt) == jcfg.RR_WIDTH_ESCALATE.get(jd)
    assert tcfg.eps_tol(tdt) == jcfg.eps_tol(jd)
    assert tcfg.tiny(tdt) == jcfg.tiny(jd)
    assert tcfg.quality_tol(tdt) == jcfg.quality_tol(jd)


@pytest.mark.parametrize("kw", [
    dict(nev=5, size_sub=4),
    dict(nev=2, size_sub=4, rr_method="ggev"),
    dict(nev=2, size_sub=4, gram_precision="low"),
    dict(nev=2, size_sub=4, residual_norm="inf"),
    dict(nev=2, size_sub=4, norm_block=0),
    dict(nev=2, size_sub=4, stall_reset=-1),
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        jcfg.SolverConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.SolverConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(nev=4, size_sub=8),
    dict(nev=4, size_sub=8, eps_ortho=1e-3),
    dict(nev=4, size_sub=8, eps_drop=1e-4),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_resolved_eps_matches(kw, jdt, tdt):
    assert tcfg.SolverConfig(**kw).resolved_eps(tdt) == \
        jcfg.SolverConfig(**kw).resolved_eps(jnp.dtype(jdt))


@pytest.mark.parametrize("kw", [
    dict(nev=4, size_sub=8),
    dict(nev=100, size_sub=200),  # 3 * 200 > 512: auto-escalation
    dict(nev=4, size_sub=8, rr_dtype="float64"),
    dict(nev=4, size_sub=8, rr_dtype="float32"),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_resolved_rr_dtype_matches(kw, jdt, tdt):
    j = jcfg.SolverConfig(**kw).resolved_rr_dtype(jnp.dtype(jdt))
    t = tcfg.SolverConfig(**kw).resolved_rr_dtype(tdt)
    if j is None:
        assert t is None
    else:
        assert t == getattr(torch, jnp.dtype(j).name)


def test_validate_problem_matches():
    cfg = dict(nev=4, size_sub=8)
    jcfg.validate_problem(24, jcfg.SolverConfig(**cfg))
    tcfg.validate_problem(24, tcfg.SolverConfig(**cfg))
    with pytest.raises(ValueError):
        jcfg.validate_problem(23, jcfg.SolverConfig(**cfg))
    with pytest.raises(ValueError):
        tcfg.validate_problem(23, tcfg.SolverConfig(**cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_fill_random_range_shape_and_generator(dtype):
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = fill_random(g1, (500, 4), dtype, "cpu")
    b = fill_random(g2, (500, 4), dtype, "cpu")
    assert a.dtype == dtype and tuple(a.shape) == (500, 4)
    assert torch.equal(a, b)
    parts = [a.real, a.imag] if dtype.is_complex else [a]
    for p in parts:
        assert float(p.min()) >= -0.5 and float(p.max()) <= 0.5
        assert float(p.std()) > 0.2  # uniform on [-0.5, 0.5]: std 0.289


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
@pytest.mark.parametrize("nd", [1, 3, 4])
def test_fill_random_rows_are_the_global_fills_rows(dtype, nd):
    """Each rank's rows, drawn chunk by chunk without the global block,
    are its rows of the unsharded fill; on the CPU the chunks give the
    bits of one generator call."""
    n, chunk = 96, 40
    whole = fill_random(torch.Generator().manual_seed(5), (n, 3), dtype, "cpu",
                        chunk_rows=chunk)
    n_loc = n // nd
    parts = [fill_random(torch.Generator().manual_seed(5), (n, 3), dtype, "cpu",
                         rows=slice(r * n_loc, (r + 1) * n_loc), chunk_rows=chunk)
             for r in range(nd)]
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(whole, fill_random(torch.Generator().manual_seed(5),
                                          (n, 3), dtype, "cpu"))
    if not dtype.is_complex:
        one = torch.rand((n, 3), generator=torch.Generator().manual_seed(5),
                         dtype=dtype) - 0.5
        assert torch.equal(whole, one)
    d = Draws(None, {"x0": whole.numpy()}, rows=slice(n_loc, 2 * n_loc))
    assert torch.equal(d.fill("x0", (n, 3), dtype, "cpu"), whole[n_loc : 2 * n_loc])


def test_draws_override_and_shape_check():
    given = np.arange(6.0).reshape(3, 2)
    d = Draws(torch.Generator().manual_seed(0), {"x0": given})
    x = d.fill("x0", (3, 2), torch.float64, "cpu")
    np.testing.assert_array_equal(x.numpy(), given)
    r = d.fill("refill", (3, 2), torch.float64, "cpu")
    assert tuple(r.shape) == (3, 2)
    with pytest.raises(ValueError):
        d.fill("x0", (2, 3), torch.float64, "cpu")
