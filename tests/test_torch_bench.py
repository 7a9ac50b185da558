"""The port's bench entry point (lobpcg_tpu_torch/bench.py, K7's plain
version, benchmarks/solve_bdg.py) against the JAX package's bench.py
and benchmarks/solve_bdg.py, on the CPU.

Criteria: the copy's plain version is exact; the headline's nnz, bytes
and vs_baseline follow bench.py's formulas to 1e-12 relative; the well
oracle is identical; the well pencil's operators agree in f64 to 1e-12
and its solve by both packages to 1e-8 relative in the eigenvalues.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch import bench
from lobpcg_tpu_torch.benchmarks import solve_bdg as tsolve
from lobpcg_tpu_torch.interop import config_from_reference, operator_from_reference
from lobpcg_tpu_torch.ops.cuda import copy as k7

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_solve_bdg():
    """The JAX package's benchmarks/solve_bdg.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_solve_bdg", REPO / "benchmarks" / "solve_bdg.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (2048, 64), (4099, 77)])
def test_stream_copy_plain_version_is_exact(shape):
    X = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, shape)
                         ).float()
    for Y in (k7.stream_copy_reference(X), k7.stream_copy(X)):
        assert torch.equal(Y, X) and Y.dtype == X.dtype
        assert Y.data_ptr() != X.data_ptr()
    with pytest.raises(ValueError):
        k7.stream_copy(X.reshape(-1))


def test_headline_arithmetic_follows_bench_py():
    """bench.py's formulas (nnz = (3m - 2) * 2, bytes = 2 n k 4,
    vs_baseline = nnz/s over 0.8 x the roofline's nnz/s) on the times the
    record carries, at n 4096, k 8 on the CPU."""
    n, k = 4096, 8
    rec = bench.measure_spmm("cpu", n=n, k=k)
    m = n // 2
    nnz = (3 * m - 2) * 2
    bytes_moved = 2 * n * k * 4
    dt, dt_copy = rec["apply_ms"] / 1e3, rec["copy_ms"] / 1e3
    copy_bw = bytes_moved / dt_copy
    nnz_per_s = nnz * k / dt
    roofline_nnz = nnz * k / (bytes_moved / copy_bw)
    assert rec["metric"] == "spmm_bdg_stencil_nnz_per_s_per_chip"
    assert (rec["nnz"], rec["bytes"], rec["device"]) == (nnz, bytes_moved, "cpu")
    for key, want in (("value", nnz_per_s),
                      ("vs_baseline", nnz_per_s / (0.80 * roofline_nnz)),
                      ("gbs", bytes_moved / dt / 1e9),
                      ("copy_roofline_gbs", copy_bw / 1e9),
                      ("copy_library_gbs",
                       bytes_moved / (rec["copy_library_ms"] / 1e3) / 1e9)):
        assert rec[key] == pytest.approx(want, rel=1e-12), key
    assert rec["apply_finite"] and rec["spec_fraction"] is None
    assert rec["power_limit"] is None
    json.dumps(rec)


def test_copy_roofline_times_both_copies_on_cpu():
    rec = bench.copy_roofline(64, 4, "cpu")
    assert set(rec) == {"copy_ms", "copy_gbs", "copy_library_ms",
                        "copy_library_gbs"}
    assert all(v > 0 for v in rec.values())


def test_spec_table_matches_card_names(monkeypatch):
    for name, bw in (("NVIDIA H100 80GB HBM3", 3.35e12),
                     ("NVIDIA H100 PCIe", 2.0e12),
                     ("NVIDIA H200", 4.8e12), ("Tesla T4", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
        assert bench.spec_bytes_per_s(0) == bw


@pytest.mark.parametrize("entry", ["measure_spmm", "main", "solve",
                                   "solve_bdg_main"])
def test_entry_points_need_the_card(entry, monkeypatch):
    """Without a card the bench entry points raise; nothing falls back
    to the CPU unless the caller passes device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "measure_spmm": lambda: bench.measure_spmm(n=64, k=2),
        "main": bench.main,
        "solve": lambda: tsolve.solve(64, 2, 8, reps=1, warmup=False),
        "solve_bdg_main": lambda: tsolve.main(["--n", "64", "--nev", "2"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("w,nev,barrier", [(1024, 56, 1.0), (64, 5, 2.5)])
def test_well_eigs_oracle_identical(w, nev, barrier):
    ref = _jax_solve_bdg().well_eigs_oracle(w, nev, barrier, margin=256)
    got = tsolve.well_eigs_oracle(w, nev, barrier, margin=256)
    np.testing.assert_array_equal(got, ref)


def _jax_well(n, nev, ss, dtype):
    """benchmarks/solve_bdg.py:166-201 with --cheb 3, in the JAX package."""
    mod = _jax_solve_bdg()
    m = n // 2
    lo = (m - mod.WELL) // 2
    V = np.full(m, mod.BARRIER + mod.SHIFT)
    V[lo : lo + mod.WELL] = mod.SHIFT
    Vd = jnp.asarray(V, dtype)
    A = jl.Laplacian1D(scale=jnp.asarray(1.0, dtype), n=n, segments=2) \
        + jl.DiagonalOperator(jnp.concatenate([Vd, Vd]))
    B = jl.BlockAntiDiagOperator(d=jnp.ones((m,), dtype))
    T = jl.ChebyshevFilter(op=A, lo=jnp.asarray(2.0, dtype),
                           hi=jnp.asarray(4.0 + mod.BARRIER + mod.SHIFT + 0.1,
                                          dtype), degree=3, chunk=0)
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + mod.WELL] = np.random.RandomState(42).uniform(
        -0.5, 0.5, size=(mod.WELL, ss))
    return A, B, T, np.concatenate([u, u], axis=0).astype(np.float64)


def test_well_problem_matches_the_jax_script():
    """The operators and X0 of well_problem against the JAX script's, in
    f64 at n 8192 (atol 1e-12); the Chebyshev chunk rule."""
    n, nev, ss = 8192, 4, 18
    jA, jB, jT, X0 = _jax_well(n, nev, ss, jnp.float64)
    A, B, T, tX0, m, lo = tsolve.well_problem(n, nev, 0, dtype="float64",
                                              cheb=3, precond=True,
                                              device="cpu")
    assert (m, lo, T.chunk, T.degree) == (n // 2, (n // 2 - 1024) // 2, 0, 3)
    np.testing.assert_array_equal(tX0.numpy(), X0)
    Z = np.random.default_rng(1).uniform(-1, 1, (n, 5))
    for top, jop in ((A, jA), (B, jB), (T, jT)):
        np.testing.assert_allclose(top.matmat(torch.from_numpy(Z)).numpy(),
                                   np.asarray(jop.matmat(jnp.asarray(Z))),
                                   atol=1e-12)
    assert tsolve.cheb_chunk_rule(4_000_000, 64) == 16
    assert tsolve.cheb_chunk_rule(1_000_000, 164) == 0
    _, _, T4, _, _, _ = tsolve.well_problem(4096, 2, 8, dtype=torch.float64,
                                            cheb=3, precond=True, device="cpu",
                                            cheb_chunk=4)
    assert T4.chunk == 4
    _, _, TJ, _, _, _ = tsolve.well_problem(4096, 2, 8, dtype=torch.float64,
                                            cheb=0, precond=True, device="cpu")
    assert type(TJ).__name__ == "JacobiPreconditioner"


def test_well_solve_matches_the_jax_package():
    """well_problem at n 8192, nev 4, f64, Chebyshev 3, tol 1e-6, solved
    by both packages from the same X0: eigenvalues agree to 1e-8
    relative, both within 1e-8 of the dense well oracle."""
    n, nev, ss = 8192, 4, 18
    jA, jB, jT, X0 = _jax_well(n, nev, ss, jnp.float64)
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=300)
    rj = jl.ilobpcg(jA, jnp.asarray(X0), jB, jT, config=cfg,
                    key=jax.random.PRNGKey(0))
    A, B, T, tX0, _, _ = tsolve.well_problem(n, nev, ss, dtype="float64",
                                             cheb=3, precond=True,
                                             device="cpu")
    rt = tl.ilobpcg(A, tX0, B, T, config=config_from_reference(cfg),
                    generator=torch.Generator().manual_seed(0))
    assert rt.converged == nev == int(rj.converged)
    lam_j = np.asarray(rj.eigenvalues)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), lam_j, rtol=1e-8)
    exact = tsolve.well_eigs_oracle(tsolve.WELL, nev, tsolve.BARRIER)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), exact, rtol=1e-8)


def test_solve_record_and_realify():
    """solve(): the JAX script's record keys, device "cpu", the chunk;
    --realify specifies the pencil in complex128 and solves its
    split-real embedding, reporting complex pairs and the same error
    against the oracle as the real solve (n 2048, nev 3, f64, within
    1e-8; at this n the well fills the domain, so the oracle's margin
    leaves ~2e-7 of model difference in both)."""
    kw = dict(tol=1e-7, dtype="float64", cheb=3, check=True, reps=1,
              warmup=False, device="cpu")
    real = tsolve.solve(2048, 3, 8, **kw)
    cplx = tsolve.solve(2048, 3, 8, realify=True, **kw)
    jax_keys = {"metric", "value", "unit", "n", "nev", "size_sub", "tol",
                "iterations", "reps", "wall_all", "converged", "quality5",
                "rr_failed", "dtype", "gram_precision", "b_cache", "ax_cache",
                "dual_basis", "pack_applies", "pad_lanes", "ortho_skip",
                "stall_reset", "rr_dtype", "device", "max_rel_err"}
    assert jax_keys <= set(real) and jax_keys <= set(cplx)
    assert real["device"] == "cpu" and real["cheb_chunk"] == 0
    assert (real["dtype"], real["rr_dtype"]) == ("float64", "None")
    assert cplx["converged"] == real["converged"] == 3
    assert cplx["dtype"] == "complex128->split-real float64"
    assert cplx["max_rel_err"] == pytest.approx(real["max_rel_err"], abs=1e-8)
    json.dumps(real)


def test_operator_from_reference_ports_the_jax_well():
    jA, _, jT, _ = _jax_well(4096, 2, 8, jnp.float64)
    A = operator_from_reference(jA, device="cpu")
    T = operator_from_reference(jT, device="cpu")
    assert type(A.left).__name__ == "Laplacian1D" and A.left.segments == 2
    assert T.degree == 3
