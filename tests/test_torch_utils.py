"""The port's utilities (lobpcg_tpu_torch/utils/{checkpoint,plan,
profiling}.py) against the JAX package's, on the CPU.

Criteria: a snapshot written by either package has the same keys, dtypes
and format version and resumes in the other; resumed and chunked f64
solves reach the one-shot eigenvalues to 1e-8 relative (the JAX test's
bound); the planner reproduces its anchor table exactly and walks its
ladder in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
from lobpcg_tpu.utils import checkpoint as jck
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.utils import checkpoint as tck
from lobpcg_tpu_torch.utils import plan, profiling
from fixtures import laplacian_exact

torch.set_num_threads(2)


def _laplacian(n):
    h = 1.0 / (n + 1)
    return (jl.Laplacian1D(scale=jnp.float64(1 / h / h), n=n),
            tl.Laplacian1D(scale=1 / h / h, n=n, dtype=torch.float64))


def _x0(n, ss):
    return np.random.RandomState(5).uniform(-0.5, 0.5, (n, ss))


def test_checkpoint_round_trip(tmp_path):
    p = tmp_path / "ck.npz"
    X = torch.from_numpy(np.random.RandomState(0).randn(20, 4))
    P = torch.zeros((20, 4), dtype=torch.float64)
    tck.save_checkpoint(p, X, torch.tensor([1.0, 2.0]), iterations=7,
                        momentum=P, meta={"converged": 1})
    ck = tck.load_checkpoint(p)
    np.testing.assert_array_equal(ck["basis"], X.numpy())
    np.testing.assert_array_equal(ck["momentum"], P.numpy())
    assert ck["iterations"] == 7 and isinstance(ck["iterations"], int)
    np.testing.assert_array_equal(ck["eigenvalues"], [1.0, 2.0])
    assert ck["meta_converged"] == 1
    assert not (tmp_path / "ck.npz.tmp").exists()
    with pytest.raises(ValueError, match="newer"):
        np.savez(tmp_path / "new.npz", version=np.int64(2), basis=X.numpy(),
                 iterations=np.int64(0))
        tck.load_checkpoint(tmp_path / "new.npz")


def test_checkpoint_format_matches_the_jax_writer(tmp_path):
    """The same snapshot written by both packages: the same npz keys,
    dtypes and values, and each package's loader reads the other's."""
    X = np.random.RandomState(1).randn(12, 3)
    lam = np.array([0.5, 1.5, 2.5])
    jck.save_checkpoint(tmp_path / "j.npz", jnp.asarray(X), jnp.asarray(lam),
                        iterations=4, momentum=jnp.asarray(X[:, ::-1]),
                        meta={"converged": 2})
    tck.save_checkpoint(tmp_path / "t.npz", torch.from_numpy(X),
                        torch.from_numpy(lam), iterations=4,
                        momentum=torch.from_numpy(X[:, ::-1].copy()),
                        meta={"converged": 2})
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert zj[key].dtype == zt[key].dtype, key
            np.testing.assert_array_equal(zj[key], zt[key])
    for reader in (jck.load_checkpoint, tck.load_checkpoint):
        a, b = reader(tmp_path / "j.npz"), reader(tmp_path / "t.npz")
        assert sorted(a) == sorted(b) and a["iterations"] == b["iterations"] == 4


def test_solve_checkpointed_matches_one_shot(tmp_path):
    """The port's chunked solve (every 7) against its one-shot solve from
    the same X0 (n 100, nev 3, f64, tol 1e-8): eigenvalues to 1e-8."""
    n, nev, ss = 100, 3, 6
    _, A = _laplacian(n)
    X0 = torch.from_numpy(_x0(n, ss))
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=200)
    full = tl.lobpcg(A, X0, config=cfg, generator=torch.Generator().manual_seed(0))
    r = tck.solve_checkpointed(tl.lobpcg, A, X0, config=cfg,
                               path=tmp_path / "s.npz", every=7,
                               generator=torch.Generator().manual_seed(0))
    assert r.converged == nev
    np.testing.assert_allclose(r.eigenvalues.numpy(), full.eigenvalues.numpy(),
                               rtol=1e-8)
    ck = tck.load_checkpoint(tmp_path / "s.npz")
    assert ck["basis"].shape == (n, ss) and ck["meta_converged"] == nev
    assert ck["iterations"] == r.iterations


def test_solve_checkpointed_resume_and_past_max_iter(tmp_path):
    n, nev, ss = 100, 3, 6
    _, A = _laplacian(n)
    X0 = torch.from_numpy(_x0(n, ss))
    p = tmp_path / "s.npz"
    short = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=4)
    tck.solve_checkpointed(tl.lobpcg, A, X0, config=short, path=p, every=4)
    assert tck.load_checkpoint(p)["iterations"] == 4
    # Already at max_iter: one capped iteration, the count kept.
    r = tck.solve_checkpointed(tl.lobpcg, A, None, config=short, path=p,
                               every=4, device="cpu")
    assert r.iterations == 4
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=200)
    r = tck.solve_checkpointed(tl.lobpcg, A, None, config=cfg, path=p,
                               every=10, device="cpu")
    assert r.converged == nev and r.iterations > 4
    exact = laplacian_exact(np.arange(1, nev + 1))
    assert np.all(np.abs(r.eigenvalues.numpy() - exact) / exact < 1e-2)


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("solver", ["lobpcg", "ilobpcg"])
def test_checkpoint_resumes_across_packages(tmp_path, first, solver):
    """One package solves 4 iterations and snapshots; the other resumes
    from the file (basis, momentum, iteration count) and converges to
    the JAX one-shot eigenvalues within 1e-8 relative."""
    n, nev, ss = 100, 3, 6
    jK, tK = _laplacian(n)
    if solver == "lobpcg":
        jA, tA, jB, tB = jK, tK, None, None
        X0 = _x0(n, ss)
    else:
        jA = jl.BlockDiagOperator(inner=jK, copies=2)
        tA = tl.BlockDiagOperator(inner=tK, copies=2)
        jB = jl.BlockAntiDiagOperator(d=jnp.ones((n,), jnp.float64))
        tB = tl.BlockAntiDiagOperator(d=torch.ones(n, dtype=torch.float64))
        u = _x0(n, ss)
        X0 = np.concatenate([u, u])
    jsolve, tsolve = getattr(jl, solver), getattr(tl, solver)
    p = tmp_path / "x.npz"
    short = dict(nev=nev, size_sub=ss, tol=1e-8, max_iter=4)
    full = dict(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)
    if first == "jax":
        jck.solve_checkpointed(jsolve, jA, jnp.asarray(X0), jB,
                               config=jl.SolverConfig(**short), path=p, every=4)
        r = tck.solve_checkpointed(tsolve, tA, None, tB,
                                   config=tl.SolverConfig(**full), path=p,
                                   every=10, device="cpu")
        it, lam, conv = r.iterations, r.eigenvalues.numpy(), r.converged
    else:
        tck.solve_checkpointed(tsolve, tA, torch.from_numpy(X0), tB,
                               config=tl.SolverConfig(**short), path=p,
                               every=4)
        r = jck.solve_checkpointed(jsolve, jA, None, jB,
                                   config=jl.SolverConfig(**full), path=p,
                                   every=10)
        it, lam, conv = int(r.iterations), np.asarray(r.eigenvalues), int(r.converged)
    assert conv == nev and it > 4
    assert "momentum" in tck.load_checkpoint(p)
    ref = jsolve(jA, jnp.asarray(X0), jB, config=jl.SolverConfig(**full),
                 key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-8)


def _cfg(**kw):
    return tl.SolverConfig(nev=56, size_sub=64, **kw)


def test_peak_estimate_is_the_anchor_table():
    """The H100 anchors (tools/plan_anchors.py): the dual basis's branch
    (quality 5 forced) holds no block more than the solve without it;
    pack_applies never enters.  The block part (the estimate less the
    fixed term) is proportional to the block size."""
    for b_cache in (True, False):
        for ax_cache in (True, False):
            assert plan.PEAK_BLOCKS_H100[(True, b_cache, ax_cache)] == \
                pytest.approx(plan.PEAK_BLOCKS_H100[(False, b_cache, ax_cache)],
                              abs=0.01)
    fixed = plan.FIXED_GB_H100
    block = 4_000_000 * 64 * 4 / 2**30
    for (dual, b_cache, ax_cache), blocks in plan.PEAK_BLOCKS_H100.items():
        for pack in (True, False):
            cfg = _cfg(use_b_cache=b_cache, use_ax_cache=ax_cache,
                       dual_basis=dual, pack_applies=pack)
            for dt in (torch.float32, np.float32):
                assert plan.estimate_peak_gb(4_000_000, 64, dt, cfg) - fixed \
                    == pytest.approx(blocks * block, rel=1e-12)
    # The flagship's full configuration: 12.45 GiB on the card.
    assert plan.estimate_peak_gb(4_000_000, 64, torch.float32, _cfg()) == \
        pytest.approx(12.453, abs=0.01)
    base = plan.estimate_peak_gb(4_000_000, 64, torch.float32, _cfg()) - fixed
    assert plan.estimate_peak_gb(2_000_000, 64, torch.float32, _cfg()) \
        - fixed == pytest.approx(base / 2)
    assert plan.estimate_peak_gb(4_000_000, 64, torch.float64, _cfg(),
                                 pad_lanes=True) - fixed == pytest.approx(2 * base)


def test_plan_walks_the_ladder_in_order():
    peak = lambda **kw: plan.estimate_peak_gb(4_000_000, 64, torch.float32,
                                              _cfg(**kw))
    full = plan.plan_config(_cfg(), 4_000_000, hbm_gb=peak() / 0.95 + 0.01)
    assert full == _cfg()
    lean = plan.plan_config(_cfg(), 4_000_000, hbm_gb=peak() / 0.95 - 0.01)
    assert not lean.use_b_cache and lean.use_ax_cache and lean.dual_basis
    # The dual basis costs no memory: no rung turns it off.
    leanest = plan.plan_config(
        _cfg(), 4_000_000, hbm_gb=peak(use_b_cache=False) / 0.95 - 0.01)
    assert not leanest.use_b_cache and not leanest.use_ax_cache
    assert leanest.dual_basis
    kept = plan.plan_config(_cfg(use_ax_cache=False), 1_000_000, hbm_gb=80.0)
    assert not kept.use_ax_cache and kept.use_b_cache  # never re-enabled
    with pytest.raises(ValueError, match="shrink size_sub"):
        plan.plan_config(_cfg(), 64_000_000, hbm_gb=16.0)


def test_plan_default_budget_reads_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan.probe_hbm_gb()
    with pytest.raises(RuntimeError, match="CUDA"):
        plan.plan_config(_cfg(), 1_000_000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 * 2**30, 80 * 2**30))
    assert plan.probe_hbm_gb() == 40.0
    assert plan.plan_config(_cfg(), 4_000_000) == _cfg()


def test_timed_and_trace_on_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    out, sec = profiling.timed(fn, torch.ones(3), warmup=2, reps=4)
    assert torch.equal(out, torch.full((3,), 2.0)) and sec >= 0.0
    assert len(calls) == 6
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
