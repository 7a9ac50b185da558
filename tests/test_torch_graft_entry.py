"""The port's entry points (lobpcg_tpu_torch/graft_entry.py) and the
sharded forms of the realified operators (parallel/sharding.py) on the
CPU, against the JAX package's ``__graft_entry__.py`` and its unsharded
solves on the same numpy inputs.

The sharded cases run on gloo groups of 2, 4 and 8 ranks, each spawned
once (``parallel.spawn``) in a background thread while the JAX
references compute in the pytest process; the ranks import this module,
so it imports no JAX at the top.  Every solve held against the JAX
package gets the JAX solver's random draws (``draws=``).  The JAX
package's sharded interpret path is a known failure (ROADMAP queue 3),
so the unsharded JAX solves are the oracle.

Tolerances: products of the sharded forms 1e-12 (f64); f64 solves 1e-9
relative on the eigenvalues, as tests/test_torch_solvers.py; f32 solves
as stated at each test.
"""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch import graft_entry as ge
from lobpcg_tpu_torch.operators.realify import (
    RealEmbeddedDenseOperator,
    RealEmbeddedDiagonalOperator,
    realify_operator,
    realify_problem,
)
from lobpcg_tpu_torch.parallel import RowMesh, shard_operator, shard_problem, spawn

TIMEOUT_S = 600.0

# The realified BdG solve: complex half-dimension m, nev, size_sub, tol,
# max_iter (complex counts; the real problem doubles them).
RB = dict(m=32, nev=3, ss=5, tol=1e-4, max_iter=500)
# The headline gates at their nev, size_sub and max_iter, at a small n.
HEADLINE = dict(n=2048)
HEADLINE_COMPLEX = dict(n_complex=1024)


def _local(mesh, X):
    n_loc = X.shape[0] // mesh.size
    return X[mesh.rank * n_loc : (mesh.rank + 1) * n_loc]


# --- the ranks' side ------------------------------------------------------


def _realified_ops():
    """Realified B (c = 2), a complex diagonal and a complex Hermitian
    dense operator, embedded in f64, with their unsharded products."""
    n = 32  # complex rows; the embeddings have 64
    rng = np.random.RandomState(21)
    d = torch.from_numpy(rng.uniform(1, 2, n // 2) + 0j)
    dc = torch.from_numpy(rng.uniform(1, 2, n) + 1j * rng.uniform(-1, 1, n))
    M = rng.randn(n, n) + 1j * rng.randn(n, n)
    ops = {
        "realified_b": realify_operator(tl.BlockAntiDiagOperator(d),
                                        torch.float64),
        "embedded_diag": realify_operator(tl.DiagonalOperator(dc),
                                          torch.float64),
        "embedded_dense": realify_operator(
            tl.DenseOperator(torch.from_numpy((M + M.conj().T) / 2)),
            torch.float64),
    }
    X = np.random.RandomState(22).uniform(-0.5, 0.5, (2 * n, 3))
    return ops, torch.from_numpy(X)


def _sharded_products(mesh):
    ops, X = _realified_ops()
    out = {}
    for name, op in ops.items():
        sop = shard_operator(op, mesh)
        got = sop.matmat(_local(mesh, X))
        out[name] = {"err": float((got - _local(mesh, op.matmat(X))).abs().max()),
                     "form": type(sop).__name__}
    return out


def _realified_bdg_solve(mesh, draws):
    m, nev, ss = RB["m"], RB["nev"], RB["ss"]
    A, B, X0 = ge._bdg_problem(m, ss, torch.complex128, "cpu")
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=RB["tol"],
                          max_iter=RB["max_iter"])
    Ar, X0r, Br, _, cfgr = realify_problem(A, X0, B, config=cfg,
                                           rdt=torch.float64)
    As, X0s, Bs, _ = shard_problem(mesh, Ar, X0r, Br)
    with mesh:
        r = tl.ilobpcg(As, X0s, Bs, config=cfgr, draws=draws, device="cpu")
    return {"lam": r.eigenvalues.numpy(), "converged": r.converged,
            "b_form": type(Bs).__name__, "b_copies": Bs.copies}


def _rank_main(mesh, world, draws):
    torch.manual_seed(0)
    out = {"products": _sharded_products(mesh)}
    if world in (2, 4):
        out["multichip"] = ge.dryrun_multichip(world, device="cpu",
                                               draws=draws["multichip"][world])
        out["headline"] = ge.dryrun_headline(world, device="cpu", **HEADLINE)
        out["headline_complex"] = ge.dryrun_headline_complex(
            world, device="cpu", **HEADLINE_COMPLEX)
    if world == 4:
        out["realified_bdg"] = _realified_bdg_solve(mesh, draws["realified_bdg"])
    return out


# --- the pytest process's side -------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _jax_bdg(m, ss, dtype):
    """The JAX entry's problem (imports JAX)."""
    import __graft_entry__ as jge

    return jge._bdg_problem(m, ss, dtype)


@pytest.fixture(scope="module")
def draws():
    """The JAX solvers' random draws of every solve the ranks run."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from test_torch_solvers import jax_draws

    out = {"multichip": {}}
    for world in (2, 4):
        m, n2, ss = 16 * world, 32 * world, 4
        cfg = jl.SolverConfig(nev=2, size_sub=ss, tol=1e-2, max_iter=1)
        out["multichip"][world] = {
            "ilobpcg": jax_draws(jax.random.PRNGKey(0), 2 * m, ss, jnp.float32,
                                 cfg, indefinite=True, with_b=True,
                                 x0_given=True),
            "lobpcg": jax_draws(jax.random.PRNGKey(1), n2, ss, jnp.float32, cfg,
                                indefinite=False, with_b=False, x0_given=True),
        }
    cfgr = jl.SolverConfig(nev=2 * RB["nev"], size_sub=2 * RB["ss"],
                           tol=RB["tol"], max_iter=RB["max_iter"])
    out["realified_bdg"] = jax_draws(jax.random.PRNGKey(0), 4 * RB["m"],
                                     2 * RB["ss"], jnp.float64, cfgr,
                                     indefinite=True, with_b=True,
                                     x0_given=True)
    return out


@pytest.fixture(scope="module")
def ranks(draws):
    """world -> the ranks' results; the groups run one after another in a
    background thread, each with what is left of one shared deadline."""
    deadline = time.monotonic() + TIMEOUT_S

    def run(world):
        left = max(10.0, deadline - time.monotonic())
        return spawn(_rank_main, world, world, draws, device="cpu",
                     timeout_s=left)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runs = {w: pool.submit(run, w) for w in (4, 2, 8)}
        yield lambda world: runs[world].result()


@pytest.fixture(scope="module")
def multichip_reference(draws):
    """world -> the JAX package's unsharded ilobpcg and lobpcg eigenvalues
    on dryrun_multichip's inputs, with its keys."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from lobpcg_tpu.solvers.ilobpcg import _ilobpcg_jit
    from lobpcg_tpu.solvers.lobpcg import _lobpcg_jit

    out = {}
    for world in (2, 4):
        m, n2, ss = 16 * world, 32 * world, 4
        A, B, X0 = _jax_bdg(m, ss, jnp.float32)
        cfg = jl.SolverConfig(nev=2, size_sub=ss, tol=1e-2, max_iter=1)
        r = _ilobpcg_jit(A, B, None, X0, jax.random.PRNGKey(0), cfg)
        K2 = jl.Laplacian1D(scale=jnp.asarray(float(n2) ** 2, jnp.float32), n=n2)
        X2 = jnp.asarray(np.random.RandomState(1).uniform(-0.5, 0.5, (n2, ss)),
                         jnp.float32)
        r2 = _lobpcg_jit(K2, None, None, X2, jax.random.PRNGKey(1), cfg)
        out[world] = (np.asarray(r.eigenvalues), np.asarray(r2.eigenvalues))
    return out


# _realified_duplicated_rows


@pytest.mark.parametrize("r0,r1", [(0, 48), (20, 70), (60, 128), (0, 128),
                                   (31, 33), (95, 97)])
def test_realified_duplicated_rows(r0, r1):
    """Bit for bit against the JAX entry's numpy helper, and against the
    port's realify_x0 of [u; u], over ranges that cross the copy (row 32)
    and re/im (row 64) boundaries."""
    import __graft_entry__ as jge

    m, ss = 32, 3
    rng = np.random.RandomState(7)
    ur = rng.uniform(-0.5, 0.5, (m, ss)).astype(np.float32)
    ui = rng.uniform(-0.5, 0.5, (m, ss)).astype(np.float32)
    got = ge._realified_duplicated_rows(ur, ui, r0, r1)
    assert got.dtype == np.float32
    assert got.tobytes() == jge._realified_duplicated_rows(ur, ui, r0, r1).tobytes()
    u = torch.from_numpy(ur) + 1j * torch.from_numpy(ui)
    full = tl.realify_x0(torch.cat([u, u]).to(torch.complex64), torch.float32)
    assert torch.equal(torch.from_numpy(got), full[r0:r1])


# entry()


def test_entry_step_matches_the_jax_entry():
    """fn(X0) against the JAX entry's jitted step on the same X0 and the
    same draws.  Both stop at the same iteration with 3/3 below the
    step's tol of 1e-3; in f32 the two packages round the contractions
    in another order over those iterations, so the eigenvalues agree to
    that tol (1e-3 relative); the same step on the problem in f64 agrees
    to 1e-9."""
    jax, jnp = _jax()
    import __graft_entry__ as jge
    import lobpcg_tpu as jl
    from lobpcg_tpu.solvers.ilobpcg import _ilobpcg_jit
    from test_torch_solvers import jax_draws

    jfn, (jX0,) = jge.entry()
    lam_j, res_j = (np.asarray(v) for v in jfn(jX0))
    fn, (X0,) = ge.entry(device="cpu")
    assert X0.dtype == torch.float32
    assert X0.numpy().tobytes() == np.asarray(jX0).tobytes()
    cfg = jl.SolverConfig(nev=3, size_sub=5, tol=1e-3, max_iter=25)
    d = jax_draws(jax.random.PRNGKey(0), 128, 5, jnp.float32, cfg,
                  indefinite=True, with_b=True, x0_given=True)
    lam, res = fn(X0, draws=d)
    np.testing.assert_allclose(lam.numpy(), lam_j, rtol=1e-3)
    assert res.numpy().max() <= 1e-3 and res_j.max() <= 1e-3
    A, B, jX64 = _jax_bdg(64, 5, jnp.float64)
    rj = _ilobpcg_jit(A, B, None, jX64, jax.random.PRNGKey(0), cfg)
    A64, B64, X64 = ge._bdg_problem(64, 5, torch.float64, "cpu")
    d64 = jax_draws(jax.random.PRNGKey(0), 128, 5, jnp.float64, cfg,
                    indefinite=True, with_b=True, x0_given=True)
    rt = tl.ilobpcg(A64, X64, B64, config=tl.SolverConfig(
        nev=3, size_sub=5, tol=1e-3, max_iter=25), draws=d64)
    assert rt.iterations == int(rj.iterations) and rt.converged == 3
    np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues),
                               rtol=1e-9)
    exact = (np.arange(1, 4) * np.pi) ** 2
    assert np.abs(lam.numpy() - exact).max() / exact.min() < 0.03


def test_entry_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.entry()


# dryrun_multichip


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip_matches_unsharded_jax(ranks, multichip_reference,
                                                world):
    """Each rank's sharded one-step ilobpcg and lobpcg against the JAX
    package's unsharded solves with the same draws (f32: 1e-5
    relative), the basis over the ranks, and the BSR product against
    tri @ X within the JAX gate's atol 1e-4."""
    lam_j, lam2_j = multichip_reference[world]
    results = ranks(world)
    for r in results:
        rec = r["multichip"]
        assert rec["ranks"] == world and rec["basis_rows"] * world == 32 * world
        np.testing.assert_allclose(rec["ilobpcg_eigenvalues"], lam_j, rtol=1e-5)
        np.testing.assert_allclose(rec["lobpcg_eigenvalues"], lam2_j, rtol=1e-5)
        assert rec["bsr_max_abs_err"] <= 1e-4
        assert rec["ilobpcg_eigenvalues"] == results[0]["multichip"]["ilobpcg_eigenvalues"]


# the sharded forms of the realified operators


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("name,form", [
    ("realified_b", "ShardedBlockAntiDiagOperator"),
    ("embedded_diag", "SumOperator"),
    ("embedded_dense", "RowPanelOperator")])
def test_realified_forms_match_unsharded(ranks, world, name, form):
    """Realified B is c = 2 copies over p = 1, 2, 4 ranks each at world
    2, 4, 8; the embedded diagonal swaps with rank (r + nd/2) % nd; the
    embedded dense operator is a row panel times the gathered X."""
    for r in ranks(world):
        rec = r["products"][name]
        assert rec["form"] == form
        assert rec["err"] <= 1e-12, rec


def test_realified_forms_keep_the_global_shape():
    ops, _ = _realified_ops()
    mesh = RowMesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    for op in ops.values():
        sop = shard_operator(op, mesh)
        assert sop.shape == op.shape == (64, 64)
    b = shard_operator(ops["realified_b"], mesh)
    assert b.copies == 2 and b.d.shape == (32,)
    assert isinstance(ops["embedded_diag"], RealEmbeddedDiagonalOperator)
    assert isinstance(ops["embedded_dense"], RealEmbeddedDenseOperator)


@pytest.mark.parametrize("rank", [0, 1])
def test_interop_places_jax_realified_operators(rank):
    """operator_from_reference(..., mesh=) on the JAX package's realified B
    and embedded diagonal: the sharded forms, whose products on this
    rank's rows equal the JAX operators' to 1e-12 (two ranks: B's two
    copies swap locally, the diagonal's swap partner is the other rank,
    whose rows the test hands over)."""
    import jax.numpy as jnp
    import lobpcg_tpu as jl
    from lobpcg_tpu.operators import realify as jr

    from lobpcg_tpu_torch.interop import operator_from_reference

    rng = np.random.RandomState(23)
    d = rng.uniform(1, 2, 16)
    dc = rng.uniform(1, 2, 32) + 1j * rng.uniform(-1, 1, 32)
    X = rng.uniform(-0.5, 0.5, (64, 3))
    mesh = RowMesh(group=None, rank=rank, size=2, device=torch.device("cpu"))
    jB = jr.realify_operator(jl.BlockAntiDiagOperator(d=jnp.asarray(d + 0j)))
    sB = operator_from_reference(jB, device="cpu", mesh=mesh)
    assert (type(sB).__name__, sB.copies) == ("ShardedBlockAntiDiagOperator", 2)
    want = np.asarray(jB.matmat(jnp.asarray(X)))
    np.testing.assert_allclose(sB.matmat(_local(mesh, torch.from_numpy(X))).numpy(),
                               _local(mesh, want), atol=1e-12)
    jD = jr.realify_operator(jl.DiagonalOperator(jnp.asarray(dc)))
    sD = operator_from_reference(jD, device="cpu", mesh=mesh)
    want = np.asarray(jD.matmat(jnp.asarray(X)))
    other = RowMesh(group=None, rank=1 - rank, size=2, device=torch.device("cpu"))
    Xl, Xp = (_local(m, torch.from_numpy(X)) for m in (mesh, other))
    got = sD.left.matmat(Xl) + sD.right.d[:, None] * Xp  # the swap's result
    np.testing.assert_allclose(got.numpy(), _local(mesh, want), atol=1e-12)


@pytest.mark.parametrize("size,copies", [(3, 2), (6, 2), (2, 3)])
def test_realified_b_ranks_that_cannot_swap_raise(size, copies):
    """3 ranks over 2 copies divide neither way; 6 ranks give each copy 3
    (odd); 2 ranks over 3 copies divide neither way: no single partner
    holds a rank's swapped rows, so each rank's form carries the exchange
    of ``row_plan``.  Every rank's messages carried by hand give the
    unsharded product, to 1e-12."""
    d = torch.from_numpy(np.random.RandomState(size).uniform(1, 2, 6))
    op = tl.BlockDiagOperator(tl.BlockAntiDiagOperator(d), copies=copies)
    n = op.shape[0]
    X = torch.from_numpy(np.random.RandomState(copies).uniform(-0.5, 0.5, (n, 3)))
    sops = [shard_operator(op, RowMesh(group=None, rank=r, size=size,
                                       device=torch.device("cpu")))
            for r in range(size)]
    n_loc = n // size
    parts = [X[r * n_loc : (r + 1) * n_loc] for r in range(size)]
    sent = {(r, q): torch.cat([parts[r][a:b] for a, b in ranges])
            for r, s in enumerate(sops) for q, ranges in s.plan.sends}
    for r, s in enumerate(sops):
        assert (type(s).__name__, s.copies) == ("ShardedBlockAntiDiagOperator",
                                                copies)
        swapped = torch.cat([(parts[r] if q < 0 else sent[(q, r)])[a:b]
                             for q, a, b in s.plan.parts])
        np.testing.assert_allclose((s.d[:, None] * swapped).numpy(),
                                   _local(RowMesh(None, r, size, "cpu"),
                                          op.matmat(X)).numpy(), atol=1e-12)


def test_sharded_realified_bdg_matches_unsharded_jax(ranks, draws):
    """The complex BdG pencil realified in f64 and solved on 4 ranks
    (realified B: two copies over two ranks each), against the JAX
    package's unsharded realified solve with the same draws."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from lobpcg_tpu.operators.realify import realify_problem as jrealify

    A, B, X0 = _jax_bdg(RB["m"], RB["ss"], jnp.complex128)
    cfg = jl.SolverConfig(nev=RB["nev"], size_sub=RB["ss"], tol=RB["tol"],
                          max_iter=RB["max_iter"])
    Ar, X0r, Br, _, cfgr = jrealify(A, X0, B, config=cfg)
    rj = jl.ilobpcg(Ar, X0r, Br, config=cfgr, key=jax.random.PRNGKey(0))
    for r in ranks(4):
        rec = r["realified_bdg"]
        assert (rec["b_form"], rec["b_copies"]) == ("ShardedBlockAntiDiagOperator", 2)
        assert rec["converged"] == int(rj.converged) == 2 * RB["nev"]
        np.testing.assert_allclose(rec["lam"], np.asarray(rj.eigenvalues),
                                   rtol=1e-9)


# the headline gates at a small n


@pytest.mark.parametrize("world", [2, 4])
def test_headline_gates_at_small_n(ranks, world):
    """dryrun_headline and dryrun_headline_complex through the same
    functions on the CPU at nev 150, size_sub 160 and two iterations:
    finite residuals, the basis over the ranks, float64 RR at the complex
    gate's width 960 (float32 storage at the real gate's 480), and the
    same numbers on every rank."""
    results = ranks(world)
    for r in results:
        h, hc = r["headline"], r["headline_complex"]
        assert h["ranks"] == hc["ranks"] == world
        assert h["basis_rows"] * world == HEADLINE["n"]
        assert hc["basis_rows"] * world == 2 * HEADLINE_COMPLEX["n_complex"]
        assert np.isfinite(h["max_residual"]) and np.isfinite(hc["max_residual"])
        assert h["iterations"] == hc["iterations"] == 2
        assert (h["rr_dtype"], hc["rr_dtype"]) == ("float32", "float64")
        assert (h["nev"], hc["nev"], hc["size_sub"]) == (150, 300, 320)
        assert h["max_memory_allocated_gib"] is None
        assert h["max_residual"] == results[0]["headline"]["max_residual"]
        assert hc["max_residual"] == results[0]["headline_complex"]["max_residual"]
