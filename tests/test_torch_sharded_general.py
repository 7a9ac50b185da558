"""The sharded cases that the JAX package solves through XLA's
partitioner and the port shards explicitly (parallel/sharding.py's
table), on gloo groups of 3, 4 and 5 CPU ranks, against the unsharded
JAX package on the same numpy inputs:

- the half swap (BlockAntiDiagOperator, realified B, the embedded
  diagonal's swap term) over any rank count, through the exchange of
  ``parallel/mesh.py:row_plan``;
- the gathered forms: CallableOperator, a LaplacianND whose nx does not
  divide, a BSROperator whose bandwidth reaches past a shard (its block
  rows times the gathered X where they divide, else the whole matrix);
- physics.bdg.BlockDiag2Operator: the pencil of ``bdg_operators`` (a
  Gaussian condensate in a harmonic trap) unrolled into one two-segment
  stencil, and gathered when its segments do not align with the shards
  or a dipolar term is added;
- a Laplacian1D whose segment boundaries fall inside a shard (n 96 in
  two segments over 3 ranks): gathered, the product the JAX package's
  partitioner gives it under ``shard_problem(..., spmd_stencil=False)``;
- operators whose rows do not divide over the ranks: the problem is
  placed whole on every rank and solved there with no row group.

Each world size is spawned once (``parallel.spawn``) and runs all of its
cases; the groups run in a background thread while the JAX references
compute in the pytest process.  The ranks import this module, so it
imports JAX only inside fixtures and tests.  Every solve gets the JAX
solver's random draws (``draws=``).

Tolerances (f64): each rank's rows of each product 1e-12 absolute
against the JAX product; eigenvalues 1e-9 relative with equal
``converged``.
"""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.operators.realify import realify_operator
from lobpcg_tpu_torch.parallel import (
    RowMesh,
    ShardedBSROperator,
    SpmdLaplacian1D,
    SpmdLaplacianND,
    shard_operator,
    shard_problem,
    spawn,
)
from lobpcg_tpu_torch.parallel.mesh import RowPlan, permute_rows, row_plan
from lobpcg_tpu_torch.parallel.sharding import (
    BSRRowPanelOperator,
    GatheredOperator,
    LocalRows,
    RowPanelOperator,
    ShardedBlockAntiDiagOperator,
)
from lobpcg_tpu_torch.physics import bdg as tbdg

TIMEOUT_S = 600.0
WORLDS = (3, 4, 5)
F64 = torch.float64

# The BdG pencil of physics.bdg_operators: m grid points in the unit box,
# kinetic -1/2 Lap_h, a Gaussian condensate in a harmonic trap.
BDG_M, BDG_G, BDG_MU, BDG_OMEGA, BDG_SIGMA = 60, 10.0, 2.0, 60.0, 0.1


def matmul_fn(X, M):
    """A CallableOperator's block function (the same for both packages)."""
    return M @ X


# --- inputs, as numpy ------------------------------------------------------


def rand_block(seed, n, k):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (n, k))


def spd(seed, n):
    G = np.random.RandomState(seed).randn(n, n)
    return G @ G.T / n + np.eye(n)


def sparse_spd(seed, n, density):
    """A symmetric, diagonally dominant matrix with ~density nonzeros."""
    rng = np.random.RandomState(seed)
    S = rng.randn(n, n) * (rng.uniform(size=(n, n)) < density)
    S = S + S.T
    return S + np.diag(np.abs(S).sum(1) + 1.0)


def banded(seed, n, bw):
    rng = np.random.RandomState(seed)
    A = sum(np.diag(rng.randn(n - abs(d)) * 0.3 ** abs(d), d)
            for d in range(-bw, bw + 1))
    return 0.5 * (A + A.T) + 2 * bw * np.eye(n)


def lap_scale(n):
    return float((n + 1) ** 2)


def bdg_inputs(m=BDG_M):
    """(kinetic scale, psi, trap, dipolar kernel, Jacobi diagonal of A)."""
    x = np.arange(1, m + 1) / (m + 1)
    psi = np.exp(-0.5 * ((x - 0.5) / BDG_SIGMA) ** 2)
    v = 0.5 * BDG_OMEGA ** 2 * (x - 0.5) ** 2
    dip = 0.5 * np.exp(-(((x[:, None] - x[None, :]) / 0.05) ** 2)) / (m + 1)
    kin = 0.5 * (m + 1) ** 2
    base = v - BDG_MU + BDG_G * psi ** 2
    diag = np.concatenate([2 * kin + base + 2 * BDG_G * psi ** 2, 2 * kin + base])
    return kin, psi, v, dip, diag


D30 = np.random.RandomState(30).uniform(1, 2, 30)
DC30 = np.random.RandomState(31).uniform(1, 2, 30) + 1j * np.random.RandomState(
    32).uniform(-1, 1, 30)


def port_op(name):
    """The port's unsharded operator of a product case, on the CPU."""
    t = torch.from_numpy
    if name == "antidiag":
        return tl.BlockAntiDiagOperator(t(D30))
    if name in ("realified_b2", "realified_b3"):
        c = int(name[-1])
        return tl.BlockDiagOperator(tl.BlockAntiDiagOperator(t(D30[: 30 // c])),
                                    copies=c)
    if name == "embedded_diag":
        return realify_operator(tl.DiagonalOperator(t(DC30)), F64)
    if name == "dense_diag96":
        return tl.DenseOperator(t(spd(96, 96))) + tl.DiagonalOperator(
            t(np.linspace(1, 2, 96)))
    if name == "callable":
        return tl.CallableOperator(args=(t(spd(60, 60)),), fn=matmul_fn, n=60,
                                   _dtype=F64)
    if name == "bsr_wide":
        return tl.BSROperator.from_dense(sparse_spd(7, 96, 0.3), block_size=8,
                                         dtype=F64, device="cpu")
    if name == "bsr_nb15":
        return tl.BSROperator.from_dense(banded(8, 120, 3), block_size=8,
                                         dtype=F64, device="cpu")
    if name == "lapnd":
        return tl.LaplacianND(lap_scale(8), (6, 8, 8), dtype=F64)
    if name == "lap_diag":
        return tl.Laplacian1D(lap_scale(60), 60, dtype=F64) \
            + tl.DiagonalOperator(t(np.linspace(0, 1, 60)))
    if name == "lap_seg2":
        return tl.Laplacian1D(lap_scale(48), 96, segments=2, dtype=F64)
    if name in ("bdg", "bdg_dipolar"):
        kin, psi, v, dip, _ = bdg_inputs()
        A, _, _, _ = tbdg.bdg_operators(
            tl.Laplacian1D(kin, BDG_M, dtype=F64), t(psi), BDG_G, BDG_MU,
            v_trap=t(v),
            dipolar=tl.DenseOperator(t(dip)) if name == "bdg_dipolar" else None)
        return A
    if name == "bdg_b":
        return tl.BlockAntiDiagOperator(torch.ones(BDG_M, dtype=F64))
    raise KeyError(name)


# name -> (rows, columns of X, seed of X)
PRODUCTS = {
    "antidiag": (60, 3, 1),
    "realified_b2": (60, 3, 2),
    "realified_b3": (60, 3, 3),
    "embedded_diag": (60, 3, 4),
    "dense_diag96": (96, 3, 5),
    "callable": (60, 3, 6),
    "bsr_wide": (96, 3, 7),
    "bsr_nb15": (120, 3, 8),
    "lapnd": (384, 3, 9),
    "lap_diag": (60, 3, 10),
    "lap_seg2": (96, 3, 14),
    "bdg": (2 * BDG_M, 3, 11),
    "bdg_dipolar": (2 * BDG_M, 3, 12),
    "bdg_b": (2 * BDG_M, 3, 13),
}

# name -> (solver, n, nev, size_sub, tol, max_iter, worlds)
SOLVES = {
    "antidiag": ("ilobpcg", 60, 4, 6, 1e-9, 200, (3, 5)),
    "dense_diag96": ("lobpcg", 96, 3, 5, 1e-9, 300, (5,)),
    "callable": ("lobpcg", 60, 3, 8, 1e-9, 300, (4, 5)),
    "bdg": ("ilobpcg", 2 * BDG_M, 3, 8, 1e-9, 300, (3, 4)),
    "bdg_dipolar": ("ilobpcg", 2 * BDG_M, 3, 8, 1e-9, 300, (5,)),
    "bsr_wide": ("lobpcg", 96, 3, 6, 1e-9, 300, (4,)),
    "lapnd": ("lobpcg", 384, 3, 6, 1e-8, 300, (4,)),
    "lap_diag": ("lobpcg", 60, 3, 6, 1e-9, 300, (4, 5)),
    "lap_seg2": ("lobpcg", 96, 3, 6, 1e-9, 300, (3,)),
}


def port_problem(name):
    """(A, X0, B, T) of a solve case, on the CPU."""
    _, n, _, ss, _, _, _ = SOLVES[name]
    t = torch.from_numpy
    if name == "antidiag":
        u = rand_block(40, 30, ss)
        return (tl.DiagonalOperator(t(np.concatenate([D30, D30[::-1] + 0.5]))),
                t(np.concatenate([u, u])), tl.BlockAntiDiagOperator(
                    torch.ones(30, dtype=F64)), None)
    if name in ("bdg", "bdg_dipolar"):
        u = rand_block(41, BDG_M, ss)
        return (port_op(name), t(np.concatenate([u, u])), port_op("bdg_b"),
                tl.JacobiPreconditioner(t(bdg_inputs()[4])))
    return port_op(name), t(rand_block(42, n, ss)), None, None


# --- the ranks' side ------------------------------------------------------


def _local(mesh, X):
    n_loc = X.shape[0] // mesh.size
    return X[mesh.rank * n_loc : (mesh.rank + 1) * n_loc]


def _form(op):
    """The sharded form's type, with the children of a SumOperator."""
    if isinstance(op, tl.SumOperator):
        return f"SumOperator({_form(op.left)}, {_form(op.right)})"
    return type(op).__name__


def _product(mesh, name):
    n, k, seed = PRODUCTS[name]
    X = torch.from_numpy(rand_block(seed, n, k))
    sop = shard_operator(port_op(name), mesh)
    replicated = n % mesh.size != 0
    Y = sop.matmat(X if replicated else _local(mesh, X))
    plan = getattr(sop, "plan", None)
    return {"Y": Y.numpy(), "form": _form(sop), "replicated": replicated,
            "peers": None if plan is None else len(plan.recvs)}


def _solve(mesh, name, draws):
    solver, n, nev, ss, tol, max_iter, _ = SOLVES[name]
    A, X0, B, T = port_problem(name)
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter)
    As, X0s, Bs, Ts = shard_problem(mesh, A, X0, B, T)
    with mesh:
        r = getattr(tl, solver)(As, X0s, Bs, Ts, config=cfg, draws=draws,
                                device="cpu")
    return {"lam": r.eigenvalues.numpy(), "converged": r.converged,
            "iterations": r.iterations, "a_form": _form(As),
            "basis_rows": r.basis.shape[0]}


def _unseeded_solve(mesh):
    """The replicated solve from X0=None: each rank draws from its own
    generator, seeded alike."""
    A, _, _, _ = port_problem("dense_diag96")
    As, _, _, _ = shard_problem(mesh, A)
    with mesh:
        r = tl.lobpcg(As, nev=3, size_sub=5, tol=1e-9, max_iter=300,
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
    return {"lam": r.eigenvalues.numpy(), "iterations": r.iterations}


def _rank_main(mesh, world, draws):
    torch.manual_seed(0)
    out = {"products": {name: _product(mesh, name) for name in PRODUCTS},
           "solves": {name: _solve(mesh, name, draws[name])
                      for name, spec in SOLVES.items() if world in spec[6]}}
    if world == 5:
        out["unseeded"] = _unseeded_solve(mesh)
    return out


# --- the pytest process's side -------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def jax_op(name):
    """The JAX package's unsharded operator of a product or solve case."""
    _, jnp = _jax()
    import lobpcg_tpu as jl
    from lobpcg_tpu.operators import realify as jr
    from lobpcg_tpu.operators.sparse import BSROperator as JBSR
    from lobpcg_tpu.physics import bdg as jbdg

    a = jnp.asarray
    if name == "antidiag":
        return jl.BlockAntiDiagOperator(d=a(D30))
    if name in ("realified_b2", "realified_b3"):
        c = int(name[-1])
        return jl.BlockDiagOperator(inner=jl.BlockAntiDiagOperator(d=a(D30[: 30 // c])),
                                    copies=c)
    if name == "embedded_diag":
        return jr.realify_operator(jl.DiagonalOperator(a(DC30)))
    if name == "dense_diag96":
        return jl.DenseOperator(a(spd(96, 96))) + jl.DiagonalOperator(
            a(np.linspace(1, 2, 96)))
    if name == "callable":
        return jl.CallableOperator(args=(a(spd(60, 60)),), fn=matmul_fn, n=60,
                                   _dtype=jnp.float64)
    if name == "bsr_wide":
        return JBSR.from_dense(sparse_spd(7, 96, 0.3), block_size=8,
                               dtype=jnp.float64)
    if name == "bsr_nb15":
        return JBSR.from_dense(banded(8, 120, 3), block_size=8, dtype=jnp.float64)
    if name == "lapnd":
        return jl.LaplacianND(scale=a(lap_scale(8)), grid=(6, 8, 8))
    if name == "lap_diag":
        return jl.Laplacian1D(scale=a(lap_scale(60)), n=60) \
            + jl.DiagonalOperator(a(np.linspace(0, 1, 60)))
    if name == "lap_seg2":
        return jl.Laplacian1D(scale=a(lap_scale(48)), n=96, segments=2)
    if name in ("bdg", "bdg_dipolar"):
        kin, psi, v, dip, _ = bdg_inputs()
        A, _, _, _ = jbdg.bdg_operators(
            jl.Laplacian1D(scale=a(kin), n=BDG_M), a(psi), BDG_G, BDG_MU,
            v_trap=a(v),
            dipolar=jl.DenseOperator(a(dip)) if name == "bdg_dipolar" else None)
        return A
    if name == "bdg_b":
        return jl.BlockAntiDiagOperator(d=jnp.ones((BDG_M,), jnp.float64))
    raise KeyError(name)


def jax_problem(name):
    """(A, X0, B, T) of a solve case for the JAX package."""
    _, jnp = _jax()
    import lobpcg_tpu as jl

    A, X0, B, T = port_problem(name)
    jB = jT = None
    if name == "antidiag":
        A = jl.DiagonalOperator(jnp.asarray(A.d.numpy()))
        jB = jl.BlockAntiDiagOperator(d=jnp.ones((30,), jnp.float64))
    else:
        A = jax_op(name)
    if name in ("bdg", "bdg_dipolar"):
        jB = jax_op("bdg_b")
        jT = jl.JacobiPreconditioner(jnp.asarray(bdg_inputs()[4]))
    return A, jnp.asarray(X0.numpy()), jB, jT


@pytest.fixture(scope="module")
def draws():
    """The JAX solvers' random draws of every solve, for the ranks."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from test_torch_solvers import jax_draws

    out = {}
    for name, (solver, n, nev, ss, tol, max_iter, _) in SOLVES.items():
        cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter)
        indefinite = solver == "ilobpcg"
        out[name] = jax_draws(jax.random.PRNGKey(0), n, ss, jnp.float64, cfg,
                              indefinite=indefinite, with_b=indefinite,
                              x0_given=True)
    return out


@pytest.fixture(scope="module")
def ranks(draws):
    """world -> the ranks' results; the groups run one after another in a
    background thread, each within what is left of one deadline."""
    deadline = time.monotonic() + TIMEOUT_S

    def run(world):
        left = max(10.0, deadline - time.monotonic())
        return spawn(_rank_main, world, world, draws, device="cpu",
                     timeout_s=left)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runs = {w: pool.submit(run, w) for w in WORLDS}
        yield lambda world: runs[world].result()


@pytest.fixture(scope="module")
def reference():
    """name -> (eigenvalues, converged) of the JAX package's unsharded
    solve of each case, with the draws the ranks got."""
    jax, _ = _jax()
    import lobpcg_tpu as jl

    out = {}
    for name, (solver, _, nev, ss, tol, max_iter, _) in SOLVES.items():
        A, X0, B, T = jax_problem(name)
        cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter)
        r = getattr(jl, solver)(A, X0, B, T, config=cfg,
                                key=jax.random.PRNGKey(0))
        out[name] = (np.asarray(r.eigenvalues), int(r.converged))
    return out


# The sharded form each product case takes at each world size.
G, P, BAD = ("GatheredOperator", "BSRRowPanelOperator",
             "ShardedBlockAntiDiagOperator")
FORMS = {
    "antidiag": {3: BAD, 4: BAD, 5: BAD},
    "realified_b2": {3: BAD, 4: BAD, 5: BAD},
    "realified_b3": {3: BAD, 4: BAD, 5: BAD},
    "embedded_diag": {w: f"SumOperator(LocalRows, {BAD})" for w in WORLDS},
    "dense_diag96": {3: "SumOperator(RowPanelOperator, LocalRows)",
                     4: "SumOperator(RowPanelOperator, LocalRows)",
                     5: "SumOperator(DenseOperator, DiagonalOperator)"},
    "callable": {w: G for w in WORLDS},
    "bsr_wide": {3: P, 4: P, 5: "BSROperator"},
    "bsr_nb15": {3: "ShardedBSROperator", 4: G, 5: "ShardedBSROperator"},
    "lapnd": {3: "SpmdLaplacianND", 4: G, 5: "LaplacianND"},
    "lap_diag": {w: "SumOperator(SpmdLaplacian1D, LocalRows)" for w in WORLDS},
    "lap_seg2": {3: G, 4: "SpmdLaplacian1D", 5: "Laplacian1D"},
    "bdg": {3: G, 4: "SumOperator(SpmdLaplacian1D, LocalRows)", 5: G},
    "bdg_dipolar": {w: G for w in WORLDS},
    "bdg_b": {w: BAD for w in WORLDS},
}
# The most ranks that hold one rank's swapped rows: none where a rank
# holds whole copies, one where a copy spans an even number of ranks.
PEERS = {
    "antidiag": {3: 2, 4: 1, 5: 2},
    "realified_b2": {3: 2, 4: 1, 5: 4},
    "realified_b3": {3: 0, 4: 2, 5: 2},
    "bdg_b": {3: 2, 4: 1, 5: 2},
}


@pytest.mark.parametrize("name,world", [(name, w) for name, spec in SOLVES.items()
                                        for w in spec[6]])
def test_sharded_solve_matches_unsharded_jax(ranks, reference, name, world):
    """Eigenvalues to 1e-9 relative and the converged count, on every
    rank, bit-equal across the ranks; the basis holds this rank's rows
    (all rows where the problem is replicated)."""
    lam_j, conv_j = reference[name]
    n = SOLVES[name][1]
    results = [r["solves"][name] for r in ranks(world)]
    for rec in results:
        assert rec["converged"] == conv_j == SOLVES[name][2]
        np.testing.assert_allclose(rec["lam"], lam_j, rtol=1e-9)
        assert rec["lam"].tobytes() == results[0]["lam"].tobytes()
        assert rec["iterations"] == results[0]["iterations"]
        assert rec["basis_rows"] == (n if n % world else n // world)


@pytest.fixture(scope="module")
def jax_products():
    """name -> the JAX operator's product of each product case."""
    _, jnp = _jax()
    return {name: np.asarray(jax_op(name).matmat(jnp.asarray(
        rand_block(seed, n, k)))) for name, (n, k, seed) in PRODUCTS.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_sharded_product_matches_unsharded_jax(ranks, jax_products, world,
                                               name):
    """Each rank's rows of the product (all rows where the problem is
    replicated) against the JAX operator's, to 1e-12, in the form the
    table names; the exchange's peers at most the ranks that hold the
    swapped rows."""
    n = PRODUCTS[name][0]
    want = jax_products[name]
    for rank, res in enumerate(ranks(world)):
        rec = res["products"][name]
        assert rec["form"] == FORMS[name][world], (rank, rec["form"])
        assert rec["replicated"] == (n % world != 0)
        rows = want if rec["replicated"] else _local(
            RowMesh(None, rank, world, torch.device("cpu")), want)
        np.testing.assert_allclose(rec["Y"], rows, rtol=0, atol=1e-12)
        if name in PEERS:
            assert rec["peers"] <= PEERS[name][world]
    if name in PEERS:
        assert max(r["products"][name]["peers"] for r in ranks(world)) \
            == PEERS[name][world]


def test_replicated_solve_from_x0_none_is_the_lone_solve(ranks):
    """Rows that do not divide (96 over 5 ranks): each rank solves the
    whole problem from X0=None with its own generator seeded alike: the
    ranks agree bit for bit, and with the unsharded solve in this process
    (which runs its GEMMs on another thread count) to 1e-12."""
    A, _, _, _ = port_problem("dense_diag96")
    lone = tl.lobpcg(A, nev=3, size_sub=5, tol=1e-9, max_iter=300,
                     generator=torch.Generator().manual_seed(3), device="cpu")
    results = [r["unseeded"] for r in ranks(5)]
    for res in results:
        assert res["lam"].tobytes() == results[0]["lam"].tobytes()
        assert res["iterations"] == lone.iterations
        np.testing.assert_allclose(res["lam"], lone.eigenvalues.numpy(),
                                   rtol=1e-12)


def test_segments_inside_a_shard_solve_gathered(ranks, draws):
    """Laplacian1D(n 96, 2 segments) on 3 ranks: a shard of 32 rows in a
    segment of 48.  The sharded solve (the gathered form on every rank)
    equals the port's unsharded solve and the JAX package's
    shard_problem(..., spmd_stencil=False) solve on its 3-device CPU
    mesh, eigenvalues to 1e-10 relative."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from lobpcg_tpu.parallel import row_mesh
    from lobpcg_tpu.parallel import shard_problem as jax_shard_problem

    solver, n, nev, ss, tol, max_iter, _ = SOLVES["lap_seg2"]
    A, X0, _, _ = port_problem("lap_seg2")
    lone = tl.lobpcg(A, X0, nev=nev, size_sub=ss, tol=tol, max_iter=max_iter,
                     draws=draws["lap_seg2"], device="cpu")
    jA, jX0 = jax_op("lap_seg2"), jnp.asarray(X0.numpy())
    As, X0s, _, _ = jax_shard_problem(row_mesh(3), jA, jX0,
                                      spmd_stencil=False)
    rj = jl.lobpcg(As, X0s, config=jl.SolverConfig(
        nev=nev, size_sub=ss, tol=tol, max_iter=max_iter),
        key=jax.random.PRNGKey(0))
    lam_j = np.asarray(rj.eigenvalues)
    assert int(rj.converged) == lone.converged == nev
    np.testing.assert_allclose(lone.eigenvalues.numpy(), lam_j, rtol=1e-10)
    for rec in (r["solves"]["lap_seg2"] for r in ranks(3)):
        assert rec["a_form"] == G
        assert rec["converged"] == nev
        np.testing.assert_allclose(rec["lam"], lone.eigenvalues.numpy(),
                                   rtol=1e-10)
        np.testing.assert_allclose(rec["lam"], lam_j, rtol=1e-10)


def test_physics_pencil_forms():
    """The bdg_operators pencil: unrolled into the well's own form (one
    two-segment stencil plus [d_top; d_bottom]) where the segments align
    with the shards, gathered where they do not, and gathered with a
    dipolar term at every rank count."""
    A = port_op("bdg")
    for world, form in ((2, "SumOperator(SpmdLaplacian1D, LocalRows)"),
                        (4, "SumOperator(SpmdLaplacian1D, LocalRows)"),
                        (3, G), (5, G)):
        mesh = RowMesh(None, 1, world, torch.device("cpu"))
        sop = shard_operator(A, mesh)
        assert _form(sop) == form
        if world in (2, 4):
            assert (sop.left.n, sop.left.segments) == (2 * BDG_M, 2)
            kin, psi, v, _, diag = bdg_inputs()
            assert sop.left.scale == kin
            want = np.concatenate([diag[:BDG_M], diag[BDG_M:]]) - 2 * kin
            np.testing.assert_allclose(sop.right.op.d.numpy(),
                                       _local(mesh, want), atol=1e-12)
        assert _form(shard_operator(port_op("bdg_dipolar"), mesh)) == G


def test_existing_fast_forms_keep_their_types():
    """What had a sharded form before keeps it: the well's A through
    SpmdLaplacian1D, a BSR matrix whose band fits a shard through
    ShardedBSROperator, dense panels, row-local diagonals, and the half
    swap at an even rank count as one message each way to the rank
    nd/2 away, of one contiguous range."""
    mesh = RowMesh(None, 1, 4, torch.device("cpu"))
    well = tl.Laplacian1D(1.0, 64, segments=2, dtype=F64) + tl.DiagonalOperator(
        torch.ones(64, dtype=F64))
    sop = shard_operator(well, mesh)
    assert isinstance(sop.left, SpmdLaplacian1D) and isinstance(sop.right, LocalRows)
    band = shard_operator(port_op("bsr_nb15"), RowMesh(None, 1, 5,
                                                       torch.device("cpu")))
    assert isinstance(band, ShardedBSROperator)
    assert isinstance(shard_operator(tl.DenseOperator(torch.eye(64)), mesh),
                      RowPanelOperator)
    assert isinstance(shard_operator(tl.JacobiPreconditioner(torch.ones(64)), mesh),
                      LocalRows)
    swap = shard_operator(tl.BlockAntiDiagOperator(torch.ones(32)), mesh)
    assert isinstance(swap, ShardedBlockAntiDiagOperator)
    assert swap.plan == RowPlan(sends=((3, ((0, 16),)),), recvs=((3, 16),),
                                parts=((3, 0, 16),))
    nd = shard_operator(tl.LaplacianND(1.0, (8, 8, 8)), mesh)
    assert isinstance(nd, SpmdLaplacianND)
    assert not isinstance(nd, GatheredOperator)


@pytest.mark.parametrize("n,world,copies", [(60, 3, 1), (60, 5, 2), (120, 5, 3),
                                            (96, 4, 3), (70, 7, 5), (64, 8, 2)])
def test_row_plan_is_the_half_swap(n, world, copies):
    """Every rank's plan, its messages carried by hand, gives the global
    half swap of each copy; a rank receives from at most two ranks when a
    copy spans an odd number of ranks."""
    from lobpcg_tpu_torch.parallel.sharding import _half_swap_pieces

    X = torch.arange(n, dtype=F64)[:, None]
    n_loc = n // world
    plans = [row_plan(n, world, r, _half_swap_pieces(n, copies))
             for r in range(world)]
    sent = {(r, q): torch.cat([X[r * n_loc + a : r * n_loc + b] for a, b in rs])
            for r, p in enumerate(plans) for q, rs in p.sends}
    got = []
    for r, p in enumerate(plans):
        Xl = X[r * n_loc : (r + 1) * n_loc]
        assert all(sent[(q, r)].shape[0] == rows for q, rows in p.recvs)
        got.append(torch.cat([(Xl if q < 0 else sent[(q, r)])[a:b]
                              for q, a, b in p.parts]))
    m = n // (2 * copies)
    assert torch.equal(torch.cat(got),
                       X.reshape(copies, 2, m, 1).flip(1).reshape(n, 1))
    if world % copies == 0 and (world // copies) % 2:
        assert max(len(p.recvs) for p in plans) <= 2


def test_permute_rows_without_peers_is_local():
    """At world size 1 the plan is a local permutation: no message."""
    from lobpcg_tpu_torch.parallel import mesh as pmesh
    from lobpcg_tpu_torch.parallel.sharding import _half_swap_pieces

    plan = row_plan(12, 1, 0, _half_swap_pieces(12, 3))
    assert plan.sends == () and plan.recvs == ()
    X = torch.arange(12, dtype=F64)[:, None]
    before = pmesh.permute_rows.launches
    Y = permute_rows(RowMesh(None, 0, 1, torch.device("cpu")), X, plan)
    assert pmesh.permute_rows.launches == before
    assert torch.equal(Y, X.reshape(3, 2, 2, 1).flip(1).reshape(12, 1))


def test_single_partner_swap_copies_nothing(monkeypatch):
    """The half swap at an even rank count: the message sent is a view of
    X, and the product's rows are the receive buffer itself."""
    from lobpcg_tpu_torch.parallel import mesh as pmesh

    mesh = RowMesh(None, 1, 4, torch.device("cpu"))
    swap = shard_operator(tl.BlockAntiDiagOperator(torch.ones(32, dtype=F64)),
                          mesh)
    X = torch.arange(16 * 3, dtype=F64).reshape(16, 3)
    seen = {}

    def p2p(mesh_, sends, recvs):
        (t, peer), = sends
        (buf, src), = recvs
        seen.update(send=t, buf=buf, peers=(peer, src))
        buf.copy_(t + 100)

    monkeypatch.setattr(pmesh, "_p2p", p2p)
    Y = permute_rows(mesh, X, swap.plan)
    assert seen["peers"] == (3, 3)
    assert seen["send"].data_ptr() == X.data_ptr()
    assert Y.data_ptr() == seen["buf"].data_ptr()
    assert torch.equal(Y, X + 100)


def test_bsr_row_panel_is_this_ranks_block_rows(monkeypatch):
    """A BSR matrix whose band reaches past a shard but whose block rows
    divide: this rank's block rows (global block columns) on the gathered
    block, equal to those rows of the unsharded product."""
    from lobpcg_tpu_torch.parallel import sharding

    op = port_op("bsr_wide")
    X = torch.from_numpy(rand_block(7, 96, 3))
    want = op.matmat(X)
    monkeypatch.setattr(sharding, "all_gather_rows", lambda mesh, Xl: X)
    for rank in range(4):
        mesh = RowMesh(None, rank, 4, torch.device("cpu"))
        sop = shard_operator(op, mesh)
        assert isinstance(sop, BSRRowPanelOperator)
        assert sop.blocks.shape[0] == 3 and sop.shape == (96, 96)
        Y = sop.matmat(_local(mesh, X))
        np.testing.assert_allclose(Y.numpy(), _local(mesh, want).numpy(),
                                   rtol=0, atol=1e-12)
