"""The port's row-sharded layer (lobpcg_tpu_torch/parallel) on gloo
process groups of 2, 4 and 8 CPU ranks, against the JAX package (its
8-device virtual mesh tests, tests/test_sharding.py, test_spmd_stencil.py,
test_spmd_bsr.py and test_stencil_nd.py:58-83) run in the pytest process.

Each world size is spawned once (``parallel.spawn``, a deadline on every
group) and runs all of its cases; the tests read the ranks' results.  The
ranks import this module, so it imports no JAX at the top: the JAX
references and random draws are made in the pytest process only.  Every
solve gets the JAX solver's random draws (``draws=``), each rank keeping
its rows of them.  Tolerances are the JAX tests' own.
"""

import concurrent.futures
import dataclasses
import time

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch import parallel
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.parallel import (
    RowMesh,
    ShardedBSROperator,
    SpmdLaplacian1D,
    SpmdLaplacianND,
    plan_shards,
    shard_operator,
    shard_problem,
    spawn,
    stencil_matmat_spmd,
    use_spmd_stencils,
)
from lobpcg_tpu_torch.utils import native

# The three spawned groups together: collectives and the joins.  The
# 8-rank group makes ~3,700 small all-reduces; it takes ~25 s on an idle
# 8-core host and over 150 s in the whole suite on six xdist workers, since
# every gloo hop waits for its rank to be scheduled.
TIMEOUT_S = 600.0


# --- inputs, as numpy (the ranks build them from the same seeds) ---------


def rand_block(seed, n, k, dtype=np.float64):
    """tests/fixtures.py:rand_block's numbers."""
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (n, k)).astype(dtype)


def banded_matrix(n, bw, seed=0):
    """tests/test_spmd_bsr.py:_banded_matrix."""
    rng = np.random.RandomState(seed)
    A = np.zeros((n, n))
    for d in range(-bw, bw + 1):
        A += np.diag(rng.randn(n - abs(d)) * (0.3 ** abs(d)), d)
    return 0.5 * (A + A.T) + 2 * bw * np.eye(n)


def dense_tridiag(n, seg, scale):
    A = np.zeros((n, n))
    for lo in range(0, n, seg):
        for i in range(seg):
            A[lo + i, lo + i] = 2 * scale
            if i > 0:
                A[lo + i, lo + i - 1] = -scale
            if i < seg - 1:
                A[lo + i, lo + i + 1] = -scale
    return A


def rcm_matrix():
    """tests/test_spmd_bsr.py:test_rcm_enables_sharding's matrices."""
    n = 128
    A = banded_matrix(n, 3, seed=4)
    scatter = np.random.RandomState(9).permutation(n)
    A_bad = A[np.ix_(scatter, scatter)]
    import scipy.sparse as sp

    M = sp.csr_matrix(A_bad)
    perm = np.asarray(native.rcm_order(n, M.indptr, M.indices))
    return A_bad, A_bad[np.ix_(perm, perm)]


def lap_scale(n):
    h = 1.0 / (n + 1)
    return 1.0 / (h * h)


# The solves: name -> (n, nev, size_sub, tol, max_iter, dtype, seed of X0).
SOLVES = {
    "lap256": (256, 3, 5, 1e-6, 300, np.float64, 201),    # test_sharding.py:28
    "lap128": (128, 3, 6, 1e-7, 200, np.float64, 5),      # test_spmd_stencil.py:72
    "f32_1024": (1024, 2, 128, 1e-5, 300, np.float32, 5),  # test_spmd_stencil.py:120
    "bsr3d": (512, 3, 6, 1e-7, 300, np.float64, 301),     # test_spmd_bsr.py:122
    "lapnd": (512, 3, 6, 1e-8, 300, np.float64, 5),       # test_stencil_nd.py:58
    "bdg64": (128, 3, 5, 1e-4, 500, np.float64, 42),      # test_sharding.py:50
}


# --- the ranks' side ------------------------------------------------------


def _local(mesh, X):
    n_loc = X.shape[0] // mesh.size
    return torch.from_numpy(X[mesh.rank * n_loc : (mesh.rank + 1) * n_loc].copy())


def _solve(mesh, name, A, draws, *, B=None, indefinite=False, X0=None,
           pallas_op=None, rr_chunk=None):
    n, nev, ss, tol, max_iter, dt, seed = SOLVES[name]
    if X0 is None:
        X0 = rand_block(seed, n, ss, dt)
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter,
                          rr_chunk_rows=rr_chunk,
                          rr_dtype="float64" if rr_chunk else None)
    if pallas_op is not None:  # an operator sharded by the caller
        As, X0s, Bs = pallas_op, _local(mesh, X0), None
    else:
        As, X0s, Bs, _ = shard_problem(mesh, A, torch.from_numpy(X0), B)
    solver = tl.ilobpcg if indefinite else tl.lobpcg
    with mesh:
        r = solver(As, X0s, Bs, config=cfg, draws=draws, device="cpu")
    return {"lam": r.eigenvalues.numpy(), "converged": r.converged,
            "iterations": r.iterations,
            "vec_shape": tuple(r.eigenvectors.shape)}


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _bsr_apply(mesh, A, k, seed, dtype=torch.float64, pallas="auto"):
    op = tl.BSROperator.from_dense(A, block_size=8, dtype=dtype, device="cpu")
    sop = ShardedBSROperator.shard(op, mesh, pallas=pallas)
    X = rand_block(seed, A.shape[0], k)
    Y = sop.matmat(_local(mesh, X).to(dtype))
    return {"Y": Y.double().numpy(), "halo": sop.halo,
            "window": sop.win_vals is not None, "kernel_ok": sop._kernel_ok(k)}


def _operators(mesh):
    """Every other sharded form of the table in parallel/sharding.py,
    applied once, against the unsharded operator's rows."""
    n = 64
    rng = np.random.RandomState(12)
    d = torch.from_numpy(rng.uniform(1, 2, n))
    ops = {
        "dense_diag": tl.DenseOperator(torch.from_numpy(rng.randn(n, n)))
        + tl.DiagonalOperator(d),
        "antidiag": tl.BlockAntiDiagOperator(d[: n // 2]),
        "cheb_jacobi": tl.ChebyshevFilter(
            op=tl.ShiftedOperator(2.0 * tl.Laplacian1D(1.0, n, 2, dtype=torch.float64),
                                  0.5), lo=0.5, hi=9.0, degree=3)
        @ tl.JacobiPreconditioner(d),
        "blockdiag": tl.BlockDiagOperator(
            tl.Laplacian1D(3.0, n // 2, dtype=torch.float64)
            + tl.DiagonalOperator(d[: n // 2]), copies=2),
    }
    X = rand_block(13, n, 3)
    out = {}
    for name, op in ops.items():
        want = op.matmat(torch.from_numpy(X))
        got = shard_operator(op, mesh).matmat(_local(mesh, X))
        out[name] = float((got - _local(mesh, want.numpy())).abs().max())
    return out


def _cases_8(mesh, draws):
    out = {
        "lap256": _solve(mesh, "lap256", tl.Laplacian1D(
            lap_scale(256), 256, dtype=torch.float64), draws["lap256"]),
        "lap128": _solve(mesh, "lap128", tl.Laplacian1D(
            lap_scale(128), 128, dtype=torch.float64), draws["lap128"]),
        "rr_chunk": _error(lambda: _solve(
            mesh, "lap256", tl.Laplacian1D(lap_scale(256), 256,
                                           dtype=torch.float64),
            draws["lap256"], rr_chunk=32)),
        "shape60": _error(lambda: SpmdLaplacian1D(
            1.0, 60, mesh=mesh, dtype=torch.float64).matmat(
                torch.zeros((7, 2), dtype=torch.float64))),
        "operators": _operators(mesh),
        "diag": _bsr_apply(mesh, np.diag(np.arange(1.0, 65)), 3, 1),
        "rcm": _bsr_apply(mesh, rcm_matrix()[1], 4, 2),
        "small_shard": _bsr_apply(mesh, banded_matrix(2048, 17), 128, 3,
                                  torch.float32, "interpret"),
    }
    m = 64  # tests/fixtures.py:bdg_ops and bdg_positive_init
    K = tl.Laplacian1D(lap_scale(m), m, dtype=torch.float64)
    u = rand_block(42, m, 5)
    out["bdg64"] = _solve(
        mesh, "bdg64", tl.BlockDiagOperator(K, copies=2), draws["bdg64"],
        B=tl.BlockAntiDiagOperator(torch.ones(m, dtype=torch.float64)),
        indefinite=True, X0=np.concatenate([u, u]))
    n = SOLVES["f32_1024"][0]
    As = SpmdLaplacian1D(float(np.float32(lap_scale(n))), n, mesh=mesh,
                         pallas="interpret", dtype=torch.float32)
    out["f32_1024"] = _solve(mesh, "f32_1024", None, draws["f32_1024"],
                             pallas_op=As)
    return out


def _cases_4(mesh, draws):
    ip, ix, v = tl.laplacian_3d_csr(8, 8, 8)
    bsr = tl.BSROperator.from_csr(ip, ix, v, block_size=8, dtype=torch.float64,
                                  device="cpu")
    sop = ShardedBSROperator.shard(bsr, mesh)
    return {
        "bsr3d": _solve(mesh, "bsr3d", None, draws["bsr3d"], pallas_op=sop),
        "lapnd": _solve(mesh, "lapnd", tl.LaplacianND(
            lap_scale(8), (8, 8, 8), dtype=torch.float64), draws["lapnd"]),
    }


def _rank_main(mesh, world, draws):
    torch.manual_seed(0)
    out = {"stencil": {}, "bsr": {}}
    if world in (2, 8):
        for seg in (1, 2, 4):
            X = _local(mesh, rand_block(7, 64, 3))
            out["stencil"][seg] = stencil_matmat_spmd(
                X, 1.5, mesh, num_segments=seg).numpy()
    for bw in (1, 5, 17):
        out["bsr"][bw] = _bsr_apply(mesh, banded_matrix(256, bw), 5, 3)
    if world in (2, 4):
        out["window"] = _bsr_apply(mesh, banded_matrix(2048, 17), 128, 3,
                                   torch.float32, "interpret")
    if world == 8:
        out.update(_cases_8(mesh, draws))
    if world == 4:
        out.update(_cases_4(mesh, draws))
    return out


def _stall(mesh):
    """Rank 0 enters a collective that rank 1 never joins."""
    if mesh.rank == 0:
        mesh.all_reduce(torch.ones(1))
    else:
        time.sleep(120)


# --- the pytest process's side -------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.fixture(scope="module")
def draws():
    """The JAX solvers' random draws of every solve, for the ranks."""
    jax, _ = _jax()
    import lobpcg_tpu as jl
    from test_torch_solvers import jax_draws

    out = {}
    for name, (n, nev, ss, tol, max_iter, dt, _) in SOLVES.items():
        cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter)
        out[name] = jax_draws(jax.random.PRNGKey(0), n, ss, dt, cfg,
                              indefinite=name == "bdg64",
                              with_b=name == "bdg64", x0_given=True)
    return out


@pytest.fixture(scope="module")
def ranks(draws):
    """world -> the ranks' results.  The groups run one after another in
    a background thread, so the JAX references (``reference``) compute
    meanwhile; each gets what is left of one shared deadline."""
    deadline = time.monotonic() + TIMEOUT_S

    def run(world):
        left = max(10.0, deadline - time.monotonic())
        return spawn(_rank_main, world, world, draws, device="cpu",
                     timeout_s=left)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runs = {w: pool.submit(run, w) for w in (8, 4, 2)}
        yield lambda world: runs[world].result()


@pytest.fixture(scope="module")
def reference():
    """name -> (eigenvalues, converged) of the JAX package's unsharded
    solve, with the same X0 and its default key."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from lobpcg_tpu.operators.sparse import BSROperator as JBSR

    def lap(n, dt=jnp.float64):
        return jl.Laplacian1D(scale=jnp.asarray(lap_scale(n), dt), n=n)

    ip, ix, v = tl.laplacian_3d_csr(8, 8, 8)
    jops = {
        "lap256": lap(256), "lap128": lap(128),
        "f32_1024": lap(1024, jnp.float32),
        "bsr3d": JBSR.from_csr(ip, ix, v, block_size=8, dtype=jnp.float64),
        "lapnd": jl.LaplacianND(scale=jnp.asarray(lap_scale(8), jnp.float64),
                                grid=(8, 8, 8)),
    }
    out = {}
    for name, jA in jops.items():
        n, nev, ss, tol, max_iter, dt, seed = SOLVES[name]
        cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter)
        r = jl.lobpcg(jA, jnp.asarray(rand_block(seed, n, ss, dt)), config=cfg,
                      key=jax.random.PRNGKey(0))
        out[name] = (np.asarray(r.eigenvalues), int(r.converged))
    return out


def gathered(results, *keys):
    """The ranks' local blocks of one case, concatenated in rank order."""
    parts = []
    for res in results:
        for k in keys:
            res = res[k]
        parts.append(res)
    return np.concatenate(parts, axis=0)


# test_sharding.py


def test_sharded_lobpcg_matches_single(ranks, reference):
    res = ranks(8)[0]["lap256"]
    assert res["converged"] == 3
    np.testing.assert_allclose(res["lam"], reference["lap256"][0], rtol=1e-7)


def test_sharded_ilobpcg_bdg(ranks):
    res = ranks(8)[0]["bdg64"]
    assert res["converged"] == 3
    for k in range(1, 4):
        exact = (k * np.pi) ** 2
        assert abs(res["lam"][k - 1] - exact) / exact < 0.01


def test_sharded_output_layout(ranks):
    """Eigenvectors come back as this rank's rows [n / nd, nev]."""
    assert {r["lap256"]["vec_shape"] for r in ranks(8)} == {(256 // 8, 3)}


def test_rr_chunk_rows_rejects_row_sharded_inputs(ranks):
    for r in ranks(8):
        assert "row-sharded" in r["rr_chunk"]
    # Unsharded inputs with the same config stay accepted.
    n = 256
    cfg = tl.SolverConfig(nev=3, size_sub=5, tol=1e-6, max_iter=50,
                          rr_dtype="float64", rr_chunk_rows=32)
    r = tl.lobpcg(tl.Laplacian1D(lap_scale(n), n, dtype=torch.float64),
                  torch.from_numpy(rand_block(202, n, 5)), config=cfg,
                  generator=torch.Generator().manual_seed(0))
    assert r.iterations > 0


def test_every_rank_returns_the_same_eigenvalues(ranks):
    for world, names in ((8, ("lap256", "lap128", "bdg64", "f32_1024")),
                         (4, ("bsr3d", "lapnd"))):
        results = ranks(world)
        for name in names:
            for r in results[1:]:
                assert r[name]["lam"].tobytes() == results[0][name]["lam"].tobytes()
                assert r[name]["iterations"] == results[0][name]["iterations"]


# test_spmd_stencil.py


@pytest.mark.parametrize("segments", [1, 2, 4])
@pytest.mark.parametrize("nd", [2, 8])
def test_spmd_stencil_matches_dense(ranks, segments, nd):
    Y = gathered(ranks(nd), "stencil", segments)
    A = dense_tridiag(64, 64 // segments, 1.5)
    np.testing.assert_allclose(Y, A @ rand_block(7, 64, 3), atol=1e-12)


def test_use_spmd_stencils_rewrites_nested():
    """BlockDiag(Sum(K, D)) becomes one two-segment stencil plus the tiled
    diagonal (the port has no partitioner to slice BlockDiag's copies);
    the untouched diagonal survives until shard_operator places it."""
    mesh = RowMesh(group=None, rank=1, size=4, device=torch.device("cpu"))
    K = tl.Laplacian1D(1.0, 32, dtype=torch.float64)
    op = tl.BlockDiagOperator(
        inner=tl.SumOperator(K, tl.DiagonalOperator(torch.ones(32))), copies=2)
    out = use_spmd_stencils(op, mesh)
    assert isinstance(out.left, SpmdLaplacian1D)
    assert out.left.mesh is mesh
    assert (out.left.n, out.left.segments) == (64, 2)
    assert isinstance(out.right, tl.DiagonalOperator)
    assert out.right.d.shape == (64,)
    placed = shard_operator(out, mesh)
    assert placed.right.op.d.shape == (16,) and placed.right.shape == (64, 64)


def test_sharded_solve_matches_unsharded(ranks, reference):
    res = ranks(8)[0]["lap128"]
    np.testing.assert_allclose(res["lam"], reference["lap128"][0], rtol=1e-9)


def test_spmd_stencil_shape_validation(ranks):
    """60 rows do not split over 8 ranks."""
    for r in ranks(8):
        assert r["shape60"].startswith("ValueError")


def test_f32_kernel_path_solve_matches_unsharded_jax(ranks, reference):
    """The f32 n 1024 x size_sub 128 solve through the sharded kernel path
    (the JAX package's sharded interpret-mode counterpart misses the
    analytic spectrum, ROADMAP queue 3), held against the JAX package's
    unsharded solve at the analytic test's 1%."""
    res = ranks(8)[0]["f32_1024"]
    lam_j, conv_j = reference["f32_1024"]
    assert res["converged"] == conv_j == 2
    np.testing.assert_allclose(res["lam"], lam_j, rtol=1e-2)


# test_spmd_bsr.py


@pytest.mark.parametrize("bw", [1, 5, 17])
@pytest.mark.parametrize("nd", [2, 4, 8])
def test_sharded_bsr_matches_dense(ranks, nd, bw):
    Y = gathered(ranks(nd), "bsr", bw, "Y")
    np.testing.assert_allclose(Y, banded_matrix(256, bw) @ rand_block(3, 256, 5),
                               atol=1e-10)


def test_sharded_bsr_diagonal_no_halo(ranks):
    results = ranks(8)
    assert {r["diag"]["halo"] for r in results} == {0}
    Y = gathered(results, "diag", "Y")
    np.testing.assert_allclose(Y, np.diag(np.arange(1.0, 65)) @ rand_block(1, 64, 3),
                               atol=1e-12)


def test_sharded_bsr_bandwidth_guard():
    A = np.eye(64)
    A[0, -1] = A[-1, 0] = 1.0  # full-bandwidth coupling
    op = tl.BSROperator.from_dense(A, block_size=8, dtype=torch.float64,
                                   device="cpu")
    mesh = RowMesh(group=None, rank=0, size=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="bandwidth"):
        ShardedBSROperator.shard(op, mesh)


def test_rcm_enables_sharding(ranks):
    """The scattered matrix exceeds the per-shard bandwidth; its RCM
    reordering (the port's utils/native.py) shards and applies."""
    A_bad, A_rcm = rcm_matrix()
    op_bad = tl.BSROperator.from_dense(A_bad, block_size=8, dtype=torch.float64,
                                       device="cpu")
    with pytest.raises(ValueError):
        plan_shards(op_bad, 8)
    Y = gathered(ranks(8), "rcm", "Y")
    np.testing.assert_allclose(Y, A_rcm @ rand_block(2, 128, 4), atol=1e-10)


@pytest.mark.parametrize("nd", [2, 4])
def test_sharded_bsr_window_kernel_matches_dense(ranks, nd):
    """The shard-local SpMM takes the edge-buffer window path (K6's plain
    version on the CPU) against the halo-extended frame."""
    results = ranks(nd)
    assert all(r["window"]["window"] and r["window"]["kernel_ok"]
               for r in results)
    Y = gathered(results, "window", "Y")
    ref = banded_matrix(2048, 17) @ rand_block(3, 2048, 128).astype(np.float32)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-5


def test_sharded_bsr_window_small_shard_fallback(ranks):
    """32 block rows a shard are fewer than the 48-block window: no window
    plan, the gather + einsum path stays right."""
    results = ranks(8)
    assert not any(r["small_shard"]["window"] for r in results)
    Y = gathered(results, "small_shard", "Y")
    ref = banded_matrix(2048, 17) @ rand_block(3, 2048, 128).astype(np.float32)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-5


def test_sharded_bsr_in_solver(ranks, reference):
    res = ranks(4)[0]["bsr3d"]
    np.testing.assert_allclose(res["lam"], reference["bsr3d"][0], rtol=1e-9)


# test_stencil_nd.py


def test_3d_sharded(ranks, reference):
    res = ranks(4)[0]["lapnd"]
    np.testing.assert_allclose(res["lam"], reference["lapnd"][0], rtol=1e-9)


def test_sharded_rewrite_partitions_laplacian_nd():
    """The JAX rewrite sets force_jnp for its partitioner; the port's
    rewrite makes the sharded operator, and keeps force_jnp as it was."""
    mesh = RowMesh(group=None, rank=0, size=4, device=torch.device("cpu"))
    A = tl.LaplacianND(1.0, (8, 8, 8), force_jnp=True, dtype=torch.float64)
    As, _, _, _ = shard_problem(mesh, A)
    assert isinstance(As, SpmdLaplacianND) and As.force_jnp
    assert As.shape == (512, 512)
    with pytest.raises(ValueError, match="divide"):
        dataclasses.replace(As, grid=(6, 8, 8)).matmat(torch.zeros((96, 2)))


# the port's own forms and limits


def test_every_sharded_form_matches_the_unsharded_operator(ranks):
    """Dense row panels with a diagonal, the block anti-diagonal swap,
    a Chebyshev filter over a shifted stencil composed with Jacobi, and a
    BlockDiag of stencil plus diagonal, over 8 ranks."""
    for r in ranks(8):
        for name, err in r["operators"].items():
            assert err <= 1e-12, (name, err)


def test_what_has_no_sharded_form_raises():
    """Over 3 ranks the half swap takes the exchange of ``row_plan``, a
    CallableOperator the gathered form, a Laplacian1D whose segment
    boundaries fall inside a shard the gathered form too (the JAX
    package's spmd_stencil=False), and operator rows that do not divide
    stay whole (a replicated solve).  Still refused: a column axis, and a
    class with no sharded form (a BlockDiagOperator of a DenseOperator)."""
    from lobpcg_tpu_torch.parallel.sharding import (
        GatheredOperator,
        ShardedBlockAntiDiagOperator,
    )

    mesh = RowMesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    swap = shard_operator(tl.BlockAntiDiagOperator(torch.ones(3)), mesh)
    assert isinstance(swap, ShardedBlockAntiDiagOperator)
    assert swap.plan is not None and swap.d.shape == (2,)
    call = shard_operator(tl.CallableOperator(args=(), fn=lambda X: X, n=6), mesh)
    assert isinstance(call, GatheredOperator) and call.shape == (6, 6)
    diag = shard_operator(tl.DiagonalOperator(torch.ones(7)), mesh)
    assert isinstance(diag, tl.DiagonalOperator) and diag.d.shape == (7,)
    lap = shard_operator(tl.Laplacian1D(1.0, 60, segments=2,
                                        dtype=torch.float64), mesh)
    assert isinstance(lap, GatheredOperator) and lap.shape == (60, 60)
    assert isinstance(lap.op, tl.Laplacian1D) and lap.op.segments == 2
    with pytest.raises(ValueError, match="axis"):
        parallel.row_sharding(mesh, 2, "cols")
    with pytest.raises(NotImplementedError, match="DenseOperator"):
        shard_operator(tl.BlockDiagOperator(tl.DenseOperator(torch.eye(3)),
                                            copies=2), mesh)


def test_row_mesh_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: row_mesh() would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.row_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        parallel.row_mesh(4, device="cpu")
    with pytest.raises(RuntimeError, match="cards"):
        spawn(_stall, 2)  # the card by default, as row_mesh


def test_a_stalled_collective_fails_by_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(Exception):
        spawn(_stall, 2, device="cpu", timeout_s=5.0)
    assert time.monotonic() - t0 < 60


def test_k6_wrapper_cpu_tensor_runs_the_plain_version():
    """On a CPU tensor the K6 wrapper is its plain version and counts
    nothing."""
    lo = torch.tensor([0, 2], dtype=torch.int32)
    wv = torch.from_numpy(rand_block(4, 2 * 16, 16, np.float32)).reshape(2, 16, 16)
    X = torch.from_numpy(rand_block(5, 32, 3, np.float32))
    top = torch.from_numpy(rand_block(6, 8 + 16, 3, np.float32))
    bot = torch.from_numpy(rand_block(7, 16 + 8, 3, np.float32))
    before = kb.bsr_window_matmat_edges.launches
    Y = kb.bsr_window_matmat_edges(lo, wv, X, top, bot, bs=8, hrows=8)
    assert kb.bsr_window_matmat_edges.launches == before
    want = kb.bsr_window_matmat_edges_reference(lo, wv, X, top, bot, bs=8,
                                                hrows=8)
    assert torch.equal(Y, want)
    with pytest.raises(ValueError, match="edge_top"):
        kb.bsr_window_matmat_edges(lo, wv, X, top[1:], bot, bs=8, hrows=8)
    with pytest.raises(ValueError, match="local"):
        kb.bsr_window_matmat_edges(lo, wv, X[:8], top, bot, bs=8, hrows=8)
