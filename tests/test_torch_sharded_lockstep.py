"""The lockstep batch under a row group: an X0 [b, n_loc, k] (each rank's
rows of b problems) through the sharded operators of
``parallel/sharding.py``, on gloo groups of 2 and 4 CPU ranks, against
``jax.vmap`` of the JAX package's solve over the same problem sharded by
its ``shard_problem`` / ``ShardedBSROperator.shard`` on ``row_mesh(nd)``
with the same nd (the sharded operators built outside the map, the
per-problem data inside it).  f64, inputs from numpy seeds; every solve
gets the JAX solver's random draws (``draws=``).

Solves (3 problems each): the BdG pencil of ``tests/fixtures.py:bdg_ops``
plus a shift; the flagship's form (a two-segment Laplacian1D plus a
DiagonalOperator [b, n], a Chebyshev T with [b] upper bounds); a
ShardedBSROperator on a windowed band and on the 8^3 Laplacian (the
frame route) plus a shift; the realified well over 3 barriers.  Per
problem: converged equal and eigenvalues 1e-7 relative against jax.vmap
(tests/test_sharding.py's bound: sharded Grams round otherwise than one
contraction), and 1e-9 against the port's lone sharded solve and its
unsharded lockstep solve.  The band also runs in f32 through the K6 route
(its plain version on the CPU): 1e-5 against jax.vmap's f64 eigenvalues.

Applies: every sharded operator class, batched, equals its problems' lone
applies bit for bit, with one exchange a batch apply.  A batch of one
problem thrice makes exactly the lone solve's all-reduces.  Then the
index maths of K1's batched edge rows and of K6's per-problem column
tiles, emulated in numpy against the plain versions.

Each world size is spawned once (``parallel.spawn``, with a deadline: a
rank that branches alone deadlocks a collective, and the deadline fails
it); the groups run in a background thread while the JAX references
compute in the pytest process.  The ranks import this module, so it
imports JAX only inside fixtures and tests.
"""

import concurrent.futures
import dataclasses
import time

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.operators.realify import (
    RealEmbeddedDenseOperator,
    RealEmbeddedDiagonalOperator,
)
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.parallel import (
    RowMesh,
    plan_shards,
    shard_operator,
    shard_problem,
    spawn,
)
from lobpcg_tpu_torch.parallel import mesh as pmesh
from lobpcg_tpu_torch.parallel import spmd_bsr

TIMEOUT_S = 600.0
WORLDS = (2, 4)
F64, F32 = torch.float64, torch.float32
SHIFTS = (0.0, 3.0, 7.0)
BARRIERS = (1.0, 2.0, 3.0)
# The BdG well of benchmarks/solve_bdg.py at a small size (as in
# tests/test_torch_batched.py): WELL sites at potential SHIFT inside a
# box at barrier + SHIFT; Chebyshev on [CHEB_LO, 4 + barrier + SHIFT + 0.1].
WELL, SHIFT, CHEB_LO = 48, 1.0, 2.0


def matmul_fn(X, M):
    """A CallableOperator's block function."""
    return M @ X


# --- inputs, as numpy ------------------------------------------------------


def rand_block(seed, n, k):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (n, k))


def banded(seed, n, bw):
    """A symmetric band of half-width bw, diagonally dominant."""
    rng = np.random.RandomState(seed)
    A = sum(np.diag(rng.randn(n - abs(d)) * 0.3 ** abs(d), d)
            for d in range(-bw, bw + 1))
    return 0.5 * (A + A.T) + 2 * bw * np.eye(n)


def sparse_spd(seed, n, density):
    rng = np.random.RandomState(seed)
    S = rng.randn(n, n) * (rng.uniform(size=(n, n)) < density)
    S = S + S.T
    return S + np.diag(np.abs(S).sum(1) + 1.0)


def well_potential(m, barrier):
    lo = (m - WELL) // 2
    inside = (np.arange(m) >= lo) & (np.arange(m) < lo + WELL)
    return np.where(inside, SHIFT, barrier + SHIFT), lo


def well_x0(n, ss):
    """[u; u], u random in the well's sites and zero outside."""
    m = n // 2
    _, lo = well_potential(m, 1.0)
    u = np.zeros((m, ss))
    u[lo : lo + WELL] = rand_block(42, WELL, ss)
    return np.concatenate([u, u])


def cheb_hi(barrier):
    return 4.0 + barrier + SHIFT + 0.1


def lap3d_csr():
    from lobpcg_tpu_torch.operators.sparse import laplacian_3d_csr

    return laplacian_3d_csr(8, 8, 8)


BAND_N, BAND_BW = 1536, 16


# name -> (solver, n, nev, size_sub, tol, dtype)
SOLVES = {
    "bdg": ("ilobpcg", 128, 3, 6, 1e-8, F64),
    "well": ("ilobpcg", 256, 4, 8, 1e-8, F64),
    "band": ("lobpcg", BAND_N, 3, 6, 1e-8, F64),
    "lap3d": ("lobpcg", 512, 3, 6, 1e-8, F64),
    "realified": ("ilobpcg", 256, 4, 8, 1e-8, F64),
    "band_f32": ("lobpcg", BAND_N, 3, 6, 1e-5, F32),
}


def _cfg(name):
    _, _, nev, ss, tol, _ = SOLVES[name]
    return tl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=400)


def port_case(name, i=None):
    """(A, X0, B, T) of a solve case for problem i, or for the batch of 3
    (i None: per-problem data [3, ...], X0 [3, n, ss]), on the CPU."""
    _, n, _, ss, _, dt = SOLVES[name]
    t = torch.from_numpy
    pick = (lambda v: v) if i is None else (lambda v: v[i])
    B = T = None
    if name == "bdg":
        m = n // 2
        A = tl.BlockDiagOperator(tl.Laplacian1D(float((m + 1) ** 2), m,
                                                dtype=F64), 2)
        A = A + tl.DiagonalOperator(pick(t(np.asarray(SHIFTS)[:, None]
                                           * np.ones(n))))
        B = tl.BlockAntiDiagOperator(torch.ones(m, dtype=F64))
        u = rand_block(0, m, ss)
        X0 = np.concatenate([u, u])
    elif name == "well":
        m = n // 2
        VV = np.stack([np.concatenate([well_potential(m, b)[0]] * 2)
                       for b in BARRIERS])
        A = tl.Laplacian1D(1.0, n, segments=2, dtype=F64) \
            + tl.DiagonalOperator(pick(t(VV)))
        hi = [cheb_hi(b) for b in BARRIERS]
        T = tl.ChebyshevFilter(op=A, lo=CHEB_LO, degree=3, hi=(
            torch.tensor(hi, dtype=F64) if i is None else hi[i]))
        B = tl.BlockAntiDiagOperator(torch.ones(m, dtype=F64))
        X0 = well_x0(n, ss)
    elif name in ("band", "band_f32", "lap3d"):
        if name == "lap3d":
            base = tl.BSROperator.from_csr(*lap3d_csr(), block_size=8,
                                           dtype=dt, device="cpu")
        else:
            base = tl.BSROperator.from_dense(banded(3, BAND_N, BAND_BW),
                                             block_size=8, dtype=dt,
                                             device="cpu")
        D = np.asarray(SHIFTS)[:, None] * np.ones(n)
        A = base + tl.DiagonalOperator(pick(t(D).to(dt)))
        X0 = rand_block(5, n, ss)
    elif name == "realified":
        mc, c128 = n // 4, torch.complex128
        V = np.stack([well_potential(mc, b)[0] for b in BARRIERS])
        K = tl.Laplacian1D(1.0, mc, dtype=c128) \
            + tl.DiagonalOperator(pick(t(V).to(c128)))
        Xc = t(well_x0(2 * mc, ss // 2)).to(c128)
        if i is None:
            Xc = Xc.expand(len(BARRIERS), *Xc.shape).contiguous()
        A, X0r, B, _, _ = tl.realify_problem(
            tl.BlockDiagOperator(K, 2), Xc,
            tl.BlockAntiDiagOperator(torch.ones(mc, dtype=c128)),
            config=tl.SolverConfig(nev=2, size_sub=ss // 2))
        hi = [cheb_hi(b) for b in BARRIERS]
        T = tl.ChebyshevFilter(op=A, lo=CHEB_LO, degree=3, hi=(
            torch.tensor(hi, dtype=F64) if i is None else hi[i]))
        return A, X0r, B, T
    else:
        raise KeyError(name)
    X0 = t(X0).to(dt)
    if i is None:
        X0 = X0.expand(len(SHIFTS), *X0.shape).contiguous()
    return A, X0, B, T


def solve(name, A, X0, B, T, draws):
    solver = getattr(tl, SOLVES[name][0])
    r = solver(A, X0, B, T, config=_cfg(name), draws=draws, device="cpu")
    return {"lam": r.eigenvalues.numpy(), "converged": np.asarray(r.converged),
            "iterations": np.asarray(r.iterations)}


# --- the applies: name -> (batched operator, problem i's operator, rows) ---


def apply_cases():
    t = torch.from_numpy
    rng = np.random.RandomState(20)
    b = 3
    d = t(rng.uniform(1, 2, (b, 48)))
    M = t(rng.randn(b, 48, 48))
    Ar, Ai = t(rng.randn(b, 24, 24)), t(rng.randn(b, 24, 24))
    dh = t(rng.uniform(1, 2, (b, 24)))
    dr, di = t(rng.uniform(1, 2, (b, 24))), t(rng.uniform(-1, 1, (b, 24)))
    scales = t(rng.uniform(1, 3, b))
    wide = tl.BSROperator.from_dense(sparse_spd(7, 96, 0.3), block_size=8,
                                     dtype=F64, device="cpu")

    def bsr(A, dt):
        return tl.BSROperator.from_dense(A, block_size=8, dtype=dt,
                                         device="cpu")

    band = banded(3, BAND_N, BAND_BW)
    b384 = banded(4, 384, 16)
    lap3 = {dt: tl.BSROperator.from_csr(*lap3d_csr(), block_size=8,
                                        dtype=dt, device="cpu")
            for dt in (F64, F32)}
    shared = {
        "lap_seg2": tl.Laplacian1D(9.0, 96, segments=2, dtype=F64),
        "lapnd": tl.LaplacianND(2.0, (8, 3, 4), dtype=F64),
        "bsr_wide": wide,
        "band_f64": bsr(band, F64),
        "band_f32": bsr(band, F32),
        "band384_f32": bsr(b384, F32),
        "lap3d_f64": lap3[F64],
        "lap3d_f32": lap3[F32],
    }
    cases = {
        "diag": (tl.DiagonalOperator(d), lambda i: tl.DiagonalOperator(d[i])),
        "dense": (tl.DenseOperator(M), lambda i: tl.DenseOperator(M[i])),
        "embedded_dense": (RealEmbeddedDenseOperator(Ar, Ai),
                           lambda i: RealEmbeddedDenseOperator(Ar[i], Ai[i])),
        "antidiag": (tl.BlockAntiDiagOperator(dh),
                     lambda i: tl.BlockAntiDiagOperator(dh[i])),
        "realified_b": (tl.BlockDiagOperator(tl.BlockAntiDiagOperator(
            dh[:, :12]), 2), lambda i: tl.BlockDiagOperator(
                tl.BlockAntiDiagOperator(dh[i, :12]), 2)),
        "embedded_diag": (RealEmbeddedDiagonalOperator(dr, di),
                          lambda i: RealEmbeddedDiagonalOperator(dr[i], di[i])),
        "callable": (tl.CallableOperator(args=(M,), fn=matmul_fn, n=48,
                                         _dtype=F64, in_axes=(0,)),
                     lambda i: tl.CallableOperator(args=(M[i],), fn=matmul_fn,
                                                   n=48, _dtype=F64)),
        "lap_scales": (tl.Laplacian1D(scales, 48, dtype=F64),
                       lambda i: tl.Laplacian1D(float(scales[i]), 48,
                                                dtype=F64)),
    }
    for name, op in shared.items():
        cases[name] = (op, lambda i, op=op: op)
    return cases


# The sharded form of each apply case at each world size, and the route a
# ShardedBSROperator takes (its kernels' plain versions on the CPU).
FORMS = {
    "diag": "LocalRows", "dense": "RowPanelOperator",
    "embedded_dense": "RowPanelOperator",
    "antidiag": "ShardedBlockAntiDiagOperator",
    "realified_b": "ShardedBlockAntiDiagOperator",
    "embedded_diag": "SumOperator(LocalRows, ShardedBlockAntiDiagOperator)",
    "callable": "GatheredOperator", "lap_scales": "SpmdLaplacian1D",
    "lap_seg2": "SpmdLaplacian1D", "lapnd": "SpmdLaplacianND",
    "bsr_wide": "BSRRowPanelOperator", "band_f64": "ShardedBSROperator",
    "band_f32": "ShardedBSROperator", "band384_f32": "ShardedBSROperator",
    "lap3d_f64": "ShardedBSROperator", "lap3d_f32": "ShardedBSROperator",
}
ROUTES = {
    "band_f64": {2: "einsum", 4: "einsum"},
    "band_f32": {2: "k6", 4: "k6"},
    # 12 block rows a shard at 4 ranks: the window (16 blocks) is wider
    # than the shard, so K5 on the frame; 24 at 2 ranks: no window fits
    # the frame, so K3 on it.
    "band384_f32": {2: "k3", 4: "k5"},
    "lap3d_f64": {2: "einsum", 4: "einsum"},
    "lap3d_f32": {2: "k3", 4: "k5"},
}
APPLY_K = 5


def _form(op):
    if isinstance(op, tl.SumOperator):
        return f"SumOperator({_form(op.left)}, {_form(op.right)})"
    return type(op).__name__


class _Routes:
    """Count the kernel wrappers ShardedBSROperator calls (their plain
    versions on the CPU) while inside."""

    NAMES = {"bsr_window_matmat_edges": "k6", "bsr_window_matmat": "k5",
             "bsr_matmat": "k3", "bsr_matmat_reference": "einsum"}

    def __enter__(self):
        self.calls = {v: 0 for v in self.NAMES.values()}
        self._saved = {}
        for name, route in self.NAMES.items():
            fn = getattr(spmd_bsr, name)
            self._saved[name] = fn

            def counted(*a, _fn=fn, _route=route, **kw):
                self.calls[_route] += 1
                return _fn(*a, **kw)

            setattr(spmd_bsr, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(spmd_bsr, name, fn)
        return False


def _exchanges():
    return (pmesh.halo_exchange.launches, pmesh.permute_rows.launches,
            pmesh.all_gather_rows.launches)


def _apply(mesh, name, op, lone):
    b = 3
    n = op.shape[0]
    dt = op.dtype
    X = torch.from_numpy(np.random.RandomState(21).randn(b, n, APPLY_K)).to(dt)
    n_loc = n // mesh.size
    Xl = X[:, mesh.rank * n_loc : (mesh.rank + 1) * n_loc].contiguous()
    sop = shard_operator(op, mesh)
    e0 = _exchanges()
    with _Routes() as routes:
        Y = sop.matmat(Xl)
    e1 = _exchanges()
    parts = []
    for i in range(b):
        lop = shard_operator(lone(i), mesh)
        parts.append(lop.matmat(Xl[i].contiguous()))
        if i == 0:
            e2 = _exchanges()
    used = [r for r, c in routes.calls.items() if c]
    return {"form": _form(sop), "equal": bool(torch.equal(Y, torch.stack(parts))),
            "shape": tuple(Y.shape),
            "batch_exchanges": [a - c for a, c in zip(e1, e0)],
            "lone_exchanges": [a - c for a, c in zip(e2, e1)],
            "route": used[-1] if used else None}


# --- the ranks' side ------------------------------------------------------


def _solves(mesh, name, draws):
    A, X0, B, T = port_case(name)
    As, X0s, Bs, Ts = shard_problem(mesh, A, X0, B, T)
    pmesh.all_reduce.launches = 0
    with mesh, _Routes() as routes:
        batch = solve(name, As, X0s, Bs, Ts, draws)
    batch["routes"] = routes.calls
    batch["x0_rows"] = X0s.shape[-2]
    lone = []
    for i in range(3):
        A, X0, B, T = port_case(name, i)
        As, X0s, Bs, Ts = shard_problem(mesh, A, X0, B, T)
        with mesh:
            lone.append(solve(name, As, X0s, Bs, Ts, draws))
    return {"batch": batch, "lone": lone}


def _all_reduces(mesh, draws):
    """The well case's problem 0 alone and thrice as a batch (size_sub 8:
    every k x k product takes torch's per-problem GEMM, so the batch is
    its lone solve bit for bit): (all-reduces, iterations) of each."""
    A, X0, B, T = port_case("well", 0)
    out = []
    for batch in (False, True):
        Ab, Tb, X = A, T, X0
        if batch:
            Ab = dataclasses.replace(A, right=tl.DiagonalOperator(
                A.right.d.expand(3, -1).contiguous()))
            Tb = dataclasses.replace(T, op=Ab)
            X = X0.expand(3, *X0.shape).contiguous()
        As, Xs, Bs, Ts = shard_problem(mesh, Ab, X, B, Tb)
        pmesh.all_reduce.launches = 0
        with mesh:
            r = solve("well", As, Xs, Bs, Ts, draws)
        out.append((pmesh.all_reduce.launches, r["iterations"].tolist()))
    return out


def _rank_main(mesh, world, draws):
    # One thread a rank: the ops are small, and idle intra-op threads
    # spinning beside other test workers' slowed the ranks several-fold.
    torch.set_num_threads(1)
    torch.manual_seed(0)
    return {
        "applies": {name: _apply(mesh, name, op, lone)
                    for name, (op, lone) in apply_cases().items()},
        "solves": {name: _solves(mesh, name, draws[name]) for name in SOLVES},
        "all_reduces": _all_reduces(mesh, draws["well"]),
    }


# --- the pytest process's side -------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.fixture(scope="module")
def draws():
    """The JAX solvers' random draws of every solve, for the ranks."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from test_torch_solvers import jax_draws

    out = {}
    for name, (solver, n, nev, ss, tol, _) in SOLVES.items():
        cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=400)
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


def jax_vmap(name, nd):
    """jax.vmap of the JAX package's solve over the 3 problems, on its
    problem sharded over row_mesh(nd): (eigenvalues, converged)."""
    jax, jnp = _jax()
    import lobpcg_tpu as jl
    from lobpcg_tpu.operators.sparse import BSROperator as JBSR
    from lobpcg_tpu.operators.sparse import laplacian_3d_csr as j_lap3d
    from lobpcg_tpu.parallel import row_mesh
    from lobpcg_tpu.parallel import shard_array as j_shard_array
    from lobpcg_tpu.parallel import shard_problem as j_shard_problem
    from lobpcg_tpu.parallel.spmd_bsr import ShardedBSROperator as JSBSR

    solver, n, nev, ss, tol, _ = SOLVES[name]
    cfg = jl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=400)
    mesh = row_mesh(nd)
    f64 = jnp.float64
    B = T = None
    if name == "bdg":
        m = n // 2
        A0 = jl.BlockDiagOperator(inner=jl.Laplacian1D(
            scale=jnp.asarray(float((m + 1) ** 2)), n=m), copies=2)
        u = rand_block(0, m, ss)
        A0, X0, B, _ = j_shard_problem(mesh, A0, jnp.asarray(
            np.concatenate([u, u])), jl.BlockAntiDiagOperator(
                d=jnp.ones((m,), f64)))

        def problem(s):
            return A0 + jl.DiagonalOperator(s * jnp.ones((n,), f64)), None

        mapped = jnp.asarray(SHIFTS)
    elif name in ("well", "realified"):
        segs, m = (2, n // 2) if name == "well" else (4, n // 4)
        lap = jl.Laplacian1D(scale=jnp.asarray(1.0), n=n, segments=segs)
        if name == "well":
            X0 = well_x0(n, ss)
            Bj = jl.BlockAntiDiagOperator(d=jnp.ones((m,), f64))
        else:
            X0 = tl.realify_x0(torch.from_numpy(well_x0(2 * m, ss // 2)).to(
                torch.complex128)).numpy()
            Bj = jl.BlockDiagOperator(inner=jl.BlockAntiDiagOperator(
                d=jnp.ones((m,), f64)), copies=2)
        A0, X0, B, _ = j_shard_problem(mesh, lap, jnp.asarray(X0), Bj)

        def problem(barrier):
            V = jnp.where(jnp.asarray(well_potential(m, 1.0)[0] == SHIFT),
                          SHIFT, barrier + SHIFT)
            A = A0 + jl.DiagonalOperator(jnp.tile(V, n // m))
            return A, jl.ChebyshevFilter(op=A, lo=jnp.asarray(CHEB_LO),
                                         hi=cheb_hi(barrier), degree=3)

        mapped = jnp.asarray(BARRIERS)
    else:
        if name == "lap3d":
            jop = JBSR.from_csr(*j_lap3d(8, 8, 8), block_size=8, dtype=f64)
        else:
            jop = JBSR.from_dense(banded(3, BAND_N, BAND_BW), block_size=8,
                                  dtype=f64)
        A0 = JSBSR.shard(jop, mesh)
        X0 = j_shard_array(jnp.asarray(rand_block(5, n, ss)), mesh)

        def problem(s):
            return A0 + jl.DiagonalOperator(s * jnp.ones((n,), f64)), None

        mapped = jnp.asarray(SHIFTS)

    def run(v):
        A, T = problem(v)
        r = getattr(jl, solver)(A, X0, B, T, config=cfg)
        return r.eigenvalues, r.converged

    lam, conv = jax.vmap(run)(mapped)
    return np.asarray(lam), np.asarray(conv)


@pytest.fixture(scope="module")
def reference():
    """(name, nd) -> jax.vmap's (eigenvalues, converged), computed lazily
    while the ranks run."""
    cache = {}

    def get(name, nd):
        if (name, nd) not in cache:
            cache[name, nd] = jax_vmap(name, nd)
        return cache[name, nd]

    return get


def _unsharded(name, draws):
    A, X0, B, T = port_case(name)
    return solve(name, A, X0, B, T, draws)


JAX_CASES = [name for name in SOLVES if name != "band_f32"]


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lockstep_matches_jax_vmap(ranks, reference, draws, world,
                                           name):
    """Each problem of the sharded lockstep solve: converged equal to
    jax.vmap's and eigenvalues to 1e-7 relative; against the port's lone
    sharded solve and its unsharded lockstep solve to 1e-9; every rank the
    same bits; X0 this rank's rows."""
    nev, n = SOLVES[name][2], SOLVES[name][1]
    lam_j, conv_j = reference(name, world)
    results = [r["solves"][name] for r in ranks(world)]
    whole = _unsharded(name, draws[name])
    for rec in results:
        got = rec["batch"]
        assert got["x0_rows"] == n // world
        assert got["converged"].tolist() == conv_j.tolist() == [nev] * 3
        np.testing.assert_allclose(got["lam"], lam_j, rtol=1e-7)
        assert got["lam"].tobytes() == results[0]["batch"]["lam"].tobytes()
        for i, lone in enumerate(rec["lone"]):
            assert int(lone["converged"]) == int(got["converged"][i])
            np.testing.assert_allclose(got["lam"][i], lone["lam"], rtol=1e-9)
        assert whole["converged"].tolist() == got["converged"].tolist()
        np.testing.assert_allclose(got["lam"], whole["lam"], rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lockstep_bsr_routes(ranks, world):
    """The band in f32 solves through the K6 route (the edge buffers),
    every apply of it: 3/3 for each shift, within 1e-5 of jax.vmap's f64
    eigenvalues and 1e-6 of its lone f32 sharded solves; the f64 band and
    the 8^3 Laplacian take the gather + einsum (K3's plain version)."""
    for rec in ranks(world):
        f32 = rec["solves"]["band_f32"]
        assert f32["batch"]["converged"].tolist() == [3, 3, 3]
        calls = f32["batch"]["routes"]
        assert calls["k6"] > 0 and calls["k5"] == calls["k3"] == 0
        for i, lone in enumerate(f32["lone"]):
            np.testing.assert_allclose(f32["batch"]["lam"][i], lone["lam"],
                                       rtol=1e-6)
        for name in ("band", "lap3d"):
            calls = rec["solves"][name]["batch"]["routes"]
            assert calls["einsum"] > 0 and calls["k6"] == calls["k3"] == 0


def test_sharded_lockstep_f32_band_against_jax(ranks, reference):
    """The f32 band's eigenvalues against jax.vmap's f64 ones: 1e-5."""
    for world in WORLDS:
        lam_j, _ = reference("band", world)
        for rec in ranks(world):
            np.testing.assert_allclose(rec["solves"]["band_f32"]["batch"]["lam"],
                                       lam_j, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(FORMS))
def test_sharded_batched_apply_is_its_lone_applies(ranks, world, name):
    """Each sharded operator class (and each ShardedBSROperator route)
    applied to a batch [3, n_loc, 5] equals its 3 lone applies bit for
    bit, makes the exchanges of one lone apply (one a batch, not 3), and
    takes the form (and route) the table names."""
    for rec in (r["applies"][name] for r in ranks(world)):
        assert rec["form"] == FORMS[name]
        assert rec["equal"]
        assert rec["batch_exchanges"] == rec["lone_exchanges"]
        if name in ROUTES:
            assert rec["route"] == ROUTES[name][world]


@pytest.mark.parametrize("world", WORLDS)
def test_every_sharded_class_exchanges_once_a_batch(ranks, world):
    """Over the apply cases, each of halo_exchange, permute_rows and
    all_gather_rows ran, once a batch apply where it ran."""
    recs = ranks(world)[0]["applies"]
    for j in range(3):
        used = [rec["batch_exchanges"][j] for rec in recs.values()
                if rec["batch_exchanges"][j]]
        assert used and set(used) == {1}


@pytest.mark.parametrize("world", WORLDS)
def test_batch_all_reduces_as_one_problem(ranks, world):
    """One problem thrice as a batch makes the lone sharded solve's
    all-reduces (one a reduction for the batch, not one a problem) in the
    same iterations."""
    for (lone_ar, lone_it), (batch_ar, batch_it) in (
            r["all_reduces"] for r in ranks(world)):
        assert batch_it == [lone_it] * 3
        assert batch_ar == lone_ar


# --- index maths of the two kernels, emulated in numpy ---------------------


def _wrap(sp, seg):
    """csrc/stencil1d.cu's wrap of a segment counter."""
    sp = np.where(sp >= seg, sp - seg, sp)
    return np.where(sp >= seg, sp % seg, sp)


def emulate_k1_batched(X, scale, E, seg, w, itemsize):
    """csrc/stencil1d.cu's batched edge form on the host: its grid of
    blocks (x: a chunk of one problem's items, y: the problem), each
    block's threads as numpy lanes, items of ``w`` elements, its running
    row, column and segment counters on its problem's rows, X, Y and the
    edge table moved by blockIdx.y problems, and the unbatched edge test
    on the problem's rows with its pair E[y] ([b, 2, k]).  Each output
    element must be written once."""
    n, k = X.shape
    b = E.shape[0]
    prows = n // b
    kw, NT = k // w, k1.THREADS
    J = k1.items_per_thread(w, itemsize)
    nitems, chunk = prows * kw, NT * J
    Y = np.full(n * k, np.nan, np.float32)
    written = np.zeros(n * k, np.int64)
    lane = np.arange(NT)
    dr, dc = divmod(NT, kw)
    two, sc = np.float32(2.0), np.float32(scale)
    for blk_y in range(b):
        off = blk_y * nitems * w  # X and Y moved by blk_y problems
        x, e = X.reshape(-1)[off:], E[blk_y].reshape(-1)
        for blk in range(-(-nitems // chunk)):
            base = blk * chunk
            r0 = base // kw
            q = base - r0 * kw + lane
            r, c = q // kw, q % kw
            sp = _wrap(r0 % seg + r, seg)
            loads = []
            for j in range(J):
                idx = base + lane + j * NT
                live = idx < nitems
                elems = idx[:, None] * w + np.arange(w)
                xv = x[np.where(live[:, None], elems, 0)]
                up, dn = np.zeros_like(xv), np.zeros_like(xv)
                has_up, has_dn = (sp != 0) & live, (sp != seg - 1) & live
                up[has_up] = x[elems[has_up] - k]
                dn[has_dn] = x[elems[has_dn] + k]
                at = c[:, None] * w + np.arange(w)
                top = ~has_up & live & (r0 + r == 0)
                bot = ~has_dn & live & (r0 + r == prows - 1)
                up[top] = e[at[top]]
                dn[bot] = e[(at + kw * w)[bot]]
                loads.append((live, elems, xv, up, dn))
                c = c + dc
                inc = np.full(NT, dr)
                inc[c >= kw] += 1
                c[c >= kw] -= kw
                r = r + inc
                sp = _wrap(sp + inc, seg)
            for live, elems, xv, up, dn in loads:
                out = sc * ((two * xv - dn) - up)
                Y[off + elems[live]] = out[live]
                np.add.at(written, off + elems[live].ravel(), 1)
    assert (written == 1).all()
    return Y.reshape(n, k)


@pytest.mark.parametrize("b,n_loc,k,segs,itemsize", [
    (3, 100, 5, 1, 4),     # ragged rows and width, one segment a problem
    (4, 96, 30, 4, 4),     # the lockstep sweep's width, pairs
    (2, 1000, 3, 8, 4),    # problems longer than a step, odd width
    (5, 8, 1, 2, 4),       # problems shorter than a step
    (3, 64, 16, 1, 4),     # 16-byte vectors
    (3, 90, 30, 3, 2),     # bf16 pairs
    (2, 50, 7, 1, 2),      # bf16, one element an item
])
def test_k1_batched_edges_index_maths_emulated(b, n_loc, k, segs, itemsize):
    """K1's batched edge form over b problems of ragged n_loc rows: every
    problem reads its own edge pair at its own ends, no element is written
    twice, and the emulation equals the plain version (once a problem)
    bit for bit; the problems' own lone plain products too."""
    rng = np.random.default_rng(b * n_loc + k)
    X = rng.uniform(-0.5, 0.5, (b * n_loc, k)).astype(np.float32)
    E = rng.uniform(0.5, 1.5, (b, 2, k)).astype(np.float32)
    w = k1.items_per_load(k, itemsize, 4096, 8192, 512)
    got = emulate_k1_batched(X, 3.7, E, n_loc // segs, w, itemsize)
    want = k1.stencil_matmat_reference(torch.from_numpy(X), 3.7,
                                       torch.from_numpy(E),
                                       num_segments=b * segs)
    np.testing.assert_array_equal(got, want.numpy())
    for i in range(b):
        lone = k1.stencil_matmat_reference(
            torch.from_numpy(X[i * n_loc : (i + 1) * n_loc]), 3.7,
            torch.from_numpy(E[i]), num_segments=segs)
        np.testing.assert_array_equal(got[i * n_loc : (i + 1) * n_loc],
                                      lone.numpy())


def k6_tile(k):
    """csrc/bsr.cu:launch_strip's column tile and row tile (WinShape)."""
    BN = 16 if k <= 16 else 32 if k <= 32 else 64 if k <= 64 else 128
    return BN, 32 if BN >= 128 else 64


def emulate_k6(lo, vals, X, top, bot, bs, hrows):
    """csrc/bsr.cu's strip_tile_kernel grid over a K6 batch on the host:
    CTA blockIdx -> (row tile, ct), ct -> (problem ct / ctiles, first
    column (ct % ctiles) * BN); the window's source buffer picked once a
    CTA (rows_of) and moved to the problem by that buffer's own stride
    (X: n_loc * k elements a problem, edge buffers (hrows + W) * k), read
    from the flat buffers.  Every output element must be written once."""
    b, n_loc, k = X.shape
    ns, strip, W = vals.shape
    BN, BM = k6_tile(k)
    ctiles, rtiles = -(-k // BN), -(-strip // BM)
    flat = {"X": X.reshape(-1), "top": top.reshape(-1), "bot": bot.reshape(-1)}
    stride = {"X": n_loc * k, "top": (hrows + W) * k, "bot": (hrows + W) * k}
    body_hi = hrows + n_loc - W
    Y = np.full((b, n_loc, k), np.nan)
    written = np.zeros(Y.shape, np.int64)
    for block in range(-(-n_loc // strip) * rtiles * ctiles * b):
        tile, ct = divmod(block, b * ctiles)
        prob, c = divmod(ct, ctiles)
        s, r0 = divmod(tile, rtiles)
        r0 *= BM
        row0 = s * strip + r0
        nrows = min(strip - r0, BM, n_loc - row0)
        if nrows <= 0:
            continue
        start = int(lo[s]) * bs
        if start < hrows:
            buf, off = "top", start
        elif start > body_hi:
            buf, off = "bot", start - body_hi
        else:
            buf, off = "X", start - hrows
        base = prob * stride[buf] + off * k
        cs = slice(c * BN, min(c * BN + BN, k))  # masked past k
        cols = np.arange(k)[cs]
        src = flat[buf][base + np.arange(W)[:, None] * k + cols[None, :]]
        Y[prob, row0 : row0 + nrows, cs] = vals[s, r0 : r0 + nrows] @ src
        written[prob, row0 : row0 + nrows, cs] += 1
    assert (written == 1).all()
    return Y


@pytest.mark.parametrize("k", [5, 16, 18, 33, 70])
def test_k6_batched_column_tiles_emulated(k):
    """K6 over a batch of 3 interior shards' frames (a band cut into 4
    shards, ragged n_loc 392 rows): each CTA's tile lies in one problem and
    reads its window from that problem's buffer, every (problem, row,
    column) is written once, and the emulated product equals the plain
    version and each problem's lone plain product."""
    n, nd, bs = 1568, 4, 8
    op = tl.BSROperator.from_dense(banded(9, n, 16), block_size=bs, dtype=F64,
                                   device="cpu")
    plan = plan_shards(op, nd, shards=[1])
    hrows, n_loc = plan.halo * bs, n // nd
    lo = torch.from_numpy(plan.lo[1])
    vals = torch.from_numpy(plan.win[1])
    W = vals.shape[2]
    assert 0 < hrows and W <= n_loc
    rng = np.random.RandomState(k)
    Xg = rng.randn(3, n, k)
    X = Xg[:, n_loc : 2 * n_loc]
    top = np.concatenate([Xg[:, n_loc - hrows : n_loc], X[:, :W]], axis=1)
    bot = np.concatenate([X[:, -W:], Xg[:, 2 * n_loc : 2 * n_loc + hrows]],
                         axis=1)
    got = emulate_k6(plan.lo[1], plan.win[1], X, top, bot, bs, hrows)
    t = torch.from_numpy
    want = kb.bsr_window_matmat_edges(lo, vals, t(X), t(top), t(bot), bs=bs,
                                      hrows=hrows)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-13, atol=1e-12)
    for i in range(3):
        lone = kb.bsr_window_matmat_edges(lo, vals, t(X[i]), t(top[i]),
                                          t(bot[i]), bs=bs, hrows=hrows)
        assert torch.equal(want[i], lone)
    starts = plan.lo[1].astype(np.int64) * bs
    assert (starts < hrows).any() and (starts > hrows + n_loc - W).any()


def test_estimate_peak_covers_a_batch_on_a_ranks_rows():
    """estimate_peak_gb of a sweep: b problems' blocks plus the lockstep
    term, on n / ranks rows a card (n when the rows do not divide)."""
    from lobpcg_tpu_torch.utils import plan

    cfg = tl.SolverConfig(nev=16, size_sub=30)
    fixed = plan.FIXED_GB_H100
    one = plan.estimate_peak_gb(1_000_000, 30, F32, cfg)
    assert plan.estimate_peak_gb(4_000_000, 30, F32, cfg, ranks=4) == one
    assert plan.estimate_peak_gb(1_000_003, 30, F32, cfg, ranks=4) \
        == plan.estimate_peak_gb(1_000_003, 30, F32, cfg)
    anchor = plan.PEAK_BLOCKS_H100[(cfg.dual_basis, cfg.use_b_cache,
                                    cfg.use_ax_cache)]
    batch = plan.estimate_peak_gb(4_000_000, 30, F32, cfg, batch=8, ranks=4)
    assert batch - fixed == pytest.approx(
        8 * (one - fixed) * (anchor + plan.LOCKSTEP_BLOCKS_H100) / anchor)
