"""The lockstep batched solve (a 3-D X0) over the operators that
``jax.vmap`` maps in the JAX package beyond ``operators/linop.py``'s:
``LaplacianND`` on 1-, 2- and 3-D grids and ``BSROperator`` over a
matrix the batch shares, ``CallableOperator`` with a shared and a
mapped argument, the realified dense and diagonal operators through
``realify_problem``, and a warm restart from one shared P0.

Each batch of 3 problems (f64, the CPU, inputs from numpy seeds) is held
against ``jax.vmap`` of the JAX solve and against each problem's lone
port solve:

- eigenvalues 1e-9 relative against jax.vmap and 1e-10 against the lone
  port solves, converged counts equal;
- iteration counts equal to the lone port solves (size_sub 8: every
  k x k product of the solve takes torch's per-problem GEMM, see
  ``test_torch_lockstep.py``'s stall tests, and the lockstep problems
  are their lone solves bit for bit), and against jax.vmap within
  ``VMAP_SPREAD``: on these inputs jax.vmap's own problems differ from
  the lone JAX solves by up to that many iterations (the rounding of
  batched small products in XLA, measured once and written below), so
  the port is held to the same spread.

The JAX solves draw from their default key, unbatched under vmap: every
problem gets the same draws, and the port's problems get those draws
(``draws=``) too.  Then the batched applies: the plain versions of K2,
K3 and K5 over a batch against b lone plain applies (equal to the bit,
f32 and f64), ``BSROperator`` choosing its kernel at one problem's width,
and the batched index maths of K2 and K3 emulated in numpy.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
import lobpcg_tpu_torch as tl
from lobpcg_tpu.operators.sparse import BSROperator as JBSROperator
from lobpcg_tpu.operators.sparse import laplacian_3d_csr as jl_laplacian_3d_csr
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.ops.cuda import stencil3d as k2
from test_torch_batched import draws_for, rand_block

torch.set_num_threads(2)
F64 = torch.float64
B, NEV, SS, TOL, MAX_ITER = 3, 4, 8, 1e-8, 300
# jax.vmap against the lone JAX solves on these inputs, measured once
# (the iteration counts of each case's three problems, vmap / lone): the
# 1-D grid 47 48 51 / the same, the 2-D grid 40 40 40 / the same, the 3-D
# grid 37 35 32 / 37 35 33, the BSR Laplacian 34 34 31 / 34 35 31, the
# band 16 16 16 / the same, the callable 38 37 37 / the same, the
# realified problem 26 24 27 / the same, the shared P0 49 50 49 / the
# same.  The largest difference of one problem's counts:
VMAP_SPREAD = 1


TRAP_C = (0.0, 60.0, 240.0)  # the sweep: trap strengths, one per problem


def scale_of(grid):
    """1/h^2 at h = 1/(max(grid) + 1), laplacian_3d_csr's spacing."""
    return float((max(grid) + 1) ** 2)


def potentials(grid):
    """B per-problem diagonals (the mapped operand of each sweep): the
    anisotropic trap c * sum_a w_a (x_a - 1/2)^2 on the grid's interior
    points, w = (1, 1.3, 1.7), at each strength of TRAP_C."""
    axes = [(np.arange(g) + 1.0) / (g + 1) - 0.5 for g in grid]
    trap = np.zeros(grid)
    for a, (x, w) in enumerate(zip(axes, (1.0, 1.3, 1.7))):
        shape = [1] * len(grid)
        shape[a] = grid[a]
        trap = trap + w * (x ** 2).reshape(shape)
    return np.stack([c * trap.ravel() for c in TRAP_C])


def lockstep_and_lone(make_op, n, X0, *, P0=None, cfg_kw=None):
    """The port's lockstep solve over the B problems (``make_op(None)``
    the batched operator, ``make_op(i)`` problem i's) and each lone solve,
    with the JAX package's draws."""
    cfg = jl.SolverConfig(nev=NEV, size_sub=SS, tol=TOL, max_iter=MAX_ITER,
                          **(cfg_kw or {}))
    d = draws_for(n, SS, cfg)
    tcfg = tl.SolverConfig(nev=NEV, size_sub=SS, tol=TOL, max_iter=MAX_ITER,
                           **(cfg_kw or {}))
    p0 = None if P0 is None else torch.from_numpy(P0)

    def solve(op, X):
        return tl.lobpcg(op, torch.from_numpy(X), P0=p0, config=tcfg,
                         draws=d, device="cpu")

    out = solve(make_op(None), np.stack([X0] * B))
    return out, [solve(make_op(i), X0) for i in range(B)], cfg


def check(out, lone, want, nev=NEV):
    """The criteria of the module docstring; ``want`` is jax.vmap's
    (eigenvalues, converged, iterations)."""
    lam_j, conv_j, it_j = (np.asarray(v) for v in want)
    assert tuple(out.eigenvalues.shape) == (B, nev)
    np.testing.assert_allclose(out.eigenvalues.numpy(), lam_j, rtol=1e-9)
    assert out.converged.tolist() == conv_j.tolist() == [nev] * B
    assert np.abs(out.iterations.numpy() - it_j).max() <= VMAP_SPREAD
    for i, r in enumerate(lone):
        np.testing.assert_allclose(out.eigenvalues[i].numpy(),
                                   r.eigenvalues.numpy(), rtol=1e-10)
        assert int(out.converged[i]) == r.converged
        assert int(out.iterations[i]) == r.iterations, i


def jax_batch(jsolve, mapped):
    """jax.vmap(jsolve) over ``mapped``: (eigenvalues, converged,
    iterations)."""
    return jax.vmap(jsolve)(mapped)


def jrun(A, X0, cfg, P0=None):
    r = jl.lobpcg(A, jnp.asarray(X0), P0=None if P0 is None else
                  jnp.asarray(P0), config=cfg)
    return r.eigenvalues, r.converged, r.iterations


@pytest.mark.parametrize("grid", [(96,), (12, 16), (6, 6, 8)])
def test_lockstep_laplacian_nd(grid):
    """A shared LaplacianND + DiagonalOperator [B, n], each grid rank."""
    n = math.prod(grid)
    V = potentials(grid)
    X0 = rand_block(1, n, SS)
    out, lone, cfg = lockstep_and_lone(
        lambda i: tl.LaplacianND(scale_of(grid), grid, dtype=F64)
        + tl.DiagonalOperator(torch.from_numpy(V if i is None else V[i])),
        n, X0)

    def jsolve(v):
        return jrun(jl.LaplacianND(jnp.asarray(scale_of(grid)), grid)
                    + jl.DiagonalOperator(v), X0, cfg)

    check(out, lone, jax_batch(jsolve, jnp.asarray(V)))


def band_csr(n, half):
    """A banded Laplacian: -1 on the ``half`` off-diagonals each side and
    2 * half on the diagonal (the nonlocal stencil sum_o (2 x_i - x_i+o
    - x_i-o), Dirichlet), times (n + 1)^2 / 100, as CSR arrays."""
    import scipy.sparse as sp

    offs = [o for o in range(-half, half + 1) if o]
    M = sp.diags([-np.ones(n - abs(o)) for o in offs], offs, shape=(n, n)) \
        + sp.identity(n) * (2.0 * half)
    M = sp.csr_matrix(M * ((n + 1) ** 2 / 100.0))
    M.sort_indices()
    return M.indptr, M.indices, M.data


@pytest.mark.parametrize("matrix", ["laplacian_3d", "band"])
def test_lockstep_bsr(matrix):
    """A shared BSROperator + DiagonalOperator [B, n]: the 3-D Laplacian's
    block-ELL of the (6, 6, 8) grid, and a symmetric band whose
    strip-window format is built (f64 runs the plain block-ELL product;
    the f32 kernels' dispatch is the next tests')."""
    if matrix == "laplacian_3d":
        csr = jl_laplacian_3d_csr(6, 6, 8)
    else:
        csr = band_csr(256, 12)
    n = len(csr[0]) - 1
    op = tl.BSROperator.from_csr(*csr, block_size=8, dtype=F64, device="cpu")
    jop = JBSROperator.from_csr(*csr, block_size=8, dtype=jnp.float64)
    assert op.win_vals is not None  # both small matrices are windowable
    V = potentials((6, 6, 8) if matrix == "laplacian_3d" else (n,))
    X0 = rand_block(2, n, SS)
    out, lone, cfg = lockstep_and_lone(
        lambda i: op + tl.DiagonalOperator(
            torch.from_numpy(V if i is None else V[i])), n, X0)

    def jsolve(v):
        return jrun(jop + jl.DiagonalOperator(v), X0, cfg)

    check(out, lone, jax_batch(jsolve, jnp.asarray(V)))


def test_lockstep_callable_operator():
    """CallableOperator(fn(X, M, shift) = M X + shift X) with M shared and
    the shift mapped (in_axes (None, 0)), as jax.vmap maps fn."""
    n = 96
    rng = np.random.RandomState(4)
    R = rng.randn(n, n)
    M = R @ R.T / n + np.diag(np.arange(1.0, n + 1))
    shifts = np.asarray([0.0, 2.5, 7.0])
    X0 = rand_block(3, n, SS)

    def fn(X, M, shift):
        return M @ X + shift * X

    Mt = torch.from_numpy(M)
    out, lone, cfg = lockstep_and_lone(
        lambda i: tl.CallableOperator(
            args=(Mt, torch.tensor(shifts if i is None else shifts[i])),
            fn=fn, n=n, _dtype=F64, in_axes=None if i is not None else (None, 0)),
        n, X0)

    def jsolve(shift):
        return jrun(jl.CallableOperator(args=(jnp.asarray(M), shift), fn=fn,
                                        n=n, _dtype=jnp.float64), X0, cfg)

    check(out, lone, jax_batch(jsolve, jnp.asarray(shifts)))
    exact = np.sort(np.linalg.eigvalsh(M))[:NEV]
    for i, s in enumerate(shifts):
        np.testing.assert_allclose(out.eigenvalues[i].numpy(), exact + s,
                                   rtol=1e-8)


def test_lockstep_realified_problem():
    """A complex Hermitian problem per shift, A_p = H + diag(d_p) with H
    dense and shared and d_p complex (real-valued) per problem, through
    realify_problem: RealEmbeddedDenseOperator (shared Ar, Ai) plus
    RealEmbeddedDiagonalOperator ([B, n] dr, di), X0 [B, 2n, 2k], one
    split-real lockstep solve; derealify per problem."""
    n, nev_c, ss_c = 48, 2, 4
    rng = np.random.RandomState(5)
    Hc = rng.randn(n, n) + 1j * rng.randn(n, n)
    Hc = (Hc + Hc.conj().T) / 2
    D = rng.uniform(0.0, 3.0, (B, n)) + 0j
    Xc = rand_block(6, n, ss_c) + 1j * rand_block(7, n, ss_c)
    ccfg = tl.SolverConfig(nev=nev_c, size_sub=ss_c, tol=TOL,
                           max_iter=MAX_ITER)
    Ht = torch.from_numpy(Hc)

    def realified(d, X):
        A, X0r, _, _, rcfg = tl.realify_problem(
            tl.DenseOperator(Ht) + tl.DiagonalOperator(torch.from_numpy(d)),
            torch.from_numpy(X), config=ccfg)
        return A, X0r, rcfg

    A, X0r, rcfg = realified(D, np.stack([Xc] * B))
    assert tuple(X0r.shape) == (B, 2 * n, 2 * ss_c)
    assert rcfg.size_sub == SS and rcfg.nev == 2 * nev_c
    kinds = {type(A.left).__name__, type(A.right).__name__}
    assert kinds == {"RealEmbeddedDenseOperator", "RealEmbeddedDiagonalOperator"}
    jcfg = jl.SolverConfig(nev=2 * nev_c, size_sub=SS, tol=TOL,
                           max_iter=MAX_ITER)
    d = draws_for(2 * n, SS, jcfg)

    def solve(op, X):
        return tl.lobpcg(op, X, config=rcfg, draws=d, device="cpu")

    out = solve(A, X0r)
    lone = []
    for i in range(B):
        Ai, Xi, _ = realified(D[i], Xc)
        assert torch.equal(Xi, X0r[i])
        lone.append(solve(Ai, Xi))

    def jsolve(dvec):
        Aj, X0j, _, _, jc = jl.realify_problem(
            jl.DenseOperator(jnp.asarray(Hc)) + jl.DiagonalOperator(dvec),
            jnp.asarray(Xc), config=jl.SolverConfig(
                nev=nev_c, size_sub=ss_c, tol=TOL, max_iter=MAX_ITER))
        r = jl.lobpcg(Aj, X0j, config=jc)
        return r.eigenvalues, r.converged, r.iterations

    check(out, lone, jax_batch(jsolve, jnp.asarray(D)), nev=2 * nev_c)
    for i in range(B):
        lam, _, _ = tl.derealify(types.SimpleNamespace(
            eigenvalues=out.eigenvalues[i], eigenvectors=out.eigenvectors[i],
            residual_norms=out.residual_norms[i]), nev_c)
        exact = np.linalg.eigvalsh(Hc + np.diag(D[i].real))[:nev_c]
        np.testing.assert_allclose(lam, exact, rtol=1e-8)


def test_lockstep_shared_p0():
    """A warm restart from one P0 [n, m] that every problem shares (a
    zero column inside it, so the prefix compaction moves a column),
    over a shared 1-D LaplacianND + DiagonalOperator [B, n]."""
    grid = (96,)
    n = math.prod(grid)
    V = potentials(grid)
    X0 = rand_block(4, n, SS)
    P0 = rand_block(5, n, SS)
    P0[:, 1] = 0.0
    P0[:, 5:] = 0.0
    out, lone, cfg = lockstep_and_lone(
        lambda i: tl.LaplacianND(scale_of(grid), grid, dtype=F64)
        + tl.DiagonalOperator(torch.from_numpy(V if i is None else V[i])),
        n, X0, P0=P0)

    def jsolve(v):
        return jrun(jl.LaplacianND(jnp.asarray(scale_of(grid)), grid)
                    + jl.DiagonalOperator(v), X0, cfg, P0=P0)

    check(out, lone, jax_batch(jsolve, jnp.asarray(V)))


# --- the batched applies ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_plain_batched_kernels_equal_lone_applies(dtype):
    """The plain versions of K2, K3 and K5 over a batch [B, n, k] equal B
    lone plain applies to the bit (what each batched launch is held to
    on the card)."""
    rng = np.random.RandomState(8)
    grid = (5, 4, 6)
    n = math.prod(grid)
    X = torch.from_numpy(rng.randn(B, n, 5)).to(dtype)
    Y = k2.stencil3d_matmat(X, 2.5, grid)
    cols, blocks, lo, win = band_formats(band_csr(256, 12), dtype)
    Xb = torch.from_numpy(rng.randn(B, 256, 7)).to(dtype)
    Y3 = kb.bsr_matmat(cols, blocks, Xb)
    Y5 = kb.bsr_window_matmat(lo, win, Xb, bs=8)
    for i in range(B):
        assert torch.equal(Y[i], k2.stencil3d_matmat(X[i], 2.5, grid))
        assert torch.equal(Y3[i], kb.bsr_matmat(cols, blocks, Xb[i]))
        assert torch.equal(Y5[i], kb.bsr_window_matmat(lo, win, Xb[i], bs=8))
    np.testing.assert_allclose(Y5.numpy(), Y3.numpy(), rtol=1e-5, atol=1e-3)
    # Per-problem output rows of K5 (a shorter Y), and the checks.
    assert tuple(kb.bsr_window_matmat(lo, win, Xb, bs=8, out_rows=100).shape) \
        == (B, 100, 7)
    with pytest.raises(ValueError):
        kb.bsr_matmat(cols, blocks, Xb[:, :-8])
    with pytest.raises(ValueError):
        k2.stencil3d_matmat(X[:, :-1], 2.5, grid)


def band_formats(csr, dtype):
    """The block-ELL (K3) and strip-window (K5) arrays of a CSR matrix."""
    op = tl.BSROperator.from_csr(*csr, block_size=8, dtype=dtype,
                                 device="cpu")
    return op.block_cols, op.blocks, op.win_lo, op.win_vals


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("grid", [(40,), (6, 7), (4, 5, 6)])
def test_laplacian_nd_batched_apply(grid, dtype, monkeypatch):
    """LaplacianND on [B, n, k] equals B lone applies to the bit; in f32 a
    3-D grid calls K2's wrapper once for the batch, a 1-D or 2-D grid K1's
    once per axis over B times the lone segment count (the batch a leading
    grid axis), and nothing couples two problems."""
    from lobpcg_tpu_torch.operators import stencil_nd

    calls = []
    real_k1, real_k2 = stencil_nd.stencil_matmat, k2.stencil3d_matmat

    def spy_k1(X, scale, edge_rows=None, *, num_segments=1):
        calls.append(("k1", tuple(X.shape), num_segments))
        return real_k1(X, scale, edge_rows, num_segments=num_segments)

    def spy_k2(X, scale, grid_shape):
        calls.append(("k2", tuple(X.shape)))
        return real_k2(X, scale, grid_shape)

    monkeypatch.setattr(stencil_nd, "stencil_matmat", spy_k1)
    monkeypatch.setattr(k2, "stencil3d_matmat", spy_k2)
    n, k = math.prod(grid), 3
    X = torch.from_numpy(np.random.RandomState(9).randn(B, n, k)).to(dtype)
    op = tl.LaplacianND(1.7, grid, dtype=dtype)
    Y = op.matmat(X)
    batch_calls, calls[:] = list(calls), []
    for i in range(B):
        assert torch.equal(Y[i], op.matmat(X[i]))
    if dtype == F64:
        assert batch_calls == []
    elif len(grid) == 3:
        assert batch_calls == [("k2", (B, n, k))]
    else:
        lone = calls[: len(grid)]
        assert [c[0] for c in batch_calls] == ["k1"] * len(grid)
        for (_, shape, segs), (_, lshape, lsegs) in zip(batch_calls, lone):
            assert shape == (B * lshape[0], lshape[1]) and segs == B * lsegs
    # An impulse at problem 1's last point reaches no other problem.
    Xi = torch.zeros_like(X)
    Xi[1, -1] = 1.0
    Yi = op.matmat(Xi)
    assert float(Yi[0].abs().sum()) == float(Yi[2].abs().sum()) == 0.0


def test_bsr_operator_picks_its_kernel_at_one_problems_width(monkeypatch):
    """A batch asks window_pays at k, one problem's width, not B*k: on a
    band of +-9 blocks at n 512 (R*bs 152, window 384 rows) k 16 takes K3
    and k 48 K5 (B*16 = 48 would take K5); one call for the batch, equal
    to the B lone applies to the bit."""
    from lobpcg_tpu_torch.operators import sparse

    calls = []
    for name in ("bsr_matmat", "bsr_window_matmat"):
        real = getattr(sparse, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, tuple(a[2].shape)))
            return _real(*a, **kw)

        monkeypatch.setattr(sparse, name, spy)
    op = tl.BSROperator.from_csr(*band_csr(512, 72), block_size=8,
                                 device="cpu")
    assert op.blocks.shape[1] * 8 == 152 and op.win_vals.shape[2] == 384
    assert not op.window_pays(16) and op.window_pays(B * 16)
    rng = np.random.RandomState(10)
    for k, kernel in ((16, "bsr_matmat"), (48, "bsr_window_matmat")):
        X = torch.from_numpy(rng.randn(B, 512, k).astype(np.float32))
        calls.clear()
        Y = op.matmat(X)
        assert calls == [(kernel, (B, 512, k))]
        for i in range(B):
            assert torch.equal(Y[i], op.matmat(X[i]))


# --- the kernels' batched index maths, emulated -------------------------------


def emulate_k2(X, scale, grid):
    """csrc/stencil3d.cu's walk over a batch on the host, one lane per
    element (V 1): row r of the batch, q = r / nz, l, the batch's i-plane
    p = q / ny, j, and the problem's own i = p % nx for the i faces; its
    f32 operation order."""
    b, n, k = X.shape
    nx, ny, nz = grid
    x = X.reshape(-1)
    idx = np.arange(b * n * k)
    r = idx // k
    q = r // nz
    l = r - q * nz
    p = q // ny
    j = q - p * ny
    i = p % nx
    sl, sj, si = k, nz * k, ny * nz * k

    def nb(has, off):
        return np.where(has, x[np.clip(idx + off, 0, x.size - 1)], 0)

    f = np.float32
    x2 = f(2.0) * x
    pi = (x2 - nb(i < nx - 1, si)) - nb(i > 0, -si)
    pj = (x2 - nb(j < ny - 1, sj)) - nb(j > 0, -sj)
    pl = (x2 - nb(l < nz - 1, sl)) - nb(l > 0, -sl)
    return (f(scale) * ((pi + pj) + pl)).reshape(X.shape)


@pytest.mark.parametrize("grid", [(3, 4, 5), (1, 2, 3), (4, 1, 1)])
def test_k2_batched_index_maths_emulated(grid):
    """K2's batched walk against its plain version, bit for bit in f32:
    the i faces tested on p % nx keep each problem's last plane from its
    neighbour's first; tested on the batch's plane p (the unbatched
    formula), the problems would couple."""
    b, k = 3, 2
    n = math.prod(grid)
    X = np.random.RandomState(11).randn(b, n, k).astype(np.float32)
    want = k2.stencil3d_matmat_reference(torch.from_numpy(X), 1.5, grid)
    got = emulate_k2(X, 1.5, grid)
    assert np.array_equal(got, want.numpy())
    coupled = emulate_k2(X.reshape(1, b * n, k), 1.5,
                         (b * grid[0],) + grid[1:]).reshape(X.shape)
    assert not np.array_equal(coupled, want.numpy())


def k3_tile_width(k):
    """csrc/bsr.cu:launch_ell's column tile at bs 8 (every width fits)."""
    return 128 if k > 64 else 64 if k > 32 else 32 if k > 16 else 16


def emulate_k3(cols, blocks, X):
    """csrc/bsr.cu's ell_tile_kernel grid over a batch on the host: CTA
    blockIdx -> (row tile, ct), ct -> (problem ct / ctiles, first column
    (ct % ctiles) * BN), each CTA's block rows times its columns of its
    problem's X.  Every output element must be written once."""
    b, n, k = X.shape
    nb, R, bs, _ = blocks.shape
    BN, BR = k3_tile_width(k), 16
    ctiles = -(-k // BN)
    Y = np.full((b, nb * bs, k), np.nan)
    written = np.zeros(Y.shape, np.int64)
    for block in range(-(-nb // BR) * ctiles * b):
        tile, ct = divmod(block, b * ctiles)
        prob, c = divmod(ct, ctiles)
        c0 = c * BN
        cs = slice(c0, min(c0 + BN, k))  # masked past k: no other problem
        for i in range(tile * BR, min(tile * BR + BR, nb)):
            acc = sum(blocks[i, r] @ X[prob, cols[i, r] * bs:(cols[i, r] + 1) * bs, cs]
                      for r in range(R))
            Y[prob, i * bs:(i + 1) * bs, cs] = acc
            written[prob, i * bs:(i + 1) * bs, cs] += 1
    assert (written == 1).all()
    return Y


@pytest.mark.parametrize("k", [5, 16, 18, 33, 70])
def test_k3_batched_column_tiles_emulated(k):
    """K3's batched column tiles at widths that are and are not multiples
    of the tile (16-128) or the 4-float vector: each tile lies in one
    problem, every (problem, row, column) is written once, and the
    emulated product equals the plain version."""
    csr = band_csr(128, 12)
    cols, blocks, _, _ = band_formats(csr, F64)
    X = np.random.RandomState(12).randn(B, 128, k)
    got = emulate_k3(cols.numpy(), blocks.numpy(), X)
    want = kb.bsr_matmat(cols, blocks, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)
