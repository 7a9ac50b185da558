"""The port's dense ops (lobpcg_tpu_torch/ops: masking, gram, residual,
svqb, ortho, rayleigh, pencil, indefinite) against the JAX package's, in
f64 on the same numpy inputs.

Tolerances: 1e-12 relative on values and Grams (f64 round-off of
O(100)-term sums).  Eigenvectors and bases are compared as subspaces
(orthogonal projectors), since LAPACK builds may flip signs or rotate
within a degenerate space; counts and flags must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
from lobpcg_tpu.ops import gram as jg
from lobpcg_tpu.ops import indefinite as jind
from lobpcg_tpu.ops import masking as jm
from lobpcg_tpu.ops import ortho as jo
from lobpcg_tpu.ops import pencil as jp
from lobpcg_tpu.ops import rayleigh as jr
from lobpcg_tpu.ops import residual as jres
from lobpcg_tpu.ops import svqb as jsv
from lobpcg_tpu.utils.prng import fill_random as jax_fill_random
from lobpcg_tpu_torch.interop import operator_from_reference
from lobpcg_tpu_torch.ops import gram as tg
from lobpcg_tpu_torch.ops import indefinite as tind
from lobpcg_tpu_torch.ops import masking as tm
from lobpcg_tpu_torch.ops import ortho as to
from lobpcg_tpu_torch.ops import pencil as tp
from lobpcg_tpu_torch.ops import rayleigh as tr
from lobpcg_tpu_torch.ops import residual as tres
from lobpcg_tpu_torch.ops import svqb as tsv
from lobpcg_tpu_torch.ops.cuda import linalg as tlin
from lobpcg_tpu_torch.ops.cuda import rr as trr

torch.set_num_threads(2)

RTOL = 1e-12
EPS = 1e-12  # f64 EPS_TOL: the solvers' eps_ortho / eps_drop


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def close(t, j, rtol=RTOL):
    t, j = npy(t), npy(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(np.abs(j).max(), 1e-300) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * scale)


def proj(U):
    """Orthogonal projector onto span(U) (zero columns ignored)."""
    U = npy(U)
    keep = np.linalg.norm(U, axis=0) > 0
    Q, _ = np.linalg.qr(U[:, keep])
    return Q @ Q.T


def same_span(t, j, rtol=1e-9):
    close(proj(t), proj(j), rtol)


def rand(seed, *shape):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape)


def spd(seed, n):
    M = rand(seed, n, n)
    return M @ M.T + n * np.eye(n)


def ops_pair(jop):
    return jop, operator_from_reference(jop, device="cpu")


def bdg_pair(m=30):
    """A = diag(K, K) as a 2-segment Laplacian + well potential,
    B = antidiag(I, I): the BdG pencil of the main path, small."""
    V = np.full(m, 2.0)
    V[m // 3 : 2 * m // 3] = 1.0
    jA = jl.Laplacian1D(scale=J(1.0), n=2 * m, segments=2) + \
        jl.DiagonalOperator(J(np.concatenate([V, V])))
    jB = jl.BlockAntiDiagOperator(d=J(np.ones(m)))
    return ops_pair(jA), ops_pair(jB)


# --- masking ----------------------------------------------------------------

def test_masking_functions_match():
    U = rand(0, 6, 5)
    G = rand(1, 5, 5)
    mask = np.array([True, False, True, True, False])
    np.testing.assert_array_equal(npy(tm.as_mask(5, 3)), npy(jm.as_mask(5, 3)))
    np.testing.assert_array_equal(npy(tm.as_mask(5, T(mask))),
                                  npy(jm.as_mask(5, J(mask))))
    np.testing.assert_array_equal(
        npy(tm.blocks_mask((4, 4, 3), (4, 2, 1))),
        npy(jm.blocks_mask((4, 4, 3), (4, 2, 1))))
    np.testing.assert_array_equal(npy(tm.mask_cols(T(U), 3)),
                                  npy(jm.mask_cols(J(U), 3)))
    np.testing.assert_array_equal(npy(tm.shift_cols(T(U), 2, 2)),
                                  npy(jm.shift_cols(J(U), 2, 2)))
    perm = np.array([4, 0, 3, 1, 2])
    np.testing.assert_array_equal(npy(tm.permute_cols(T(U), T(perm))),
                                  npy(jm.permute_cols(J(U), J(perm))))
    np.testing.assert_array_equal(npy(tm.inject_diag(T(G), 3, 5.0)),
                                  npy(jm.inject_diag(J(G), 3, 5.0)))
    np.testing.assert_array_equal(npy(tm.inject_diag(T(G), T(mask), 1.0)),
                                  npy(jm.inject_diag(J(G), J(mask), 1.0)))
    np.testing.assert_array_equal(npy(tm.dead_mass(T(G), 2)),
                                  npy(jm.dead_mass(J(G), 2)))
    flags = np.array([False, True, False, True, False, False])
    tperm, tk = tm.compact_by_flag(T(flags))
    jperm, jk = jm.compact_by_flag(J(flags))
    np.testing.assert_array_equal(npy(tperm), npy(jperm))
    assert tk == int(jk)
    ok = np.array([True, True, False, True])
    assert tm.prefix_count(T(ok)) == int(jm.prefix_count(J(ok)))


# --- gram -------------------------------------------------------------------

def test_gram_family_matches():
    n, k = 40, 4
    U, V, W = rand(2, n, k), rand(3, n, k), rand(4, n, k)
    jB, tB = ops_pair(jl.DenseOperator(J(spd(5, n))))
    close(tg.mm(T(U), T(spd(6, k))), jg.mm(J(U), J(spd(6, k))))
    close(tg._hdot(T(U), T(V)), jg._hdot(J(U), J(V)))
    close(tg.gram_self(T(U), tB), jg.gram_self(J(U), jB))
    close(tg.gram_self(T(U), tB, chunk=3), jg.gram_self(J(U), jB, chunk=3))
    close(tg.gram_cross(T(V), T(U), tB), jg.gram_cross(J(V), J(U), jB))
    close(tg.gram_self_mat(T(U), T(spd(7, n))),
          jg.gram_self_mat(J(U), J(spd(7, n))))
    close(tg.gram_cross_mat(T(U), T(V), T(spd(8, n))),
          jg.gram_cross_mat(J(U), J(V), J(spd(8, n))))
    blocks_t, blocks_j = (T(U), T(V), T(W)), (J(U), J(V), J(W))
    close(tg.bh_dot(blocks_t, T(W)), jg.bh_dot(blocks_j, J(W)))
    C = rand(9, 3 * k, k)
    close(tg.b_mm(blocks_t, T(C)), jg.b_mm(blocks_j, J(C)))
    close(tg.gram_blocks(blocks_t, tB), jg.gram_blocks(blocks_j, jB))
    app_t = tg.applied_blocks(tB, blocks_t, {0: tB.matmat(T(U))})
    app_j = jg.applied_blocks(jB, blocks_j, {0: jB.matmat(J(U))})
    for a, b in zip(app_t, app_j):
        close(a, b)
    close(tg.herm_tile_gram(blocks_t, app_t), jg.herm_tile_gram(blocks_j, app_j))
    close(tg.gram_blocks_pre(blocks_t, app_t),
          jg.gram_blocks_pre(blocks_j, app_j))
    pt_, pj_ = tg.apply_block_op_pair(tB, T(U), T(V)), \
        jg.apply_block_op_pair(jB, J(U), J(V))
    close(pt_[0], pj_[0])
    close(pt_[1], pj_[1])
    assert tg.as_blocks(T(np.hstack([U, V])), k)[1].shape == (n, k)


def test_scale_diag_frob_and_ortho_err_match():
    G = rand(10, 6, 6)
    G = G + G.T
    G[2, 2] = 0.0  # guarded zero diagonal
    Dt, Gst = tlin.scale_diag(T(G))
    Dj, Gsj = jg.scale_diag(J(G))
    close(Dt, Dj)
    close(Gst, Gsj)
    close(tg.frob_norm(T(G)), jg.frob_norm(J(G)))
    close(tg.ortho_err(T(G)), jg.ortho_err(J(G)))
    close(tg.ortho_err(T(G), 4), jg.ortho_err(J(G), 4))


@pytest.mark.parametrize("chunk", [0, 16])
def test_widened_hdot_matches(chunk):
    """f32 storage with an f64 contraction (rr_dtype="float64")."""
    U = rand(11, 70, 3).astype(np.float32)
    V = rand(12, 70, 3).astype(np.float32)
    with tg.mixed_chunk_ctx(chunk), jg.mixed_chunk_ctx(chunk):
        t = tg._hdot(T(V), T(U), torch.float64)
        j = jg._hdot(J(V), J(U), jnp.float64)
    assert t.dtype == torch.float64
    close(t, j)


def test_precision_ctx_sets_and_restores_tf32():
    """Both names set TF32 off for the solve and restore the flags."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tg.precision_ctx("high"):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            with tg.precision_ctx("highest"):
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("name", ["high", "highest"])
def test_precision_high_leaves_tf32_off(name):
    """gram_precision="high" keeps full f32 Grams: the card has no
    counterpart of the TPU's bf16_3x through torch, and TF32 is coarser."""
    with tg.precision_ctx(name):
        assert torch.backends.cuda.matmul.allow_tf32 is False


# --- residual ---------------------------------------------------------------

def test_residual_and_norms_match():
    (jA, tA), (jB, tB) = bdg_pair()
    X = rand(13, 60, 4)
    lam = np.array([1.1, 1.2, -0.5, 2.0])
    AX = npy(jA.matmat(J(X)))
    for ax in (None, AX):
        Wt = tres.get_residual(T(X), None if ax is None else T(ax), T(lam),
                               tA, tB)
        Wj = jres.get_residual(J(X), None if ax is None else J(ax), J(lam),
                               jA, jB)
        close(Wt, Wj)
    BW = npy(jB.matmat(J(npy(Wt))))
    for bw in (None, BW):
        close(
            tres.get_residual_norm(Wt, T(lam), T(np.float64(6.0)),
                                   T(np.float64(1.0)), 3,
                                   None if bw is None else T(bw)),
            jres.get_residual_norm(Wj, J(lam), 6.0, 1.0, 3,
                                   None if bw is None else J(bw)),
        )


@pytest.mark.parametrize("block", [1, 8])
def test_estimate_norm_matches_with_same_start(block):
    (jA, tA), _ = bdg_pair()
    key = jnp.asarray([0, 7], dtype=jnp.uint32)
    v0 = jax_fill_random(key, (60, block), jnp.float64)
    close(tres.estimate_norm(tA, T(npy(v0)), 10),
          jres.estimate_norm(jA, key, 10, block))


# --- svqb -------------------------------------------------------------------

def _deficient(seed, n, k):
    U = rand(seed, n, k)
    U[:, 3] = U[:, 1]  # exactly dependent column
    U[:, 5] = 0.0  # zero column
    return U


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("count", [6, 4])
def test_svqb_matches(drop, count):
    n, k = 40, 6
    # Dropping is tested on a rank-deficient block; without dropping the
    # round-off directions of a deficient block would be kept, so a
    # full-rank one.
    U = _deficient(14, n, k) if drop else rand(14, n, k)
    jB, tB = ops_pair(jl.DenseOperator(J(spd(15, n))))
    Ut, kt = tsv.svqb(T(U), count, tB, tau=EPS, drop=drop)
    Uj, kj = jsv.svqb(J(U), count, jB, tau=EPS, drop=drop)
    assert kt == int(kj)
    same_span(Ut, Uj)
    # Dead columns exactly zero on both sides.
    np.testing.assert_array_equal(npy(Ut)[:, kt:], 0.0)


def test_svqb_mat_and_transform_match():
    k = 5
    U = rand(16, k, k)
    mat = spd(17, k)
    same_span(tsv.svqb_mat(T(U), T(mat), tau=EPS),
              jsv.svqb_mat(J(U), J(mat), tau=EPS))
    G = U @ mat @ U.T
    Tt, kt = tsv._svqb_transform(T(G), 4, EPS, True, torch.float64)
    Tj, kj = jsv._svqb_transform(J(G), 4, EPS, True, jnp.float64)
    assert kt == int(kj)
    close(Tt.T @ T(G) @ Tt, npy(Tj).T @ G @ npy(Tj), 1e-10)


def test_robust_basis_init_matches_with_same_refill():
    n, k = 40, 6
    X = _deficient(18, n, k)
    jB, tB = ops_pair(jl.DenseOperator(J(spd(19, n))))
    key = jnp.asarray([0, 3], dtype=jnp.uint32)
    refill = npy(jax_fill_random(key, (n, k), jnp.float64))
    Xt = tsv.robust_basis_init(T(X), tB, lambda: T(refill), tau=EPS)
    Xj = jsv.robust_basis_init(J(X), jB, key, tau=EPS)
    same_span(Xt, Xj)
    close(Xt.T @ tB.matmat(Xt), np.eye(k), 1e-10)


# --- ortho ------------------------------------------------------------------

@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("pre_applied", [False, True])
def test_ortho_drop_matches(with_b, pre_applied):
    n, m = 48, 4
    X = np.linalg.qr(rand(20, n, m))[0]
    P = rand(21, n, m)
    P[:, 3] = 0.0
    W = rand(22, n, m)
    jB, tB = ops_pair(jl.DenseOperator(J(spd(23, n)))) if with_b \
        else (None, None)
    kw = dict(eps_ortho=EPS, eps_drop=EPS, return_bu=True)
    if pre_applied and with_b:
        kw_t = dict(kw, Bvb=(tB.matmat(T(X)), tB.matmat(T(P))))
        kw_j = dict(kw, Bvb=(jB.matmat(J(X)), jB.matmat(J(P))))
    else:
        kw_t = kw_j = kw
    Ut, nt, BUt = to.ortho_drop(T(W), m, (T(X), T(P)), m + 3, tB, **kw_t)
    Uj, nj, BUj = jo.ortho_drop(J(W), m, (J(X), J(P)), m + 3, jB, **kw_j)
    assert nt == int(nj)
    same_span(Ut, Uj)
    close(BUt, Ut if tB is None else tB.matmat(Ut), 1e-10)


@pytest.mark.parametrize("entry_check", [False, True])
def test_ortho_indefinite_matches(entry_check):
    (jA, tA), (jB, tB) = bdg_pair()
    n, m = 60, 4
    Xh = rand(24, n // 2, m)
    X = np.vstack([Xh, Xh])  # B-positive block
    X = npy(jsv.svqb(J(X), m, jB, tau=EPS, drop=False)[0])
    P = np.zeros((n, m))
    W = rand(25, n, m)
    Ut, nt, BUt = to.ortho_indefinite(
        T(W), 3, (T(X), T(P)), m, tB, eps_ortho=EPS, eps_drop=EPS,
        return_bu=True, entry_check=entry_check)
    Uj, nj, BUj = jo.ortho_indefinite(
        J(W), 3, (J(X), J(P)), m, jB, eps_ortho=EPS, eps_drop=EPS,
        return_bu=True, entry_check=entry_check)
    assert nt == int(nj)
    same_span(Ut, Uj)
    close(BUt, tB.matmat(Ut), 1e-10)


def test_ortho_indefinite_mat_matches():
    k, nx = 12, 4
    G = rand(26, k, k)
    mat = G + G.T + np.diag(np.r_[np.full(6, 4.0), np.full(6, -4.0)])
    V = rand(27, k, nx)
    U = rand(28, k, nx)
    same_span(
        to.ortho_indefinite_mat(T(U), T(V), T(mat), eps_ortho=EPS,
                                eps_drop=EPS),
        jo.ortho_indefinite_mat(J(U), J(V), J(mat), eps_ortho=EPS,
                                eps_drop=EPS),
    )


# --- rayleigh ---------------------------------------------------------------

def _laplacian_pair(n=48):
    h = 1.0 / (n + 1)
    return ops_pair(jl.Laplacian1D(scale=J(1.0 / h / h), n=n))


def test_rayleigh_ritz_matches():
    jA, tA = _laplacian_pair()
    jB, tB = ops_pair(jl.DenseOperator(J(spd(29, 48))))
    X = rand(30, 48, 5)
    Ct, lt_ = tr.rayleigh_ritz(T(X), tA, tB)
    Cj, lj = jr.rayleigh_ritz(J(X), jA, jB)
    close(lt_, lj)
    same_span(T(X) @ Ct[:, :2], X @ npy(Cj)[:, :2])


def _xpw(seed, n, m, np_act, nw_act):
    X = np.linalg.qr(rand(seed, n, m))[0]
    P = rand(seed + 1, n, m)
    P[:, np_act:] = 0.0
    W = rand(seed + 2, n, m)
    W[:, nw_act:] = 0.0
    return X, P, W


@pytest.mark.parametrize("use_ortho", [0, 1])
@pytest.mark.parametrize("counts", [(4, 4), (2, 3), (0, 4)])
def test_rayleigh_ritz_modified_matches(use_ortho, counts):
    n, m = 48, 4
    jA, tA = _laplacian_pair(n)
    X, P, W = _xpw(31, n, m, *counts)
    AX = npy(jA.matmat(J(X)))
    rt = tr.rayleigh_ritz_modified((T(X), T(P), T(W)), T(AX), *counts,
                                   use_ortho, tA, None, nx=m)
    rj = jr.rayleigh_ritz_modified((J(X), J(P), J(W)), J(AX), *counts,
                                   jnp.int32(use_ortho), jA, None, nx=m)
    assert rt.flag == int(rj.flag)
    assert rt.p_count == int(rj.p_count)
    close(rt.lam, rj.lam, 1e-10)
    S = np.hstack([X, P, W])
    same_span(T(S) @ rt.Cx, S @ npy(rj.Cx))
    if rt.p_count:
        same_span(T(S) @ rt.Cp, S @ npy(rj.Cp))


def test_block_dinv_r_matches():
    G = spd(32, 9)
    Dt, okt, rct = trr.block_dinv_r(T(G), 3)
    Dj, okj, rcj = jr._block_dinv_r(J(G), 3)
    assert bool(okt) == bool(okj)
    close(rct, rcj, 1e-10)
    close(Dt.T @ T(G) @ Dt, np.eye(9), 1e-10)
    np.testing.assert_array_equal(npy(Dt)[3:, :3], 0.0)  # block-triangular


# --- pencil -----------------------------------------------------------------

def _pencil(seed, k=8, shift=None):
    """GA, GB of a definite pencil: GB symmetric indefinite; GA HPD, or
    indefinite when ``shift`` (then GA + shift*GB is HPD)."""
    H = spd(seed, k)
    GB = rand(seed + 1, k, k)
    GB = GB + GB.T
    GA = H if shift is None else H - shift * GB
    return GA, GB


def _cmp_pencil(t, j):
    lt_, Vt, okt = t
    lj, Vj, okj = j
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(npy(lt_), npy(lj), rtol=1e-9, equal_nan=True)
    if bool(okj):
        Vt, Vj = npy(Vt), npy(Vj)
        Vt = Vt / np.linalg.norm(Vt, axis=0)
        Vj = Vj / np.linalg.norm(Vj, axis=0)
        np.testing.assert_allclose(np.abs(np.sum(Vt * Vj, axis=0)), 1.0,
                                   atol=1e-8)


@pytest.mark.parametrize("shift", [None, 0.5 * 20, 3.0 * 20])
def test_pencil_eig_cholesky_matches(shift):
    GA, GB = _pencil(33, shift=shift)
    _cmp_pencil(tp.pencil_eig_cholesky(T(GA), T(GB), 1e-30),
                jp.pencil_eig_cholesky(J(GA), J(GB), 1e-30))


def test_pencil_eig_cholesky_live_mask_matches():
    GA, GB = _pencil(34)
    live = np.array([True] * 6 + [False] * 2)
    GA = npy(jm.inject_diag(J(GA), J(live), 1.0))
    GB = npy(jm.inject_diag(J(GB), J(live), 1.0))
    _cmp_pencil(tp.pencil_eig_cholesky(T(GA), T(GB), 1e-30, T(live)),
                jp.pencil_eig_cholesky(J(GA), J(GB), 1e-30, J(live)))


@pytest.mark.parametrize("method", ["qz", "auto"])
def test_pencil_eig_qz_and_auto_match(method):
    GA, GB = _pencil(35, shift=100.0)
    lt_, _, okt = tp.pencil_eig(T(GA), T(GB), method=method, tiny=1e-30)
    lj, _, okj = jp.pencil_eig(J(GA), J(GB), method=method, tiny=1e-30)
    assert bool(okt) and bool(okj)
    np.testing.assert_allclose(np.sort(npy(lt_)), np.sort(npy(lj)),
                               rtol=1e-9)


# --- indefinite -------------------------------------------------------------

def test_signature_sort_matches_lexsort():
    lam = np.array([3.0, -1.0, 2.0, 2.0, 5.0, -4.0, 0.5, 1e30, -2.0])
    sig = np.array([1, -1, 1, 0, -1, -1, 1, 0, 1], dtype=np.int32)
    np.testing.assert_array_equal(
        npy(tind.signature_sort(T(lam), T(sig))),
        npy(jind.signature_sort(J(lam), J(sig))),
    )


def test_indefinite_rayleigh_ritz_matches():
    (jA, tA), (jB, tB) = bdg_pair()
    Xh = rand(36, 30, 4)
    X = np.vstack([Xh, Xh + 0.1 * rand(37, 30, 4)])
    Ct, lt_, st, okt = tind.indefinite_rayleigh_ritz(
        T(X), tA, tB, method="cholesky", tiny=1e-30)
    Cj, lj, sj, okj = jind.indefinite_rayleigh_ritz(
        J(X), jA, jB, method="cholesky", tiny=1e-30)
    assert bool(okt) == bool(okj)
    close(lt_, lj, 1e-10)
    np.testing.assert_array_equal(npy(st), npy(sj))
    same_span(T(X) @ Ct[:, :2], X @ npy(Cj)[:, :2])


@pytest.mark.parametrize("r", [None, 0.5])
@pytest.mark.parametrize("counts", [(4, 4), (2, 3)])
def test_indefinite_rayleigh_ritz_modified_matches(r, counts):
    m, nx = 30, 4
    V = np.full(m, 2.0)
    V[10:20] = 1.0
    jA = jl.Laplacian1D(scale=J(1.0), n=2 * m, segments=2) + \
        jl.DiagonalOperator(J(np.concatenate([V, V])))
    d = np.ones(m) if r is None else r ** np.arange(m)
    jA, tA = ops_pair(jA)
    jB, tB = ops_pair(jl.BlockAntiDiagOperator(d=J(d)))
    Xh = rand(38, m, nx)
    X = np.vstack([Xh, Xh])
    X = npy(jsv.svqb(J(X), nx, jB, tau=EPS, drop=False)[0])
    _, P, W = _xpw(39, 2 * m, nx, *counts)
    kw = dict(nx=nx, method="cholesky", tiny=1e-30, quality_tol=1e-12,
              eps_ortho=EPS, eps_drop=EPS)
    rt = tind.indefinite_rayleigh_ritz_modified(
        (T(X), T(P), T(W)), None, *counts, tA, tB, **kw)
    rj = jind.indefinite_rayleigh_ritz_modified(
        (J(X), J(P), J(W)), None, *counts, jA, jB, **kw)
    assert rt.rr_ok == bool(rj.rr_ok)
    assert rt.quality == int(rj.quality)
    close(rt.lam, rj.lam, 1e-9)
    np.testing.assert_array_equal(npy(rt.sig), npy(rj.sig))
    S = np.hstack([X, P, W])
    same_span(T(S) @ rt.Cx[:, :2], S @ npy(rj.Cx)[:, :2])
    same_span(T(S) @ rt.Cx_ortho[:, :2], S @ npy(rj.Cx_ortho)[:, :2])
