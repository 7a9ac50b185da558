"""Tests of the port that need a CUDA device (marker ``gpu``; each skips
without one).  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Each kernel (K1 stencil and its fused forms stencil_diag and
cheb_step, K2 3-D stencil, K3/K4/K5/K6 block-sparse SpMMs, K7 streaming
copy, the tall Gram) is held against its plain PyTorch version on the card (the fused
forms also against the eager chain they replace, bit for bit), and
small solves must go through the kernels; the row-sharded layer runs at
world size 1 on NCCL.
"""

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.ops.cuda import copy as k7
from lobpcg_tpu_torch.ops.cuda import gram as kg
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.ops.cuda import stencil3d as k2

SCALE = 3.7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _k1_family() -> int:
    """Launches of K1 and of the two kernels that carry its walk further
    (the BdG operator's apply and the Chebyshev step): a solve of
    Laplacian1D + DiagonalOperator launches one of them where K1 alone
    was launched before."""
    return (k1.stencil_matmat.launches + k1.stencil_diag.launches
            + k1.cheb_step.launches)


# K1's widths: whole 16-byte vectors or not, the sweeps' 30 and the
# README's 6 among them.
K1_WIDTHS = [1, 2, 3, 6, 7, 8, 15, 16, 30, 31, 33, 64, 78, 129, 256]


def _k1_check(X, E, segments):
    """K1 launched once, held to its plain version within 2 ulp of the
    storage dtype x |scale| x max|X| (the kernel and the plain version do
    the same f32 operations in the same order)."""
    before = k1.stencil_matmat.launches
    y = k1.stencil_matmat(X, SCALE, E, num_segments=segments)
    assert k1.stencil_matmat.launches == before + 1
    want = k1.stencil_matmat_reference(X, SCALE, E, num_segments=segments)
    torch.cuda.synchronize()
    tol = 2 * torch.finfo(X.dtype).eps * SCALE * float(X.float().abs().max())
    assert y.dtype == X.dtype and y.shape == X.shape
    assert float((y.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("k", K1_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("sliced", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, k, dtype, edges, sliced):
    """Every width, with and without edge rows, on an aligned X and on a
    row slice X[1:] (k * itemsize bytes past the allocation's start)."""
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (513, k))).to(cuda_device, dtype)
    X = X[1:] if sliced else X[:512]
    E = (torch.from_numpy(rng.uniform(-0.5, 0.5, (2, k))).to(cuda_device, dtype)
         if edges else None)
    _k1_check(X, E, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,segments", [
    (3_000_000, 1, 8),     # thousands of blocks
    (1_000_000, 3, 64),
    (300_000, 30, 16),
    (4096, 3000, 4),       # rows longer than a block's chunk
    (64, 9000, 2),
    (1024, 7, 1024),       # one-row segments
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_many_blocks_and_wide_rows_on_card(cuda_device, n, k, segments,
                                                  dtype):
    """A row slice X[1:] (items narrowed to its alignment) with edge rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + k)
    X = (torch.rand((n + 1, k), generator=gen, device=cuda_device) - 0.5)
    X = X.to(dtype)[1:]
    E = (torch.rand((2, k), generator=gen, device=cuda_device) - 0.5).to(dtype)
    _k1_check(X, E, segments)


@pytest.mark.gpu
def test_kernel_refuses_items_its_bases_do_not_hold(cuda_device):
    """X[1:] of [n, 30] f32 lies 120 bytes past its allocation: items of
    2 elements (8 bytes) fit it, items of 4 do not, and the kernel
    returns cudaErrorInvalidValue for them rather than reading across."""
    X = torch.zeros((65, 30), device=cuda_device)[1:]
    Y = torch.empty_like(X)
    assert k1.items_per_load(30, 4, X.data_ptr(), Y.data_ptr()) == 2
    assert k1.launch(X, Y, 1.0, None, 64, 2) == 0
    assert k1.launch(X, Y, 1.0, None, 64, 4) != 0
    assert k1.launch(X, Y, 1.0, None, 64, 3) != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    X = torch.zeros((64, 8), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        k1.stencil_matmat(X, 1.0)
    with pytest.raises(ValueError):
        k1.stencil_matmat(X.float()[:, ::2], 1.0)  # not contiguous


@pytest.mark.gpu
def test_small_bdg_solve_runs_through_the_kernel(cuda_device):
    m, well, nev, ss, dt = 512, 64, 4, 8, torch.float32
    lo = (m - well) // 2
    V = np.full(m, 2.0)
    V[lo : lo + well] = 1.0
    Vd = torch.as_tensor(np.concatenate([V, V]), dtype=dt, device=cuda_device)
    A = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt) \
        + tl.DiagonalOperator(Vd)
    B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=cuda_device))
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=6.1, degree=3)
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
    before = _k1_family()
    r = tl.ilobpcg(A, X0, B, T, nev=nev, size_sub=ss, tol=1e-5, max_iter=300,
                   generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert r.converged == nev
    assert _k1_family() - before >= 2 * r.iterations
    H = np.diag(2.0 + V) - np.eye(m, k=1) - np.eye(m, k=-1)
    exact = np.linalg.eigvalsh(H)[:nev]
    lam = r.eigenvalues.double().cpu().numpy()
    assert np.abs(lam - exact).max() / exact.min() <= 1e-5


# --- K2: the fused 3-D stencil ----------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(1, 1, 1), (5, 7, 9), (3, 16, 8), (2, 3, 1)])
@pytest.mark.parametrize("k", [1, 3, 4, 16, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil3d_kernel_matches_plain_on_card(cuda_device, grid, k, dtype):
    """Tolerance: 4 ulp of the storage dtype x 12 |scale| max|X| (the
    largest output); the kernel and the plain version do the same f32
    operations in the same order."""
    rng = np.random.default_rng(k)
    n = int(np.prod(grid))
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, k))).to(cuda_device, dtype)
    before = k2.stencil3d_matmat.launches
    y = k2.stencil3d_matmat(X, SCALE, grid)
    assert k2.stencil3d_matmat.launches == before + 1
    want = k2.stencil3d_matmat_reference(X, SCALE, grid)
    torch.cuda.synchronize()
    tol = 4 * torch.finfo(dtype).eps * 12 * SCALE * float(X.float().abs().max())
    assert y.dtype == dtype and y.shape == X.shape
    assert float((y.float() - want.float()).abs().max()) <= tol


# --- K3 / K4 / K5: the block-sparse SpMMs ---------------------------------

def _bsr_tol(plain, op_abs, X, depth):
    """2 x depth x eps_f32 x max(|A| |X|): the error bound of a length-
    `depth` f32 dot in another summation order."""
    return 2 * depth * torch.finfo(torch.float32).eps * float(
        plain(op_abs, X.abs()).abs().max())


def _banded(n, band, seed):
    rng = np.random.RandomState(seed)
    A = np.zeros((n, n))
    for d in range(-band, band + 1):
        A += np.diag(rng.randn(n - abs(d)), d)
    return A


# K3's tiles (csrc/bsr.cu ell_tile_kernel): 32/16/16/8 block rows at
# BN 16/32/64/128 for bs 8 (fewer at bs 24, whose 24 rows are three
# 8-row groups); (360, 8) leaves a ragged last tile, (99, 3) a block of 3
# rows in an 8-row group.  k fills a column tile (16, 128), leaves ragged
# ones (1, 5, 8, 48, 127) and exceeds 128 (130); offset 1 starts X off a
# 16-byte boundary (the 4-byte path).
K3_KS = [1, 5, 8, 16, 48, 127, 128, 130]


@pytest.mark.gpu
@pytest.mark.parametrize("n,bs", [(96, 8), (99, 3), (192, 24), (360, 8)])
@pytest.mark.parametrize("k", K3_KS)
@pytest.mark.parametrize("offset", [0, 1])
def test_bsr_ell_kernel_matches_plain_on_card(cuda_device, n, bs, k, offset):
    A = _banded(n, 2 * bs, n)
    op = tl.BSROperator.from_dense(A, block_size=bs, device=cuda_device)
    X = _offset_X(n, k, offset, k, cuda_device)
    before = kb.bsr_matmat.launches
    y = kb.bsr_matmat(op.block_cols, op.blocks, X)
    assert kb.bsr_matmat.launches == before + 1
    want = kb.bsr_matmat_reference(op.block_cols, op.blocks, X)
    torch.cuda.synchronize()
    R = op.blocks.shape[1]
    tol = _bsr_tol(lambda B, Z: kb.bsr_matmat_reference(op.block_cols, B, Z),
                   op.blocks.abs(), X, R * bs)
    assert float((y - want).abs().max()) <= tol


@pytest.mark.gpu
def test_bsr_ell_and_strip_kernels_reject_what_they_do_not_take(cuda_device):
    cols = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    bs = kb.K3_MAX_BS + 1
    blocks = torch.zeros((2, 1, bs, bs), device=cuda_device)
    with pytest.raises(ValueError):
        kb.bsr_matmat(cols, blocks, torch.zeros((2 * bs, 4), device=cuda_device))
    with pytest.raises(TypeError):
        kb.bsr_matmat(cols.long(), blocks[:, :, :8, :8],
                      torch.zeros((16, 4), device=cuda_device))
    Rs = kb.K4_MAX_UNION // 8 + 1  # K4's union past its row table
    with pytest.raises(ValueError):
        kb.bsr_strip_matmat(torch.zeros((1, Rs), dtype=torch.int32, device=cuda_device),
                            torch.zeros((1, 8, Rs * 8), device=cuda_device),
                            torch.zeros((16, 4), device=cuda_device), bs=8)


# The window tile kernel's edges (csrc/bsr.cu: 32- or 64-row tiles, 16-
# or 32-row window chunks, 16/32/64/128-column tiles from k): (256, 8, 8) and
# (200, 8, 16) have all-zero chunks in every row tile; (384, 24, 30) a
# strip of 264 rows (whole tiles and 8 rows); (99, 3, 6) a window of
# 99 rows (ragged chunk) on a strip of 258; (128, 8, 127) a dense matrix,
# no zero chunk; (384, 8, 24) two strips, the last of 128 rows.  k fills
# each column tile (16, 32, 64, 128), leaves ragged ones (1, 3, 5, 24, 48,
# 127) and exceeds 128 (130).  K4 runs the same tiles on the strip-ELL
# union (W = Rs * bs).
WINDOW_KS = [1, 3, 5, 16, 24, 32, 48, 64, 127, 128, 130]
STRIP_CASES = [(256, 8, 8), (200, 8, 16), (384, 24, 30), (99, 3, 6),
               (128, 8, 127), (384, 8, 24)]


def _offset_X(n, k, offset, seed, device):
    """A uniform(-1, 1) [n, k] f32 X whose rows start ``offset`` elements
    into an allocation (offset 1: off a 16-byte boundary)."""
    big = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (n * k + 1,))
                           ).to(device, torch.float32)
    return big[offset : offset + n * k].view(n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("n,bs,band", STRIP_CASES)
@pytest.mark.parametrize("k", WINDOW_KS)
@pytest.mark.parametrize("offset", [0, 1])
def test_bsr_strip_and_window_kernels_match_plain_on_card(cuda_device, n, bs,
                                                          band, k, offset):
    A = _banded(n, band, band)
    op = tl.BSROperator.from_dense(A, block_size=bs, device="cpu")
    strip = bs * (-(-256 // bs))
    sc, sv = kb.ell_to_strip_ell(op.block_cols.numpy(), op.blocks.numpy(),
                                 strip=strip)
    lo, wv = kb.ell_to_strip_window(op.block_cols.numpy(), op.blocks.numpy(),
                                    strip=strip)
    dev = lambda a: torch.from_numpy(a).to(cuda_device)
    sc, sv, lo, wv = dev(sc), dev(sv), dev(lo), dev(wv)
    X = _offset_X(n, k, offset, k, cuda_device)
    ell = kb.bsr_matmat_reference(op.block_cols.to(cuda_device),
                                  op.blocks.to(cuda_device), X)
    for fn, ref, idx, vals in (
        (kb.bsr_strip_matmat, kb.bsr_strip_matmat_reference, sc, sv),
        (kb.bsr_window_matmat, kb.bsr_window_matmat_reference, lo, wv),
    ):
        before = fn.launches
        y = fn(idx, vals, X, bs=bs)
        assert fn.launches == before + 1
        want = ref(idx, vals, X, bs=bs)
        torch.cuda.synchronize()
        tol = _bsr_tol(lambda V, Z: ref(idx, V, Z, bs=bs), vals.abs(), X,
                       vals.shape[2])
        assert y.shape == (n, k)
        assert float((y - want).abs().max()) <= tol
        assert float((y - ell).abs().max()) <= tol


def _poison(X):
    """NaN and +-Inf in rows that stored zeros, padding blocks (row 0) and
    padding union entries meet, and +Inf over -Inf in one column."""
    n, k = X.shape
    X[0, k // 2] = float("nan")
    X[n // 2, 0] = float("inf")
    X[n - 1, k - 1] = -float("inf")
    X[n // 3, (k - 1) // 3] = float("inf")
    X[n // 3 + 1, (k - 1) // 3] = -float("inf")
    return X


def _same_nonfinite(y, want, tol):
    """The plain version's isnan / isinf pattern, the finite outputs
    within tol."""
    assert torch.equal(y.isnan(), want.isnan())
    assert torch.equal(y.isinf(), want.isinf())
    fin = want.isfinite()
    assert float((y[fin] - want[fin]).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("n,bs,band", STRIP_CASES)
@pytest.mark.parametrize("k", [5, 16, 128, 130])
@pytest.mark.parametrize("offset", [0, 1])
def test_bsr_kernels_carry_nonfinite_like_plain_on_card(cuda_device, n, bs, band,
                                                         k, offset):
    """K3, K4 and K5 on an X with NaN and +-Inf that in most row tiles
    only stored zeros (skipped chunks) meet: the non-finite pattern of
    each equals its plain version's (tests/test_torch_sparse.py holds the
    plain versions to the Pallas kernels' pattern)."""
    A = _banded(n, band, band)
    op = tl.BSROperator.from_dense(A, block_size=bs, device="cpu")
    strip = bs * (-(-256 // bs))
    cols, blocks = op.block_cols.numpy(), op.blocks.numpy()
    dev = lambda a: torch.from_numpy(a).to(cuda_device)
    fmts = [(kb.bsr_strip_matmat, kb.bsr_strip_matmat_reference,
             *map(dev, kb.ell_to_strip_ell(cols, blocks, strip=strip))),
            (kb.bsr_window_matmat, kb.bsr_window_matmat_reference,
             *map(dev, kb.ell_to_strip_window(cols, blocks, strip=strip)))]
    X = _offset_X(n, k, offset, k, cuda_device)
    Xabs = X.abs()
    _poison(X)
    cols_d, blocks_d = dev(cols), dev(blocks)
    y = kb.bsr_matmat(cols_d, blocks_d, X)
    want = kb.bsr_matmat_reference(cols_d, blocks_d, X)
    torch.cuda.synchronize()
    _same_nonfinite(y, want, _bsr_tol(
        lambda B, Z: kb.bsr_matmat_reference(cols_d, B, Z), blocks_d.abs(), Xabs,
        blocks.shape[1] * bs))
    for fn, ref, idx, vals in fmts:
        y = fn(idx, vals, X, bs=bs)
        want = ref(idx, vals, X, bs=bs)
        torch.cuda.synchronize()
        assert want.isnan().any()
        _same_nonfinite(y, want, _bsr_tol(lambda V, Z: ref(idx, V, Z, bs=bs),
                                          vals.abs(), Xabs, vals.shape[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf"), 1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_nonfinite_flag_on_card(cuda_device, value, offset):
    """The flag K4/K5/K6 read: 1 exactly when one of the buffers holds a
    NaN or Inf, wherever it sits (the float4 body, the tail, an unaligned
    buffer, the second or third span)."""
    X = _offset_X(1027, 3, offset, 0, cuda_device)
    halo = torch.zeros((5, 3), device=cuda_device)
    assert int(kb.nonfinite_flag(X)) == 0
    assert int(kb.nonfinite_flag(X, halo[:0], halo)) == 0
    bad = value != 1.0
    for where in (0, 1500, X.numel() - 1):
        Z = X.clone().view(-1)
        Z[where] = value
        assert int(kb.nonfinite_flag(Z.view(X.shape))) == bad
    H = halo.clone()
    H[4, 2] = value
    assert int(kb.nonfinite_flag(X, halo, H)) == bad


@pytest.mark.gpu
@pytest.mark.parametrize("W,strip,k", [(4196, 96, 5), (8200, 70, 16), (4099, 64, 48)])
def test_window_kernel_wide_and_scattered_windows_on_card(cuda_device, W, strip, k):
    """K5 on windows wider than the window rule admits (4,096 rows), with
    half of the 16-row chunks zero at random (holes between nonzero
    chunks), a strip that is not a multiple of the row tile and the last
    strip's rows cut by out_rows."""
    rng = np.random.default_rng(W)
    ns = 2
    wv = rng.uniform(-1, 1, (ns, strip, W)).astype(np.float32)
    for c in np.nonzero(rng.random(-(-W // 16)) < 0.5)[0]:
        wv[:, :, c * 16 : (c + 1) * 16] = 0.0
    rows = W + 40
    lo = rng.integers(0, (rows - W) // 8 + 1, ns).astype(np.int32)
    lo, wv = torch.from_numpy(lo).to(cuda_device), torch.from_numpy(wv).to(cuda_device)
    X = torch.from_numpy(rng.uniform(-1, 1, (rows, k))).to(cuda_device, torch.float32)
    n_out = ns * strip - 5
    y = kb.bsr_window_matmat(lo, wv, X, bs=8, out_rows=n_out)
    want = kb.bsr_window_matmat_reference(lo, wv, X, bs=8, out_rows=n_out)
    torch.cuda.synchronize()
    tol = _bsr_tol(lambda V, Z: kb.bsr_window_matmat_reference(
        lo, V, Z, bs=8, out_rows=n_out), wv.abs(), X, W)
    assert y.shape == (n_out, k)
    assert float((y - want).abs().max()) <= tol


@pytest.mark.gpu
def test_bsr_operator_dispatch_on_card(cuda_device):
    """A dense matrix carries a window that pays (R*bs = W) and goes to
    K5; a narrow band carries one that does not (R*bs 40 against W 384)
    and goes to K3, as does the 3-D Laplacian's CSR, which has none."""
    rng = np.random.RandomState(1)
    for A, pays in ((rng.randn(128, 128), True), (_banded(512, 16, 1), False)):
        op = tl.BSROperator.from_dense(A, block_size=8, device=cuda_device)
        assert op.win_vals is not None and op.window_pays(4) == pays
        X = torch.ones((A.shape[0], 4), device=cuda_device)
        b5, b3 = kb.bsr_window_matmat.launches, kb.bsr_matmat.launches
        y = op.matmat(X)
        assert (kb.bsr_window_matmat.launches - b5, kb.bsr_matmat.launches - b3) \
            == ((1, 0) if pays else (0, 1))
        np.testing.assert_allclose(y.cpu().numpy(), A.sum(axis=1)[:, None]
                                   * np.ones((1, 4)), rtol=1e-5, atol=1e-4)
    lap = tl.BSROperator.from_csr(*tl.laplacian_3d_csr(16, 16, 16),
                                  block_size=8, device=cuda_device)
    assert lap.win_vals is None
    b3 = kb.bsr_matmat.launches
    lap.matmat(torch.ones((4096, 4), device=cuda_device))
    assert kb.bsr_matmat.launches == b3 + 1


# --- K6 and the row-sharded layer ------------------------------------------

def _k6_shards(case):
    """(bs, hrows, n_loc, W, [(lo, win_vals)] per shard, global rows) of a
    row-sharded banded matrix.  "band4": n 4096 cut into 4 shards by the
    sharded operator's planning (strip 256, W 384).  "ragged264": one
    interior shard built by hand at bs 24: strip 264 (not a multiple of
    the 32- or 64-row tile), halo 1 block, n_loc 792, W 312 (not a
    multiple of the 16- or 32-row chunk), its three strips reading
    edge_top, X and edge_bot."""
    from lobpcg_tpu_torch.parallel import plan_shards

    if case == "band4":
        n, nd, bs = 4096, 4, 8
        op = tl.BSROperator.from_dense(_banded(n, 24, 3), block_size=bs,
                                       device="cpu")
        plan = plan_shards(op, nd)
        return (bs, plan.halo * bs, n // nd, plan.width * bs,
                [(plan.lo[d], plan.win[d]) for d in range(nd)], n)
    bs, nb_loc, halo, Wb = 24, 33, 1, 13
    rng = np.random.RandomState(6)
    # Local block row i couples to frame block columns i .. i + 2.
    cols = (np.arange(nb_loc)[:, None] + np.arange(3)[None, :]).astype(np.int32)
    vals = rng.uniform(-0.5, 0.5, (nb_loc, 3, bs, bs)).astype(np.float32)
    lo, wv = kb.ell_to_strip_window(cols, vals, strip=264,
                                    ncols=nb_loc + 2 * halo, force_width=Wb)
    n_loc = nb_loc * bs
    # The one shard sits in the middle of a global X of 3 shards' rows.
    return bs, halo * bs, n_loc, Wb * bs, [(None, None), (lo, wv), (None, None)], \
        3 * n_loc


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["band4", "ragged264"])
@pytest.mark.parametrize("k", WINDOW_KS)
@pytest.mark.parametrize("offset", [0, 1])
def test_k6_matches_k5_and_plain_on_card(cuda_device, case, k, offset):
    """A banded matrix cut into row shards, the halos cut from the global
    X: K6 on each shard equals K5 on the concatenated frame bit for bit
    (the same tile function, tiles and FFMA order), and its plain version
    within the window tolerance.  ``offset`` 1 makes X's rows start off a
    16-byte boundary (the 4-byte path of K6; K5 reads the concatenated,
    aligned frame)."""
    bs, hrows, n_loc, W, shards, n = _k6_shards(case)
    X = _offset_X(n, k, offset, k, cuda_device)
    zeros = torch.zeros((hrows, k), device=cuda_device)
    nd = len(shards)
    for d, (lo, wv) in enumerate(shards):
        if lo is None:
            continue
        xs = X[d * n_loc : (d + 1) * n_loc]
        up = X[d * n_loc - hrows : d * n_loc] if d else zeros
        dn = X[(d + 1) * n_loc : (d + 1) * n_loc + hrows] if d < nd - 1 else zeros
        top = torch.cat([up, xs[:W]])
        bot = torch.cat([xs[-W:], dn])
        starts = lo.astype(np.int64) * bs
        if case == "ragged264":
            assert (starts < hrows).any() and (starts > hrows + n_loc - W).any()
        lo = torch.from_numpy(lo).to(cuda_device)
        wv = torch.from_numpy(wv).to(cuda_device)
        before = kb.bsr_window_matmat_edges.launches
        y6 = kb.bsr_window_matmat_edges(lo, wv, xs, top, bot, bs=bs, hrows=hrows)
        assert kb.bsr_window_matmat_edges.launches == before + 1
        y5 = kb.bsr_window_matmat(lo, wv, torch.cat([up, xs, dn]), bs=bs,
                                  out_rows=n_loc)
        want = kb.bsr_window_matmat_edges_reference(lo, wv, xs, top, bot, bs=bs,
                                                    hrows=hrows)
        torch.cuda.synchronize()
        assert y6.shape == (n_loc, k)
        assert torch.equal(y6, y5), d
        tol = _bsr_tol(lambda V, Z: kb.bsr_window_matmat_reference(
            lo, V, torch.cat([up.abs(), Z, dn.abs()]), bs=bs, out_rows=n_loc),
            wv.abs(), xs, W)
        assert float((y6 - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["band4", "ragged264"])
@pytest.mark.parametrize("k", [5, 16, 130])
def test_k6_carries_nonfinite_like_plain_on_card(cuda_device, case, k):
    """K6 on shards of an X with NaN and +-Inf (in the halos too): each
    shard's non-finite pattern equals its plain version's, and K5's on
    the concatenated frame."""
    bs, hrows, n_loc, W, shards, n = _k6_shards(case)
    X = _offset_X(n, k, 0, k, cuda_device)
    Xabs = X.abs()
    _poison(X)
    X[n_loc - 1, k - 1] = float("nan")  # the last row of shard 0: a halo row
    zeros = torch.zeros((hrows, k), device=cuda_device)
    nd = len(shards)
    for d, (lo, wv) in enumerate(shards):
        if lo is None:
            continue
        rows = slice(d * n_loc - hrows if d else 0,
                     (d + 1) * n_loc + hrows if d < nd - 1 else n)
        frame_abs = torch.cat([zeros] * (d == 0) + [Xabs[rows]]
                              + [zeros] * (d == nd - 1))
        xs = X[d * n_loc : (d + 1) * n_loc]
        up = X[d * n_loc - hrows : d * n_loc] if d else zeros
        dn = X[(d + 1) * n_loc : (d + 1) * n_loc + hrows] if d < nd - 1 else zeros
        top, bot = torch.cat([up, xs[:W]]), torch.cat([xs[-W:], dn])
        lo, wv = torch.from_numpy(lo).to(cuda_device), torch.from_numpy(wv).to(cuda_device)
        y6 = kb.bsr_window_matmat_edges(lo, wv, xs, top, bot, bs=bs, hrows=hrows)
        y5 = kb.bsr_window_matmat(lo, wv, torch.cat([up, xs, dn]), bs=bs,
                                  out_rows=n_loc)
        want = kb.bsr_window_matmat_edges_reference(lo, wv, xs, top, bot, bs=bs,
                                                    hrows=hrows)
        torch.cuda.synchronize()
        tol = _bsr_tol(lambda V, Z: kb.bsr_window_matmat_reference(
            lo, V, Z, bs=bs, out_rows=n_loc), wv.abs(), frame_abs, W)
        _same_nonfinite(y6, want, tol)
        _same_nonfinite(y6, y5, 0.0)


@pytest.mark.gpu
def test_k6_rejects_what_it_does_not_take(cuda_device):
    lo = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    wv = torch.zeros((2, 16, 16), device=cuda_device)
    X = torch.zeros((32, 4), device=cuda_device)
    top = torch.zeros((24, 4), device=cuda_device)
    with pytest.raises(TypeError):
        kb.bsr_window_matmat_edges(lo.long(), wv, X, top, top, bs=8, hrows=8)
    with pytest.raises(ValueError):
        kb.bsr_window_matmat_edges(lo, wv, X, top[:, ::2], top[:, ::2], bs=8,
                                   hrows=8)


@pytest.mark.gpu
def test_sharded_layer_at_world_size_one_on_card(cuda_device):
    """row_mesh(1) on NCCL: a sharded banded apply launches K6 once (and
    K5 never) and agrees with BSROperator.matmat; a sharded BdG well solve
    converges through K1 with its reductions all-reduced."""
    import torch.distributed as dist

    from lobpcg_tpu_torch import parallel
    from lobpcg_tpu_torch.parallel import mesh as pmesh

    mesh = parallel.row_mesh(1)
    try:
        n, k = 4096, 16
        op = tl.BSROperator.from_dense(_banded(n, 24, 5), block_size=8,
                                       device=cuda_device)
        sop = parallel.ShardedBSROperator.shard(op, mesh)
        X = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (n, k))
                             ).to(cuda_device, torch.float32)
        b6, b5 = kb.bsr_window_matmat_edges.launches, kb.bsr_window_matmat.launches
        y = sop.matmat(X)
        assert (kb.bsr_window_matmat_edges.launches,
                kb.bsr_window_matmat.launches) == (b6 + 1, b5)
        want = op.matmat(X)
        torch.cuda.synchronize()
        tol = _bsr_tol(lambda B, Z: kb.bsr_matmat_reference(op.block_cols, B, Z),
                       op.blocks.abs(), X, sop.win_vals.shape[2])
        assert float((y - want).abs().max()) <= tol

        m, well, nev, ss = 512, 64, 4, 8
        lo = (m - well) // 2
        V = np.full(m, 2.0)
        V[lo : lo + well] = 1.0
        Vd = torch.as_tensor(np.concatenate([V, V]), dtype=torch.float32,
                             device=cuda_device)
        A = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2) + tl.DiagonalOperator(Vd)
        B = tl.BlockAntiDiagOperator(d=torch.ones(m, device=cuda_device))
        T = tl.ChebyshevFilter(op=A, lo=2.0, hi=6.1, degree=3)
        u = np.zeros((m, ss), np.float32)
        u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
        X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
        As, X0s, Bs, Ts = parallel.shard_problem(mesh, A, X0, B, T)
        k1_before, ar_before = _k1_family(), pmesh.all_reduce.launches
        with mesh:
            r = tl.ilobpcg(As, X0s, Bs, Ts, nev=nev, size_sub=ss, tol=1e-5,
                           max_iter=300,
                           generator=torch.Generator(device=cuda_device).manual_seed(0))
        assert r.converged == nev
        assert _k1_family() - k1_before >= r.iterations
        assert pmesh.all_reduce.launches > ar_before
        assert torch.isfinite(r.eigenvalues).all()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_small_3d_solves_run_through_k2_and_k3(cuda_device):
    g, nev, ss = (12, 12, 12), 3, 6
    n = int(np.prod(g))
    h = 1.0 / 13
    X0 = torch.from_numpy(np.random.RandomState(0).uniform(-0.5, 0.5, (n, ss))
                          ).to(cuda_device, torch.float32)
    exact = tl.laplacian_nd_eigs(g, 1.0 / h**2, nev)
    ops = {
        "k2": (tl.LaplacianND(scale=1.0 / h**2, grid=g), k2.stencil3d_matmat),
        "k3": (tl.BSROperator.from_csr(*tl.laplacian_3d_csr(*g), block_size=8,
                                       device=cuda_device), kb.bsr_matmat),
    }
    for A, fn in ops.values():
        before = fn.launches
        r = tl.lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-5, max_iter=500,
                      generator=torch.Generator(device=cuda_device).manual_seed(0))
        assert r.converged == nev
        assert fn.launches - before >= r.iterations
        lam = r.eigenvalues.double().cpu().numpy()
        assert np.abs(lam - exact).max() <= 1e-5 * 12 / h**2


# --- The batched launches (a lockstep batch of problems sharing the grid
# or the matrix): one launch for the batch, each problem's Y equal to its
# lone launch's bit for bit (the same f32 operations in the same order),
# the batch within the lone tolerance of the batched plain version.


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(1, 1, 1), (5, 7, 9), (3, 16, 8), (2, 3, 1)])
@pytest.mark.parametrize("k", [1, 3, 16, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil3d_batched_launch_on_card(cuda_device, grid, k, dtype):
    b = 3
    n = int(np.prod(grid))
    X = torch.from_numpy(np.random.default_rng(k).uniform(-0.5, 0.5, (b, n, k))
                         ).to(cuda_device, dtype)
    before = k2.stencil3d_matmat.launches
    y = k2.stencil3d_matmat(X, SCALE, grid)
    assert k2.stencil3d_matmat.launches == before + 1
    want = k2.stencil3d_matmat_reference(X, SCALE, grid)
    lone = [k2.stencil3d_matmat(X[i], SCALE, grid) for i in range(b)]
    torch.cuda.synchronize()
    tol = 4 * torch.finfo(dtype).eps * 12 * SCALE * float(X.float().abs().max())
    assert y.shape == X.shape
    assert float((y.float() - want.float()).abs().max()) <= tol
    for i in range(b):
        assert torch.equal(y[i], lone[i])


@pytest.mark.gpu
@pytest.mark.parametrize("n,bs", [(96, 8), (99, 3), (360, 8)])
@pytest.mark.parametrize("k", [1, 5, 16, 48, 130])
def test_bsr_ell_batched_launch_on_card(cuda_device, n, bs, k):
    b = 3
    A = _banded(n, 2 * bs, n)
    op = tl.BSROperator.from_dense(A, block_size=bs, device=cuda_device)
    X = torch.from_numpy(np.random.default_rng(k).uniform(-1, 1, (b, n, k))
                         ).to(cuda_device, torch.float32)
    before = kb.bsr_matmat.launches
    y = kb.bsr_matmat(op.block_cols, op.blocks, X)
    assert kb.bsr_matmat.launches == before + 1
    lone = [kb.bsr_matmat(op.block_cols, op.blocks, X[i]) for i in range(b)]
    want = kb.bsr_matmat_reference(op.block_cols, op.blocks, X)
    torch.cuda.synchronize()
    tol = _bsr_tol(lambda B, Z: kb.bsr_matmat_reference(op.block_cols, B, Z),
                   op.blocks.abs(), X, op.blocks.shape[1] * bs)
    assert float((y - want).abs().max()) <= tol
    for i in range(b):
        assert torch.equal(y[i], lone[i])


@pytest.mark.gpu
@pytest.mark.parametrize("n,bs,band", [(256, 8, 8), (384, 24, 30), (99, 3, 6)])
@pytest.mark.parametrize("k", [1, 5, 16, 48, 130])
def test_bsr_window_batched_launch_on_card(cuda_device, n, bs, band, k):
    b = 3
    A = _banded(n, band, band)
    op = tl.BSROperator.from_dense(A, block_size=bs, device="cpu")
    lo, wv = kb.ell_to_strip_window(op.block_cols.numpy(), op.blocks.numpy(),
                                    strip=bs * (-(-256 // bs)))
    lo, wv = (torch.from_numpy(a).to(cuda_device) for a in (lo, wv))
    X = torch.from_numpy(np.random.default_rng(k).uniform(-1, 1, (b, n, k))
                         ).to(cuda_device, torch.float32)
    X[1, n // 2, 0] = float("nan")  # one problem's NaN: the flag is the batch's
    before = kb.bsr_window_matmat.launches
    y = kb.bsr_window_matmat(lo, wv, X, bs=bs)
    assert kb.bsr_window_matmat.launches == before + 1
    lone = [kb.bsr_window_matmat(lo, wv, X[i], bs=bs) for i in range(b)]
    want = kb.bsr_window_matmat_reference(lo, wv, X, bs=bs)
    torch.cuda.synchronize()
    fin = torch.nan_to_num(X, nan=0.0)
    tol = _bsr_tol(lambda V, Z: kb.bsr_window_matmat_reference(lo, V, Z, bs=bs),
                   wv.abs(), fin, wv.shape[2])
    _same_nonfinite(y, want, tol)
    for i in (0, 2):  # the finite problems: their lone launches' bits
        assert torch.equal(y[i], lone[i])


@pytest.mark.gpu
def test_lockstep_3d_solves_run_through_batched_k2_and_k3(cuda_device):
    """A lockstep batch of 2 on the 12^3 grid (the Laplacian, and it plus
    a trap) through LaplacianND and BSROperator: converged, and the
    kernel launched once a batch apply (as often as the longest problem
    alone applies A)."""
    g, nev, ss = (12, 12, 12), 3, 6
    n = int(np.prod(g))
    h = 1.0 / 13
    x = (np.arange(12) + 1) * h - 0.5
    trap = (x[:, None, None] ** 2 + 1.3 * x[None, :, None] ** 2
            + 1.7 * x[None, None, :] ** 2).ravel()
    V = torch.from_numpy(np.stack([0 * trap, 400 * trap])).to(cuda_device,
                                                            torch.float32)
    X0 = torch.from_numpy(np.random.RandomState(0).uniform(-0.5, 0.5, (n, ss))
                          ).to(cuda_device, torch.float32)
    for A, fn in (
            (tl.LaplacianND(scale=1.0 / h**2, grid=g), k2.stencil3d_matmat),
            (tl.BSROperator.from_csr(*tl.laplacian_3d_csr(*g), block_size=8,
                                     device=cuda_device), kb.bsr_matmat)):
        counts = []
        for Ai, X in ((A + tl.DiagonalOperator(V), X0.expand(2, n, ss)),
                      (A + tl.DiagonalOperator(V[0]), X0),
                      (A + tl.DiagonalOperator(V[1]), X0)):
            before = fn.launches
            r = tl.lobpcg(Ai, X.contiguous(), nev=nev, size_sub=ss, tol=1e-5,
                          max_iter=500, generator=torch.Generator(
                              device=cuda_device).manual_seed(0))
            counts.append((fn.launches - before, r.iterations))
            assert (torch.as_tensor(r.converged) == nev).all()
        (batch, its), lone = counts[0], counts[1:]
        longest = max(range(2), key=lambda i: lone[i][1])
        if int(its.max()) == lone[longest][1]:
            assert batch == lone[longest][0]
        assert batch < lone[0][0] + lone[1][0]


@pytest.mark.gpu
def test_entry_points_default_to_the_card(cuda_device):
    A = tl.Laplacian1D(scale=1.0, n=64)
    r = tl.lobpcg(A, nev=2, size_sub=4, tol=1e-5, max_iter=200)
    assert r.eigenvalues.device.type == "cuda"
    op = tl.BSROperator.from_dense(np.eye(16), block_size=8)
    assert op.blocks.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(40,), (12, 9), (6, 5, 7)])
def test_laplacian_nd_kernels_match_plain_formula_on_card(cuda_device, grid):
    """f32 LaplacianND (K1 passes in 1-D/2-D, K2 in 3-D) against its
    plain pad/slice formula (force_jnp) on the card; tolerance 4 ulp x
    12 |scale| max|X|, the largest output."""
    n = int(np.prod(grid))
    X = torch.from_numpy(np.random.default_rng(n).uniform(-0.5, 0.5, (n, 12))
                         ).to(cuda_device, torch.float32)
    y = tl.LaplacianND(scale=SCALE, grid=grid).matmat(X)
    want = tl.LaplacianND(scale=SCALE, grid=grid, force_jnp=True).matmat(X)
    torch.cuda.synchronize()
    tol = 4 * torch.finfo(torch.float32).eps * 12 * SCALE * float(X.abs().max())
    assert float((y - want).abs().max()) <= tol


def _banded_ell(nb, bs, w, seed):
    """A block-banded block-ELL matrix: block row i couples to block
    columns i-w..i+w (padding blocks zero at column 0)."""
    rng = np.random.RandomState(seed)
    R = 2 * w + 1
    i = np.arange(nb)[:, None]
    j = i + np.arange(-w, w + 1)[None, :]
    ok = (j >= 0) & (j < nb)
    cols = np.where(ok, j, 0).astype(np.int32)
    vals = rng.uniform(-0.5, 0.5, (nb, R, bs, bs)).astype(np.float32)
    vals[~ok] = 0.0
    return cols, vals


@pytest.mark.gpu
def test_kernels_address_past_2_31_elements(cuda_device):
    """n * k > 2**31, so the last rows' element offsets need 64 bits: each
    kernel's last rows against the plain version of the sub-problem that
    produces them."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    eps = torch.finfo(torch.float32).eps
    # K2 on 160^3 x 528.
    g, k = (160, 160, 160), 528
    plane = g[1] * g[2]
    X = torch.rand((int(np.prod(g)), k), generator=gen, device=cuda_device) - 0.5
    assert X.numel() > 2**31
    y = k2.stencil3d_matmat(X, SCALE, g)[-plane:]
    want = k2.stencil3d_matmat_reference(X[-2 * plane:], SCALE,
                                         (2, g[1], g[2]))[-plane:]
    assert float((y - want).abs().max()) <= 4 * eps * 12 * SCALE * 0.5
    del X, y, want
    torch.cuda.empty_cache()
    # K3, K4, K5 on a block-banded matrix, n 2^20 x 2056.
    nb, bs, w, k = 2**17, 8, 3, 2056
    cols, vals = _banded_ell(nb, bs, w, 0)
    strip = 256
    sc, sv = kb.ell_to_strip_ell(cols, vals, strip=strip)
    lo, wv = kb.ell_to_strip_window(cols, vals, strip=strip)
    dev = lambda a: torch.from_numpy(a).to(cuda_device)
    cols_d, vals_d, sc, sv, lo, wv = (dev(a) for a in (cols, vals, sc, sv, lo, wv))
    X = torch.rand((nb * bs, k), generator=gen, device=cuda_device) - 0.5
    assert X.numel() > 2**31
    m = strip // bs  # the last strip's block rows
    Xg = X.view(nb, bs, k)[cols_d[-m:].long()]
    want = torch.einsum("nrij,nrjk->nik", vals_d[-m:], Xg).reshape(strip, k)
    tol = 2 * wv.shape[2] * eps * 0.25 * (2 * w + 1) * bs
    for fn, idx, v in ((kb.bsr_matmat, cols_d, vals_d),
                       (kb.bsr_strip_matmat, sc, sv),
                       (kb.bsr_window_matmat, lo, wv)):
        y = fn(idx, v, X) if fn is kb.bsr_matmat else fn(idx, v, X, bs=bs)
        assert float((y[-strip:] - want).abs().max()) <= tol
        del y
        torch.cuda.empty_cache()


# --- K7: the streaming copy ---------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 64, 256])
@pytest.mark.parametrize("n", [1, 7, 1021, 4099])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_copy_kernel_matches_clone_on_card(cuda_device, n, k, offset):
    """Bit for bit, at n not a multiple of 4 and, with a nonzero offset,
    a base address that is not 16-byte aligned (a contiguous view into
    an offset storage)."""
    buf = torch.rand(n * k + offset, device=cuda_device) - 0.5
    X = buf[offset:].view(n, k)
    assert X.is_contiguous() and (X.data_ptr() % 16 == 0) == (offset == 0)
    before = k7.stream_copy.launches
    Y = k7.stream_copy(X)
    assert k7.stream_copy.launches == before + 1
    torch.cuda.synchronize()
    assert Y.data_ptr() != X.data_ptr()
    assert torch.equal(Y, k7.stream_copy_reference(X))


@pytest.mark.gpu
def test_copy_kernel_rejects_what_it_does_not_take(cuda_device):
    X = torch.zeros((64, 8), device=cuda_device)
    with pytest.raises(TypeError):
        k7.stream_copy(X.double())
    with pytest.raises(ValueError):
        k7.stream_copy(X[:, ::2])  # not contiguous


@pytest.mark.gpu
def test_copy_kernel_past_2_31_bytes(cuda_device):
    """[2^21 + 3, 256] f32 is more than 2^31 bytes (and 2^29 elements):
    the offsets of the last rows need more than 31 bits of bytes."""
    n, k = 2**21 + 3, 256
    X = torch.rand((n, k), device=cuda_device,
                   generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert X.numel() * 4 > 2**31
    Y = k7.stream_copy(X)
    torch.cuda.synchronize()
    assert torch.equal(Y, X)


@pytest.mark.gpu
def test_solve_checkpointed_on_card(cuda_device, tmp_path):
    """A small well Hamiltonian K = tridiag[-1, 2, -1] + V solved in
    chunks of 7 iterations, snapshotted to disk, against the one-shot
    solve from the same X0 and the dense eigenvalues (f32; tolerance
    1e-5 relative, the f32 solve's: ||K|| ~ 6, so rounding is far
    below it)."""
    n, nev, ss, well = 256, 3, 6, 32
    V = np.full(n, 2.0)
    V[(n - well) // 2 : (n + well) // 2] = 1.0
    A = tl.Laplacian1D(scale=1.0, n=n) + tl.DiagonalOperator(
        torch.as_tensor(V, dtype=torch.float32, device=cuda_device))
    X0 = torch.from_numpy(np.random.RandomState(5).uniform(-0.5, 0.5, (n, ss))
                          ).to(cuda_device, torch.float32)
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=300)
    gen = lambda: torch.Generator(device=cuda_device).manual_seed(0)
    full = tl.lobpcg(A, X0, config=cfg, generator=gen())
    before = _k1_family()
    r = tl.solve_checkpointed(tl.lobpcg, A, X0, config=cfg,
                              path=tmp_path / "ck.npz", every=7,
                              generator=gen())
    assert _k1_family() > before
    assert r.converged == nev and r.eigenvalues.device.type == "cuda"
    ck = tl.load_checkpoint(tmp_path / "ck.npz")
    assert ck["basis"].shape == (n, ss) and ck["iterations"] == r.iterations
    np.testing.assert_allclose(r.eigenvalues.cpu().numpy(),
                               full.eigenvalues.cpu().numpy(), rtol=1e-5)
    H = np.diag(2.0 + V) - np.eye(n, k=1) - np.eye(n, k=-1)
    np.testing.assert_allclose(r.eigenvalues.double().cpu().numpy(),
                               np.linalg.eigvalsh(H)[:nev], rtol=1e-5)


@pytest.mark.gpu
def test_bdg_physics_solve_runs_through_k1(cuda_device):
    """The uniform-gas BdG pencil (physics/bdg.py) in f32 on the card:
    the Laplacian1D kinetic term launches K1, and the solve reproduces
    the Bogoliubov dispersion to 1e-3 relative: f32 rounding at
    ||A|| ~ 3.3e4 bounds the absolute error near ||A|| eps_f32 ~ 2e-3,
    6e-5 of omega_1 ~ 33, and the tolerance leaves a margin over it."""
    from lobpcg_tpu_torch.physics import bdg_operators, bdg_positive_start

    m, g, nev, ss = 128, 50.0, 4, 8
    h = 1.0 / (m + 1)
    kinetic = tl.Laplacian1D(scale=0.5 / h**2, n=m)
    psi = torch.ones(m, device=cuda_device)
    A, B, _, _ = bdg_operators(kinetic, psi, g=g, mu=g)
    eps = 2.0 / h**2 * np.sin(np.arange(1, m + 1) * np.pi * h / 2) ** 2
    omega = np.sort(np.sqrt(eps * (eps + 2 * g)))
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    X0 = bdg_positive_start(gen, m, ss, torch.float32)
    before = _k1_family()
    r = tl.ilobpcg(A, X0, B, nev=nev, size_sub=ss, tol=1e-5, max_iter=400,
                   generator=gen)
    assert r.converged == nev
    assert _k1_family() - before >= 2 * r.iterations
    np.testing.assert_allclose(r.eigenvalues.double().cpu().numpy(),
                               omega[:nev], rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol,rtol", [(torch.complex128, 1e-8, 1e-9),
                                            (torch.complex64, 1e-5, 1e-5)])
def test_native_complex_solve_matches_realify_on_card(cuda_device, dtype, tol,
                                                      rtol):
    """A dense Hermitian problem (n 64, nev 3) solved natively in complex
    on the card and through the split-real embedding: both within rtol
    of the dense eigenvalues (1e-9 in complex128 at tol 1e-8; 1e-5 in
    complex64 at tol 1e-5, whose rounding floor is ~||A|| eps_f32 ~ 1e-5
    absolute at ||A|| ~ 100 against eigenvalues ~ 50)."""
    n, nev, ss = 64, 3, 5
    rng = np.random.RandomState(1)
    M = rng.randn(n, n) + 1j * rng.randn(n, n)
    A_np = (M + M.conj().T) / 2 + n * np.eye(n)
    X0 = rng.uniform(-0.5, 0.5, (n, ss)) + 1j * rng.uniform(-0.5, 0.5, (n, ss))
    A = tl.DenseOperator(torch.from_numpy(A_np).to(cuda_device, dtype))
    X0t = torch.from_numpy(X0).to(cuda_device, dtype)
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=300)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    native = tl.lobpcg(A, X0t, config=cfg, generator=gen)
    Ar, X0r, _, _, cfgr = tl.realify_problem(A, X0t, config=cfg)
    assert Ar.dtype == dtype.to_real()
    rr = tl.lobpcg(Ar, X0r, config=cfgr, generator=gen)
    lam, _, _ = tl.derealify(rr, nev)
    exact = np.linalg.eigvalsh(A_np)[:nev]
    assert native.converged == nev and rr.converged == 2 * nev
    assert native.eigenvectors.dtype == dtype
    np.testing.assert_allclose(native.eigenvalues.double().cpu().numpy(),
                               exact, rtol=rtol)
    np.testing.assert_allclose(lam, exact, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("k,segments", [(160, 2), (320, 4)])
def test_kernel_at_the_headline_widths(cuda_device, k, segments):
    """K1 at the widths of the two headline gates (the real gate's 160
    columns over 2 segments, the split-real gate's 320 over 4), with and
    without edge rows, against its plain version; tolerance as
    test_kernel_matches_plain_on_card."""
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (8192, k))).to(cuda_device,
                                                               torch.float32)
    E = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, k))).to(cuda_device,
                                                            torch.float32)
    tol = 2 * torch.finfo(torch.float32).eps * SCALE * float(X.abs().max())
    for edges in (None, E):
        before = k1.stencil_matmat.launches
        y = k1.stencil_matmat(X, SCALE, edges, num_segments=segments)
        assert k1.stencil_matmat.launches == before + 1
        want = k1.stencil_matmat_reference(X, SCALE, edges, num_segments=segments)
        torch.cuda.synchronize()
        assert float((y - want).abs().max()) <= tol


@pytest.mark.gpu
def test_k3_on_a_frame_matches_plain_on_card(cuda_device):
    """K3 with ``frame=True``: X larger than the block rows (a shard's
    halo-extended frame) read only through the column indices, against
    the plain version on the same frame."""
    rng = np.random.default_rng(3)
    nb, R, bs, k, nb_ext = 40, 3, 8, 48, 44
    cols = torch.from_numpy(np.sort(rng.integers(0, nb_ext, (nb, R)), axis=1)
                            .astype(np.int32)).to(cuda_device)
    blocks = torch.from_numpy(rng.uniform(-1, 1, (nb, R, bs, bs))).to(
        cuda_device, torch.float32)
    X = torch.from_numpy(rng.uniform(-1, 1, (nb_ext * bs, k))).to(
        cuda_device, torch.float32)
    before = kb.bsr_matmat.launches
    y = kb.bsr_matmat(cols, blocks, X, frame=True)
    assert kb.bsr_matmat.launches == before + 1
    assert y.shape == (nb * bs, k)
    want = kb.bsr_matmat_reference(cols, blocks, X)
    torch.cuda.synchronize()
    tol = _bsr_tol(lambda B, Z: kb.bsr_matmat_reference(cols, B, Z),
                   blocks.abs(), X, R * bs)
    assert float((y - want).abs().max()) <= tol
    with pytest.raises(ValueError):
        kb.bsr_matmat(cols, blocks, X)  # not a frame: rows must be nb * bs


@pytest.mark.gpu
def test_sharded_realified_b_and_k3_frame_at_world_size_one(cuda_device):
    """row_mesh(1) on NCCL: realified B (two copies, swapped locally) and
    the embedded complex diagonal against their unsharded products, and
    a sharded BSR apply without a window plan launching K3 on its frame
    (the dry run's tridiagonal)."""
    import torch.distributed as dist

    from lobpcg_tpu_torch import graft_entry, parallel

    mesh = parallel.row_mesh(1)
    try:
        m = 1024
        rng = np.random.default_rng(5)
        d = torch.from_numpy(rng.uniform(1, 2, m)).to(cuda_device, torch.complex64)
        dc = torch.from_numpy(rng.uniform(1, 2, 2 * m) + 1j * rng.uniform(-1, 1, 2 * m)
                              ).to(cuda_device, torch.complex64)
        X = torch.from_numpy(rng.uniform(-1, 1, (4 * m, 8))).to(cuda_device,
                                                               torch.float32)
        for op in (tl.realify_operator(tl.BlockAntiDiagOperator(d)),
                   tl.realify_operator(tl.DiagonalOperator(dc))):
            sop = parallel.shard_operator(op, mesh)
            assert torch.equal(sop.matmat(X), op.matmat(X))
        rec = graft_entry.dryrun_multichip(1)
        assert not rec["bsr_window"] and rec["bsr_max_abs_err"] <= 1e-4
        tri = tl.BSROperator.from_dense(
            np.diag(2.0 * np.ones(16)) - np.diag(np.ones(15), 1)
            - np.diag(np.ones(15), -1), block_size=8, device=cuda_device)
        sop = parallel.ShardedBSROperator.shard(tri, mesh)
        before = kb.bsr_matmat.launches
        y = sop.matmat(X[:16])
        assert kb.bsr_matmat.launches == before + 1
        torch.cuda.synchronize()
        assert float((y - tri.matmat(X[:16])).abs().max()) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gathered_form_and_exchange_swap_at_world_size_one(cuda_device):
    """row_mesh(1) on NCCL: the gathered forms of a BSROperator (the whole
    matrix, and this rank's block rows through K3 on the gathered block)
    and of a CallableOperator, the half swap through the exchange's plan
    (at one rank a local permutation, no message), and the physics pencil
    unrolled onto K1, each equal to the unsharded product."""
    import torch.distributed as dist

    from lobpcg_tpu_torch import parallel
    from lobpcg_tpu_torch.parallel import mesh as pmesh
    from lobpcg_tpu_torch.parallel.sharding import (
        BSRRowPanelOperator,
        GatheredOperator,
    )
    from lobpcg_tpu_torch.physics import bdg

    mesh = parallel.row_mesh(1)
    try:
        n = 1536
        rng = np.random.default_rng(9)
        X = torch.from_numpy(rng.uniform(-1, 1, (n, 16))).to(cuda_device,
                                                            torch.float32)
        tri = tl.BSROperator.from_dense(
            np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
            - np.diag(np.ones(n - 1), -1), block_size=8, device=cuda_device)
        g = GatheredOperator.place(tri, mesh)

        def spmms():
            return kb.bsr_matmat.launches + kb.bsr_window_matmat.launches

        gathers, before = pmesh.all_gather_rows.launches, spmms()
        assert torch.equal(g.matmat(X), tri.matmat(X))
        assert pmesh.all_gather_rows.launches == gathers + 1
        assert spmms() == before + 2  # the gathered apply and the reference
        panel = BSRRowPanelOperator.shard(tri, mesh)
        k3 = kb.bsr_matmat.launches
        y = panel.matmat(X)
        assert kb.bsr_matmat.launches == k3 + 1
        assert torch.equal(y, kb.bsr_matmat(tri.block_cols, tri.blocks, X))
        M = torch.from_numpy(rng.uniform(-1, 1, (n, n))).to(cuda_device,
                                                           torch.float32)
        call = tl.CallableOperator(args=(M,), fn=lambda Y, A: A @ Y, n=n)
        assert isinstance(parallel.shard_operator(call, mesh), GatheredOperator)
        assert torch.equal(parallel.shard_operator(call, mesh).matmat(X),
                           call.matmat(X))
        d = torch.from_numpy(rng.uniform(1, 2, n // 6)).to(cuda_device,
                                                          torch.float32)
        b3 = tl.BlockDiagOperator(tl.BlockAntiDiagOperator(d), copies=3)
        swap = parallel.shard_operator(b3, mesh)
        assert swap.plan.sends == () and swap.plan.recvs == ()
        moved = pmesh.permute_rows.launches
        assert torch.equal(swap.matmat(X), b3.matmat(X))
        assert pmesh.permute_rows.launches == moved
        m = n // 2
        psi = torch.linspace(0, 1, m, device=cuda_device)
        A, _, _, _ = bdg.bdg_operators(tl.Laplacian1D(0.5, m), psi, 2.0, 1.0)
        flat = parallel.shard_operator(A, mesh)
        assert isinstance(flat.left, parallel.SpmdLaplacian1D)
        k1_before = _k1_family()
        y = flat.matmat(X)
        assert _k1_family() == k1_before + 1
        torch.cuda.synchronize()
        assert float((y - A.matmat(X)).abs().max()) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_small_batched_sweep_on_card(cuda_device):
    """lt.batched over 3 barrier heights of a small f32 well through K1:
    each problem equal to its lone solve (eigenvalues bit for bit,
    iterations equal)."""
    m, well, nev, ss, dt = 512, 64, 4, 8, torch.float32
    lo = (m - well) // 2
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def solve(barrier):
        V = torch.full((m,), 1.0 + float(barrier), dtype=dt, device=cuda_device)
        V[lo : lo + well] = 1.0
        A = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt) \
            + tl.DiagonalOperator(torch.cat([V, V]))
        B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=cuda_device))
        T = tl.ChebyshevFilter(op=A, lo=2.0, hi=5.1 + float(barrier), degree=3)
        r = tl.ilobpcg(A, X0, B, T, nev=nev, size_sub=ss, tol=1e-5,
                       max_iter=300, generator=gen)
        return r.eigenvalues, r.converged, r.iterations

    barriers = torch.tensor([1.0, 2.0, 3.0])
    before = _k1_family()
    lam, conv, it = tl.batched(solve, generators=[gen])(barriers)
    assert _k1_family() > before
    assert lam.shape == (3, nev) and lam.device == cuda_device
    assert conv.tolist() == [nev] * 3
    for i in (0, 2):
        gen.manual_seed(0)
        lone = solve(barriers[i])
        assert torch.equal(lam[i], lone[0]) and int(it[i]) == lone[2]


@pytest.mark.gpu
@pytest.mark.parametrize("per_problem_scale", [False, True])
def test_laplacian1d_batched_apply_is_one_k1_launch(cuda_device,
                                                    per_problem_scale):
    """Laplacian1D(segments=2) on X [3, 512, 8] f32: one K1 launch over 6
    segments, equal to the three problems' own applies (a per-problem
    scale multiplies after K1 at scale 1: 2 ulp)."""
    scales = [SCALE, 0.5, 2.0]
    X = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.5, 0.5, (3, 512, 8))).to(cuda_device, torch.float32)
    scale = torch.tensor(scales, device=cuda_device) if per_problem_scale \
        else SCALE
    op = tl.Laplacian1D(scale, 512, segments=2)
    before = k1.stencil_matmat.launches
    Y = op.matmat(X)
    assert k1.stencil_matmat.launches == before + 1
    for i in range(3):
        s = scales[i] if per_problem_scale else SCALE
        want = tl.Laplacian1D(s, 512, segments=2).matmat(X[i])
        tol = 2 * torch.finfo(torch.float32).eps * s * float(X.abs().max())
        assert float((Y[i] - want).abs().max()) <= tol


@pytest.mark.gpu
def test_small_lockstep_sweep_on_card(cuda_device):
    """The small well sweep of test_small_batched_sweep_on_card as one
    lockstep ilobpcg (A = shared stencil + DiagonalOperator [3, n],
    Chebyshev with [3] upper bounds): 4/4 for every barrier, each within
    the solve's tolerance of its lone solve and at most one iteration
    apart (f32, batched GEMMs round otherwise), and K1 launched once per
    batch apply: as the longest problem alone, over the lockstep's
    iterations."""
    m, well, nev, ss, dt = 512, 64, 4, 8, torch.float32
    lo = (m - well) // 2
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
    barriers = (1.0, 2.0, 3.0)
    B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=cuda_device))
    lap = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt)
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=300)

    def diag(barrier):
        V = torch.full((m,), 1.0 + barrier, dtype=dt, device=cuda_device)
        V[lo : lo + well] = 1.0
        return torch.cat([V, V])

    def lone(barrier, it_cap=None):
        A = lap + tl.DiagonalOperator(diag(barrier))
        T = tl.ChebyshevFilter(op=A, lo=2.0, hi=5.1 + barrier, degree=3)
        before = _k1_family()
        r = tl.ilobpcg(A, X0, B, T, config=cfg, it_cap=it_cap,
                       generator=torch.Generator(device=cuda_device).manual_seed(0))
        return r, _k1_family() - before

    A = lap + tl.DiagonalOperator(torch.stack([diag(b) for b in barriers]))
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=torch.tensor(
        [5.1 + b for b in barriers], dtype=torch.float64, device=cuda_device),
        degree=3)
    before = _k1_family()
    out = tl.ilobpcg(A, X0.expand(3, *X0.shape).contiguous(), B, T, config=cfg,
                     generator=torch.Generator(device=cuda_device).manual_seed(0))
    launches = _k1_family() - before
    assert out.converged.tolist() == [nev] * 3
    assert out.eigenvalues.shape == (3, nev) and out.basis.shape == (3, 2 * m, ss)
    for i, b in enumerate(barriers):
        r, _ = lone(b)
        assert abs(int(out.iterations[i]) - r.iterations) <= 1
        assert float(((out.eigenvalues[i] - r.eigenvalues).abs()
                      / r.eigenvalues.abs()).max()) <= cfg.tol
    longest = int(torch.argmax(out.iterations))
    r, total = lone(barriers[longest])
    _, fixed = lone(barriers[longest], it_cap=0)
    per_it = (total - fixed) // r.iterations
    assert launches == fixed + per_it * int(out.iterations.max())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1_000_000, 2 * 500_009])
def test_batched_tall_gram_split_on_card(cuda_device, n):
    """The batched tall Gram V^H U ([4, n, 30] f32, uniform [0, 1)
    entries: sums of n positive terms) against float64, relative to the
    largest entry: within 1e-5 (the solve's tolerance) at n 1,000,000
    (8000-row pieces) and at 2 x 500,009, which has no divisor in
    [1024, 8192] (8192-row pieces and the 594 rows left over).  One
    strided-batched GEMM over all the rows erred by 1.9e-4 at 1M."""
    from lobpcg_tpu_torch.ops import gram

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    V = torch.rand((4, n, 30), generator=gen, device=cuda_device)
    U = torch.rand((4, n, 30), generator=gen, device=cuda_device)
    ref = torch.matmul(V.double().mH, U.double())
    err = float((gram._local_hdot(V, U).double() - ref).abs().max())
    assert err / float(ref.abs().max()) <= 1e-5


# --- the lockstep batch under a row group ----------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 8, 30, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_batched_edges_on_card(cuda_device, k, dtype):
    """K1's batched edge form: X of 4 problems of 1,000 rows (5 segments
    each), edge rows [4, 2, k]: one launch, equal to its plain version
    (once a problem) and to each problem's lone launch with its own edge
    pair, bit for bit."""
    b, n_loc, segs = 4, 1000, 5
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (b * n_loc, k))).to(
        cuda_device, dtype)
    E = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 2, k))).to(cuda_device, dtype)
    before = k1.stencil_matmat.launches
    y = k1.stencil_matmat(X, SCALE, E, num_segments=b * segs)
    assert k1.stencil_matmat.launches == before + 1
    want = k1.stencil_matmat_reference(X, SCALE, E, num_segments=b * segs)
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    for i in range(b):
        rows = slice(i * n_loc, (i + 1) * n_loc)
        lone = k1.stencil_matmat(X[rows].contiguous(), SCALE, E[i].contiguous(),
                                 num_segments=segs)
        assert torch.equal(y[rows], lone), i


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["band4", "ragged264"])
@pytest.mark.parametrize("k", [5, 16, 32, 130])
def test_k6_batched_launch_on_card(cuda_device, case, k):
    """K6 over a batch of 3 problems on one interior shard, each problem's
    halos cut from its own global X: one launch, each problem equal to its
    lone launch bit for bit, and within tolerance of the plain version."""
    bs, hrows, n_loc, W, shards, n = _k6_shards(case)
    d = 1
    lo, wv = (torch.from_numpy(a).to(cuda_device) for a in shards[d])
    Xg = torch.stack([_offset_X(n, k, 0, k + s, cuda_device) for s in range(3)])
    xs = Xg[:, d * n_loc : (d + 1) * n_loc].contiguous()
    up = Xg[:, d * n_loc - hrows : d * n_loc]
    dn = Xg[:, (d + 1) * n_loc : (d + 1) * n_loc + hrows]
    top = torch.cat([up, xs[:, :W]], dim=1)
    bot = torch.cat([xs[:, -W:], dn], dim=1)
    before = kb.bsr_window_matmat_edges.launches
    y = kb.bsr_window_matmat_edges(lo, wv, xs, top, bot, bs=bs, hrows=hrows)
    assert kb.bsr_window_matmat_edges.launches == before + 1
    assert y.shape == (3, n_loc, k)
    want = kb.bsr_window_matmat_edges_reference(lo, wv, xs, top, bot, bs=bs,
                                                hrows=hrows)
    for i in range(3):
        lone = kb.bsr_window_matmat_edges(lo, wv, xs[i], top[i].contiguous(),
                                          bot[i].contiguous(), bs=bs,
                                          hrows=hrows)
        torch.cuda.synchronize()
        assert torch.equal(y[i], lone), i
        tol = _bsr_tol(lambda V, Z: kb.bsr_window_matmat_reference(
            lo, V, torch.cat([up[i].abs(), Z, dn[i].abs()]), bs=bs,
            out_rows=n_loc), wv.abs(), xs[i], W)
        assert float((y[i] - want[i]).abs().max()) <= tol


@pytest.mark.gpu
def test_sharded_lockstep_at_world_size_one_on_card(cuda_device):
    """row_mesh(1) on NCCL: the small well sweep as one lockstep ilobpcg
    through shard_problem (X0 [3, n, 8], DiagonalOperator [3, n],
    Chebyshev [3]) takes the unsharded lockstep trajectory bit for bit
    (eigenvalues, iterations, K1 launches), and a sharded band applied to
    a batch launches K6 once, each problem its lone apply's bits."""
    import torch.distributed as dist

    from lobpcg_tpu_torch import parallel

    m, well, nev, ss, dt = 512, 64, 4, 8, torch.float32
    lo = (m - well) // 2
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
    X0 = X0.expand(3, *X0.shape).contiguous()
    B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=cuda_device))
    Vs = []
    for barrier in (1.0, 2.0, 3.0):
        V = torch.full((m,), 1.0 + barrier, dtype=dt, device=cuda_device)
        V[lo : lo + well] = 1.0
        Vs.append(torch.cat([V, V]))
    A = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt) \
        + tl.DiagonalOperator(torch.stack(Vs))
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=torch.tensor(
        [6.1, 7.1, 8.1], dtype=torch.float64, device=cuda_device), degree=3)
    cfg = tl.SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=300)

    def run(A, X0, B, T):
        before = _k1_family()
        r = tl.ilobpcg(A, X0, B, T, config=cfg,
                       generator=torch.Generator(device=cuda_device).manual_seed(0))
        return r, _k1_family() - before

    whole, whole_k1 = run(A, X0, B, T)
    mesh = parallel.row_mesh(1)
    try:
        As, X0s, Bs, Ts = parallel.shard_problem(mesh, A, X0, B, T)
        with mesh:
            r, k1_launches = run(As, X0s, Bs, Ts)
        assert r.converged.tolist() == [nev] * 3
        assert torch.equal(r.eigenvalues, whole.eigenvalues)
        assert r.iterations.tolist() == whole.iterations.tolist()
        assert k1_launches == whole_k1

        n, k = 4096, 16
        op = tl.BSROperator.from_dense(_banded(n, 24, 5), block_size=8,
                                       device=cuda_device)
        sop = parallel.ShardedBSROperator.shard(op, mesh)
        X = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (3, n, k))
                             ).to(cuda_device, torch.float32)
        before = kb.bsr_window_matmat_edges.launches
        y = sop.matmat(X)
        assert kb.bsr_window_matmat_edges.launches == before + 1
        for i in range(3):
            assert torch.equal(y[i], sop.matmat(X[i]))
    finally:
        dist.destroy_process_group()


# --- K1's fused forms: the BdG operator's apply and the Chebyshev step -------

# Widths 1-320: whole 16-byte vectors or not, the flagship's 64 and its
# Chebyshev chunk 16, the sweeps' 30, the 1M x 150 solve's 164, the
# gates' 320.
FUSED_WIDTHS = [1, 2, 3, 6, 8, 16, 30, 33, 64, 129, 164, 320]


class _ChainDiagonal(tl.DiagonalOperator):
    """A DiagonalOperator that the fused route does not take (it reports
    no row scales): trees holding it run the eager chain of operations
    that the fused kernels replace."""

    def row_scales(self):
        return None


def _well_diag(rng, rows, dtype, device, shape=None):
    return torch.from_numpy(rng.uniform(1.0, 3.0, shape or rows)).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("k", FUSED_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sliced", [False, True])
def test_stencil_diag_is_the_chain_on_card(cuda_device, k, dtype, sliced):
    """Laplacian1D + DiagonalOperator: one stencil_diag launch, no K1,
    equal (torch.equal) to the eager chain (K1, the multiply, the add) and
    to its plain version, on an aligned X and on a row slice X[1:]."""
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (513, k))).to(cuda_device, dtype)
    X = X[1:] if sliced else X[:512]
    d = _well_diag(rng, 512, dtype, cuda_device)
    lap = tl.Laplacian1D(SCALE, 512, segments=2)
    A, chain = lap + tl.DiagonalOperator(d), lap + _ChainDiagonal(d)
    before = (k1.stencil_diag.launches, k1.stencil_matmat.launches)
    Y = A.matmat(X)
    assert (k1.stencil_diag.launches, k1.stencil_matmat.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(Y, chain.matmat(X))
    assert torch.equal(Y, k1.stencil_diag_reference(X, SCALE, d, num_segments=2))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 30, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["per_problem", "shared_diag", "scaled"])
def test_stencil_diag_batched_is_the_chain_on_card(cuda_device, k, dtype, form):
    """A batch [3, 256, k]: per-problem scales [3] and diagonals [3, n],
    one diagonal for all, or a ScaledOperator by a number; one launch,
    each the chain's bits."""
    rng = np.random.default_rng(100 + k)
    b, n = 3, 256
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, n, k))).to(cuda_device, dtype)
    if form == "per_problem":
        lap = tl.Laplacian1D(torch.tensor([SCALE, 0.7, 2.1], dtype=torch.float64,
                                          device=cuda_device), n, segments=2)
        d = _well_diag(rng, n, dtype, cuda_device, (b, n))
    else:
        lap = tl.Laplacian1D(SCALE, n, segments=4)
        if form == "scaled":
            lap = tl.ScaledOperator(lap, 0.37)
        d = _well_diag(rng, n, dtype, cuda_device)
    A, chain = lap + tl.DiagonalOperator(d), lap + _ChainDiagonal(d)
    before = k1.stencil_diag.launches
    Y = A.matmat(X)
    assert k1.stencil_diag.launches == before + 1
    assert torch.equal(Y, chain.matmat(X))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 8, 30, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_edge_rows_on_card(cuda_device, k, dtype):
    """Batched edge rows [3, 2, k] (a sharded lockstep batch's halos) with
    per-problem coefficients: stencil_diag and every kind of Chebyshev
    step (first with a number and with per-problem theta, middle, last)
    equal to their plain versions, bit for bit; stencil_diag also to the
    chain through K1 with the same edge rows."""
    rng = np.random.default_rng(7 + k)
    b, n, segs = 3, 128, 6
    def block():
        return torch.from_numpy(rng.uniform(-0.5, 0.5, (b * n, k))).to(
            cuda_device, dtype)
    X, y, dd = block(), block(), block()
    E = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, 2, k))).to(cuda_device, dtype)
    diag = _well_diag(rng, n, dtype, cuda_device, (b, n))
    post = torch.tensor([1.5, 0.25, 3.0], device=cuda_device).to(dtype)
    args = dict(num_segments=segs, post=post, problems=b)
    Y = k1.stencil_diag(X, 1.0, diag, E, **args)
    assert torch.equal(Y, k1.stencil_diag_reference(X, 1.0, diag, E, **args))
    chain = (k1.stencil_matmat(X, 1.0, E, num_segments=segs).view(b, n, k)
             * post[:, None, None] + diag.unsqueeze(-1) * X.view(b, n, k))
    assert torch.equal(Y, chain.view(b * n, k))
    c1 = torch.tensor([0.3, 0.6, 0.9], device=cuda_device).to(dtype).view(b, 1, 1)
    c2 = torch.tensor([0.11, 0.05, 0.2], device=cuda_device).to(dtype).view(b, 1, 1)
    theta = torch.tensor([3.5, 4.0, 4.75], device=cuda_device).to(dtype).view(b, 1, 1)
    cases = [dict(y=None, d=None, theta=4.05, last=False),
             dict(y=None, d=None, theta=theta, last=True),
             dict(y=y, d=dd, theta=None, last=False),
             dict(y=y, d=dd, theta=None, last=True)]
    for case in cases:
        got = k1.cheb_step(X, case["y"], case["d"], SCALE, diag, c1, c2, E,
                           theta=case["theta"], last=case["last"], **args)
        want = k1.cheb_step_reference(X, case["y"], case["d"], SCALE, diag, c1,
                                      c2, E, theta=case["theta"],
                                      last=case["last"], **args)
        assert torch.equal(got[0], want[0]), case
        assert (got[1] is None) == case["last"]
        assert case["last"] or torch.equal(got[1], want[1]), case


@pytest.mark.gpu
@pytest.mark.parametrize("k", FUSED_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("degree", [2, 3, 5])
def test_chebyshev_filter_is_the_chain_on_card(cuda_device, k, dtype, degree):
    """ChebyshevFilter on Laplacian1D + DiagonalOperator: degree - 1
    cheb_step launches and nothing of K1, the chain's bits, on a row
    slice X[1:]."""
    rng = np.random.default_rng(200 + k)
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (513, k))).to(cuda_device, dtype)[1:]
    d = _well_diag(rng, 512, dtype, cuda_device)
    lap = tl.Laplacian1D(1.0, 512, segments=2)
    T = tl.ChebyshevFilter(lap + tl.DiagonalOperator(d), 2.0, 6.1, degree=degree)
    chain = tl.ChebyshevFilter(lap + _ChainDiagonal(d), 2.0, 6.1, degree=degree)
    before = (k1.cheb_step.launches, k1.stencil_matmat.launches)
    Y = T.matmat(X)
    assert (k1.cheb_step.launches, k1.stencil_matmat.launches) == (
        before[0] + degree - 1, before[1])
    assert torch.equal(Y, chain.matmat(X))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, 30, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [0, 8])
def test_chebyshev_filter_batched_is_the_chain_on_card(cuda_device, k, dtype,
                                                       chunk):
    """A lockstep batch [3, 256, k]: per-problem diagonals and upper bounds
    [3] (the recurrence's coefficients one a problem), whole or in column
    chunks: the chain's bits."""
    rng = np.random.default_rng(300 + k)
    b, n = 3, 256
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, n, k))).to(cuda_device, dtype)
    d = _well_diag(rng, n, dtype, cuda_device, (b, n))
    lap = tl.Laplacian1D(1.0, n, segments=2)
    hi = torch.tensor([6.1, 7.1, 9.1], dtype=torch.float64, device=cuda_device)
    T = tl.ChebyshevFilter(lap + tl.DiagonalOperator(d), 2.0, hi, degree=3,
                           chunk=chunk)
    chain = tl.ChebyshevFilter(lap + _ChainDiagonal(d), 2.0, hi, degree=3,
                               chunk=chunk)
    before = k1.cheb_step.launches
    Y = T.matmat(X)
    pieces = k // chunk if chunk and chunk < k and k % chunk == 0 else 1
    assert k1.cheb_step.launches == before + 2 * pieces
    assert torch.equal(Y, chain.matmat(X))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_carry_nonfinite_like_the_chain_on_card(cuda_device,
                                                              dtype):
    """NaN and +-Inf in X: the fused apply and filter put NaN and Inf
    where the chain does, and equal its finite values."""
    rng = np.random.default_rng(5)
    n, k = 512, 30
    X = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, k))).to(cuda_device, dtype)
    X[7, 3], X[100, 0], X[255, 29], X[256, 5] = (float("nan"), float("inf"),
                                                 -float("inf"), float("nan"))
    d = _well_diag(rng, n, dtype, cuda_device)
    lap = tl.Laplacian1D(1.0, n, segments=2)
    A, chain = lap + tl.DiagonalOperator(d), lap + _ChainDiagonal(d)
    pairs = [(A.matmat(X), chain.matmat(X)),
             (tl.ChebyshevFilter(A, 2.0, 6.1, degree=3).matmat(X),
              tl.ChebyshevFilter(chain, 2.0, 6.1, degree=3).matmat(X))]
    for got, want in pairs:
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        assert bool(torch.isnan(want).any())
        assert torch.equal(got[fin], want[fin])


@pytest.mark.gpu
def test_fused_kernels_reject_what_they_do_not_take(cuda_device):
    X = torch.zeros((64, 8), device=cuda_device)
    d = torch.ones(64, device=cuda_device)
    with pytest.raises(TypeError):
        k1.stencil_diag(X.double(), 1.0, d.double())
    with pytest.raises(TypeError):
        k1.stencil_diag(X, 1.0, d.double())  # diag of another dtype
    with pytest.raises(ValueError):
        k1.stencil_diag(X[:, ::2], 1.0, d)  # not contiguous
    with pytest.raises(ValueError):
        k1.cheb_step(X, X, None, 1.0, d, 0.5, 0.5)  # y without d
    # f64 and a realified (two-diagonal) tree keep the chain.
    op = tl.Laplacian1D(1.0, 64) + tl.DiagonalOperator(d.double())
    before = k1.stencil_diag.launches
    op.matmat(X.double())
    assert k1.stencil_diag.launches == before


def _small_well(device, barriers):
    """The small f32 well of test_small_bdg_solve_runs_through_the_kernel
    over ``barriers`` (one: A, T unbatched; several: a lockstep batch)."""
    m, well, ss, dt = 512, 64, 8, torch.float32
    lo = (m - well) // 2
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, ss))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=device)
    Vs = []
    for barrier in barriers:
        V = torch.full((m,), 1.0 + barrier, dtype=dt, device=device)
        V[lo : lo + well] = 1.0
        Vs.append(torch.cat([V, V]))
    d = Vs[0] if len(barriers) == 1 else torch.stack(Vs)
    hi = 5.1 + barriers[0] if len(barriers) == 1 else torch.tensor(
        [5.1 + b for b in barriers], dtype=torch.float64, device=device)
    if len(barriers) > 1:
        X0 = X0.expand(len(barriers), *X0.shape).contiguous()
    B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=device))
    lap = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt)
    return lap, d, hi, B, X0


@pytest.mark.gpu
@pytest.mark.parametrize("barriers", [(1.0,), (1.0, 2.0, 3.0)])
def test_small_solves_through_fused_kernels_are_the_chain_on_card(
        cuda_device, barriers):
    """The small BdG well, alone and as a lockstep batch of 3 barriers,
    through the fused kernels and through the eager chain: equal
    eigenvalues (torch.equal) and iterations, and as many launches of
    the K1 family as the chain launched K1."""
    lap, d, hi, B, X0 = _small_well(cuda_device, barriers)
    cfg = tl.SolverConfig(nev=4, size_sub=8, tol=1e-5, max_iter=300)
    out = []
    for diag in (tl.DiagonalOperator(d), _ChainDiagonal(d)):
        A = lap + diag
        T = tl.ChebyshevFilter(op=A, lo=2.0, hi=hi, degree=3)
        before = (_k1_family(), k1.stencil_matmat.launches)
        r = tl.ilobpcg(A, X0, B, T, config=cfg,
                       generator=torch.Generator(device=cuda_device).manual_seed(0))
        out.append((r, _k1_family() - before[0],
                    k1.stencil_matmat.launches - before[1]))
    (fused, fused_family, fused_k1), (chain, chain_family, chain_k1) = out
    assert torch.equal(fused.eigenvalues, chain.eigenvalues)
    assert torch.as_tensor(fused.iterations).tolist() == \
        torch.as_tensor(chain.iterations).tolist()
    assert fused_k1 == 0 and fused_family == chain_family == chain_k1 > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pytorch_scalar_rules_the_fused_kernels_follow_on_card(cuda_device,
                                                                dtype):
    """The rules by which PyTorch's CUDA ops take a Python number, which
    the fused kernels' coefficients follow (ops/cuda/stencil.py:
    host_scalar, host_reciprocal), over 48 values: X * c computes with
    f32(c) in f32 and bf16 alike, and X / c multiplies by f32(1 / c), the
    reciprocal taken in float64 (at 4.05, the flagship's theta, neither
    the f32 reciprocal of f32(c) nor a true division gives its bits)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    X = ((torch.rand(1 << 18, generator=gen, device=cuda_device) * 8 - 4)
         .to(dtype))
    xf = X.float()
    values = [4.05, 0.3717, 1 / 3, 0.123456789, 3.55, 5.05, 4.75, 7.3] + list(
        np.random.RandomState(1).uniform(0.1, 10, 40))
    for c in map(float, values):
        assert torch.equal(X * c, (xf * k1.host_scalar(c)).to(dtype)), c
        assert torch.equal(c * X, (xf * k1.host_scalar(c)).to(dtype)), c
        assert torch.equal(X / c, (xf * k1.host_reciprocal(c)).to(dtype)), c
    if dtype == torch.float32:
        c = 4.05
        f32_recip = float(np.float32(1.0) / np.float32(c))
        assert not torch.equal(X / c, xf * f32_recip)
        assert not torch.equal(X / c, xf / float(np.float32(c)))


# --- the solver's tall tail (csrc/tail.cu) -------------------------------------

from lobpcg_tpu_torch.ops import gram as _gram  # noqa: E402
from lobpcg_tpu_torch.ops import masking as _masking  # noqa: E402
from lobpcg_tpu_torch.ops import residual as _residual  # noqa: E402
from lobpcg_tpu_torch.ops.cuda import tail  # noqa: E402

# Widths of the tail's blocks: whole 16-byte vectors or not, the lockstep
# 30, the flagship 64, the 1M x 150 solve's 164, the complex gate's 320.
TAIL_WIDTHS = [1, 2, 3, 7, 16, 30, 33, 64, 164, 320]


def _same_bits(a, b) -> bool:
    """Equal shape and dtype, NaN where NaN, every other bit equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a.contiguous().view(ints)[~nan],
                       b.contiguous().view(ints)[~nan])


def _tail_block(device, shape, dtype, seed=0, special=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = (torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
         * 2 - 1).to(dtype)
    if special:
        pick = torch.rand(shape, generator=gen, device=device) < 0.1
        vals = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0], dtype=dtype, device=device)
        idx = torch.randint(0, 5, shape, generator=gen, device=device)
        X = torch.where(pick, vals[idx], X)
    return X


def _launched(fn, wrapper):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k", TAIL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["plain", "copies2", "batched", "per_row",
                                  "col_slice", "row_slice"])
def test_tail_antidiag_on_card(cuda_device, k, dtype, form):
    """antidiag launched once, bit for bit its plain version and the
    operators' eager chain: one and two copies, a batch with per-problem
    d, the sharded form's per-row scales, a column slice of a wider
    block, a row slice X[1:]; NaN, +-Inf and -0 among the inputs."""
    m = 1000
    b = 3 if form == "batched" else None
    lead = () if b is None else (b,)
    copies = 2 if form == "copies2" else 1
    n = 2 * copies * m
    X = _tail_block(cuda_device, lead + (n + (form == "row_slice"),
                                         k + 5 if form == "col_slice" else k),
                    dtype, 1, special=True)
    if form == "col_slice":
        X = X[..., 2:2 + k]
    if form == "row_slice":
        X = X[1:]
    if form == "per_row":
        d = _tail_block(cuda_device, (n,), dtype, 2, special=True)
        chain = d[..., None] * torch.cat([X[m:], X[:m]])
    else:
        d = _tail_block(cuda_device, lead + (m,), dtype, 2, special=True)
        B = tl.BlockAntiDiagOperator(d=d)
        if copies == 2:
            B = tl.BlockDiagOperator(B, 2)
        with tail.eager_chain():
            chain = B.matmat(X)
    got = _launched(lambda: tail.antidiag(X, d, copies), tail.antidiag)
    assert _same_bits(got, tail.antidiag_reference(X, d, copies))
    assert _same_bits(got, chain)


@pytest.mark.gpu
@pytest.mark.parametrize("k", TAIL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b_kind", ["antidiag", "copies2", "none", "bx",
                                    "batched", "col_slice", "row_slice"])
def test_tail_residual_on_card(cuda_device, k, dtype, b_kind):
    """residual launched once, bit for bit its plain version and
    get_residual's eager chain: B anti-diagonal (one and two copies,
    per-problem d and lam), B None, a given BX, column slices of wider
    blocks (W[..., :nev]), row slices; lam in f64, cast as the chain
    casts it; NaN, +-Inf and -0 among the inputs."""
    m = 1000
    b = 3 if b_kind == "batched" else None
    lead = () if b is None else (b,)
    copies = 2 if b_kind == "copies2" else 1
    n = 2 * copies * m
    wide = k + 3 if b_kind == "col_slice" else k
    tall = n + (b_kind == "row_slice")
    X = _tail_block(cuda_device, lead + (tall, wide), dtype, 3, special=True)
    AX = _tail_block(cuda_device, lead + (tall, wide), dtype, 4, special=True)
    if b_kind == "col_slice":
        X, AX = X[..., :k], AX[..., 1:1 + k]
    if b_kind == "row_slice":
        X, AX = X[1:], AX[:-1]
    lam = _tail_block(cuda_device, lead + (k,), torch.float64, 5, special=True) * 40
    d = _tail_block(cuda_device, lead + (m,), dtype, 6, special=True)
    B = None
    if b_kind in ("antidiag", "batched", "col_slice", "row_slice"):
        B = tl.BlockAntiDiagOperator(d=d)
    elif b_kind == "copies2":
        B = tl.BlockDiagOperator(tl.BlockAntiDiagOperator(d=d), 2)
    BX = _tail_block(cuda_device, lead + (n, k), dtype, 7, special=True) \
        if b_kind == "bx" else None
    with tail.eager_chain():
        chain = _residual.get_residual(X, AX, lam, None, B, BX)
    got = _launched(lambda: _residual.get_residual(X, AX, lam, None, B, BX),
                    tail.residual)
    plain = tail.residual_reference(AX, X, lam, d if B is not None else None,
                                    BX, copies)
    assert _same_bits(got, plain)
    assert _same_bits(got, chain)


@pytest.mark.gpu
@pytest.mark.parametrize("k", TAIL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nterms", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["sum", "update", "update_lanes",
                                  "update_mask"])
def test_tail_combine_on_card(cuda_device, k, dtype, nterms, form):
    """combine launched once, bit for bit its plain version: the sum of
    1-4 terms left to right, and live * (U - sum) with a count, [b]
    counts or a boolean mask; the output written over terms[0]; NaN,
    +-Inf and -0 among the inputs."""
    if form == "sum" and nterms == 1:
        pytest.skip("one term and no U: b_mm returns the term, no pass")
    b = 2 if form == "update_lanes" else None
    lead = () if b is None else (b,)
    n = 3001
    terms = [_tail_block(cuda_device, lead + (n, k), dtype, 10 + i, special=True)
             for i in range(nterms)]
    U = None if form == "sum" else _tail_block(cuda_device, lead + (n, k),
                                               dtype, 20, special=True)
    live = {"sum": None, "update": max(k - 2, 0),
            "update_lanes": torch.tensor([k, k // 2], device=cuda_device),
            "update_mask": torch.arange(k, device=cuda_device) % 3 != 1}[form]
    plain = tail.combine_reference(terms, U, live)
    scratch = terms[0].clone()
    got = _launched(lambda: tail.combine([scratch] + terms[1:], U, live,
                                         out=scratch), tail.combine)
    assert got.data_ptr() == scratch.data_ptr()
    assert _same_bits(got, plain)
    fresh = _launched(lambda: tail.combine(terms, U, live), tail.combine)
    assert _same_bits(fresh, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("k", TAIL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["mask_count", "mask_bool", "shift",
                                  "shift_big", "lanes", "col_slice",
                                  "row_slice"])
def test_tail_compact_on_card(cuda_device, k, dtype, case):
    """compact launched once, bit for bit its plain version and
    masking's eager chain: the mask alone (a count, a boolean mask),
    Python shifts (past the last column too), [b] shifts and counts, a
    column slice, a row slice; a dead NaN/Inf column gives NaN, a
    negative value -0."""
    b = 3 if case == "lanes" else None
    lead = () if b is None else (b,)
    U = _tail_block(cuda_device, lead + (2001, k + 4 if case == "col_slice"
                                         else k), dtype, 30, special=True)
    if case == "col_slice":
        U = U[..., 1:1 + k]
    if case == "row_slice":
        U = U[1:]
    shift, live = {
        "mask_count": (0, k // 2),
        "mask_bool": (0, torch.arange(k, device=cuda_device) % 2 == 0),
        "shift": (min(3, k - 1), k - min(3, k - 1)),
        "shift_big": (k + 2, k),
        "lanes": (torch.tensor([0, 1, k + 1], device=cuda_device),
                  torch.tensor([k, k - 1, 0], device=cuda_device)),
        "col_slice": (1, k - 1),
        "row_slice": (0, k - 1),
    }[case]
    with tail.eager_chain():
        chain = _masking.shift_cols(U, shift, live)
    got = _launched(lambda: _masking.shift_cols(U, shift, live), tail.compact)
    assert _same_bits(got, tail.compact_reference(U, shift, live))
    assert _same_bits(got, chain)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 30, 64, 164])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tail_compact_over_its_input_on_card(cuda_device, k, dtype):
    """The mask written over its own input (out=U, the SVQB pass's
    scratch) equals the plain version bit for bit; a shifted compact
    refuses to write over U."""
    U = _tail_block(cuda_device, (3001, k), dtype, 50, special=True)
    want = tail.compact_reference(U, 0, k // 2)
    got = _launched(lambda: tail.compact(U, 0, k // 2, out=U), tail.compact)
    assert got.data_ptr() == U.data_ptr() and _same_bits(got, want)
    with pytest.raises(ValueError):
        tail.compact(U, 1, k, out=U)


@pytest.mark.gpu
def test_tail_b_mm_and_update_are_the_chain_on_card(cuda_device):
    """b_mm of 3 and 5 blocks and the projection update of 2, through the
    GEMMs and combine, against the eager chain, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    blocks = [torch.rand((40_000, 64), generator=gen, device=cuda_device) - 0.5
              for _ in range(5)]
    C = torch.rand((320, 64), generator=gen, device=cuda_device) - 0.5
    U = torch.rand((40_000, 64), generator=gen, device=cuda_device) - 0.5
    for nb in (3, 5):
        with tail.eager_chain():
            chain = _gram.b_mm(blocks[:nb], C[: 64 * nb])
        assert _same_bits(_gram.b_mm(blocks[:nb], C[: 64 * nb]), chain)
    with tail.eager_chain():
        chain = _gram.b_mm_update(U, blocks[:2], C[:128], 50)
    before = tail.combine.launches
    got = _gram.b_mm_update(U, blocks[:2], C[:128], 50)
    assert tail.combine.launches == before + 1
    assert _same_bits(got, chain)


@pytest.mark.gpu
def test_tail_routes_by_dtype_on_card(cuda_device):
    """Complex blocks and mixed dtypes run the plain version (no launch);
    shapes the kernels do not take raise."""
    X = torch.ones((64, 8), dtype=torch.complex64, device=cuda_device)
    d = torch.ones(32, dtype=torch.complex64, device=cuda_device)
    counts = [tail.antidiag.launches, tail.compact.launches]
    assert torch.equal(tail.antidiag(X, d), tail.antidiag_reference(X, d))
    tail.compact(X, 1, 3)
    tail.antidiag(X.real.contiguous(), d.real.double())  # mixed: plain
    assert [tail.antidiag.launches, tail.compact.launches] == counts
    Xr = torch.ones((64, 8), device=cuda_device)
    with pytest.raises(ValueError):
        tail.antidiag(Xr, torch.ones(33, device=cuda_device))
    with pytest.raises(ValueError):
        tail.combine([Xr] * 5)
    with pytest.raises(ValueError):
        tail.combine([Xr, Xr], out=torch.ones((64, 9), device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("barriers", [(1.0,), (1.0, 2.0, 3.0)])
def test_small_solves_through_tail_kernels_are_the_chain_on_card(
        cuda_device, barriers):
    """The small BdG well, alone and as a lockstep batch of 3 barriers,
    through the tail kernels and through the eager tail
    (tail.eager_chain()): equal eigenvalues and eigenvectors (torch.equal)
    and iterations; each of the four kernels launched."""
    lap, d, hi, B, X0 = _small_well(cuda_device, barriers)
    cfg = tl.SolverConfig(nev=4, size_sub=8, tol=1e-5, max_iter=300)
    A = lap + tl.DiagonalOperator(d)
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=hi, degree=3)
    names = ("antidiag", "residual", "combine", "compact")

    def solve():
        before = [getattr(tail, f).launches for f in names]
        r = tl.ilobpcg(A, X0, B, T, config=cfg,
                       generator=torch.Generator(device=cuda_device).manual_seed(0))
        return r, [getattr(tail, f).launches - b for f, b in zip(names, before)]

    got, launched = solve()
    with tail.eager_chain():
        chain, chain_launched = solve()
    assert torch.equal(got.eigenvalues, chain.eigenvalues)
    assert torch.equal(got.eigenvectors, chain.eigenvectors)
    assert torch.as_tensor(got.iterations).tolist() == \
        torch.as_tensor(chain.iterations).tolist()
    assert min(launched) > 0 and chain_launched == [0, 0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_abs2_is_abs_squared_on_card(cuda_device, dtype):
    """x ** 2 (ops/gram.py: abs2, real blocks) is abs(x) ** 2 on the card
    at [4M, 64], NaN, +-Inf and -0 among the values: elementwise, summed
    over rows (col_norms) and over the block (tall_frob_norm)."""
    X = _tail_block(cuda_device, (4_000_000, 64), dtype, 40, special=True)
    X[:1000] = _tail_block(cuda_device, (1000, 64), dtype, 41)  # finite rows
    old = torch.abs(X) ** 2
    assert _same_bits(_gram.abs2(X), old)
    assert _same_bits(torch.sum(_gram.abs2(X[:, :8]), dim=-2),
                      torch.sum(old[:, :8], dim=-2))
    assert _same_bits(torch.sum(_gram.abs2(X[:1000]), dim=-2),
                      torch.sum(old[:1000], dim=-2))
    assert _same_bits(_residual.col_norms(X), torch.sqrt(torch.sum(old, dim=-2)))
    assert _same_bits(_gram.tall_frob_norm(X[:1000]),
                      torch.sqrt(torch.sum(old[:1000], dim=(-2, -1))))


# --- Spans (utils/profiling.py) on the device trace's clock -------------------

import json  # noqa: E402

from lobpcg_tpu_torch.utils import profiling  # noqa: E402

# Host calls that wait for the device: the reads' stream synchronisation,
# and any synchronous copy or device-wide wait.
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize")
_PHASE_PREFIXES = ("lobpcg.apply.", "lobpcg.ortho", "lobpcg.rr",
                   "lobpcg.update")


def _innermost_at(spans, t):
    """The innermost of the (start, end, name) spans open at t."""
    open_ = [s for s in spans if s[0] <= t < s[1]]
    return min(open_, key=lambda s: s[1] - s[0]) if open_ else None


@pytest.mark.gpu
def test_spans_mark_every_sync_of_a_solve_on_card(cuda_device, tmp_path):
    """A small BdG well solve traced on the card: every blocking host
    call inside lobpcg.solve lies in a lobpcg.sync.* span and every span
    holds one, so the spans count the points where the host waits (an
    eigh of one matrix waits twice: cuSOLVER's own synchronisation and
    torch's read of its status); the device runs each stream's operations
    in the order of the launch calls the trace matches them to; the work
    launched outside every phase is at most 2% of the device's busy
    time."""
    m, well, dt = 100_000, 1024, torch.float32
    lo = (m - well) // 2
    V = np.full(m, 2.0)
    V[lo : lo + well] = 1.0
    Vd = torch.as_tensor(np.concatenate([V, V]), dtype=dt, device=cuda_device)
    A = tl.Laplacian1D(scale=1.0, n=2 * m, segments=2, dtype=dt) \
        + tl.DiagonalOperator(Vd)
    B = tl.BlockAntiDiagOperator(d=torch.ones(m, dtype=dt, device=cuda_device))
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=6.1, degree=3)
    u = np.zeros((m, 24), np.float32)
    u[lo : lo + well] = np.random.RandomState(42).uniform(-0.5, 0.5, (well, 24))
    X0 = torch.as_tensor(np.concatenate([u, u]), device=cuda_device)
    cfg = tl.SolverConfig(nev=16, size_sub=24, tol=1e-5, max_iter=300)

    def solve():
        return tl.ilobpcg(A, X0, B, T, config=cfg, generator=torch.Generator(
            device=cuda_device).manual_seed(0))

    solve()  # kernels built, library handles made
    with profiling.trace(tmp_path):
        r = solve()
    assert r.converged == 16
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("ph") == "X"]

    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]

    solve_ev = next(e for e in events if e["name"] == profiling.SOLVE)
    tid = solve_ev["tid"]
    s0, s1, _ = iv(solve_ev)
    host = [e for e in events if e.get("tid") == tid]
    ours = [iv(e) for e in host if e.get("cat") in ("user_annotation", "cpu_op")
            and e["name"].startswith("lobpcg.")]
    syncs = [s for s in ours if s[2].startswith("lobpcg.sync.")]
    phases = [s for s in ours if s[2].startswith(_PHASE_PREFIXES)]
    blocking = [iv(e) for e in host if e.get("cat") in ("cuda_runtime",
                                                        "cuda_driver")
                and e["name"] in BLOCKING and s0 <= float(e["ts"]) < s1]
    outside = [b for b in blocking
               if not any(s[0] <= b[0] and b[1] <= s[1] for s in syncs)]
    assert blocking and outside == [], outside[:5]
    empty = [s for s in syncs
             if not any(s[0] <= b[0] and b[1] <= s[1] for b in blocking)]
    assert syncs and empty == [], empty[:5]

    launches = {e["args"]["correlation"]: float(e["ts"]) for e in host
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                     "gpu_memset")]
    ours_dev = [e for e in device
                if s0 <= launches.get(e["args"]["correlation"], -1.0) < s1]
    assert ours_dev
    # Each device operation is matched to its launch call by correlation:
    # on each stream the operations run in the order of their launches.
    # (The device's times are not compared with the host's: the profiler
    # may place them milliseconds apart, by an amount that moves.)
    for stream in {e["args"].get("stream") for e in ours_dev}:
        starts = [float(e["ts"]) for e in sorted(
            (e for e in ours_dev if e["args"].get("stream") == stream),
            key=lambda e: launches[e["args"]["correlation"]])]
        assert starts == sorted(starts), stream
    busy = sum(float(e["dur"]) for e in ours_dev)
    unphased = sum(float(e["dur"]) for e in ours_dev if _innermost_at(
        phases, launches[e["args"]["correlation"]]) is None)
    assert unphased <= 0.02 * busy, (unphased, busy)


# --- the tall Gram (csrc/gram.cu) ----------------------------------------------


def _gram_operands(n, kv, ku, dist, sliced, device, seed):
    """V [n, kv] and U [n, ku] on the card, uniform [0, 1) (sums of n
    positive terms) or standard normal; ``sliced``: V a column slice of a
    wider block (row stride kv + 8, 16 bytes past the row's start)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand if dist == "uniform" else torch.randn
    V = draw((n, kv + 8 if sliced else kv), generator=gen, device=device)
    if sliced:
        V = V[:, 4:4 + kv]
    return V, draw((n, ku), generator=gen, device=device)


def _gram_errors(V, U):
    """The kernel's and torch.matmul's largest error against the float64
    product, relative to its largest entry."""
    from lobpcg_tpu_torch.ops.gram import precision_ctx

    with precision_ctx("highest"):  # TF32 off for the yardstick too
        want = torch.matmul(V.double().mT, U.double())
        lib = torch.matmul(V.mT, U)
        before = kg.tall_gram.launches
        got = kg.tall_gram(V, U)
        assert kg.tall_gram.launches == before + 1
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    return (float((got.double() - want).abs().max()) / scale,
            float((lib.double() - want).abs().max()) / scale)


# (n, kv, ku, V a column slice): the solves' shapes, and every width at
# 2 x 500,009 rows (a row count with no divisor near 8,192).
GRAM_CASES = ([(4_000_000, 164, 164, False), (4_000_000, 64, 64, False),
               (1_000_000, 164, 164, False), (1_000_018, 164, 164, True),
               (4_000_000, 60, 60, True)]
              + [(1_000_018, k, k, False) for k in (1, 16, 30, 63, 65, 163, 164, 256)]
              + [(1_000_018, 16, 164, False), (1_000_018, 256, 30, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("n,kv,ku,sliced", GRAM_CASES)
@pytest.mark.parametrize("dist", ["uniform", "randn"])
def test_tall_gram_accuracy_on_card(cuda_device, n, kv, ku, sliced, dist):
    """The kernel's largest error relative to the largest entry of the
    float64 product is no worse than torch.matmul's on the same inputs,
    from width 4.  At width 1 cuBLAS runs a dot kernel that sums more
    accurately (and faster): ops/gram.py keeps it there."""
    from lobpcg_tpu_torch.ops import gram

    V, U = _gram_operands(n, kv, ku, dist, sliced, cuda_device, seed=kv + ku)
    err, lib_err = _gram_errors(V, U)
    if min(kv, ku) >= 4:
        assert err <= lib_err, (err, lib_err)
    else:
        assert gram._tall_route(V, U) == "matmul"


@pytest.mark.gpu
@pytest.mark.parametrize("n,kv,ku", [(4_000_000, 164, 164), (1_000_018, 16, 16),
                                     (1_000_018, 256, 256)])
def test_tall_gram_repeats_bit_for_bit_on_card(cuda_device, n, kv, ku):
    V, U = _gram_operands(n, kv, ku, "randn", False, cuda_device, seed=5)
    first = kg.tall_gram(V, U)
    assert torch.equal(kg.tall_gram(V, U), first)


@pytest.mark.gpu
def test_tall_gram_rejects_what_it_does_not_take(cuda_device):
    X = torch.zeros((4096, 64), device=cuda_device)
    for V, U in ((X.double(), X.double()), (X.mT[:, :64], X[:64]),
                 (torch.zeros((4096, 257), device=cuda_device), X),
                 (X, X[:100]), (X[None], X[None])):
        with pytest.raises(ValueError):
            kg.tall_gram(V, U)


@pytest.mark.gpu
def test_well_solve_takes_every_tall_gram_through_the_kernel(cuda_device):
    """In a short ilobpcg on the well at n 262,144, every 2-D f32 tall
    Gram (n >= 65,536) is one kernel launch."""
    from lobpcg_tpu_torch.benchmarks.solve_bdg import well_problem
    from lobpcg_tpu_torch.ops import gram

    A, B, T, X0, _, _ = well_problem(262_144, 8, 16, dtype=torch.float32, cheb=3,
                                     precond=True, device=cuda_device)
    seen = []
    tall_hmm = gram._tall_hmm

    def spy(V, U):
        if (V.dim() == 2 and V.dtype == torch.float32
                and V.shape[0] >= gram._KERNEL_MIN_ROWS):
            seen.append((tuple(V.shape), tuple(U.shape)))
        return tall_hmm(V, U)

    gram._tall_hmm = spy
    try:
        before = kg.tall_gram.launches
        r = tl.ilobpcg(A, X0, B, T, nev=8, size_sub=16, tol=1e-5, max_iter=6,
                       generator=torch.Generator(device=cuda_device).manual_seed(0))
        launches = kg.tall_gram.launches - before
    finally:
        gram._tall_hmm = tall_hmm
    assert r.iterations >= 1 and seen
    assert launches == len(seen), (launches, len(seen))
