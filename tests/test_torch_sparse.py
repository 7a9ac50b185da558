"""The port's sparse layer against the JAX package on the same numpy
inputs, on the CPU: the native host preparation
(lobpcg_tpu_torch/utils/native.py), the host formats and the plain
versions of K3/K4/K5 (lobpcg_tpu_torch/ops/cuda/bsr.py), and
BSROperator (lobpcg_tpu_torch/operators/sparse.py).

Host arrays must be byte-identical.  The plain SpMMs are held against the
Pallas kernels in interpret mode at rtol 1e-5 / atol 1e-4 (the JAX
package's own tolerance for them, tests/test_sparse.py); BSROperator's
f64 matmat against the JAX operator at atol 1e-10.
"""

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lobpcg_tpu.operators import sparse as jsparse
from lobpcg_tpu.ops.pallas import bsr as jbsr
from lobpcg_tpu.utils import native as jnative
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.interop import operator_from_reference
from lobpcg_tpu_torch.operators import sparse as tsparse
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.ops.cuda import copy as k7
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.ops.cuda import stencil3d as k2
from lobpcg_tpu_torch.utils import native as tnative

torch.set_num_threads(2)

CSRC = pathlib.Path(tl.__file__).resolve().parent / "csrc"


def _rand_sparse(n, density, seed):
    """tests/test_sparse.py's random symmetric matrix."""
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=density, random_state=rng, format="csr")
    M = M + M.T
    M.sort_indices()
    return M


def _banded(n, band, rng):
    A = np.zeros((n, n))
    for d in range(-band, band + 1):
        A += np.diag(rng.randn(n - abs(d)), d)
    return A


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(params=["native", "fallback"])
def prep_mode(request, monkeypatch):
    """Both packages with the native library, or both on their
    NumPy/SciPy fallbacks."""
    if request.param == "fallback":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LIB_TRIED", True)
    elif not tnative.native_available():
        pytest.skip("native/libsparse_prep.so is not built")
    return request.param


# --- native host preparation ----------------------------------------------

def test_native_host_prep_matches_jax(prep_mode):
    rng = np.random.RandomState(1)
    n, nnz = 100, 800
    rows, cols, vals = rng.randint(0, n, nnz), rng.randint(0, n, nnz), rng.randn(nnz)
    for a, b in zip(tnative.coo_to_csr(n, rows, cols, vals),
                    jnative.coo_to_csr(n, rows, cols, vals)):
        assert np.array_equal(a, b)
    M = _rand_sparse(128, 0.05, 2)
    for a, b in zip(tnative.csr_to_bsr(128, 8, M.indptr, M.indices, M.data),
                    jnative.csr_to_bsr(128, 8, M.indptr, M.indices, M.data)):
        assert np.array_equal(a, b)
    M = _rand_sparse(200, 0.02, 3)
    assert np.array_equal(tnative.rcm_order(200, M.indptr, M.indices),
                          jnative.rcm_order(200, M.indptr, M.indices))
    ip, ix, _ = tl.laplacian_3d_csr(8, 8, 8)
    off = tnative.partition_rows(512, ip, 4)
    assert np.array_equal(off, jnative.partition_rows(512, ip, 4))
    assert np.array_equal(tnative.halo_rows(int(off[1]), int(off[2]), ip, ix),
                          jnative.halo_rows(int(off[1]), int(off[2]), ip, ix))


def test_native_library_is_the_repositorys():
    assert tnative._lib_path() == jnative._lib_path()
    assert tnative.native_available() == jnative.native_available()


def test_laplacian_3d_csr_matches_jax():
    for a, b in zip(tl.laplacian_3d_csr(5, 6, 7), jsparse.laplacian_3d_csr(5, 6, 7)):
        _same(a, b)


# --- host formats -----------------------------------------------------------

def _ell(n, bs, seed=4, banded=None):
    if banded is None:
        A = _rand_sparse(n, 0.08, seed).toarray()
    else:
        A = _banded(n, banded, np.random.RandomState(seed))
    op = jsparse.BSROperator.from_dense(A, block_size=bs, dtype=jnp.float32)
    return np.array(op.block_cols), np.array(op.blocks)


FORMAT_CASES = [(256, 8, None), (256, 16, None), (200, 8, None),
                (384, 8, 24), (200, 8, 16), (240, 24, 30), (264, 24, None)]


@pytest.mark.parametrize("n,bs,band", FORMAT_CASES)
@pytest.mark.parametrize("strip", [128, 256, 264])
def test_host_formats_byte_identical(n, bs, band, strip):
    cols, blocks = _ell(n, bs, banded=band)
    if strip % bs:
        with pytest.raises(ValueError):
            kb.ell_to_strip_window(cols, blocks, strip=strip)
        return
    for a, b in zip(kb.ell_to_strip_ell(cols, blocks, strip=strip),
                    jbsr.ell_to_strip_ell(cols, blocks, strip=strip)):
        _same(a, b)
    for a, b in zip(kb.ell_to_strip_window(cols, blocks, strip=strip),
                    jbsr.ell_to_strip_window(cols, blocks, strip=strip)):
        _same(a, b)
    assert (kb.bsr_window_widths(cols, blocks, strip=strip)
            == jbsr.bsr_window_widths(cols, blocks, strip=strip))


def test_bsr_to_ell_matches_jax():
    M = _rand_sparse(96, 0.1, 7)
    bsr = tnative.csr_to_bsr(96, 8, M.indptr, M.indices, M.data)
    for a, b in zip(tsparse._bsr_to_ell(*bsr), jsparse._bsr_to_ell(*bsr)):
        _same(a, b)


# --- plain K3 / K4 / K5 against the Pallas kernels (interpret) -------------

def _X(n, k, seed=7):
    return np.random.RandomState(seed).randn(n, k).astype(np.float32)


def test_plain_bsr_matmat_matches_pallas_interpret():
    cols, blocks = _ell(64, 8, seed=6)
    X = _X(64, 128)
    want = np.asarray(jbsr.bsr_matmat_pallas(
        jnp.asarray(cols), jnp.asarray(blocks), jnp.asarray(X), interpret=True))
    y = kb.bsr_matmat(torch.from_numpy(cols), torch.from_numpy(blocks),
                      torch.from_numpy(X))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,bs", [(256, 8), (256, 16), (200, 8)])
def test_plain_strip_ell_matches_pallas_interpret(n, bs):
    cols, blocks = _ell(n, bs)
    sc, sv = kb.ell_to_strip_ell(cols, blocks)
    X = _X(n, 128, n + bs)
    want = np.asarray(jbsr.bsr_strip_matmat_pallas(
        jnp.asarray(sc), jnp.asarray(sv), jnp.asarray(X), bs=bs, interpret=True))
    y = kb.bsr_strip_matmat(torch.from_numpy(sc), torch.from_numpy(sv),
                            torch.from_numpy(X), bs=bs)
    assert tuple(y.shape) == (n, 128)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,bs,band", [(256, 8, 8), (384, 8, 24), (256, 16, 16),
                                       (200, 8, 16), (104, 8, 16)])
def test_plain_strip_window_matches_pallas_interpret(n, bs, band):
    """(104, 8, 16): a 13-block matrix, so the window is the whole matrix,
    W 104 (not a multiple of 32 or of the kernel's window chunk)."""
    cols, blocks = _ell(n, bs, seed=5, banded=band)
    lo, wv = kb.ell_to_strip_window(cols, blocks)
    X = _X(n, 128, band)
    want = np.asarray(jbsr.bsr_window_matmat_pallas(
        jnp.asarray(lo), jnp.asarray(wv), jnp.asarray(X), bs=bs, interpret=True))
    y = kb.bsr_window_matmat(torch.from_numpy(lo), torch.from_numpy(wv),
                             torch.from_numpy(X), bs=bs)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)
    ell = kb.bsr_matmat_reference(torch.from_numpy(cols),
                                  torch.from_numpy(blocks), torch.from_numpy(X))
    np.testing.assert_allclose(y.numpy(), ell.numpy(), rtol=1e-5, atol=1e-4)


def test_plain_window_out_rows_cuts_the_result():
    cols, blocks = _ell(200, 8, banded=16)
    lo, wv = kb.ell_to_strip_window(cols, blocks)
    X = torch.from_numpy(_X(200, 4))
    full = kb.bsr_window_matmat(torch.from_numpy(lo), torch.from_numpy(wv), X)
    cut = kb.bsr_window_matmat(torch.from_numpy(lo), torch.from_numpy(wv), X,
                               out_rows=120)
    assert torch.equal(cut, full[:120])


# --- non-finite X: the oracle of the kernels' NaN/Inf pattern ---------------

def _poisoned(n, k, seed):
    """_X with a NaN and +-Inf in rows that padding blocks, padding union
    entries and stored zeros meet (row 0 is column 0's block: every
    padding block multiplies it), and +Inf over -Inf in one column."""
    X = _X(n, k, seed)
    X[0, 1] = np.nan
    X[n // 2, 0] = np.inf
    X[n - 1, k - 1] = -np.inf
    X[n // 3, 2], X[n // 3 + 1, 2] = np.inf, -np.inf
    return X


@pytest.mark.parametrize("kernel", ["ell", "strip", "window"])
def test_plain_nonfinite_pattern_matches_pallas_interpret(kernel):
    """The Pallas kernels (interpret) and the port's plain versions give
    the same isnan / isinf pattern for an X poisoned with NaN and +-Inf:
    each forms every product of its format, 0 * NaN and 0 * Inf
    included.  The card kernels K3-K6 are held to this pattern
    (tests/test_torch_gpu.py)."""
    n, bs, k = 384, 8, 12
    cols, blocks = _ell(n, bs, seed=8, banded=16 if kernel == "window" else None)
    X = _poisoned(n, k, 9)
    if kernel == "ell":
        want = jbsr.bsr_matmat_pallas(jnp.asarray(cols), jnp.asarray(blocks),
                                      jnp.asarray(X), interpret=True)
        y = kb.bsr_matmat(torch.from_numpy(cols), torch.from_numpy(blocks),
                          torch.from_numpy(X))
    else:
        conv = kb.ell_to_strip_ell if kernel == "strip" else kb.ell_to_strip_window
        pallas = (jbsr.bsr_strip_matmat_pallas if kernel == "strip"
                  else jbsr.bsr_window_matmat_pallas)
        fn = kb.bsr_strip_matmat if kernel == "strip" else kb.bsr_window_matmat
        idx, vals = conv(cols, blocks)
        want = pallas(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(X), bs=bs,
                      interpret=True)
        y = fn(torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(X),
               bs=bs)
    want, y = np.asarray(want), y.numpy()
    assert np.isnan(want).any() and np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(y), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(y[fin], want[fin], rtol=1e-5, atol=1e-4)


# --- BSROperator -------------------------------------------------------------

def _operators(A, bs, jdt, tdt):
    jop = jsparse.BSROperator.from_dense(A, block_size=bs, dtype=jdt)
    top = tl.BSROperator.from_dense(A, block_size=bs, dtype=tdt, device="cpu")
    return jop, top


@pytest.mark.parametrize("case", ["random", "banded", "laplacian"])
def test_bsr_operator_carries_the_same_arrays(case):
    rng = np.random.RandomState(9)
    if case == "random":
        A = _rand_sparse(128, 0.1, 9).toarray()
    elif case == "banded":
        A = _banded(400, 20, rng)
    else:
        ip, ix, v = tl.laplacian_3d_csr(16, 16, 16)
        A = None
    if A is None:
        jop = jsparse.BSROperator.from_csr(ip, ix, v, block_size=8, dtype=jnp.float32)
        top = tl.BSROperator.from_csr(ip, ix, v, block_size=8, device="cpu")
        assert top.win_vals is None  # not windowable: K3 on the card
    else:
        jop, top = _operators(A, 8, jnp.float32, torch.float32)
        assert top.win_vals is not None  # windowable: K5 on the card
    assert top.n == jop.n and top.shape == jop.shape
    assert top.dtype == torch.float32
    for name in ("block_cols", "blocks", "win_lo", "win_vals"):
        a, b = getattr(top, name), getattr(jop, name)
        assert (a is None) == (b is None)
        if a is not None:
            _same(a.numpy(), b)


@pytest.mark.parametrize("case", ["random", "banded"])
def test_bsr_operator_matmat_matches_jax_f64(case):
    rng = np.random.RandomState(4)
    A = (_rand_sparse(96, 0.08, 4).toarray() if case == "random"
         else _banded(200, 12, rng))
    jop, top = _operators(A, 8, jnp.float64, torch.float64)
    X = rng.randn(A.shape[0], 7)
    np.testing.assert_allclose(top.matmat(torch.from_numpy(X)).numpy(),
                               np.asarray(jop.matmat(jnp.asarray(X))),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(top.matmat(torch.from_numpy(X)).numpy(), A @ X,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("bs", [8, 24, 64])
def test_bsr_operator_block_sizes_match_dense(bs):
    """tests/test_sparse.py's strip-rounding case: strips round up to a
    block-row multiple (bs 24 -> strip 264)."""
    rng = np.random.RandomState(bs)
    nb = 24
    n = nb * bs
    dense = np.zeros((n, n))
    for i in range(nb):
        for j in range(max(0, i - 2), min(nb, i + 3)):
            dense[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.randn(bs, bs)
    dense = dense + dense.T + 10 * np.eye(n)
    jop, top = _operators(dense, bs, jnp.float64, torch.float64)
    if top.win_vals is not None:
        assert top.win_vals.shape[1] % bs == 0 and top.win_vals.shape[1] >= 256
    assert (top.win_vals is None) == (jop.win_vals is None)
    X = rng.randn(n, 8)
    np.testing.assert_allclose(top.matmat(torch.from_numpy(X)).numpy(),
                               dense @ X, rtol=1e-12,
                               atol=1e-9 * np.abs(dense @ X).max())


def test_bsr_operator_f32_dispatch_on_cpu(monkeypatch):
    """f32 goes to the window wrapper when the window pays at the block's
    width (R*bs > theta(k) * W: a dense matrix, R*bs = W), else to the
    block-ELL wrapper (a narrow band, R*bs 40 against W 256; the 3-D
    Laplacian, no window); each runs its plain version on a CPU tensor.
    f64 goes straight to the plain gather + einsum."""
    seen = []
    for name in ("bsr_window_matmat", "bsr_matmat"):
        real = getattr(tsparse, name)
        monkeypatch.setattr(tsparse, name,
                            lambda *a, _n=name, _r=real, **kw:
                            (seen.append(_n), _r(*a, **kw))[1])
    rng = np.random.RandomState(2)
    A = _banded(256, 10, rng)
    _, banded = _operators(A, 8, jnp.float32, torch.float32)
    _, dense = _operators(rng.randn(64, 64), 8, jnp.float32, torch.float32)
    assert banded.win_vals is not None and dense.win_vals is not None
    lap = tl.BSROperator.from_csr(*tl.laplacian_3d_csr(16, 16, 16),
                                  block_size=8, device="cpu")
    dense.matmat(torch.ones((64, 3)))
    banded.matmat(torch.ones((256, 3)))
    lap.matmat(torch.ones((4096, 3)))
    tl.BSROperator.from_dense(A, block_size=8, dtype=torch.float64,
                              device="cpu").matmat(torch.ones((256, 3),
                                                              dtype=torch.float64))
    assert seen == ["bsr_window_matmat", "bsr_matmat", "bsr_matmat"]


@pytest.mark.parametrize("rbs,W,k,pays", [
    (56, 384, 16, False), (56, 384, 128, False),    # the SPD band of chip_smoke.py
    (152, 512, 32, False), (152, 512, 48, True),    # band 72: K3 to k 32, K5 from 48
    (152, 512, 128, True), (64, 64, 1, True)])
def test_window_pays_follows_the_measured_crossing(rbs, W, k, pays):
    """BSROperator.window_pays on the shapes chip_smoke.py's sweep
    measured (R*bs, W) at widths on either side of the crossing."""
    R, bs = rbs // 8, 8
    op = tl.BSROperator(block_cols=torch.zeros((1, R), dtype=torch.int32),
                        blocks=torch.zeros((1, R, bs, bs)),
                        win_lo=torch.zeros(1, dtype=torch.int32),
                        win_vals=torch.zeros((1, 8, W)), n=8)
    assert op.window_pays(k) == pays
    op.win_vals = None
    assert not op.window_pays(k)


def test_constructors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.BSROperator.from_dense(np.eye(16), block_size=8)


def test_operator_from_reference_bsr_round_trip():
    rng = np.random.RandomState(3)
    A = _banded(200, 16, rng)
    for jop in (jsparse.BSROperator.from_dense(A, block_size=8, dtype=jnp.float64),
                jsparse.BSROperator.from_csr(*jsparse.laplacian_3d_csr(8, 8, 8),
                                             block_size=8, dtype=jnp.float64)):
        top = operator_from_reference(jop, device="cpu")
        assert isinstance(top, tl.BSROperator)
        assert top.block_cols.dtype == torch.int32
        X = rng.randn(jop.n, 5)
        np.testing.assert_allclose(top.matmat(torch.from_numpy(X)).numpy(),
                                   np.asarray(jop.matmat(jnp.asarray(X))),
                                   rtol=0, atol=1e-10)


def test_wrappers_reject_bad_arguments():
    cols, blocks = _ell(64, 8)
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    with pytest.raises(ValueError):
        kb.bsr_matmat(tc, tb, torch.zeros((63, 4)))
    with pytest.raises(ValueError):
        kb.bsr_matmat(tc[:, :1], tb, torch.zeros((64, 4)))
    lo, wv = (torch.from_numpy(a) for a in kb.ell_to_strip_window(cols, blocks))
    with pytest.raises(ValueError):
        kb.bsr_window_matmat(lo, wv, torch.zeros((64, 4)), out_rows=10**6)
    sc, sv = (torch.from_numpy(a) for a in kb.ell_to_strip_ell(cols, blocks))
    with pytest.raises(ValueError):
        kb.bsr_strip_matmat(sc, sv, torch.zeros((64, 4)), bs=16)


def test_cpu_tensors_never_move_launch_counters():
    cols, blocks = _ell(64, 8)
    X = torch.from_numpy(_X(64, 4))
    before = (kb.bsr_matmat.launches, kb.bsr_strip_matmat.launches,
              kb.bsr_window_matmat.launches)
    kb.bsr_matmat(torch.from_numpy(cols), torch.from_numpy(blocks), X)
    kb.bsr_strip_matmat(*(torch.from_numpy(a) for a in kb.ell_to_strip_ell(cols, blocks)), X)
    kb.bsr_window_matmat(*(torch.from_numpy(a) for a in kb.ell_to_strip_window(cols, blocks)), X)
    assert (kb.bsr_matmat.launches, kb.bsr_strip_matmat.launches,
            kb.bsr_window_matmat.launches) == before


# --- the kernels' C interfaces ---------------------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64, "float": ctypes.c_float}


@pytest.mark.parametrize("module,source", [(k1, "stencil1d.cu"),
                                           (k2, "stencil3d.cu"),
                                           (kb, "bsr.cu"),
                                           (k7, "copy.cu")])
def test_ctypes_signatures_match_the_sources(module, source):
    """Each wrapper's ctypes argument list equals its C entry point's
    parameter list in csrc/ (a mismatch shows only on the card, as a
    crash)."""
    text = (CSRC / source).read_text()
    protos = dict(re.findall(r"^int (lobpcg_\w+)\(([^)]*)\)", text, re.M))
    assert set(protos) == set(module.SIGNATURES)
    for sym, params in protos.items():
        types = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                 for p in params.split(",")]
        assert types == module.SIGNATURES[sym], sym
