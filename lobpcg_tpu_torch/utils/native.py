"""ctypes bindings for the repository's native sparse-preprocessing library
(``native/sparse_prep.cpp``, built by ``make -C native`` into
``native/libsparse_prep.so``), with NumPy/SciPy fallbacks used when the
library is absent (port of ``lobpcg_tpu/utils/native.py``).

Host-side preparation, not a device kernel: operator assembly
(COO -> CSR), BSR blocking for the sparse SpMM kernels, RCM bandwidth
reduction, and row-partition / halo planning.  The same library and the
same fallbacks as the JAX package, so both packages get the same arrays.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import numpy as np

_I8 = np.int64
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _lib_path() -> pathlib.Path:
    return (
        pathlib.Path(__file__).resolve().parents[2]
        / "native"
        / "libsparse_prep.so"
    )


def load_library(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    """Load (and memoize) the native library; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB is not None:
        return _LIB
    if _LIB_TRIED and path is None:
        return None
    _LIB_TRIED = True
    p = pathlib.Path(path) if path else _lib_path()
    if not p.exists():
        return None
    lib = ctypes.CDLL(str(p))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.coo_to_csr.restype = ctypes.c_int64
    lib.coo_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p,
                               f64p, i64p, i64p, f64p]
    lib.bsr_count_blocks.restype = ctypes.c_int64
    lib.bsr_count_blocks.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.csr_to_bsr.restype = None
    lib.csr_to_bsr.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p,
                               f64p, i64p, i64p, f64p]
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.partition_rows.restype = None
    lib.partition_rows.argtypes = [ctypes.c_int64, i64p, ctypes.c_int64, i64p]
    lib.halo_count.restype = ctypes.c_int64
    lib.halo_count.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.halo_fill.restype = None
    lib.halo_fill.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p]
    _LIB = lib
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def native_available() -> bool:
    return load_library() is not None


# ---------------------------------------------------------------------------
# COO -> CSR


def coo_to_csr(
    n: int, rows: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    rows = np.ascontiguousarray(rows, _I8)
    cols = np.ascontiguousarray(cols, _I8)
    nnz = rows.shape[0]
    lib = load_library()
    if lib is not None:
        v = (
            np.ascontiguousarray(vals, np.float64)
            if vals is not None
            else None
        )
        indptr = np.zeros(n + 1, _I8)
        indices = np.zeros(nnz, _I8)
        vout = np.zeros(nnz, np.float64) if v is not None else None
        out_nnz = lib.coo_to_csr(
            n, nnz, _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
            _ptr(v, ctypes.c_double) if v is not None else None,
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
            _ptr(vout, ctypes.c_double) if vout is not None else None,
        )
        return indptr, indices[:out_nnz], (
            vout[:out_nnz] if vout is not None else None
        )
    # NumPy fallback (with duplicate summation).
    order = np.lexsort((cols, rows))
    r, c = rows[order], cols[order]
    v = vals[order] if vals is not None else None
    key = r * n + c
    uniq, first = np.unique(key, return_index=True)
    if v is not None:
        sums = np.add.reduceat(v, first)
    r_u, c_u = uniq // n, uniq % n
    indptr = np.zeros(n + 1, _I8)
    np.add.at(indptr, r_u + 1, 1)
    indptr = np.cumsum(indptr).astype(_I8)
    return indptr, c_u.astype(_I8), (sums if v is not None else None)


# ---------------------------------------------------------------------------
# CSR -> BSR


def csr_to_bsr(
    n: int,
    bs: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    vals: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (block_indptr [nb+1], block_indices [nblocks],
    block_vals [nblocks, bs, bs])."""
    indptr = np.ascontiguousarray(indptr, _I8)
    indices = np.ascontiguousarray(indices, _I8)
    vals = np.ascontiguousarray(vals, np.float64)
    nb = (n + bs - 1) // bs
    lib = load_library()
    if lib is not None:
        nblocks = lib.bsr_count_blocks(
            n, bs, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64)
        )
        bip = np.zeros(nb + 1, _I8)
        bix = np.zeros(nblocks, _I8)
        bv = np.zeros(nblocks * bs * bs, np.float64)
        lib.csr_to_bsr(
            n, bs, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
            _ptr(vals, ctypes.c_double), _ptr(bip, ctypes.c_int64),
            _ptr(bix, ctypes.c_int64), _ptr(bv, ctypes.c_double),
        )
        return bip, bix, bv.reshape(nblocks, bs, bs)
    # scipy fallback
    import scipy.sparse as sp

    M = sp.csr_matrix((vals, indices, indptr), shape=(n, n)).tobsr((bs, bs))
    M.sort_indices()
    return (
        M.indptr.astype(_I8),
        M.indices.astype(_I8),
        np.asarray(M.data, np.float64),
    )


# ---------------------------------------------------------------------------
# RCM reordering


def rcm_order(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    indptr = np.ascontiguousarray(indptr, _I8)
    indices = np.ascontiguousarray(indices, _I8)
    lib = load_library()
    if lib is not None:
        perm = np.zeros(n, _I8)
        lib.rcm_order(
            n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
            _ptr(perm, ctypes.c_int64),
        )
        return perm
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    M = sp.csr_matrix(
        (np.ones(len(indices)), indices, indptr), shape=(n, n)
    )
    return reverse_cuthill_mckee(M, symmetric_mode=True).astype(_I8)


# ---------------------------------------------------------------------------
# Partition + halo plan


def partition_rows(n: int, indptr: np.ndarray, nparts: int) -> np.ndarray:
    indptr = np.ascontiguousarray(indptr, _I8)
    lib = load_library()
    if lib is not None:
        off = np.zeros(nparts + 1, _I8)
        lib.partition_rows(
            n, _ptr(indptr, ctypes.c_int64), nparts, _ptr(off, ctypes.c_int64)
        )
        return off
    total = int(indptr[-1])
    off = np.zeros(nparts + 1, _I8)
    for p in range(1, nparts):
        off[p] = int(np.searchsorted(indptr, total * p // nparts))
    off[nparts] = n
    return off


def halo_rows(
    row_lo: int, row_hi: int, indptr: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    indptr = np.ascontiguousarray(indptr, _I8)
    indices = np.ascontiguousarray(indices, _I8)
    lib = load_library()
    if lib is not None:
        cnt = lib.halo_count(
            row_lo, row_hi, _ptr(indptr, ctypes.c_int64),
            _ptr(indices, ctypes.c_int64),
        )
        out = np.zeros(cnt, _I8)
        lib.halo_fill(
            row_lo, row_hi, _ptr(indptr, ctypes.c_int64),
            _ptr(indices, ctypes.c_int64), _ptr(out, ctypes.c_int64),
        )
        return out
    cols = np.concatenate(
        [
            indices[indptr[r] : indptr[r + 1]]
            for r in range(row_lo, row_hi)
        ]
        or [np.zeros(0, _I8)]
    )
    ext = cols[(cols < row_lo) | (cols >= row_hi)]
    return np.unique(ext).astype(_I8)
