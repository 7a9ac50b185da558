"""Materialized sparse operators: block-ELL with a strip-window fast
path (port of ``lobpcg_tpu/operators/sparse.py``).

The host prepares the matrix with the repository's native library
(``utils/native.py``: COO -> CSR -> BSR), pads it to block-ELL, and for
windowable (banded, RCM-reordered) matrices also builds the strip-window
format.  On the card an f32 block goes through the strip-window kernel
(K5) when the window exists and pays at the block's width
(``BSROperator.window_pays``), else the block-ELL kernel (K3); a CPU
tensor, or a dtype the kernels do not take (f64, complex), runs the
plain gather + einsum.

A batched X [b, n, k] (a lockstep batched solve) shares the matrix, as
``jax.vmap`` shares an unmapped operand: one K3 or K5 launch for the
batch, the kernel chosen at the width of one problem, k.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lobpcg_tpu_torch.config import resolve_device
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops.cuda.bsr import (
    bsr_matmat,
    bsr_matmat_reference,
    bsr_window_matmat,
    bsr_window_widths,
    ell_to_strip_window,
)
from lobpcg_tpu_torch.utils import native


def _bsr_to_ell(bip: np.ndarray, bix: np.ndarray, bv: np.ndarray):
    """Pad BSR rows to uniform width R (ELL).  Padding blocks are zero
    with block-column 0.  (The JAX package's per-row loop, vectorized:
    the same arrays.)"""
    nb = len(bip) - 1
    counts = np.diff(bip)
    R = max(1, int(counts.max()))
    bs = bv.shape[-1]
    cols = np.zeros((nb, R), np.int32)
    vals = np.zeros((nb, R, bs, bs), bv.dtype)
    row = np.repeat(np.arange(nb), counts)
    idx = np.arange(bip[0], bip[-1])
    cols[row, idx - bip[row]] = bix[idx]
    vals[row, idx - bip[row]] = bv[idx]
    return cols, vals


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


# K5 against K3 for an f32 block of k columns.  K3 streams the block-ELL
# values and gathers R*bs X rows per output row, at a cost that grows
# with R*bs and with its column tile (16, 32, 64 or 128 wide, from k);
# K5 streams W window values per output row and skips the X rows of
# all-zero chunks.  So the window pays when R*bs > theta * W, theta by
# K3's column tile: the ratio of the two kernels' times per unit of
# width (t5 / W over t3 / (R*bs)), measured on the symmetric banded
# matrix (R*bs 56, W 384) of chip_smoke.py's window sweep (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md, Findings): K3 wins there at every k from 16
# to 128, and on the band-72 matrix (R*bs 152, W 512) the rule picks the
# faster kernel at each of the seven widths measured (K3 up to k 32, K5
# from 48, by 1-3% at 48 and 64 and by about 20% from 96).
_WINDOW_THETA = ((16, 0.55), (32, 0.34), (64, 0.27), (None, 0.19))


@dataclasses.dataclass
class BSROperator(LinearOperator):
    """Block-ELL sparse operator with a strip-window fast path.

    block_cols: [nb, R] int32 block-column indices (padding -> 0)
    blocks:     [nb, R, bs, bs] dense blocks (padding -> zeros)
    win_lo/win_vals: optional strip-window re-expansion ([ns] int32,
    [ns, strip, W]), built by the constructors for windowable matrices
    (``ops/cuda/bsr.py:ell_to_strip_window``).
    """

    block_cols: torch.Tensor
    blocks: torch.Tensor
    win_lo: Optional[torch.Tensor] = None
    win_vals: Optional[torch.Tensor] = None
    n: int = 0

    def window_pays(self, k: int) -> bool:
        """Whether an f32 block of k columns goes to K5 rather than K3
        (``_WINDOW_THETA``): the window exists and R*bs > theta(k) * W."""
        if self.win_vals is None:
            return False
        _, R, bs, _ = self.blocks.shape
        theta = next(t for k_max, t in _WINDOW_THETA if k_max is None or k <= k_max)
        return R * bs > theta * self.win_vals.shape[2]

    def matmat(self, X):
        """Y = A @ X for X [n, k], or [b, n, k] for b problems sharing A.

        A batch asks ``window_pays`` at k, one problem's width, not at
        b*k: ``jax.vmap`` maps the JAX package's dispatch over the
        problems, each choosing at its own width, and the batched kernels
        tile each problem's columns alone (``csrc/bsr.cu``), so a batch
        runs each problem's lone product in one launch.  Asked at b*k, a
        batch would take K5 on the band-72 matrix from b*k >= 48 where its
        lone problems take K3."""
        bs = self.blocks.shape[2]
        if X.dtype == torch.float32 and self.blocks.dtype == torch.float32:
            X = X.contiguous()
            if self.window_pays(X.shape[-1]):
                return bsr_window_matmat(self.win_lo, self.win_vals, X, bs=bs)
            return bsr_matmat(self.block_cols, self.blocks, X)
        return bsr_matmat_reference(self.block_cols, self.blocks, X)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    # -- constructors -------------------------------------------------
    # ``device=None`` means the CUDA card (raises without one).

    @classmethod
    def from_csr(cls, indptr, indices, vals, *, block_size: int,
                 dtype=torch.float32, device=None) -> "BSROperator":
        device = resolve_device(device)
        n = len(indptr) - 1
        if n % block_size:
            raise ValueError(
                f"n={n} not divisible by block_size={block_size}"
            )
        bip, bix, bv = native.csr_to_bsr(
            n, block_size, np.asarray(indptr), np.asarray(indices),
            np.asarray(vals, np.float64),
        )
        cols, blocks = _bsr_to_ell(bip, bix, bv)
        npdt = _numpy_dtype(dtype)

        # The JAX package's window rule, unchanged: build the strip-window
        # arrays when padding every strip to the max column span stays
        # within ~4x the ELL storage; strip ~256 rows rounded up to a
        # block-row multiple.
        win_lo = win_vals = None
        strip = block_size * (-(-256 // block_size))
        Wb = bsr_window_widths(cols, blocks, strip=strip)
        nb, R = cols.shape
        if Wb * block_size <= 4096 and Wb <= 4 * R + 16:
            lo, wv = ell_to_strip_window(cols, blocks.astype(npdt), strip=strip)
            win_lo = torch.from_numpy(lo).to(device)
            win_vals = torch.from_numpy(wv).to(device)
        return cls(
            block_cols=torch.from_numpy(cols).to(device),
            blocks=torch.from_numpy(blocks.astype(npdt)).to(device),
            win_lo=win_lo,
            win_vals=win_vals,
            n=n,
        )

    @classmethod
    def from_coo(cls, n, rows, cols, vals, *, block_size: int,
                 dtype=torch.float32, device=None) -> "BSROperator":
        indptr, indices, v = native.coo_to_csr(
            n, np.asarray(rows), np.asarray(cols),
            np.asarray(vals, np.float64),
        )
        return cls.from_csr(indptr, indices, v, block_size=block_size,
                            dtype=dtype, device=device)

    @classmethod
    def from_dense(cls, A, *, block_size: int, dtype=torch.float32,
                   tol: float = 0.0, device=None) -> "BSROperator":
        A = np.asarray(A)
        rows, cols = np.nonzero(np.abs(A) > tol)
        return cls.from_coo(
            A.shape[0], rows, cols, A[rows, cols], block_size=block_size,
            dtype=dtype, device=device,
        )


def laplacian_3d_csr(nx: int, ny: int, nz: int, h: float = None):
    """7-point 3-D Dirichlet Laplacian as CSR (host assembly) — the
    BASELINE.json config "3D Laplacian (stencil CSR)".  Returns
    (indptr, indices, vals) with eigenvalues sum of per-axis (k pi)^2
    terms under Dirichlet BCs."""
    import scipy.sparse as sp

    if h is None:
        h = 1.0 / (max(nx, ny, nz) + 1)

    def lap1d(m):
        return sp.diags(
            [-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
            [-1, 0, 1],
        )

    Ix, Iy, Iz = (sp.identity(m) for m in (nx, ny, nz))
    L = (
        sp.kron(sp.kron(lap1d(nx), Iy), Iz)
        + sp.kron(sp.kron(Ix, lap1d(ny)), Iz)
        + sp.kron(sp.kron(Ix, Iy), lap1d(nz))
    ) / (h * h)
    L = L.tocsr()
    L.sort_indices()
    return L.indptr.astype(np.int64), L.indices.astype(np.int64), L.data
