"""Gram-matrix assembly: the contraction-over-n hot spot (port of
``lobpcg_tpu/ops/gram.py``).

One product per Gram: a [k, n] x [n, k] contraction, by
``ops/cuda/gram.py:tall_gram`` (the hand-written kernel ``csrc/gram.cu``
where it takes the pair, else ``torch.matmul``); a batched pair is cut
over rows here first.  The full k x k matrix is always formed (k <= 3 *
size_sub); ``eigh`` symmetrizes the round-off.

The projections back to the tall space (``b_mm``, ``b_mm_update``,
``mm_masked``) are calls of ``ops/cuda/proj.py:project`` (the
hand-written kernel ``csrc/proj.cu`` where it takes the operands, else
the GEMMs and the tail kernels it replaced).

Under a row group (a sharded solve, ``ops/rows.py``) every contraction
over the rows of tall blocks (``_hdot`` and the Grams built on it) is
all-reduced; the ``_mat`` Grams act on k x k coefficients and are not.

Precision: both ``precision_ctx("highest")`` (the default) and
``"high"`` run every f32 contraction in full f32, with TF32 off (see
``precision_ctx``).  The solver entry points set the context from
``SolverConfig.gram_precision`` and restore the previous backend flags
on exit.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops import masking
from lobpcg_tpu_torch.ops.cuda import gram as gram_kernel
from lobpcg_tpu_torch.ops.cuda.chains import mm
from lobpcg_tpu_torch.ops.cuda.proj import project
from lobpcg_tpu_torch.ops.rows import row_sum
from lobpcg_tpu_torch.utils.profiling import APPLY, span

# The active Gram precision name ("highest" or "high"), set by
# precision_ctx for the duration of a solve.
_PRECISION = ["highest"]


class precision_ctx:
    """Context manager: set the Gram-contraction precision name and turn
    TF32 off for the duration, restoring the previous name and backend
    TF32 flags on exit.

    Both names keep TF32 off.  The JAX package's ``Precision.HIGH`` is
    the TPU's bf16_3x, close to full f32 accuracy; the card has no
    counterpart through torch, and TF32 (about three decimal digits) is
    much coarser: with it the BdG main path converged 0/56 in 300
    iterations on the H100 where the reference converges.  TF32 stays
    unused until a parity test shows it is safe."""

    def __init__(self, name: str):
        if name not in ("highest", "high"):
            raise ValueError(f"unknown gram precision: {name!r}")
        self._new = name

    def __enter__(self):
        self._old = (
            _PRECISION[0],
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
        )
        _PRECISION[0] = self._new
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (_PRECISION[0], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._old
        return False


def apply_block_op(op: Optional[LinearOperator], X: torch.Tensor,
                   role: str = "B") -> torch.Tensor:
    """Y = Op @ X for a whole block; identity when op is None.  ``role``
    ("A", "B" or "T") names the apply's span, ``lobpcg.apply.<role>``."""
    if op is None:
        return X
    with span(APPLY[role]):
        return op.matmat(X)


def apply_block_op_pair(op, U: torch.Tensor, V: torch.Tensor,
                        role: str = "B"):
    """(op @ U, op @ V) in one span, as ``apply_block_op``."""
    if op is None:
        return U, V
    with span(APPLY[role]):
        return op.matmat(U), op.matmat(V)


def applied_blocks(op, blocks, pre=None, pack=True, role="B"):
    """[op @ b for b in blocks], reusing ``pre[j]`` where given.
    ``pack`` (the JAX package's packing of two same-width applies into
    one) is accepted for parity and has no effect: every operator of the
    port applies any width on its fast path."""
    pre = pre or {}
    return [apply_block_op(op, b, role) if pre.get(j) is None else pre[j]
            for j, b in enumerate(blocks)]


# Row-chunk size for WIDENED contractions (rr_dtype wider than storage):
# torch.matmul has no preferred_element_type, so a widened contraction
# casts its tall operands to the wide dtype one row chunk at a time and
# the tall block is never doubled in memory.  Set per solve from
# SolverConfig.rr_chunk_rows by mixed_chunk_ctx; 0 = _WIDEN_ROWS.
_MIXED_CHUNK = [0]
_WIDEN_ROWS = 1 << 16


class mixed_chunk_ctx:
    """Context manager: set the widened-Gram row-chunk size (restores
    the previous value on exit)."""

    def __init__(self, rows):
        self._new = int(rows or 0)

    def __enter__(self):
        self._old = _MIXED_CHUNK[0]
        _MIXED_CHUNK[0] = self._new
        return self

    def __exit__(self, *exc):
        _MIXED_CHUNK[0] = self._old
        return False


# Rows of one piece of a batched tall contraction (_tall_hmm): at most
# gram_kernel.MAX_ROWS (the kernel's slab), at least _SPLIT_MIN where n
# has such a divisor.
_SPLIT_MIN = 1024


@functools.lru_cache(maxsize=64)
def _split_rows(n: int) -> int:
    """Rows of one piece: n itself up to MAX_ROWS, else the largest
    divisor of n in [_SPLIT_MIN, MAX_ROWS], else MAX_ROWS (the last n %
    MAX_ROWS rows then make a product of their own)."""
    top = gram_kernel.MAX_ROWS
    if n <= top:
        return n
    for r in range(top, _SPLIT_MIN - 1, -1):
        if n % r == 0:
            return r
    return top


def _tall_hmm(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """V^H @ U for tall blocks: ``gram_kernel.tall_gram`` (the kernel or
    one ``torch.matmul``), except that a batched pair [b, n, k] of more
    than MAX_ROWS rows is cut into pieces of ``_split_rows(n)`` rows that
    run as one batched GEMM, and the pieces' products (and that of the
    rows left over) are summed: cuBLAS's strided-batched GEMM gives each
    problem's small output to a few thread blocks that run the whole
    n-long reduction in f32, slow and less accurate than the split over
    rows its unbatched GEMM makes."""
    n = V.shape[-2]
    if V.dim() == 2 or (r := _split_rows(n)) == n:
        return gram_kernel.tall_gram(V, U)
    m = n - n % r
    lead = V.shape[:-2]
    Vs = V[..., :m, :].reshape(lead + (m // r, r, V.shape[-1]))
    Us = U[..., :m, :].reshape(lead + (m // r, r, U.shape[-1]))
    out = torch.matmul(Vs.mH, Us).sum(dim=-3)
    if m < n:
        out = out + torch.matmul(V[..., m:, :].mH, U[..., m:, :])
    return out


def _local_hdot(V: torch.Tensor, U: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """V^H @ U over the rows at hand.  ``out_dtype`` wider than the
    storage dtype accumulates in that dtype, casting row chunks
    (mixed_chunk_ctx) of both operands."""
    dt = out_dtype if out_dtype is not None else U.dtype
    if dt == V.dtype and dt == U.dtype:
        return _tall_hmm(V, U)
    rows = _MIXED_CHUNK[0] or _WIDEN_ROWS
    n = V.shape[-2]
    acc = None
    for j in range(0, n, rows):
        p = _tall_hmm(V[..., j : j + rows, :].to(dt),
                      U[..., j : j + rows, :].to(dt))
        acc = p if acc is None else acc + p
    return acc


def _hdot(V: torch.Tensor, U: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """V^H @ U for tall blocks: the local contraction, all-reduced over
    the row group of a sharded solve (ops/rows.py)."""
    return row_sum(_local_hdot(V, U, out_dtype))


def gram_self(
    U: torch.Tensor, B: Optional[LinearOperator] = None, out_dtype=None,
    chunk: Optional[int] = None, role: str = "B",
) -> torch.Tensor:
    """G = U^H B U  (B None -> U^H U).  ``chunk``: assemble G column
    block by column block, so only a [n, chunk] B-application transient
    is live at a time.  ``role``: B's span, as in ``apply_block_op``."""
    k = U.shape[-1]
    if chunk is None or B is None or chunk >= k:
        BU = apply_block_op(B, U, role)
        return _hdot(U, BU, out_dtype)
    cols = []
    for j in range(0, k, chunk):
        BUj = apply_block_op(B, U[..., j : j + chunk], role)
        cols.append(_hdot(U, BUj, out_dtype))
    return torch.cat(cols, dim=-1)


def gram_cross(
    V: torch.Tensor, U: torch.Tensor, B: Optional[LinearOperator] = None,
    out_dtype=None,
) -> torch.Tensor:
    """G = V^H B U."""
    BU = apply_block_op(B, U)
    return _hdot(V, BU, out_dtype)


def gram_self_mat(U: torch.Tensor, mat: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """G = U^H mat U with an explicit dense metric, in coefficient
    space (U is [k, c], replicated: no row reduction)."""
    return _local_hdot(U, mm(mat, U), out_dtype)


def gram_cross_mat(
    V: torch.Tensor, U: torch.Tensor, mat: torch.Tensor, out_dtype=None
) -> torch.Tensor:
    """G = V^H mat U with an explicit dense metric, in coefficient
    space."""
    return _local_hdot(V, mm(mat, U), out_dtype)


def as_blocks(S, nx: int):
    """Normalize a subspace argument (a [n, 3m] tensor or a tuple of
    [n, m] blocks) to a tuple of column blocks."""
    if isinstance(S, (tuple, list)):
        return tuple(S)
    k = S.shape[-1]
    return tuple(S[..., j : j + nx] for j in range(0, k, nx))


def blocks_width(S) -> int:
    if isinstance(S, (tuple, list)):
        return sum(b.shape[-1] for b in S)
    return S.shape[-1]


def blocks_dtype(S):
    if isinstance(S, (tuple, list)):
        return S[0].dtype
    return S.dtype


def bh_dot(blocks, Y: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """[sum_i k_i, c] stack of blocks_i^H Y."""
    return torch.cat([_hdot(b, Y, out_dtype) for b in blocks], dim=-2)


def b_mm(blocks, C: torch.Tensor) -> torch.Tensor:
    """Sum_i blocks_i @ C[rows_i] — project-back without materializing S
    (``project``)."""
    return project(blocks, C)


def b_mm_update(U: torch.Tensor, blocks, C: torch.Tensor, live) -> torch.Tensor:
    """mask_cols(U - b_mm(blocks, C), live), the projection update of
    ``ops/ortho.py`` (``project``)."""
    return project(blocks, C, U, live)


def mm_masked(U: torch.Tensor, T: torch.Tensor, live,
              in_place: bool = True) -> torch.Tensor:
    """mask_cols(mm(U, T), live): SVQB's transform of a tall block and its
    mask (``project``).  ``in_place``: the mask may be written over the
    GEMM output where the GEMM runs, so a second SVQB pass holds one tall
    block fewer."""
    return project((U,), T, None, live, in_place=in_place)


def herm_tile_gram(blocks, applied, out_dtype=None) -> torch.Tensor:
    """G = S^H (Op S) from upper-triangle tall contractions only, the
    lower tiles mirrored as G_ji = G_ij^H (Op Hermitian).
    ``applied[j]`` must be Op @ blocks[j]."""
    nb = len(blocks)
    tiles = [[None] * nb for _ in range(nb)]
    for j in range(nb):
        for i in range(j + 1):
            tiles[i][j] = _hdot(blocks[i], applied[j], out_dtype)
            if i != j:
                tiles[j][i] = tiles[i][j].mH
    return torch.cat([torch.cat(row, dim=-1) for row in tiles], dim=-2)


def gram_blocks(blocks, B: Optional[LinearOperator] = None,
                out_dtype=None) -> torch.Tensor:
    """G = S^H B S over column blocks (B Hermitian): one [n, m]
    B-application transient at a time, upper-triangle contractions."""
    nb = len(blocks)
    tiles = [[None] * nb for _ in range(nb)]
    for j, b in enumerate(blocks):
        Bb = apply_block_op(B, b)
        for i in range(j + 1):
            tiles[i][j] = _hdot(blocks[i], Bb, out_dtype)
            if i != j:
                tiles[j][i] = tiles[i][j].mH
    return torch.cat([torch.cat(row, dim=-1) for row in tiles], dim=-2)


def gram_blocks_pre(blocks, Bblocks, out_dtype=None) -> torch.Tensor:
    """G = S^H (B S) from pre-applied operator blocks."""
    return herm_tile_gram(blocks, Bblocks, out_dtype)


def frob_norm(X: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of a k x k (replicated) matrix, in the real dtype
    (one per problem of a batch)."""
    return torch.sqrt(torch.sum(torch.abs(X) ** 2, dim=(-2, -1)))


def abs2(X: torch.Tensor) -> torch.Tensor:
    """|X|^2 elementwise: X ** 2 for a real block (the same bits as
    abs(X) ** 2, one pass fewer), abs(X) ** 2 for a complex one, as the
    JAX package's ``jnp.abs(x) ** 2``."""
    return torch.abs(X) ** 2 if X.is_complex() else X ** 2


def tall_frob_norm(X: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of a tall [n, k] block, summed over the row group
    of a sharded solve (one per problem of a batch)."""
    return torch.sqrt(row_sum(torch.sum(abs2(X), dim=(-2, -1))))


def ortho_err(G: torch.Tensor, count=None) -> torch.Tensor:
    """||G - I_sig||_F using |G_jj| - 1 on the diagonal (works for +-1
    signature diagonals); off-diagonals counted once (upper triangle).
    When `count` is given (an int, or one per problem), dead rows/cols
    (index >= count) are excluded."""
    k = G.shape[-1]
    diag = torch.diagonal(G, dim1=-2, dim2=-1)
    diag_err = torch.abs(diag) - 1.0
    off = G - masking.diag(diag)
    if count is not None:
        live = masking.as_mask(k, count, G.device)
        keep = live[..., :, None] & live[..., None, :]
        off = off * keep.to(off.dtype)
        diag_err = torch.where(live, diag_err, 0.0)
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=G.device), 1)
    off2 = torch.sum((torch.abs(off) ** 2) * upper, dim=(-2, -1))
    return torch.sqrt(off2 + torch.sum(diag_err**2, dim=-1))
