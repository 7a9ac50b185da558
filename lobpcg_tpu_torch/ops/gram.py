"""Gram-matrix assembly: the contraction-over-n hot spot (port of
``lobpcg_tpu/ops/gram.py``).

One ``torch.matmul`` per Gram: a [k, n] x [n, k] contraction that goes to
cuBLAS on the GPU.  The full k x k matrix is always formed (k <= 3 *
size_sub); ``eigh`` symmetrizes the round-off.

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
from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.rows import row_sum

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


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Numerically-sensitive matmul at the context's precision; the
    result has B's dtype (the JAX package's preferred_element_type)."""
    if A.dtype != B.dtype:
        dt = torch.promote_types(A.dtype, B.dtype)
        return torch.matmul(A.to(dt), B.to(dt)).to(B.dtype)
    return torch.matmul(A, B)


def apply_block_op(op: Optional[LinearOperator], X: torch.Tensor) -> torch.Tensor:
    """Y = Op @ X for a whole block; identity when op is None."""
    if op is None:
        return X
    return op.matmat(X)


def _pack_pair_ok(op, ku: int, kv: int) -> bool:
    """Pack two adjacent same-width applies into one wide call iff the
    operator's fast path needs the combined width.  Every operator of
    the port answers apply_width_ok True, so this is never the case."""
    return (
        op is not None
        and ku == kv
        and not op.apply_width_ok(ku)
        and op.apply_width_ok(ku + kv)
    )


def apply_block_op_pair(op, U: torch.Tensor, V: torch.Tensor):
    """(op @ U, op @ V), packed into one [n, ku+kv] apply when that is
    the operator's fast path."""
    if op is None:
        return U, V
    if _pack_pair_ok(op, U.shape[-1], V.shape[-1]):
        ku = U.shape[-1]
        Y = op.matmat(torch.cat([U, V], dim=-1))
        return Y[..., :ku], Y[..., ku:]
    return op.matmat(U), op.matmat(V)


def applied_blocks(op, blocks, pre=None, pack=True):
    """[op @ b for b in blocks], reusing ``pre[j]`` where given and
    packing adjacent same-width applies when the operator prefers the
    combined width (apply_block_op_pair)."""
    pre = pre or {}
    n_b = len(blocks)
    todo = [j for j in range(n_b) if pre.get(j) is None]
    applied = [pre.get(j) for j in range(n_b)]
    i = 0
    while i < len(todo):
        j = todo[i]
        if pack and i + 1 < len(todo):
            j2 = todo[i + 1]
            if _pack_pair_ok(op, blocks[j].shape[-1], blocks[j2].shape[-1]):
                applied[j], applied[j2] = apply_block_op_pair(
                    op, blocks[j], blocks[j2]
                )
                i += 2
                continue
        applied[j] = apply_block_op(op, blocks[j])
        i += 1
    return applied


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
# this many, at least _SPLIT_MIN where n has such a divisor.
_SPLIT_MAX, _SPLIT_MIN = 8192, 1024


@functools.lru_cache(maxsize=64)
def _split_rows(n: int) -> int:
    """Rows of one piece: n itself up to _SPLIT_MAX, else the largest
    divisor of n in [_SPLIT_MIN, _SPLIT_MAX], else _SPLIT_MAX (the last
    n % _SPLIT_MAX rows then make a product of their own)."""
    if n <= _SPLIT_MAX:
        return n
    for r in range(_SPLIT_MAX, _SPLIT_MIN - 1, -1):
        if n % r == 0:
            return r
    return _SPLIT_MAX


def _tall_hmm(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """V^H @ U for tall blocks.  A batched pair [b, n, k] is cut into
    pieces of ``_split_rows(n)`` rows that run as one batched GEMM, and
    the pieces' products (and that of the rows left over) are summed:
    cuBLAS's strided-batched GEMM gives each problem's small output to a
    few thread blocks that run the whole n-long reduction in f32, slow
    and less accurate than the split over rows its unbatched GEMM
    makes."""
    if V.dim() == 2:
        return torch.matmul(V.mH, U)
    n = V.shape[-2]
    r = _split_rows(n)
    if r == n:
        return torch.matmul(V.mH, U)
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
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """G = U^H B U  (B None -> U^H U).  ``chunk``: assemble G column
    block by column block, so only a [n, chunk] B-application transient
    is live at a time."""
    k = U.shape[-1]
    if chunk is None or B is None or chunk >= k:
        BU = apply_block_op(B, U)
        return _hdot(U, BU, out_dtype)
    cols = []
    for j in range(0, k, chunk):
        BUj = B.matmat(U[..., j : j + chunk])
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
    """Sum_i blocks_i @ C[rows_i] — project-back without materializing S.
    The GEMMs are torch.matmul; their outputs are summed left to right
    in ``tail.combine`` passes (the eager adds inside
    ``tail.eager_chain()``)."""
    if tail.eager():
        out = None
        j = 0
        for b in blocks:
            w = b.shape[-1]
            t = mm(b, C[..., j : j + w, :])
            out = t if out is None else out + t
            j += w
        return out
    return _projected(blocks, C)


def b_mm_update(U: torch.Tensor, blocks, C: torch.Tensor, live) -> torch.Tensor:
    """mask_cols(U - b_mm(blocks, C), live), the projection update of
    ``ops/ortho.py``: the GEMMs, then one ``tail.combine`` pass for the
    sum, the subtraction and the mask (the eager chain inside
    ``tail.eager_chain()``)."""
    if tail.eager():
        return masking.mask_cols(U - b_mm(blocks, C), live)
    return _projected(blocks, C, U, live)


# Terms a combine pass sums before the next GEMM: as many tall blocks as
# the eager chain held at once (the running sum, a term and their sum).
_COMBINE_GROUP = 3


def _projected(blocks, C, U=None, live=None):
    """The GEMM outputs blocks_i @ C[rows_i] summed left to right in
    ``tail.combine`` passes of up to _COMBINE_GROUP terms (each written
    over its first term), the last one also forming live * (U - sum)."""
    acc, j = [], 0
    for i, b in enumerate(blocks):
        w = b.shape[-1]
        acc.append(mm(b, C[..., j : j + w, :]))
        j += w
        if len(acc) == _COMBINE_GROUP and i < len(blocks) - 1:
            acc = [_combine(acc)]
    return _combine(acc, U, live)


def _combine(terms, U=None, live=None):
    if len(terms) == 1 and U is None and live is None:
        return terms[0]
    t0 = terms[0]
    return tail.combine(terms, U, live, out=t0 if t0.is_contiguous() else None)


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


def scale_diag(G: torch.Tensor):
    """Guarded Jacobi scaling: D_ii = 1/sqrt(|G_ii|), Gs = D G D."""
    rdt = G.real.dtype if G.is_complex() else G.dtype
    gd = torch.abs(torch.diagonal(G, dim1=-2, dim2=-1)).to(rdt)
    pos = gd > 0
    D = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, gd, 1.0)), 1.0)
    Gs = (D[..., :, None] * G) * D[..., None, :].to(G.dtype)
    return D, Gs


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
