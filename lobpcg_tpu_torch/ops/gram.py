"""Gram-matrix assembly: the contraction-over-n hot spot (port of
``lobpcg_tpu/ops/gram.py``).

One product per Gram: a [k, n] x [n, k] contraction.  On the card a tall
2-D real f32 pair goes to the hand-written kernel ``csrc/gram.cu``
(``ops/cuda/gram.py:tall_gram``), every other product to
``torch.matmul`` (cuBLAS).  The full k x k matrix is always formed (k <=
3 * size_sub); ``eigh`` symmetrizes the round-off.

The projections back to the tall space (``b_mm``, ``b_mm_update``,
``mm_masked``) go on the card to the hand-written kernel ``csrc/proj.cu``
(``ops/cuda/proj.py:project``) where ``_proj_takes`` says so: the sum over
the terms, U - sum and the column mask in its epilogue.  Every other
projection runs a ``torch.matmul`` a term and a ``tail.combine`` pass.

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
from lobpcg_tpu_torch.ops.cuda import proj as proj_kernel
from lobpcg_tpu_torch.ops.cuda import tail
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


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Numerically-sensitive matmul at the context's precision; the
    result has B's dtype (the JAX package's preferred_element_type)."""
    if A.dtype != B.dtype:
        dt = torch.promote_types(A.dtype, B.dtype)
        return torch.matmul(A.to(dt), B.to(dt)).to(B.dtype)
    return torch.matmul(A, B)


def apply_block_op(op: Optional[LinearOperator], X: torch.Tensor,
                   role: str = "B") -> torch.Tensor:
    """Y = Op @ X for a whole block; identity when op is None.  ``role``
    ("A", "B" or "T") names the apply's span, ``lobpcg.apply.<role>``."""
    if op is None:
        return X
    with span(APPLY[role]):
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


def apply_block_op_pair(op, U: torch.Tensor, V: torch.Tensor,
                        role: str = "B"):
    """(op @ U, op @ V), packed into one [n, ku+kv] apply when that is
    the operator's fast path; one span, as ``apply_block_op``."""
    if op is None:
        return U, V
    with span(APPLY[role]):
        if _pack_pair_ok(op, U.shape[-1], V.shape[-1]):
            ku = U.shape[-1]
            Y = op.matmat(torch.cat([U, V], dim=-1))
            return Y[..., :ku], Y[..., ku:]
        return op.matmat(U), op.matmat(V)


def applied_blocks(op, blocks, pre=None, pack=True, role="B"):
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
                    op, blocks[j], blocks[j2], role
                )
                i += 2
                continue
        applied[j] = apply_block_op(op, blocks[j], role)
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


# Rows from which a 2-D Gram on the card is tall enough for csrc/gram.cu.
_KERNEL_MIN_ROWS = 65_536


def _kernel_widths(kv: int, ku: int) -> bool:
    """Widths at which csrc/gram.cu ran faster than cuBLAS on the card
    (4M rows, PERF.md's tall Gram row): both from 4 up to 96, where one
    block's tile holds the whole Gram and the product is byte-bound or
    nearly, and both in (128, 168], where one tile of up to 441 threads
    covers it.  cuBLAS's 64 x 64 tiles won at 100-128 and at 200 and 256
    (two tiles a side; 169-199 stays cuBLAS's too, untimed but 176), and
    its dot kernel at width 1, faster and with half the error."""
    lo, hi = min(kv, ku), max(kv, ku)
    return (4 <= lo and hi <= 96) or (128 < lo and hi <= 168)


def _kernel_takes(V: torch.Tensor, U: torch.Tensor) -> bool:
    """Does a pair on the card go to ``gram_kernel.tall_gram``?  Both
    2-D, real f32, column stride 1 (``gram_kernel.takes``), n >=
    _KERNEL_MIN_ROWS and widths the kernel wins at (``_kernel_widths``),
    by shape, dtype and layout alone."""
    return (V.shape[-2] >= _KERNEL_MIN_ROWS and gram_kernel.takes(V, U)
            and _kernel_widths(V.shape[-1], U.shape[-1]))


def _tall_route(V: torch.Tensor, U: torch.Tensor) -> str:
    """The product ``_tall_hmm`` runs: "kernel" (csrc/gram.cu: a pair on
    the card that ``_kernel_takes``), "split" (a batched pair cut over
    rows) or "matmul" (one ``torch.matmul``: the k x k ``_mat`` Grams,
    complex and f64 blocks, the widened ``rr_dtype`` chunks, CPU
    tensors)."""
    if V.dim() == 2:
        if V.is_cuda and U.is_cuda and _kernel_takes(V, U):
            return "kernel"
        return "matmul"
    n = V.shape[-2]
    return "matmul" if _split_rows(n) == n else "split"


def _tall_hmm(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """V^H @ U for tall blocks, by ``_tall_route``.  A batched pair [b, n,
    k] is cut into pieces of ``_split_rows(n)`` rows that run as one
    batched GEMM, and the pieces' products (and that of the rows left
    over) are summed: cuBLAS's strided-batched GEMM gives each problem's
    small output to a few thread blocks that run the whole n-long
    reduction in f32, slow and less accurate than the split over rows
    its unbatched GEMM makes."""
    route = _tall_route(V, U)
    if route == "kernel":
        return gram_kernel.tall_gram(V, U)
    if route == "matmul":
        return torch.matmul(V.mH, U)
    n = V.shape[-2]
    r = _split_rows(n)
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
    (``_projected``; the GEMMs and the eager adds inside
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
    ``ops/ortho.py`` (``_projected``; the eager chain inside
    ``tail.eager_chain()``)."""
    if tail.eager():
        return masking.mask_cols(U - b_mm(blocks, C), live)
    return _projected(blocks, C, U, live)


def mm_masked(U: torch.Tensor, T: torch.Tensor, live,
              in_place: bool = True) -> torch.Tensor:
    """mask_cols(mm(U, T), live): SVQB's transform of a tall block and its
    mask (``_projected``; the GEMM and ``mask_cols`` inside
    ``tail.eager_chain()``).  ``in_place``: the mask may be written over
    the GEMM output where the GEMM runs, so a second SVQB pass holds one
    tall block fewer."""
    def library(blocks, C, _, live):
        UT = mm(blocks[0], C)
        return masking.mask_cols(UT, live, out=UT if in_place else None)

    if tail.eager():
        return library((U,), T, None, live)
    return _projected((U,), T, None, live, library=library)


# Terms a combine pass sums before the next GEMM: as many tall blocks as
# the eager chain held at once (the running sum, a term and their sum).
_COMBINE_GROUP = 3


def _proj_widths(m: int) -> bool:
    """Output widths m at which csrc/proj.cu ran faster than cuBLAS's
    GEMMs plus combine on the card (three terms at 4M rows,
    ``tools/proj_widths.py``, PERF.md's projection row): 4 to 128, and 161
    to 168, where the tile of the 4M x 150 solve's 164 is fixed at compile
    time.  From 129 to 160 the generic tile ran 3-9% slower than cuBLAS
    (m 129: 23.9 against 23.0 ms; 150: 23.6 against 23.2)."""
    return 4 <= m <= 128 or 160 < m <= proj_kernel.MAX_M


def _proj_takes(blocks, C, U=None, live=None) -> bool:
    """Does a projection on the card go to ``proj_kernel.project``?  1 to
    ``proj_kernel.MAX_TERMS`` 2-D real f32 blocks with column stride 1,
    C [sum of their widths, m], U None or [n, m], a live count or boolean
    [m] (``proj_kernel.takes``), n >= _KERNEL_MIN_ROWS and an m the kernel
    wins at (``_proj_widths``): by shape, dtype and layout alone."""
    return (blocks[0].shape[-2] >= _KERNEL_MIN_ROWS
            and proj_kernel.takes(blocks, C, U, live)
            and _proj_widths(C.shape[-1]))


def _proj_route(blocks, C, U=None, live=None) -> str:
    """The product ``_projected`` runs: "kernel" (csrc/proj.cu: operands
    on the card that ``_proj_takes``), "cublas" (a ``torch.matmul`` a
    term and a ``tail.combine`` pass on the card: batched [b, n, k] blocks,
    complex and f64, n under _KERNEL_MIN_ROWS, other widths) or "host"
    (CPU tensors: the same chain's plain versions)."""
    if not all(T.is_cuda for T in (*blocks, C)):
        return "host"
    return "kernel" if _proj_takes(blocks, C, U, live) else "cublas"


def _projected(blocks, C, U=None, live=None, library=None):
    """live * (U - sum_i blocks_i @ C[rows_i]) by ``_proj_route``,
    counting the projections on the card in ``_projected.kernel`` and
    ``_projected.cublas``.  The cuBLAS and host route: ``library(blocks,
    C, U, live)``, by default the GEMM outputs summed left to right in
    ``tail.combine`` passes of up to _COMBINE_GROUP terms (each written
    over its first term), the last one also forming live * (U - sum)."""
    route = _proj_route(blocks, C, U, live)
    if route == "kernel":
        _projected.kernel += 1
        return proj_kernel.project(blocks, C, U, live)
    if route == "cublas":
        _projected.cublas += 1
    return (library or _gemms_combined)(blocks, C, U, live)


_projected.kernel = 0
_projected.cublas = 0


def _gemms_combined(blocks, C, U, live):
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
