"""Block-sparse x dense SpMMs: the hand-written CUDA kernels of
``csrc/bsr.cu``, their plain PyTorch versions, and the host-side format
conversions.

Port of the TPU kernels of ``lobpcg_tpu/ops/pallas/bsr.py``:

- K3 ``bsr_matmat`` (``bsr_matmat_pallas``): block-ELL,
  Y[blk i] = sum_r blocks[i, r] . X[blk block_cols[i, r]].
- K4 ``bsr_strip_matmat`` (``bsr_strip_matmat_pallas``): strip-ELL, per
  strip one [strip, Rs*bs] row block times the X rows of its column
  union.  No operator dispatches it, as in the JAX package.
- K5 ``bsr_window_matmat`` (``bsr_window_matmat_pallas``): strip-window,
  per strip one [strip, W] row block times the contiguous X rows
  [lo[s]*bs, lo[s]*bs + W).
- K6 ``bsr_window_matmat_edges`` (``bsr_window_matmat_pallas_edges``):
  K5 against a halo-extended frame [halo_up | X | halo_dn] handed over as
  three buffers (X and two small edge buffers), so the sharded operator
  never concatenates the frame.

Each wrapper launches its kernel for a CUDA tensor (f32, contiguous, any
k >= 1, int32 indices; full f32 FFMA, no TF32) and runs its plain
version only for a CPU tensor; each counts its launches in
``.launches``.  K3, K5 and K6 also take a batch X [b, n, k] of problems
that share the matrix (a lockstep batched solve, ``operators/sparse.py``
and ``parallel/spmd_bsr.py``): one launch for the batch, with each
problem's Y equal to its lone launch's, and plain versions equal to b
lone plain products.  Index arrays are not range-checked on the card (that
would cost a host sync): they must address rows of X, as the formats
built here do.  K4, K5 and K6 skip column chunks whose values are all
zero unless X holds a NaN or Inf (``nonfinite_flag``: a device-side
flag, set by one pass over X just before the kernel), so their
non-finite pattern is the plain version's.

The host formats (``ell_to_strip_ell``, ``ell_to_strip_window``,
``bsr_window_widths``) are the JAX package's numpy code, so the same
matrix takes byte-identical formats in both packages; their strip of
~256 rows and 128-lane window padding are TPU choices, kept for that
reason.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library

STRIP = 128  # the JAX package's default strip (its MXU height)
# K3's largest block size: three stages of one block row's [bs, bs] block
# and [bs, 16] X slab must fit the 227 KB of shared memory a CTA can use.
K3_MAX_BS = 128
# K4's widest strip union (Rs * bs columns): its CTAs keep a table of the
# union's X rows in shared memory (csrc/bsr.cu kStripUnionMax).
K4_MAX_UNION = 32768


_P, _I64 = ctypes.c_void_p, ctypes.c_int64

# The C entry points of csrc/bsr.cu and their argument types (each
# returns an int cudaError_t).
SIGNATURES = {
    "lobpcg_bsr_ell_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                           _P],
    "lobpcg_nonfinite_f32": [_P, _I64, _P, _I64, _P, _I64, _P, _P],
    "lobpcg_bsr_strip_f32": [_P, _I64, _P, _P, _P, _I64, _I64, _I64, _I64, _P,
                             _P],
    "lobpcg_bsr_window_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                              _I64, _P, _P],
    "lobpcg_bsr_window_edges_f32": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                    _I64, _I64, _I64, _I64, _I64, _P, _P],
}


@functools.cache
def _lib():
    """The built library with its entry points' ctypes signatures."""
    return load_library("bsr", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("bsr")


# ---------------------------------------------------------------------------
# Host-side formats (numpy; the JAX package's code)


def ell_to_strip_ell(block_cols, blocks, *, strip: int = STRIP):
    """Host-side conversion: block-ELL -> strip-ELL.

    Returns (strip_cols [ns, Rs] i32, strip_vals [ns, strip, Rs*bs]) as
    numpy arrays.  Each strip groups SB = strip//bs block rows; its
    column list is the sorted union of the members' block-columns, and
    strip_vals[s][g*bs + i, u*bs + j] = A-block(row g, col strip_cols[u])
    re-expanded against the union (absent -> zero).  The trailing strip
    is zero-padded (cols 0 / zero values).  K4 (``bsr_strip_matmat``)
    multiplies each strip's values by the X rows of its union.
    """
    cols = np.asarray(block_cols)
    vals = np.asarray(blocks)
    nb, R, bs, _ = vals.shape
    if strip % bs:
        raise ValueError(f"block size {bs} must divide strip {strip}")
    SB = strip // bs
    ns = -(-nb // SB)
    nbp = ns * SB

    # Identify real (non-padding) blocks: padding is col 0 + all-zero.
    # (A genuinely-zero stored block at col 0 is indistinguishable from
    # padding; dropping it is harmless — it contributes nothing.)
    nz = vals.reshape(nb, R, -1).any(axis=2) | (cols != 0)
    if nbp > nb:  # zero-pad the trailing partial strip
        pad = nbp - nb
        cols = np.concatenate([cols, np.zeros((pad, R), cols.dtype)])
        vals = np.concatenate(
            [vals, np.zeros((pad, R, bs, bs), vals.dtype)]
        )
        nz = np.concatenate([nz, np.zeros((pad, R), bool)])

    # Per-strip dense rank of each member's column within the sorted
    # union (vectorized: sort, mark firsts, cumsum, un-permute).
    M = SB * R
    BIGC = np.int64(1) << 40
    c = np.where(nz, cols.astype(np.int64), BIGC).reshape(ns, M)
    order = np.argsort(c, axis=1, kind="stable")
    cs = np.take_along_axis(c, order, 1)
    new = np.ones((ns, M), bool)
    new[:, 1:] = cs[:, 1:] != cs[:, :-1]
    rank_sorted = np.cumsum(new, axis=1) - 1
    rank = np.empty_like(rank_sorted)
    np.put_along_axis(rank, order, rank_sorted, 1)
    live = c != BIGC
    Rs = max(1, int((rank_sorted * live[np.arange(ns)[:, None], order]
                     ).max(initial=0)) + 1)

    s_idx, m_idx = np.nonzero(live)
    strip_cols = np.zeros((ns, Rs), np.int32)
    strip_cols[s_idx, rank[s_idx, m_idx]] = c[s_idx, m_idx]

    # Scatter-add block values: [ns, SB, bs, Rs, bs] view of
    # [ns, strip, Rs*bs].
    sv5 = np.zeros((ns, SB, bs, Rs, bs), vals.dtype)
    g_idx = m_idx // R
    r_idx = m_idx % R
    np.add.at(
        sv5,
        (s_idx[:, None, None], g_idx[:, None, None],
         np.arange(bs)[None, :, None], rank[s_idx, m_idx][:, None, None],
         np.arange(bs)[None, None, :]),
        vals.reshape(ns * SB, R, bs, bs)[s_idx * SB + g_idx, r_idx],
    )
    return strip_cols, sv5.reshape(ns, strip, Rs * bs)


def ell_to_strip_window(block_cols, blocks, *, strip: int = STRIP,
                        ncols: Optional[int] = None,
                        force_width: Optional[int] = None):
    """Host-side conversion: block-ELL -> strip-window (banded fast path).

    ``ncols``: number of block columns the indices address (default: the
    row count, a square matrix).  The sharded operator passes its
    halo-extended local frame width nb_local + 2*halo: its local block
    matrix is rectangular, and windows clamp to the extended frame.
    ``force_width``: use this window width (in block columns) instead of
    the computed one; the sharded operator converts each shard on its own
    and needs one width across shards.  Must be >= the max span.

    Each strip stores ONE contiguous block-column window [lo, lo + Wb)
    covering every column its rows touch, and a dense [strip, Wb*bs]
    chunk re-expanded against that window.  K5 (``bsr_window_matmat``)
    multiplies it by the contiguous X rows [lo*bs, lo*bs + Wb*bs).

    Returns (lo [ns] i32, win_vals [ns, strip, Wb*bs]).  Only sensible
    for matrices whose per-strip column span is bounded (bands, RCM-
    reordered); `Wb` is the max span, and scattered matrices explode it
    — gate with `bsr_window_widths` before converting.
    """
    cols = np.asarray(block_cols)
    vals = np.asarray(blocks)
    nb, R, bs, _ = vals.shape
    if strip % bs:
        raise ValueError(f"block size {bs} must divide strip {strip}")
    SB = strip // bs
    ns = -(-nb // SB)
    nbp = ns * SB

    nz = vals.reshape(nb, R, -1).any(axis=2) | (cols != 0)
    if nbp > nb:
        pad = nbp - nb
        cols = np.concatenate([cols, np.zeros((pad, R), cols.dtype)])
        vals = np.concatenate(
            [vals, np.zeros((pad, R, bs, bs), vals.dtype)]
        )
        nz = np.concatenate([nz, np.zeros((pad, R), bool)])

    c2 = cols.astype(np.int64).reshape(ns, SB * R)
    nz2 = nz.reshape(ns, SB * R)
    cmin = np.where(nz2, c2, np.iinfo(np.int64).max).min(axis=1)
    cmax = np.where(nz2, c2, np.int64(-1)).max(axis=1)
    empty = ~nz2.any(axis=1)
    cmin[empty] = 0
    cmax[empty] = 0
    Wb = max(1, int((cmax - cmin).max()) + 1)
    # Pad the window width to a multiple of lcm(bs, 128) columns: the
    # TPU's 128-lane alignment, kept so that both packages build the
    # same format (re-choosing it for Hopper is later tuning work).
    nc = nb if ncols is None else ncols
    if force_width is not None:
        if force_width < Wb:
            raise ValueError(f"force_width {force_width} < max span {Wb}")
        Wb = force_width
    else:
        step = math.lcm(bs, 128) // bs
        Wb = -(-Wb // step) * step
    Wb = min(Wb, nc)  # tiny matrices: the whole matrix
    lo = np.clip(cmin, 0, max(0, nc - Wb)).astype(np.int32)

    win = np.zeros((ns, SB, bs, Wb, bs), vals.dtype)
    s_idx, m_idx = np.nonzero(nz2)
    g_idx = m_idx // R
    r_idx = m_idx % R
    w_idx = c2[s_idx, m_idx] - lo[s_idx]
    np.add.at(
        win,
        (s_idx[:, None, None], g_idx[:, None, None],
         np.arange(bs)[None, :, None], w_idx[:, None, None],
         np.arange(bs)[None, None, :]),
        vals.reshape(nbp, R, bs, bs)[s_idx * SB + g_idx, r_idx],
    )
    return lo, win.reshape(ns, strip, Wb * bs)


def bsr_window_widths(block_cols, blocks, *, strip: int = STRIP):
    """Max per-strip block-column span (the Wb the window format would
    pad to) — cheap windowability check before converting."""
    cols = np.asarray(block_cols)
    vals = np.asarray(blocks)
    nb, R, bs, _ = vals.shape
    SB = strip // bs
    ns = -(-nb // SB)
    nz = vals.reshape(nb, R, -1).any(axis=2) | (cols != 0)
    pad = ns * SB - nb
    if pad:
        cols = np.concatenate([cols, np.zeros((pad, R), cols.dtype)])
        nz = np.concatenate([nz, np.zeros((pad, R), bool)])
    c2 = cols.astype(np.int64).reshape(ns, SB * R)
    nz2 = nz.reshape(ns, SB * R)
    cmin = np.where(nz2, c2, np.iinfo(np.int64).max).min(axis=1)
    cmax = np.where(nz2, c2, np.int64(-1)).max(axis=1)
    ok = nz2.any(axis=1)
    spans = np.where(ok, cmax - cmin + 1, 1)
    return int(spans.max(initial=1))


# ---------------------------------------------------------------------------
# Plain versions (any device and dtype; f32 inputs accumulate in f32)


def _result_dtype(vals, X):
    return torch.promote_types(vals.dtype, X.dtype)


def _per_problem(fn, *args, X, **kwargs):
    """A plain product of a batch X [b, n, k]: fn(*args, X[i]) for each
    problem, stacked, so the batch equals b lone products bit for bit."""
    return torch.stack([fn(*args, x, **kwargs) for x in X])


def bsr_matmat_reference(
    block_cols: torch.Tensor, blocks: torch.Tensor, X: torch.Tensor
) -> torch.Tensor:
    """Block-ELL SpMM as gather + einsum (``lobpcg_tpu/ops/pallas/bsr.py:
    bsr_matmat_reference``); a batch [b, n, k] one problem at a time."""
    if X.dim() == 3:
        return _per_problem(bsr_matmat_reference, block_cols, blocks, X=X)
    nb, R, bs, _ = blocks.shape
    k = X.shape[1]
    dt = _result_dtype(blocks, X)
    Xg = X.to(dt).reshape(-1, bs, k)[block_cols.long()]  # [nb, R, bs, k]
    Y = torch.einsum("nrij,nrjk->nik", blocks.to(dt), Xg)
    return Y.reshape(nb * bs, k).to(X.dtype)


def _strip_product(rows, vals, X, out_rows):
    """Y[s*strip + i] = sum_w vals[s, i, w] X[rows[s, w]], cut to out_rows."""
    ns, strip, _ = vals.shape
    dt = _result_dtype(vals, X)
    Y = torch.bmm(vals.to(dt), X.to(dt)[rows])  # [ns, strip, k]
    return Y.reshape(ns * strip, X.shape[1])[:out_rows].to(X.dtype)


def bsr_strip_matmat_reference(strip_cols, strip_vals, X, *, bs: int = 8,
                               out_rows: Optional[int] = None):
    """Strip-ELL SpMM: each strip's values times the gathered X rows
    strip_cols[s, w // bs] * bs + w % bs, as one batched product."""
    _check_strip(strip_cols, strip_vals, X, bs, out_rows)
    ns, Rs = strip_cols.shape
    rows = (strip_cols.long()[:, :, None] * bs
            + torch.arange(bs, device=X.device)).reshape(ns, Rs * bs)
    return _strip_product(rows, strip_vals, X, _out_rows(X, out_rows))


def bsr_window_matmat_reference(lo, win_vals, X, *, bs: int = 8,
                                out_rows: Optional[int] = None):
    """Strip-window SpMM: each strip's values times the contiguous X rows
    [lo[s]*bs, lo[s]*bs + W), as one batched product; a batch [b, n, k]
    one problem at a time."""
    _check_window(lo, win_vals, X, bs, out_rows)
    if X.dim() == 3:
        return _per_problem(bsr_window_matmat_reference, lo, win_vals, X=X,
                            bs=bs, out_rows=out_rows)
    W = win_vals.shape[2]
    rows = lo.long()[:, None] * bs + torch.arange(W, device=X.device)
    return _strip_product(rows, win_vals, X, _out_rows(X, out_rows))


def bsr_window_matmat_edges_reference(lo, win_vals, X, edge_top, edge_bot, *,
                                      bs: int = 8, hrows: int = 0,
                                      out_rows: Optional[int] = None):
    """K6's function: the strip-window product against the extended frame
    [edge_top[:hrows] | X | edge_bot[W:]] (= [halo_up | X | halo_dn]),
    concatenated here and handed to the K5 plain version; a batch one
    problem at a time."""
    _check_edges(lo, win_vals, X, edge_top, edge_bot, hrows, out_rows)
    if X.dim() == 3:
        return torch.stack([
            bsr_window_matmat_edges_reference(lo, win_vals, x, t, b, bs=bs,
                                              hrows=hrows, out_rows=out_rows)
            for x, t, b in zip(X, edge_top, edge_bot)])
    W = win_vals.shape[2]
    x_ext = torch.cat([edge_top[:hrows], X, edge_bot[W:]], dim=0)
    return bsr_window_matmat_reference(
        lo, win_vals, x_ext, bs=bs, out_rows=_out_rows(X, out_rows))


# ---------------------------------------------------------------------------
# Argument checks and the kernel wrappers


def _out_rows(X, out_rows):
    return X.shape[-2] if out_rows is None else int(out_rows)


def _check_common(what, vals, X, idx, batch=False):
    if X.dim() not in ((2, 3) if batch else (2,)) or X.shape[-1] < 1:
        raise ValueError(f"{what}: X must be [n, k]"
                         f"{' or [b, n, k]' if batch else ''}, got "
                         f"{tuple(X.shape)}")
    if vals.device != X.device or idx.device != X.device:
        raise ValueError(f"{what}: operands on different devices")


def _check_ell(block_cols, blocks, X, frame=False):
    _check_common("bsr_matmat", blocks, X, block_cols, batch=True)
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"bsr_matmat: blocks must be [nb, R, bs, bs], got "
                         f"{tuple(blocks.shape)}")
    nb, R, bs, _ = blocks.shape
    if tuple(block_cols.shape) != (nb, R):
        raise ValueError(f"bsr_matmat: block_cols must be [{nb}, {R}], got "
                         f"{tuple(block_cols.shape)}")
    rows = X.shape[-2]
    if frame:
        if rows < bs or rows % bs:
            raise ValueError(f"bsr_matmat: a frame X has whole block rows, "
                             f"got {rows} rows at bs={bs}")
    elif rows != nb * bs:
        raise ValueError(f"bsr_matmat: X has {rows} rows, expected "
                         f"{nb * bs}")


def _check_strip_rows(what, vals, X, out_rows):
    ns, strip, _ = vals.shape
    if not 1 <= _out_rows(X, out_rows) <= ns * strip:
        raise ValueError(f"{what}: out_rows must be in [1, {ns * strip}]")


def _check_strip(strip_cols, strip_vals, X, bs, out_rows):
    _check_common("bsr_strip_matmat", strip_vals, X, strip_cols)
    if strip_cols.dim() != 2 or strip_vals.dim() != 3:
        raise ValueError("bsr_strip_matmat: strip_cols must be [ns, Rs] and "
                         "strip_vals [ns, strip, Rs*bs]")
    ns, Rs = strip_cols.shape
    if strip_vals.shape[0] != ns or strip_vals.shape[2] != Rs * bs:
        raise ValueError(
            f"bsr_strip_matmat: strip_vals {tuple(strip_vals.shape)} does not "
            f"match strip_cols {tuple(strip_cols.shape)} at bs={bs}")
    _check_strip_rows("bsr_strip_matmat", strip_vals, X, out_rows)


def _check_window(lo, win_vals, X, bs, out_rows):
    _check_common("bsr_window_matmat", win_vals, X, lo, batch=True)
    if lo.dim() != 1 or win_vals.dim() != 3 or win_vals.shape[0] != lo.shape[0]:
        raise ValueError("bsr_window_matmat: lo must be [ns] and win_vals "
                         "[ns, strip, W]")
    if win_vals.shape[2] > X.shape[-2]:
        raise ValueError(f"bsr_window_matmat: window width {win_vals.shape[2]} "
                         f"exceeds X's {X.shape[-2]} rows")
    _check_strip_rows("bsr_window_matmat", win_vals, X, out_rows)


def _check_edges(lo, win_vals, X, edge_top, edge_bot, hrows, out_rows):
    what = "bsr_window_matmat_edges"
    _check_common(what, win_vals, X, lo, batch=True)
    if lo.dim() != 1 or win_vals.dim() != 3 or win_vals.shape[0] != lo.shape[0]:
        raise ValueError(f"{what}: lo must be [ns] and win_vals [ns, strip, W]")
    W, (n_loc, k) = win_vals.shape[2], X.shape[-2:]
    lead = tuple(X.shape[:-2])
    if W > n_loc:
        raise ValueError(f"{what}: window width {W} exceeds the {n_loc} local "
                         "rows; use the extended-frame product")
    if hrows < 0:
        raise ValueError(f"{what}: hrows must be >= 0, got {hrows}")
    for name, e in (("edge_top", edge_top), ("edge_bot", edge_bot)):
        if tuple(e.shape) != lead + (hrows + W, k):
            raise ValueError(f"{what}: {name} must be "
                             f"{list(lead + (hrows + W, k))}, got "
                             f"{tuple(e.shape)}")
        if e.device != X.device or e.dtype != X.dtype:
            raise ValueError(f"{what}: {name} differs from X in device or dtype")
    _check_strip_rows(what, win_vals, X, out_rows)


def _kernel_operands(what, vals, X, idx):
    """Raise on what the kernels do not take: a device other than CUDA,
    a dtype other than f32 (int32 indices), non-contiguous operands."""
    if X.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {X.device}")
    if X.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"{what}: kernel takes f32, got {vals.dtype} x {X.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: indices must be int32, got {idx.dtype}")
    if not (X.is_contiguous() and vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")


def _empty_out(X, rows):
    return torch.empty((*X.shape[:-2], rows, X.shape[-1]), dtype=X.dtype,
                       device=X.device)


def nonfinite_flag(*bufs: torch.Tensor) -> torch.Tensor:
    """The non-finite flag that K4/K5/K6 take: a one-element int32 tensor
    on the card, 1 if any of the (one to three, contiguous f32 CUDA)
    buffers holds a NaN or Inf, else 0.  One pass over their bytes
    (``csrc/bsr.cu:lobpcg_nonfinite_f32``) on the current stream; nothing
    waits for it on the host."""
    lib = _lib()
    flag = torch.empty(1, dtype=torch.int32, device=bufs[0].device)
    spans = [(b.data_ptr(), b.numel()) for b in bufs]
    spans += [(bufs[0].data_ptr(), 0)] * (3 - len(spans))
    with torch.cuda.device(flag.device):
        code = lib.lobpcg_nonfinite_f32(
            *(v for span in spans for v in span), flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(lib, code, "nonfinite_flag launch")
    return flag


def bsr_matmat(block_cols: torch.Tensor, blocks: torch.Tensor,
               X: torch.Tensor, *, frame: bool = False) -> torch.Tensor:
    """K3: Y = block-ELL(block_cols, blocks) @ X, [nb*bs, k]; for a batch
    X [b, n, k] (b problems sharing the matrix), Y [b, nb*bs, k].

    X has nb*bs rows, or with ``frame`` any whole number of block rows
    that ``block_cols`` index into (a shard's halo-extended frame,
    ``parallel/spmd_bsr.py``): the kernel reads X only through the
    column indices.  A batch is one launch whose column tiles run over
    the b problems' columns, each tile inside one problem
    (``csrc/bsr.cu``).  CUDA tensor: launches
    ``csrc/bsr.cu:lobpcg_bsr_ell_f32`` on the
    current stream without synchronising and counts it in
    ``bsr_matmat.launches``; it stages a block row's blocks and X slabs in
    shared memory, so it takes block sizes up to ``K3_MAX_BS``.  CPU
    tensor: the plain version."""
    _check_ell(block_cols, blocks, X, frame)
    if X.device.type == "cpu":
        return bsr_matmat_reference(block_cols, blocks, X)
    _kernel_operands("bsr_matmat", blocks, X, block_cols)
    lib = _lib()
    nb, R, bs, _ = blocks.shape
    if bs > K3_MAX_BS:
        raise ValueError(f"bsr_matmat: the kernel takes block sizes up to "
                         f"{K3_MAX_BS}, got {bs}")
    Y = _empty_out(X, nb * bs)
    with torch.cuda.device(X.device):
        code = lib.lobpcg_bsr_ell_f32(
            block_cols.data_ptr(), blocks.data_ptr(), X.data_ptr(),
            Y.data_ptr(), nb, R, bs, X.shape[-1],
            X.shape[0] if X.dim() == 3 else 1, X.shape[-2],
            torch.cuda.current_stream().cuda_stream,
        )
    bsr_matmat.launches += 1
    check(lib, code, "bsr_matmat launch")
    return Y


def bsr_strip_matmat(strip_cols: torch.Tensor, strip_vals: torch.Tensor,
                     X: torch.Tensor, *, bs: int = 8,
                     out_rows: Optional[int] = None) -> torch.Tensor:
    """K4: strip-ELL SpMM, [out_rows (default X's rows), k].

    CUDA tensor: launches ``csrc/bsr.cu:lobpcg_bsr_strip_f32`` (K5's tile
    kernel with the union's rows gathered through a table in shared
    memory, so unions up to ``K4_MAX_UNION`` columns, skipping all-zero
    chunks as K5 does) and counts it in ``bsr_strip_matmat.launches``.
    CPU tensor: the plain version."""
    _check_strip(strip_cols, strip_vals, X, bs, out_rows)
    if X.device.type == "cpu":
        return bsr_strip_matmat_reference(strip_cols, strip_vals, X, bs=bs,
                                          out_rows=out_rows)
    _kernel_operands("bsr_strip_matmat", strip_vals, X, strip_cols)
    lib = _lib()
    ns, Rs = strip_cols.shape
    if Rs * bs > K4_MAX_UNION:
        raise ValueError(f"bsr_strip_matmat: the kernel takes unions up to "
                         f"{K4_MAX_UNION} columns, got {Rs * bs}")
    strip = strip_vals.shape[1]
    nr = _out_rows(X, out_rows)
    Y = _empty_out(X, nr)
    flag = nonfinite_flag(X)
    with torch.cuda.device(X.device):
        code = lib.lobpcg_bsr_strip_f32(
            strip_cols.data_ptr(), Rs, strip_vals.data_ptr(), X.data_ptr(),
            Y.data_ptr(), nr, strip, bs, X.shape[1], flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    bsr_strip_matmat.launches += 1
    check(lib, code, "bsr_strip_matmat launch")
    return Y


def bsr_window_matmat(lo: torch.Tensor, win_vals: torch.Tensor,
                      X: torch.Tensor, *, bs: int = 8,
                      out_rows: Optional[int] = None) -> torch.Tensor:
    """K5: strip-window SpMM, [out_rows (default X's rows), k]; for a batch
    X [b, n, k] (b problems sharing the matrix), [b, out_rows, k].

    CUDA tensor: launches ``csrc/bsr.cu:lobpcg_bsr_window_f32`` (once for
    a batch, after one non-finite flag pass over the whole batch) and
    counts it in ``bsr_window_matmat.launches``.  CPU tensor: the plain
    version.  The kernel skips window chunks whose values are all zero
    when X is finite (the full sum; at most a zero's sign differs) and
    none when X holds a NaN or Inf, so a non-finite value of X that only
    stored zeros multiply reaches Y as in the plain version."""
    _check_window(lo, win_vals, X, bs, out_rows)
    if X.device.type == "cpu":
        return bsr_window_matmat_reference(lo, win_vals, X, bs=bs,
                                           out_rows=out_rows)
    _kernel_operands("bsr_window_matmat", win_vals, X, lo)
    lib = _lib()
    _, strip, W = win_vals.shape
    nr = _out_rows(X, out_rows)
    Y = _empty_out(X, nr)
    flag = nonfinite_flag(X)
    with torch.cuda.device(X.device):
        code = lib.lobpcg_bsr_window_f32(
            lo.data_ptr(), win_vals.data_ptr(), X.data_ptr(), Y.data_ptr(),
            nr, strip, W, bs, X.shape[-1], X.shape[0] if X.dim() == 3 else 1,
            X.shape[-2], flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    bsr_window_matmat.launches += 1
    check(lib, code, "bsr_window_matmat launch")
    return Y


def bsr_window_matmat_edges(lo: torch.Tensor, win_vals: torch.Tensor,
                            X: torch.Tensor, edge_top: torch.Tensor,
                            edge_bot: torch.Tensor, *, bs: int = 8,
                            hrows: int = 0,
                            out_rows: Optional[int] = None) -> torch.Tensor:
    """K6: the strip-window SpMM against the halo-extended frame
    [halo_up | X | halo_dn] without building it, [out_rows (default X's
    rows), k].  ``lo`` addresses the extended frame (in blocks);
    ``edge_top`` = [halo_up | X[:W]] and ``edge_bot`` = [X[-W:] | halo_dn]
    are [hrows + W, k] each, and W <= X's rows.  A batch X [b, n_loc, k]
    (b problems sharing the matrix) takes edge buffers [b, hrows + W, k],
    each problem's own, and gives [b, out_rows, k].

    CUDA tensor: launches ``csrc/bsr.cu:lobpcg_bsr_window_edges_f32``
    (once for a batch, after one non-finite flag pass over X and the
    edge buffers) and counts it in ``bsr_window_matmat_edges.launches``: K5's
    kernel on another base pointer, so equal to K5 on the concatenated
    frame bit for bit (and skipping all-zero chunks when and as K5 does),
    and each problem of a batch equal to its lone launch.  CPU tensor:
    the plain version."""
    _check_edges(lo, win_vals, X, edge_top, edge_bot, hrows, out_rows)
    if X.device.type == "cpu":
        return bsr_window_matmat_edges_reference(
            lo, win_vals, X, edge_top, edge_bot, bs=bs, hrows=hrows,
            out_rows=out_rows)
    what = "bsr_window_matmat_edges"
    _kernel_operands(what, win_vals, X, lo)
    if not (edge_top.is_contiguous() and edge_bot.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    lib = _lib()
    _, strip, W = win_vals.shape
    n_loc, k = X.shape[-2:]
    nr = _out_rows(X, out_rows)
    Y = _empty_out(X, nr)
    # The edge buffers whole: their copies of X's rows add nothing to the flag.
    flag = nonfinite_flag(X, edge_top, edge_bot)
    with torch.cuda.device(X.device):
        code = lib.lobpcg_bsr_window_edges_f32(
            lo.data_ptr(), win_vals.data_ptr(), X.data_ptr(),
            edge_top.data_ptr(), edge_bot.data_ptr(), Y.data_ptr(),
            nr, strip, W, bs, k, hrows, n_loc,
            X.shape[0] if X.dim() == 3 else 1, flag.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    bsr_window_matmat_edges.launches += 1
    check(lib, code, "bsr_window_matmat_edges launch")
    return Y


bsr_matmat.launches = 0
bsr_strip_matmat.launches = 0
bsr_window_matmat.launches = 0
bsr_window_matmat_edges.launches = 0
