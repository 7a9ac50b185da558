"""The solver's tall elementwise tail: the hand-written CUDA kernels of
``csrc/tail.cu`` and their plain PyTorch versions.

In the JAX package these chains are jnp expressions inside the jitted
solve, and XLA fuses each into one loop over the tall block; the port
ran each operation of a chain as its own PyTorch pass.  Four kernels
take their place, each with the bits of the eager chain it replaces
(every operation rounded on its own, in the chain's order; the live
mask a multiply by 1 or 0), so a solve through them keeps its
trajectory bit for bit:

- ``antidiag(X, d, copies)``: B X of the anti-diagonal B = {{0, D}, {D,
  0}} (``BlockAntiDiagOperator``; ``copies`` 2: the split-real form,
  one half swap inside each copy; the sharded form's row scales), the
  counterpart of ``lobpcg_tpu/operators/linop.py:319-323``;
- ``residual(AX, X, lam, d, BX)``: W = AX - (B X) diag(lam), B the
  anti-diagonal (its partner rows of X read in place), a given BX, or
  none (``lobpcg_tpu/ops/residual.py:get_residual``);
- ``combine(terms, U, live)``: live * (U - ((t0 + t1) + t2)), the
  projection update of ``ops/ortho.py``, and without U the project-back
  sum of ``ops/gram.py:b_mm`` (``lobpcg_tpu/ops/ortho.py:231``,
  ``lobpcg_tpu/ops/gram.py:321-330``);
- ``compact(U, shift, live)``: out[:, j] = live_j * U[:, clamp(j +
  shift, 0, k - 1)], ``masking.shift_cols`` and, with shift 0,
  ``masking.mask_cols`` (``lobpcg_tpu/ops/masking.py:46-62``).

Routes, by device and dtype alone: a CPU tensor runs the plain version;
a CUDA tensor of real f32 or f64, every block and per-row operand of one
dtype, launches the kernel (any layout: operands are read through their
strides, so a column slice ``W[..., :nev]`` is never copied); a CUDA
tensor of any other dtype (complex, bf16, f16) or of mixed dtypes runs
the plain version, as the eager chain did.  A shape the kernel does not
take raises.  Nothing is retried after a failure.  No Python scalar
enters these chains: lam, d and the live counts are tensors or ints.
Inside ``chains.eager_chain()`` every wrapper runs its plain version,
which is the eager chain of its call site (``operators/linop.py``,
``ops/residual.py``, ``ops/masking.py``, ``proj.py``,
``parallel/sharding.py``) before these kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library
from lobpcg_tpu_torch.ops.cuda.chains import as_mask, eager, read
from lobpcg_tpu_torch.ops.cuda.stencil import items_per_load

KERNEL_DTYPES = (torch.float32, torch.float64)
THREADS = 256  # threads a block (csrc/tail.cu: kThreads)
MAX_TERMS = 4  # combine's terms (kMaxTerms)
MAX_BATCH = 65535  # problems: the grid's y extent (kMaxBatch)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_TALL = [_P, _I, _I, _I]  # base, batch / row / column strides
_LIVE = [_P, _I, _P, _I, _I, _I]  # mask, mask_sb, count_b, count_sb, count, kind
_SHAPE = [_P, _I, _I, _I, _I, _P]  # Y, batch, n, k, w, stream
# The C entry points of csrc/tail.cu and their argument types (each
# returns an int cudaError_t).
SIGNATURES = {
    **{f"lobpcg_tail_antidiag_{s}": _TALL + [_P, _P, _I, _I] + _SHAPE[1:4]
       + [_I, _I, _P] for s in _SUFFIX.values()},
    **{f"lobpcg_tail_residual_{s}": _TALL * 3 + [_P, _I, _I, _I, _P, _I]
       + _SHAPE for s in _SUFFIX.values()},
    **{f"lobpcg_tail_combine_{s}": [_P, _P, _I] + _TALL + _LIVE + _SHAPE
       for s in _SUFFIX.values()},
    **{f"lobpcg_tail_compact_{s}": _TALL + [_P, _I, _I] + _LIVE + _SHAPE
       for s in _SUFFIX.values()},
}

@functools.cache
def _lib():
    """The built library with its entry points' ctypes signatures."""
    return load_library("tail", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("tail")


# --- shapes, layouts and the live mask ----------------------------------------


def _dims(T: torch.Tensor):
    """(problems, rows, columns) of a block [n, k] or [b, n, k]."""
    if T.dim() not in (2, 3):
        raise ValueError(f"a tall block must be [n, k] or [b, n, k], got "
                         f"{tuple(T.shape)}")
    return (1, *T.shape) if T.dim() == 2 else tuple(T.shape)


def _tall(T: Optional[torch.Tensor]):
    """(base, batch stride, row stride, column stride) in elements; a
    block without a batch has batch stride 0."""
    if T is None:
        return [None, 0, 0, 0]
    if T.dim() == 2:
        return [T.data_ptr(), 0, T.stride(0), T.stride(1)]
    return [T.data_ptr(), T.stride(0), T.stride(1), T.stride(2)]


def item_width(k: int, itemsize: int, operands) -> int:
    """Elements the kernels load and store at once (an item): K1's
    ``items_per_load`` over the operands' bases ((base, batch stride,
    row stride, column stride) of ``_tall``), narrowed until every
    operand's strides fall on item boundaries too; 1 where a column
    stride is not 1."""
    operands = [op for op in operands if op[0] is not None]
    w = items_per_load(k, itemsize, *(op[0] for op in operands))
    while w > 1 and any(sc != 1 or sb % w or sr % w
                        for _, sb, sr, sc in operands):
        w //= 2
    return w


def _mask(S: torch.Tensor, live) -> torch.Tensor:
    """``masking.mask_cols``' chain: S times its live mask cast to S's
    dtype."""
    m = as_mask(S.shape[-1], live, S.device)
    return S * m[..., None, :].to(S.dtype)


def _problem_values(v: torch.Tensor, b: int, what: str) -> torch.Tensor:
    """An integer tensor of one value or one a problem, as int64 on the
    device; raises on another count."""
    v = v.to(torch.int64).reshape(-1)
    if v.numel() not in (1, b):
        raise ValueError(f"{what}: {v.numel()} values for {b} problems")
    return v.contiguous()


def _live_args(live, b: int, k: int, device):
    """The kernel's live arguments (mask, mask_sb, count_b, count_sb,
    count, kind) and the tensors they point into."""
    if live is None:
        return [None, 0, None, 0, 0, 0], ()
    if isinstance(live, torch.Tensor):
        if live.device != device:
            raise ValueError("live mask or counts on another device than "
                             "the block")
        if live.dtype == torch.bool:
            if live.shape[-1] != k or live.dim() not in (1, 2) or (
                    live.dim() == 2 and live.shape[0] != b):
                raise ValueError(f"a live mask must be [{k}] or [{b}, {k}], "
                                 f"got {tuple(live.shape)}")
            m = live.contiguous().view(torch.uint8)
            return [m.data_ptr(), k if m.dim() == 2 else 0, None, 0, 0, 2], (m,)
        c = _problem_values(live, b, "live counts")
        return [None, 0, c.data_ptr(), int(c.numel() > 1), 0, 1], (c,)
    return [None, 0, None, 0, int(live), 1], ()


def _check_device(what: str, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: operands on other devices")


def _kernel_route(*tensors) -> bool:
    """Do these CUDA tensors run the kernel: all real f32 or all f64?
    (Else the plain version, by dtype alone.)"""
    dts = {t.dtype for t in tensors if t is not None}
    return len(dts) == 1 and dts.pop() in KERNEL_DTYPES


def _launch(sym: str, dtype, args) -> None:
    lib = _lib()
    code = getattr(lib, f"{sym}_{_SUFFIX[dtype]}")(*args)
    check(lib, code, f"{sym} launch")


def _stream(T: torch.Tensor) -> int:
    with torch.cuda.device(T.device):
        return torch.cuda.current_stream().cuda_stream


# --- antidiag -----------------------------------------------------------------------


def _swap_scales(X: torch.Tensor, d: torch.Tensor, copies: int):
    """(rows a half, per_row) of the half swap of X's rows by d: d one
    value a row of a half ([h] or [b, h]) or one a row ([n] or [b, n])."""
    b, n, _ = _dims(X)
    copies = int(copies)
    if copies < 1 or n % (2 * copies):
        raise ValueError(f"antidiag: {n} rows are not {copies} copies of two "
                         f"halves")
    h = n // (2 * copies)
    if d.dim() not in (1, 2) or d.shape[-1] not in (h, n) or (
            d.dim() == 2 and (X.dim() != 3 or d.shape[0] != b)):
        raise ValueError(f"antidiag: d must be [{h}] or [{n}] (or one a "
                         f"problem of a batched X), got {tuple(d.shape)}")
    return h, d.shape[-1] == n


def antidiag_reference(X: torch.Tensor, d: torch.Tensor,
                       copies: int = 1) -> torch.Tensor:
    """Plain version of ``antidiag``: each copy's two halves of rows
    swapped (a flip of the half axis), times the row scales d (d
    first, as ``BlockAntiDiagOperator``'s chain multiplies), in d's and
    X's promoted dtype."""
    h, per_row = _swap_scales(X, d, copies)
    c = int(copies)
    Xs = X.unflatten(-2, (c, 2, h)).flip(-3)
    if per_row:
        s = d.unflatten(-1, (c, 2, h))[..., None]
    else:
        s = d[..., None, None, :, None]
    return (s * Xs).flatten(-4, -2)


def antidiag(X: torch.Tensor, d: torch.Tensor, copies: int = 1) -> torch.Tensor:
    """Y = diag(B, ..., B) X, ``copies`` copies of B = {{0, D}, {D, 0}} down
    X's rows ([n, k] or [b, n, k]): in each copy, row i of one half is d
    times row i of the other.  d: D's diagonal, one value a row of a half
    ([n / (2 copies)], or [b, ...] one a problem), or one value a row
    ([n] or [b, n]: the sharded form's row scales).  The bits of
    ``antidiag_reference``.

    CUDA tensor of real f32 or f64 (d of X's dtype): launches
    ``csrc/tail.cu``'s antidiag on the current stream, without
    synchronising, and counts it in ``antidiag.launches``; X at any
    strides.  Other dtypes on CUDA, CPU tensors, and inside
    ``chains.eager_chain()``: the plain version.
    """
    h, per_row = _swap_scales(X, d, copies)
    if eager() or X.device.type == "cpu" or not _kernel_route(X, d):
        return antidiag_reference(X, d, copies)
    _check_device("antidiag", X, d)
    b, n, k = _dims(X)
    if b > MAX_BATCH:
        raise ValueError(f"antidiag: up to {MAX_BATCH} problems, got {b}")
    if d.stride(-1) != 1:
        d = d.contiguous()
    Y = torch.empty(X.shape, dtype=X.dtype, device=X.device)
    x, y = _tall(X), _tall(Y)
    w = item_width(k, X.element_size(), [x, y])
    _launch("lobpcg_tail_antidiag", X.dtype, [
        *x, y[0], d.data_ptr(), d.stride(0) if d.dim() == 2 else 0,
        int(per_row), b, n, k, 2 * h, w, _stream(X)])
    antidiag.launches += 1
    return Y


antidiag.launches = 0


# --- residual -----------------------------------------------------------------------


def residual_reference(AX, X, lam, d=None, BX=None, copies: int = 1):
    """Plain version of ``residual``: ``get_residual``'s chain, B X (the
    anti-diagonal's ``antidiag_reference`` of X where d is given, else BX,
    else X) times lam cast to its dtype, subtracted from AX."""
    if BX is None:
        BX = X if d is None else antidiag_reference(X, d, copies)
    return AX - BX * lam[..., None, :].to(BX.dtype)


def residual(AX: torch.Tensor, X: torch.Tensor, lam: torch.Tensor,
             d: Optional[torch.Tensor] = None,
             BX: Optional[torch.Tensor] = None,
             copies: int = 1) -> torch.Tensor:
    """W = AX - (B X) diag(lam) in one pass: B the anti-diagonal of
    ``antidiag(X, d, copies)`` where d is given (X's partner rows are
    read in place), else the block BX where given, else B None (B X =
    X).  lam: [k], or [b, k] for a batch, cast to the block's dtype as
    the chain casts it.  The bits of ``residual_reference``.

    CUDA tensors of real f32 or f64 (AX, X, BX and d of one dtype):
    launches ``csrc/tail.cu``'s residual on the current stream and counts
    it in ``residual.launches``; blocks at any strides.  Other dtypes on
    CUDA, CPU tensors, and inside ``chains.eager_chain()``: the plain
    version.
    """
    if eager():
        return residual_reference(AX, X, lam, d, BX, copies)
    if d is not None and BX is not None:
        raise ValueError("residual: B is the anti-diagonal of d or the block "
                         "BX, not both")
    for T in (AX, BX):
        if T is not None and T.shape != X.shape:
            raise ValueError(f"residual: blocks of shapes {tuple(T.shape)} "
                             f"and {tuple(X.shape)}")
    h = _swap_scales(X, d, copies)[0] if d is not None else 1
    if X.device.type == "cpu" or not _kernel_route(AX, X, BX, d):
        return residual_reference(AX, X, lam, d, BX, copies)
    b, n, k = _dims(X)
    _check_device("residual", X, AX, BX, d, lam)
    if lam.shape[-1] != k or lam.dim() not in (1, 2) or (
            lam.dim() == 2 and (X.dim() != 3 or lam.shape[0] != b)):
        raise ValueError(f"residual: lam must be [{k}] or [{b}, {k}], got "
                         f"{tuple(lam.shape)}")
    if b > MAX_BATCH:
        raise ValueError(f"residual: up to {MAX_BATCH} problems, got {b}")
    lam = lam.to(X.dtype)
    if lam.stride(-1) != 1:
        lam = lam.contiguous()
    if d is not None and d.stride(-1) != 1:
        d = d.contiguous()
    Y = torch.empty(X.shape, dtype=X.dtype, device=X.device)
    ax, x, bx, y = _tall(AX), _tall(X if BX is None else None), _tall(BX), \
        _tall(Y)
    w = item_width(k, X.element_size(), [ax, x, bx, y])
    _launch("lobpcg_tail_residual", X.dtype, [
        *ax, *_tall(X), *bx,
        None if d is None else d.data_ptr(),
        d.stride(0) if d is not None and d.dim() == 2 else 0,
        int(d is not None and d.shape[-1] == n), 2 * h,
        lam.data_ptr(), lam.stride(0) if lam.dim() == 2 else 0,
        y[0], b, n, k, w, _stream(X)])
    residual.launches += 1
    return Y


residual.launches = 0


# --- combine ------------------------------------------------------------------------


def combine_reference(terms: Sequence[torch.Tensor], U=None,
                      live=None) -> torch.Tensor:
    """Plain version of ``combine``: ``b_mm``'s left-to-right sum of the
    terms, subtracted from U where given, masked by ``mask_cols`` where
    ``live`` is given."""
    S = terms[0]
    for t in terms[1:]:
        S = S + t
    if U is not None:
        S = U - S
    if live is not None:
        S = _mask(S, live)
    return S


def combine(terms: Sequence[torch.Tensor], U: Optional[torch.Tensor] = None,
            live=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """live * (U - (((t0 + t1) + t2) + t3)) in one pass over up to
    MAX_TERMS terms (the project-back GEMM outputs, summed left to right
    as ``b_mm`` sums them); without U the sum alone, without ``live`` no
    mask (``live`` as ``masking.mask_cols`` takes it: a count, [b]
    counts, or a boolean [k] / [b, k] mask).  ``out``: a contiguous block
    of the result's shape and dtype that the kernel writes into (it may
    be terms[0], the caller's scratch: each element is read before it is
    written); the result is returned, ``out`` where the kernel ran (the
    plain version leaves ``out`` alone).  The bits of
    ``combine_reference``.

    CUDA tensors of real f32 or f64 (terms and U of one dtype): launches
    ``csrc/tail.cu``'s combine on the current stream and counts it in
    ``combine.launches``; operands at any strides.  Other dtypes on
    CUDA, CPU tensors, and inside ``chains.eager_chain()``: the plain
    version.
    """
    if eager():
        return combine_reference(terms, U, live)
    terms = list(terms)
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"combine: 1 to {MAX_TERMS} terms, got {len(terms)}")
    shape = terms[0].shape
    for T in terms[1:] + [U]:
        if T is not None and T.shape != shape:
            raise ValueError(f"combine: blocks of shapes {tuple(T.shape)} "
                             f"and {tuple(shape)}")
    if terms[0].device.type == "cpu" or not _kernel_route(*terms, U):
        return combine_reference(terms, U, live)
    b, n, k = _dims(terms[0])
    _check_device("combine", *terms, U)
    if b > MAX_BATCH:
        raise ValueError(f"combine: up to {MAX_BATCH} problems, got {b}")
    if out is None:
        out = torch.empty(shape, dtype=terms[0].dtype, device=terms[0].device)
    elif (out.shape != shape or out.dtype != terms[0].dtype
          or out.device != terms[0].device or not out.is_contiguous()):
        raise ValueError("combine: out must be a contiguous block of the "
                         "result's shape, dtype and device")
    live_args, keep = _live_args(live, b, k, out.device)
    tall = [_tall(T) for T in terms]
    u, y = _tall(U), _tall(out)
    w = item_width(k, out.element_size(), tall + [u, y])
    ptrs = (ctypes.c_void_p * MAX_TERMS)(*[t[0] for t in tall])
    strides = (ctypes.c_int64 * (3 * MAX_TERMS))(
        *[s for t in tall for s in t[1:]])
    _launch("lobpcg_tail_combine", out.dtype, [
        ptrs, strides, len(terms), *u, *live_args, y[0], b, n, k, w,
        _stream(out)])
    del keep
    combine.launches += 1
    return out


combine.launches = 0


# --- compact ------------------------------------------------------------------------


def compact_reference(U: torch.Tensor, shift=0, live=None) -> torch.Tensor:
    """Plain version of ``compact``: ``masking.shift_cols``' chain, the
    column gather U[..., clamp(j + shift, 0, w - 1)] (per problem for [b]
    shifts), then ``mask_cols``; shift 0 the mask alone."""
    w = U.shape[-1]
    shift = read(shift)
    if isinstance(shift, torch.Tensor):
        ar = torch.arange(w, device=U.device)
        src = torch.clamp(ar + shift[..., None], 0, w - 1)
        out = torch.take_along_dim(U, src[..., None, :], dim=-1)
    elif int(shift) != 0:
        ar = torch.arange(w, device=U.device)
        out = U[..., torch.clamp(ar + int(shift), 0, w - 1)]
    else:
        out = U
    return _mask(out, live)


def compact(U: torch.Tensor, shift=0, live=None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[..., j] = live_j * U[..., clamp(j + shift, 0, w - 1)] in one pass:
    ``masking.shift_cols(U, shift, live)``, and with shift 0
    ``masking.mask_cols(U, live)``.  shift: an int, or [b] one a problem;
    ``live`` as ``masking.mask_cols`` takes it (required).  ``out``: a
    contiguous block of U's shape and dtype that the kernel writes into;
    with shift 0 it may be U itself (the caller's scratch: each element
    is read before it is written, by the same thread); the result is
    returned, ``out`` where the kernel ran (the plain version leaves it
    alone).  The bits of ``compact_reference``.

    CUDA tensor of real f32 or f64: launches ``csrc/tail.cu``'s compact
    on the current stream and counts it in ``compact.launches``; U at any
    strides.  Other dtypes on CUDA, CPU tensors, and inside
    ``chains.eager_chain()``: the plain version.
    """
    if live is None:
        raise ValueError("compact: live (a count, counts or a mask) is "
                         "required")
    if eager() or U.device.type == "cpu" or not _kernel_route(U):
        return compact_reference(U, shift, live)
    b, n, k = _dims(U)
    _check_device("compact", U)
    if b > MAX_BATCH:
        raise ValueError(f"compact: up to {MAX_BATCH} problems, got {b}")
    keep = []
    if isinstance(shift, torch.Tensor) and shift.dim() >= 1:
        if shift.device != U.device:
            raise ValueError("compact: shifts on another device than U")
        s = _problem_values(shift, b, "compact shifts")
        keep.append(s)
        shift_args = [s.data_ptr(), int(s.numel() > 1), 0]
    else:
        shift_args = [None, 0, int(shift)]
    live_args, kept = _live_args(live, b, k, U.device)
    shifted = shift_args[0] is not None or shift_args[2] != 0
    if out is None:
        Y = torch.empty(U.shape, dtype=U.dtype, device=U.device)
    elif (out.shape != U.shape or out.dtype != U.dtype or out.device != U.device
          or not out.is_contiguous() or (shifted and out is U)):
        raise ValueError("compact: out must be a contiguous block of U's "
                         "shape, dtype and device, and U itself only with "
                         "shift 0")
    else:
        Y = out
    u, y = _tall(U), _tall(Y)
    w = item_width(k, U.element_size(), [u, y])
    _launch("lobpcg_tail_compact", U.dtype, [
        *u, *shift_args, *live_args, y[0], b, n, k, w, _stream(U)])
    del keep, kept
    compact.launches += 1
    return Y


compact.launches = 0
