"""The tall projection Y = live * (U - sum_i V_i C_i) of real f32 blocks
V_i [n, w_i] and the coefficients C [sum_i w_i, m]: the hand-written
CUDA kernel ``csrc/proj.cu`` and its plain PyTorch version.

It replaces no TPU kernel: the JAX package leaves these contractions to
XLA's dot at ``Precision.HIGHEST`` and lets XLA fuse the sum, the
subtraction and the mask around them; the port ran one cuBLAS GEMM a term
(``torch.matmul``, an sm80 SIMT kernel at about 45% of the card's FFMA
peak) and summed the tall blocks they wrote in a ``tail.combine`` pass.
The kernel gives each block a slab of rows and all m output columns,
each thread an 8 x 8 register tile, stages the terms' columns and C's
rows through shared memory by ``cp.async``, and applies the sum, U - sum
and the mask in registers: no term block is written.  Every product is an
f32 FFMA, each term one FFMA chain over its K in order, the chains added
left to right as combine adds the GEMM outputs.

``project`` takes any projection (``ops/gram.py``'s ``b_mm``,
``b_mm_update`` and ``mm_masked`` are calls of it): it launches the kernel
for operands on the card that ``takes`` accepts (tall enough, at the
widths where the kernel beat cuBLAS), runs the library chain the kernel
replaced (``library``: a GEMM a term, then ``tail.combine`` passes, or
``tail.compact`` after one masked GEMM) for every other projection, and
runs the plain version ``project_reference`` (``mm`` a term, then
``tail.combine_reference``: the eager chain) inside
``chains.eager_chain()``.  ``launch`` is the kernel alone, for the
measurements that time it outside that route.  ``plan`` chooses the
launch's shape from m alone (csrc/proj.cu says how).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch

from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library
from lobpcg_tpu_torch.ops.cuda.chains import eager, mm
from lobpcg_tpu_torch.ops.cuda.gram import MIN_ROWS

MAX_THREADS = 256  # threads a block (csrc/proj.cu: kMaxThreads)
STAGES = 4  # shared-memory stages (kStages)
MAX_TERMS = tail.MAX_TERMS  # terms of one launch (kMaxTerms)
PAD = 4  # K a stage holds beyond its bk: a term's rest of up to 4 (kPad)
MAX_M = 168  # output columns: one block's 2 hn, 21 threads of 8 columns
STAGE_BYTES = 56 * 1024  # bytes of a stage at most: 4 stages fit 227 KB
# Terms a combine pass of the library chain sums before the next GEMM: as
# many tall blocks as the eager chain held at once (the running sum, a
# term and their sum).
COMBINE_GROUP = 3

_P, _I = ctypes.c_void_p, ctypes.c_int64
# The C entry point of csrc/proj.cu and its argument types (it returns
# an int cudaError_t).
SIGNATURES = {
    "lobpcg_proj_sgemm_f32": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                              _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


@functools.cache
def _lib():
    """The built library with its entry point's ctypes signature."""
    return load_library("proj", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("proj")


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's shape: blocks of 8 tms rows and 2 hn columns (2 hn - 8 <
    m <= 2 hn), run by tms x hn / 4 threads of 8 x 8 outputs, bk of K a
    stage."""

    hn: int
    tms: int
    bk: int

    @property
    def threads(self) -> int:
        return self.tms * (self.hn // 4)

    @property
    def rows(self) -> int:
        return 8 * self.tms

    def stage_bytes(self) -> int:
        """V's rows and C's, bk + PAD of K each."""
        return 4 * (self.rows + 2 * self.hn) * (self.bk + PAD)


@functools.lru_cache(maxsize=256)
def plan(m: int) -> Plan:
    """The tile for m output columns: 2 hn of them, the fewest that hold m
    in 8-column thread tiles, and as many rows of threads as MAX_THREADS
    allows, halved until a stage fits STAGE_BYTES.  bk, the K a stage: 8
    up to m 24, else the largest of 32, 16, 8 whose stage fits at those
    threads (measured on the card at [4M, 64] x 3: 2.92 ms at 32, 3.14 at
    16, 3.90 at 8; at [4M, 16] x 3, 8 and 16 alike)."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"tall projection: m must be in [1, {MAX_M}], got {m}")
    hn = 4 * -(-m // 8)
    tms = MAX_THREADS // (hn // 4)
    bk = 8 if m <= 24 else next(b for b in (32, 16, 8)
                                if Plan(hn, tms, b).stage_bytes() <= STAGE_BYTES)
    while Plan(hn, tms, bk).stage_bytes() > STAGE_BYTES:
        tms //= 2
    return Plan(hn, tms, bk)


def vector_width(tensors: Sequence[torch.Tensor], widths: Sequence[int]) -> int:
    """Floats a copy moves: the widest of 4, 2, 1 that divides every row
    stride, every width and every base (in floats)."""
    for w in (4, 2, 1):
        if (all(t.stride(0) % w == 0 and t.data_ptr() % (4 * w) == 0
                for t in tensors) and all(k % w == 0 for k in widths)):
            return w
    return 1


def _live_kind(live) -> Optional[str]:
    """The kernel's form of a live mask: "none", "count" (an int, or a 0-d
    integer tensor on the device), "mask" (a boolean [m]); None for a form
    it does not take ([b] counts and [b, m] masks, which make mask_cols's
    result [b, n, m])."""
    if live is None:
        return "none"
    if isinstance(live, torch.Tensor):
        if live.dtype == torch.bool:
            return "mask" if live.dim() == 1 else None
        if live.is_floating_point() or live.is_complex():
            return None
        return "count" if live.dim() == 0 else None
    return "count"


def _fits(blocks: Sequence[torch.Tensor], C: torch.Tensor,
          U: Optional[torch.Tensor] = None, live=None) -> bool:
    """Can the kernel run live * (U - sum_i blocks_i C_i), by shape, dtype
    and layout?  1 to MAX_TERMS 2-D real f32 blocks of the same rows, C
    [sum of their widths, m] with m in [1, MAX_M], U None or [n, m], every
    column stride 1 and every row stride at least the width; ``live``
    None, a count, or a boolean [m]."""
    if not 1 <= len(blocks) <= MAX_TERMS or C.dim() != 2:
        return False
    n, (K, m) = blocks[0].shape[0], C.shape
    tall = list(blocks) + ([] if U is None else [U])
    if not (1 <= m <= MAX_M and n >= 1 and C.dtype == torch.float32
            and C.stride(1) == 1 and C.stride(0) >= m
            and K == sum(b.shape[-1] for b in blocks)):
        return False
    for T in tall:
        if (T.dim() != 2 or T.dtype != torch.float32 or T.shape[0] != n
                or T.shape[1] < 1 or T.stride(1) != 1 or T.stride(0) < T.shape[1]):
            return False
    if U is not None and U.shape[1] != m:
        return False
    kind = _live_kind(live)
    return kind is not None and (kind != "mask" or live.shape[0] == m)


def _widths(m: int) -> bool:
    """Output widths m at which csrc/proj.cu ran faster than cuBLAS's
    GEMMs plus combine on the card (three terms at 4M rows,
    ``tools/proj_widths.py``, PERF.md's projection row): 4 to 128, and 161
    to 168, where the tile of the 4M x 150 solve's 164 is fixed at compile
    time.  From 129 to 160 the generic tile ran 3-9% slower than cuBLAS
    (m 129: 23.9 against 23.0 ms; 150: 23.6 against 23.2)."""
    return 4 <= m <= 128 or 160 < m <= MAX_M


def takes(blocks: Sequence[torch.Tensor], C: torch.Tensor,
          U: Optional[torch.Tensor] = None, live=None) -> bool:
    """Does ``project`` launch the kernel for these operands on the card?
    Operands of n >= MIN_ROWS rows that the kernel can run (``_fits``), at
    an m it wins at (``_widths``): by shape, dtype and layout alone, the
    device being ``project``'s check."""
    return (blocks[0].shape[-2] >= MIN_ROWS and _fits(blocks, C, U, live)
            and _widths(C.shape[1]))


def project_reference(blocks: Sequence[torch.Tensor], C: torch.Tensor,
                      U: Optional[torch.Tensor] = None, live=None) -> torch.Tensor:
    """Plain version: ``mm`` a term, then ``tail.combine_reference`` (the
    sum left to right, U - sum, the mask): the eager chain of ``b_mm``,
    ``b_mm_update`` and ``mm_masked``."""
    terms, j = [], 0
    for b in blocks:
        w = b.shape[-1]
        terms.append(mm(b, C[..., j:j + w, :]))
        j += w
    return tail.combine_reference(terms, U, live)


def library(blocks: Sequence[torch.Tensor], C: torch.Tensor,
            U: Optional[torch.Tensor] = None, live=None,
            in_place: bool = True) -> torch.Tensor:
    """The library chain the kernel replaced, each pass a wrapper that
    takes its own route: one ``mm`` (cuBLAS on the card) a term, summed
    left to right in ``tail.combine`` passes of up to COMBINE_GROUP terms,
    the last one also forming live * (U - sum); one term with a mask and
    no U is ``mm_masked``'s GEMM and a ``tail.compact`` pass.
    ``in_place``: each pass may write over the GEMM output it reads (where
    contiguous)."""
    if len(blocks) == 1 and U is None and live is not None:
        T = mm(blocks[0], C)
        return tail.compact(T, 0, live, out=T if in_place else None)
    acc, j = [], 0
    for i, b in enumerate(blocks):
        w = b.shape[-1]
        acc.append(mm(b, C[..., j:j + w, :]))
        j += w
        if len(acc) == COMBINE_GROUP and i < len(blocks) - 1:
            acc = [_combine(acc, in_place=in_place)]
    return _combine(acc, U, live, in_place)


def _combine(terms, U=None, live=None, in_place=True):
    if len(terms) == 1 and U is None and live is None:
        return terms[0]
    t0 = terms[0]
    out = t0 if in_place and t0.is_contiguous() else None
    return tail.combine(terms, U, live, out=out)


def _live_args(live, m: int, device):
    """(mask, count_ptr, count, kind) for the C entry point, and the
    tensors they point into."""
    kind = _live_kind(live)
    if kind == "none":
        return [None, None, 0, 0], ()
    if kind == "mask":
        if live.device != device:
            raise ValueError("tall projection: the live mask on another device")
        mk = live.contiguous().view(torch.uint8)
        return [mk.data_ptr(), None, 0, 2], (mk,)
    if isinstance(live, torch.Tensor):
        if live.device != device:
            raise ValueError("tall projection: the live count on another device")
        c = live.to(torch.int64).reshape(1)
        return [None, c.data_ptr(), 0, 1], (c,)
    return [None, None, max(-1, min(int(live), m + 1)), 1], ()


def project(blocks: Sequence[torch.Tensor], C: torch.Tensor,
            U: Optional[torch.Tensor] = None, live=None,
            in_place: bool = True) -> torch.Tensor:
    """Y = live * (U - sum_i blocks_i @ C[rows_i]), term i's rows of C
    following term i - 1's; without U the sum, without ``live`` no mask
    (``live`` as ``masking.mask_cols`` takes it).  ``in_place``: as
    ``library`` takes it.

    Operands on the card that ``takes`` accepts: one launch of the kernel.
    Any other operands: ``library`` (CPU tensors run its passes' plain
    versions), counted on the card in ``project.fallbacks``.  Inside
    ``chains.eager_chain()``: ``project_reference``.  Terms, C and U on
    two devices raise.
    """
    blocks = list(blocks)
    if not blocks:
        raise ValueError("tall projection: no terms")
    dev = C.device
    if any(T.device != dev for T in blocks + ([] if U is None else [U])):
        raise ValueError("tall projection: operands on one device")
    if eager():
        return project_reference(blocks, C, U, live)
    if dev.type == "cuda":
        if takes(blocks, C, U, live):
            return _launch(blocks, C, U, live)
        project.fallbacks += 1
    return library(blocks, C, U, live, in_place)


def launch(blocks: Sequence[torch.Tensor], C: torch.Tensor,
           U: Optional[torch.Tensor] = None, live=None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel alone, whatever ``takes`` says: Y [n, m] as ``project``
    forms it (``live`` a count, as an int or a 0-d tensor, or a boolean
    [m]), launched on the current stream without synchronising and
    counted in ``project.launches``.  ``out``: a contiguous [n, m] f32
    block the kernel writes into (none of the operands); the result is
    returned.  Operands off the card, or ones the kernel cannot run
    (``_fits``), raise."""
    blocks = list(blocks)
    dev = C.device
    if not blocks or dev.type != "cuda" or any(
            T.device != dev for T in blocks + ([] if U is None else [U])):
        raise ValueError("tall projection: operands on one CUDA device")
    if not _fits(blocks, C, U, live):
        raise ValueError(
            f"tall projection: the kernel takes 1 to {MAX_TERMS} [n, w] real "
            f"f32 blocks, C [sum w, m <= {MAX_M}], U [n, m] or None, column "
            f"stride 1, and a count or a boolean [m] live mask; got "
            f"{[(tuple(b.shape), b.dtype, b.stride()) for b in blocks]}, C "
            f"{tuple(C.shape)} {C.dtype} {C.stride()}, U "
            f"{None if U is None else (tuple(U.shape), U.dtype, U.stride())}")
    return _launch(blocks, C, U, live, out)


def _launch(blocks, C, U, live, out=None, p: Optional[Plan] = None):
    """One launch of csrc/proj.cu into ``out`` (allocated where None)
    with plan p (``plan(m)`` where None), counted in ``project.launches``;
    the callers check the operands (``tools/proj_widths.py --tune`` times
    other plans)."""
    n, m = blocks[0].shape[0], C.shape[1]
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=C.device)
    elif (out.shape != (n, m) or out.dtype != torch.float32
          or out.device != C.device or not out.is_contiguous()):
        raise ValueError("tall projection: out must be a contiguous [n, m] f32 "
                         "block on the operands' device")
    p = p or plan(m)
    widths = [b.shape[1] for b in blocks]
    w = vector_width(list(blocks) + [C, out] + ([] if U is None else [U]),
                     widths + [m])
    live_args, keep = _live_args(live, m, out.device)
    pad = MAX_TERMS - len(blocks)
    ptrs = (ctypes.c_void_p * MAX_TERMS)(*[b.data_ptr() for b in blocks], *[None] * pad)
    lds = (ctypes.c_int64 * MAX_TERMS)(*[b.stride(0) for b in blocks], *[0] * pad)
    ws = (ctypes.c_int64 * MAX_TERMS)(*widths, *[0] * pad)
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lobpcg_proj_sgemm_f32(
            ptrs, lds, ws, len(blocks), C.data_ptr(), C.stride(0),
            None if U is None else U.data_ptr(), 0 if U is None else U.stride(0),
            *live_args, out.data_ptr(), out.stride(0), n, m, p.hn, p.tms, p.bk,
            w, stream)
    del keep
    check(lib, code, "tall projection launch")
    project.launches += 1
    return out


project.launches = 0
project.fallbacks = 0
