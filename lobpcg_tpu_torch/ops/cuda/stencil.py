"""Segmented 1-D tridiagonal stencil SpMM: the hand-written CUDA kernel
``csrc/stencil1d.cu`` and its plain PyTorch version.

Port of the TPU kernel ``lobpcg_tpu/ops/pallas/stencil.py:
stencil_matmat_pallas``: Y = scale * (2 X - X[i-1] - X[i+1]) on each of
``num_segments`` equal row segments of an [n, k] block, with no coupling
across segment edges (Dirichlet).  ``edge_rows`` ([2, k], optional)
replaces the zeros above row 0 and below row n-1; a batched table
[b, 2, k] treats X as b problems of n / b rows each (each a whole number
of segments) and gives each problem its own pair: the halos of a
row-sharded lockstep batch (``parallel/spmd_stencil.py``), one launch for
the batch.

``stencil_matmat`` launches the kernel for a CUDA tensor and runs the
plain version ``stencil_matmat_reference`` only for a CPU tensor.  The
kernel takes any k >= 1 (the TPU gate ``k % 128 == 0`` is a fact about
TPU lanes), any element-aligned base (a row slice ``X[1:]`` included),
f32, and bf16 with f32 arithmetic, all at its streaming rate through one
design (the header of ``csrc/stencil1d.cu``): X's flat run of n * k
elements in items of up to one 16-byte vector.  The item width is chosen
here, by ``items_per_load``, so that the CPU tests can check it; the
kernel checks it again and refuses one that does not hold.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_SYMBOLS = {
    torch.float32: "lobpcg_stencil1d_f32",
    torch.bfloat16: "lobpcg_stencil1d_bf16",
}


# The C entry points of csrc/stencil1d.cu and their argument types (each
# returns an int cudaError_t).
SIGNATURES = {
    sym: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
          ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
          ctypes.c_int64, ctypes.c_void_p]
    for sym in _SYMBOLS.values()
}

THREADS = 256  # threads a block (csrc/stencil1d.cu: kThreads)
# The problems the batched edge form takes (kMaxBatch: one grid row a
# problem).
MAX_BATCH = 65535
# X bytes a thread loads before it computes, in at most MAX_ITEMS items
# (kBytesInFlight, kMaxItems).
BYTES_IN_FLIGHT, MAX_ITEMS = 32, 8


def items_per_load(k: int, itemsize: int, *ptrs: int) -> int:
    """Elements the kernel loads and stores at once (an item): the largest
    power of two up to one 16-byte vector that divides k and puts every
    base in ``ptrs`` (X, Y and the edge rows' addresses) on an item
    boundary.  An item never straddles two rows."""
    w = 16 // itemsize
    while w > 1 and (k % w or any(p % (w * itemsize) for p in ptrs)):
        w //= 2
    return w


def items_per_thread(w: int, itemsize: int) -> int:
    """Items a thread loads before it computes: BYTES_IN_FLIGHT of X, in
    at most MAX_ITEMS."""
    return min(BYTES_IN_FLIGHT // (w * itemsize), MAX_ITEMS)


@functools.cache
def _lib():
    """The built library with its entry points' ctypes signatures."""
    return load_library("stencil1d", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record
    (path, whether nvcc ran, its seconds and output)."""
    _lib()
    return build_record("stencil1d")


def _check_args(X, edge_rows, num_segments):
    if X.dim() != 2:
        raise ValueError(f"stencil_matmat: X must be [n, k], got {tuple(X.shape)}")
    n, k = X.shape
    if n < 1 or k < 1:
        raise ValueError(f"stencil_matmat: empty block {tuple(X.shape)}")
    if num_segments < 1 or n % num_segments:
        raise ValueError(
            f"stencil_matmat: n={n} not divisible by num_segments={num_segments}"
        )
    if edge_rows is not None:
        b = _problems(edge_rows)
        if tuple(edge_rows.shape[-2:]) != (2, k) or edge_rows.dim() not in (2, 3):
            raise ValueError(
                f"stencil_matmat: edge_rows must be [2, {k}] or [b, 2, {k}], "
                f"got {tuple(edge_rows.shape)}"
            )
        if b < 1 or n % b or num_segments % b:
            raise ValueError(
                f"stencil_matmat: {b} problems' edge rows do not split n={n} "
                f"rows in {num_segments} segments into whole segments")
        if edge_rows.device != X.device:
            raise ValueError("stencil_matmat: edge_rows on another device than X")


def _problems(edge_rows) -> int:
    """The problems an edge table serves: b of [b, 2, k], 1 of [2, k]."""
    return edge_rows.shape[0] if edge_rows.dim() == 3 else 1


def stencil_matmat_reference(
    X: torch.Tensor,
    scale: float,
    edge_rows: Optional[torch.Tensor] = None,
    *,
    num_segments: int = 1,
) -> torch.Tensor:
    """Plain version: the pad/slice formula of ``lobpcg_tpu/operators/
    linop.py`` (Laplacian1D fallback) plus ``edge_rows``, once a problem
    for a batched edge table.  Any dtype; bf16 computes in f32 and rounds
    once, as the kernel does."""
    _check_args(X, edge_rows, num_segments)
    if edge_rows is not None and edge_rows.dim() == 3:
        b = edge_rows.shape[0]
        return torch.cat([
            stencil_matmat_reference(x, scale, e, num_segments=num_segments // b)
            for x, e in zip(X.chunk(b), edge_rows)])
    n, k = X.shape
    out_dtype = X.dtype
    if X.dtype == torch.bfloat16:
        X = X.float()
    Xs = X.reshape(num_segments, n // num_segments, k)
    Xp = torch.nn.functional.pad(Xs, (0, 0, 1, 1))
    if edge_rows is not None:
        Xp[0, 0] = edge_rows[0].to(X.dtype)
        Xp[-1, -1] = edge_rows[1].to(X.dtype)
    Y = scale * (2.0 * Xs - Xp[:, 2:] - Xp[:, :-2])
    return Y.reshape(n, k).to(out_dtype)


def stencil_matmat(
    X: torch.Tensor,
    scale: float,
    edge_rows: Optional[torch.Tensor] = None,
    *,
    num_segments: int = 1,
) -> torch.Tensor:
    """Y = scale * tridiag[-1, 2, -1] X per row segment, with the edge
    rows ([2, k], or [b, 2, k] one pair a problem) outside X's ends or
    each problem's.

    CUDA tensor: launches ``csrc/stencil1d.cu`` on the current stream
    (f32 or bf16, contiguous, any k), without synchronising, and counts
    the launch in ``stencil_matmat.launches``; anything the kernel does
    not take raises.  CPU tensor: the plain version.
    """
    _check_args(X, edge_rows, num_segments)
    if X.device.type == "cpu":
        return stencil_matmat_reference(
            X, scale, edge_rows, num_segments=num_segments
        )
    if X.device.type != "cuda":
        raise ValueError(f"stencil_matmat: unsupported device {X.device}")
    if X.dtype not in KERNEL_DTYPES:
        raise TypeError(f"stencil_matmat: kernel takes f32/bf16, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("stencil_matmat: X must be contiguous")
    if edge_rows is not None:
        edge_rows = edge_rows.to(X.dtype).contiguous()
    n, k = X.shape
    if edge_rows is not None and _problems(edge_rows) > MAX_BATCH:
        raise ValueError(f"stencil_matmat: the batched edge form takes up to "
                         f"{MAX_BATCH} problems, got {_problems(edge_rows)}")
    Y = torch.empty_like(X)
    ptrs = [X.data_ptr(), Y.data_ptr()]
    if edge_rows is not None:
        ptrs.append(edge_rows.data_ptr())
    code = launch(X, Y, scale, edge_rows, n // num_segments,
                  items_per_load(k, X.element_size(), *ptrs),
                  batch=1 if edge_rows is None else _problems(edge_rows))
    stencil_matmat.launches += 1
    check(_lib(), code, "stencil1d launch")
    return Y


def launch(X, Y, scale, edge_rows, seg_rows: int, w: int,
           batch: int = 1) -> int:
    """One launch of the kernel on CUDA tensors X, Y (and edge_rows, of
    X's dtype: [2, k], or [batch, 2, k] for X of ``batch`` problems) in
    items of ``w`` elements; returns the cudaError_t.  It counts no
    launch and checks no argument: ``stencil_matmat`` does, and the
    kernel refuses a ``w`` that does not hold."""
    lib = _lib()
    n, k = X.shape
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        return getattr(lib, _SYMBOLS[X.dtype])(
            X.data_ptr(), Y.data_ptr(),
            None if edge_rows is None else edge_rows.data_ptr(),
            float(scale), n, k, seg_rows, batch, w, stream,
        )


stencil_matmat.launches = 0
