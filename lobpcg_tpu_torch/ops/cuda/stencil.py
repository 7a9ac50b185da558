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

Two fused kernels extend K1's walk (the same source, an epilogue chosen
at compile time): ``stencil_diag``, A X = post * stencil(X) + diag * X,
the BdG well operator ``Laplacian1D + DiagonalOperator`` in one pass, and
``cheb_step``, one step of ``ChebyshevFilter`` on that operator.  Each
gives the bits of the eager chain of PyTorch operations it replaces,
which its plain version (``stencil_diag_reference``,
``cheb_step_reference``) is, operation for operation: the operator layer
(``operators/linop.py: StencilDiagonal``) sends a tree of that shape to
them and every other tree to the chain.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_SYMBOLS = {
    torch.float32: "lobpcg_stencil1d_f32",
    torch.bfloat16: "lobpcg_stencil1d_bf16",
}


_SYMBOLS_DIAG = {
    torch.float32: "lobpcg_stencil_diag_f32",
    torch.bfloat16: "lobpcg_stencil_diag_bf16",
}
_SYMBOLS_CHEB = {
    torch.float32: "lobpcg_cheb_step_f32",
    torch.bfloat16: "lobpcg_cheb_step_bf16",
}

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
# The C entry points of csrc/stencil1d.cu and their argument types (each
# returns an int cudaError_t).
SIGNATURES = {
    **{sym: [_P, _P, _P, _F, _I, _I, _I, _I, _I, _P]
       for sym in _SYMBOLS.values()},
    # X, Y, edge, diag, diag_stride, scale, post, post_b, n, k, seg_rows,
    # batch, w, stream
    **{sym: [_P, _P, _P, _P, _I, _F, _F, _P, _I, _I, _I, _I, _I, _P]
       for sym in _SYMBOLS_DIAG.values()},
    # X, y, d, y_out, d_out, edge, diag, diag_stride, scale, post, post_b,
    # c1, c1_b, c2, c2_b, first, first_b, n, k, seg_rows, batch, w, stream
    **{sym: [_P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _P, _F, _P, _F, _P, _F,
             _P, _I, _I, _I, _I, _I, _P]
       for sym in _SYMBOLS_CHEB.values()},
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


# --- the fused kernels: the BdG operator and the Chebyshev step ---------------


def host_scalar(c) -> float:
    """The f32 value with which PyTorch's CUDA elementwise operation of an
    f32 or bf16 tensor and the Python number ``c`` computes: the number's
    own f32 value, not one rounded to the tensor's dtype (torch 2.11 on
    the H100: ``X * c`` and ``c * X`` in f32 and bf16 alike)."""
    return float(torch.tensor(c, dtype=torch.float64).float())


def host_reciprocal(c) -> float:
    """The f32 factor by which PyTorch's CUDA ``X / c`` multiplies X for a
    Python number c: the f32 value of c's float64 reciprocal (torch 2.11
    on the H100, f32 and bf16: tests/test_torch_gpu.py holds the rule;
    neither X times the f32 reciprocal of f32(c) nor a true division gives
    its bits at c 4.05, the flagship's theta)."""
    c = float(c)
    return host_scalar(1.0 / c if c else math.copysign(math.inf, c))


def _coefficient(v, dtype, problems: int):
    """(f32 scalar, [problems] f32 tensor or None) a fused kernel reads
    for a coefficient of the chain: a Python number (``host_scalar``), or
    a tensor of one value or one a problem, which the chain casts to X's
    dtype (``ChebyshevFilter``'s ``coef``, ``apply_scale``)."""
    if isinstance(v, torch.Tensor):
        t = v.to(dtype).float().reshape(-1)
        if t.numel() not in (1, problems):
            raise ValueError(f"a per-problem coefficient has {t.numel()} "
                             f"values for {problems} problems")
        return 0.0, t.expand(problems).contiguous()
    return host_scalar(v), None


def _per_problem(v):
    """A coefficient as the chain broadcasts it over [b, n, k]."""
    return v.reshape(-1, 1, 1) if isinstance(v, torch.Tensor) else v


def _check_fused(X, diag, edge_rows, num_segments, problems, post):
    _check_args(X, edge_rows, num_segments)
    rows = X.shape[0]
    if problems < 1 or rows % problems or num_segments % problems:
        raise ValueError(f"{problems} problems do not split {rows} rows in "
                         f"{num_segments} segments into whole segments")
    if edge_rows is not None and _problems(edge_rows) != problems:
        raise ValueError(f"edge rows for {_problems(edge_rows)} problems, "
                         f"X holds {problems}")
    n = rows // problems
    if diag.shape[-1] != n or diag.dim() not in (1, 2) or (
            diag.dim() == 2 and diag.shape[0] != problems):
        raise ValueError(f"diag must be [{n}] or [{problems}, {n}], got "
                         f"{tuple(diag.shape)}")
    if isinstance(post, torch.Tensor) and post.numel() not in (1, problems):
        raise ValueError(f"post has {post.numel()} values for {problems} "
                         f"problems")


def stencil_diag_reference(X, scale, diag, edge_rows=None, *, num_segments=1,
                           post=None, problems=1):
    """Plain version of ``stencil_diag``: the eager chain of
    ``SumOperator(Laplacian1D, DiagonalOperator).matmat`` on X [rows, k]
    of ``problems`` problems, each operation of the chain in its order:
    the stencil (K1's plain version), times ``post`` (``ScaledOperator``'s
    number, or ``apply_scale``'s per-problem [b] scales cast to X's
    dtype), plus ``diag`` ([n] shared, or [b, n]) times X."""
    _check_fused(X, diag, edge_rows, num_segments, problems, post)
    rows, k = X.shape
    shape = (problems, rows // problems, k)
    Y = stencil_matmat_reference(X, scale, edge_rows,
                                 num_segments=num_segments).view(shape)
    if isinstance(post, torch.Tensor):
        Y = Y * _per_problem(post.to(Y.dtype))
    elif post is not None:
        Y = post * Y
    return (Y + diag.unsqueeze(-1) * X.reshape(shape)).reshape(rows, k)


def _fused_device_checks(what, X, diag, *blocks):
    if X.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {X.device}")
    if X.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: kernel takes f32/bf16, got {X.dtype}")
    for B in (X, *blocks):
        if B is not None and not B.is_contiguous():
            raise ValueError(f"{what}: blocks must be contiguous")
        if B is not None and (B.dtype, B.shape) != (X.dtype, X.shape):
            raise ValueError(f"{what}: blocks must all be X's dtype and shape")
    if diag.dtype != X.dtype or diag.device != X.device:
        raise TypeError(f"{what}: diag must be X's dtype, on X's device")


def _diag_args(diag):
    """The diagonal as the kernel reads it: unit stride along its rows,
    and its problems' stride (0 for one shared diagonal)."""
    if diag.stride(-1) != 1:
        diag = diag.contiguous()
    return diag, diag.stride(0) if diag.dim() == 2 else 0


def stencil_diag(
    X: torch.Tensor,
    scale: float,
    diag: torch.Tensor,
    edge_rows: Optional[torch.Tensor] = None,
    *,
    num_segments: int = 1,
    post=None,
    problems: int = 1,
) -> torch.Tensor:
    """Y = post * (scale * tridiag[-1, 2, -1] X per row segment) + diag * X
    on X [rows, k] of ``problems`` problems of rows / problems rows each
    (``diag`` [n] shared or [problems, n]; ``post`` None, a number, or
    one value a problem; ``edge_rows`` [2, k] for one problem or
    [problems, 2, k]), with the bits of the eager chain
    ``stencil_diag_reference``.

    CUDA tensor: launches ``csrc/stencil1d.cu``'s stencil_diag on the
    current stream (f32 or bf16, contiguous, any k; one grid row a
    problem), without synchronising, and counts the launch in
    ``stencil_diag.launches``; anything the kernel does not take raises.
    CPU tensor: the plain version.
    """
    _check_fused(X, diag, edge_rows, num_segments, problems, post)
    if X.device.type == "cpu":
        return stencil_diag_reference(X, scale, diag, edge_rows,
                                      num_segments=num_segments, post=post,
                                      problems=problems)
    _fused_device_checks("stencil_diag", X, diag)
    if problems > MAX_BATCH:
        raise ValueError(f"stencil_diag: up to {MAX_BATCH} problems, got "
                         f"{problems}")
    if edge_rows is not None:
        edge_rows = edge_rows.to(X.dtype).contiguous()
    diag, diag_stride = _diag_args(diag)
    post_f, post_b = _coefficient(1.0 if post is None else post, X.dtype,
                                  problems)
    n, k = X.shape
    Y = torch.empty_like(X)
    ptrs = [X.data_ptr(), Y.data_ptr()]
    if edge_rows is not None:
        ptrs.append(edge_rows.data_ptr())
    lib = _lib()
    with torch.cuda.device(X.device):
        code = getattr(lib, _SYMBOLS_DIAG[X.dtype])(
            X.data_ptr(), Y.data_ptr(), _ptr(edge_rows), diag.data_ptr(),
            diag_stride, float(scale), post_f, _ptr(post_b), n, k,
            n // num_segments, problems,
            items_per_load(k, X.element_size(), *ptrs),
            torch.cuda.current_stream().cuda_stream)
    stencil_diag.launches += 1
    check(lib, code, "stencil_diag launch")
    return Y


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def cheb_step_reference(X, y, d, scale, diag, c1, c2, edge_rows=None, *,
                        num_segments=1, post=None, problems=1, theta=None,
                        last=False):
    """Plain version of ``cheb_step``: one step of
    ``ChebyshevFilter._apply`` on X [rows, k] of ``problems`` problems as
    its eager chain computes it, A = ``stencil_diag_reference``'s
    operator: d' = c1 d + c2 (X - A y), y' = y + d'; returns (y', d'),
    d' None for the ``last`` step.  ``theta`` given: the first step, y = d
    = X / theta (y and d None; ``edge_rows`` are then y's, X's halo rows
    over theta).  The coefficients are the chain's: numbers, or one value
    a problem of X's dtype."""
    _check_fused(X, diag, edge_rows, num_segments, problems, post)
    rows, k = X.shape
    shape = (problems, rows // problems, k)
    X3 = X.reshape(shape)
    if theta is not None:
        y = d = (X3 / _per_problem(theta)).reshape(rows, k)
    Ay = stencil_diag_reference(y, scale, diag, edge_rows,
                                num_segments=num_segments, post=post,
                                problems=problems).view(shape)
    d = _per_problem(c1) * d.reshape(shape) + _per_problem(c2) * (X3 - Ay)
    y = y.reshape(shape) + d
    return y.view(rows, k), None if last else d.view(rows, k)


def cheb_step(X, y, d, scale, diag, c1, c2, edge_rows=None, *,
              num_segments=1, post=None, problems=1, theta=None, last=False,
              overwrite_d=False):
    """One Chebyshev step in one pass, with the bits of
    ``cheb_step_reference``: reads X, y (with its rows above and below,
    ``edge_rows`` outside each problem) and d, writes y' and, unless
    ``last``, d'.  The first step (``theta`` given, y and d None) reads X
    only and forms y = d = X / theta in the kernel: for a number theta as
    the chain divides by a host number (``host_reciprocal``), for
    per-problem ones as it divides by a tensor.  ``overwrite_d``: d is
    the caller's scratch, and the kernel writes d' (or, on the last
    step, y') over it: each element of d is read only by the thread that
    writes that element, so a filter holds one block fewer.

    CUDA tensor: launches ``csrc/stencil1d.cu``'s cheb_step on the
    current stream and counts it in ``cheb_step.launches``; anything the
    kernel does not take raises.  CPU tensor: the plain version.
    """
    _check_fused(X, diag, edge_rows, num_segments, problems, post)
    if (theta is None) == (y is None) or (y is None) != (d is None):
        raise ValueError("cheb_step: the first step takes theta and no y, d; "
                         "a later one y and d and no theta")
    if X.device.type == "cpu":
        return cheb_step_reference(X, y, d, scale, diag, c1, c2, edge_rows,
                                   num_segments=num_segments, post=post,
                                   problems=problems, theta=theta, last=last)
    _fused_device_checks("cheb_step", X, diag, y, d)
    if problems > MAX_BATCH:
        raise ValueError(f"cheb_step: up to {MAX_BATCH} problems, got "
                         f"{problems}")
    if edge_rows is not None:
        edge_rows = edge_rows.to(X.dtype).contiguous()
    diag, diag_stride = _diag_args(diag)
    dt = X.dtype
    post_f, post_b = _coefficient(1.0 if post is None else post, dt, problems)
    c1_f, c1_b = _coefficient(c1, dt, problems)
    c2_f, c2_b = _coefficient(c2, dt, problems)
    first_f, first_b = 1.0, None
    if isinstance(theta, torch.Tensor):
        first_f, first_b = _coefficient(theta, dt, problems)
    elif theta is not None:
        first_f = host_reciprocal(theta)
    n, k = X.shape
    reuse = overwrite_d and d is not None
    y_out = d if reuse and last else torch.empty_like(X)
    d_out = None if last else d if reuse else torch.empty_like(X)
    ptrs = [B.data_ptr() for B in (X, y, d, y_out, d_out, edge_rows)
            if B is not None]
    lib = _lib()
    with torch.cuda.device(X.device):
        code = getattr(lib, _SYMBOLS_CHEB[dt])(
            X.data_ptr(), _ptr(y), _ptr(d), y_out.data_ptr(), _ptr(d_out),
            _ptr(edge_rows), diag.data_ptr(), diag_stride, float(scale),
            post_f, _ptr(post_b), c1_f, _ptr(c1_b), c2_f, _ptr(c2_b), first_f,
            _ptr(first_b), n, k, n // num_segments, problems,
            items_per_load(k, X.element_size(), *ptrs),
            torch.cuda.current_stream().cuda_stream)
    cheb_step.launches += 1
    check(lib, code, "cheb_step launch")
    return y_out, d_out


stencil_diag.launches = 0
cheb_step.launches = 0
