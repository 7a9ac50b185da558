"""Fused 7-point 3-D Dirichlet Laplacian SpMM: the hand-written CUDA
kernel ``csrc/stencil3d.cu`` and its plain PyTorch version.

Port of the TPU kernel ``lobpcg_tpu/ops/pallas/stencil3d.py:
stencil3d_matmat_pallas``: Y = scale * (6 X - the six grid neighbours)
on the flat C-order [nx*ny*nz, k] block, every neighbour outside the
grid zero; or on a batch [b, nx*ny*nz, k] of such blocks, each problem
its own grid (the map ``jax.vmap`` makes of the Pallas kernel), in one
launch.

``stencil3d_matmat`` launches the kernel for a CUDA tensor and runs the
plain version ``stencil3d_matmat_reference`` only for a CPU tensor.  The
kernel takes any grid with nx, ny, nz >= 1 and any k >= 1 (the TPU
gates ``nz % 8``, ``k % 128`` and the VMEM budget are facts of the TPU),
f32, and bf16 with f32 arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_SYMBOLS = {
    torch.float32: "lobpcg_stencil3d_f32",
    torch.bfloat16: "lobpcg_stencil3d_bf16",
}


# The C entry points of csrc/stencil3d.cu and their argument types (each
# returns an int cudaError_t).
SIGNATURES = {
    sym: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
          ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
          ctypes.c_void_p]
    for sym in _SYMBOLS.values()
}


@functools.cache
def _lib():
    """The built library with its entry points' ctypes signatures."""
    return load_library("stencil3d", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("stencil3d")


def _check_args(X, grid_shape):
    if len(grid_shape) != 3 or min(grid_shape) < 1:
        raise ValueError(f"stencil3d_matmat: grid_shape must be 3 sizes >= 1, "
                         f"got {grid_shape}")
    if X.dim() not in (2, 3) or X.shape[-1] < 1:
        raise ValueError(f"stencil3d_matmat: X must be [n, k] or [b, n, k], "
                         f"got {tuple(X.shape)}")
    if X.shape[-2] != math.prod(grid_shape):
        raise ValueError(f"stencil3d_matmat: X has {X.shape[-2]} rows, grid "
                         f"{grid_shape} has {math.prod(grid_shape)} points")


def lap_along(Xg: torch.Tensor, axis: int) -> torch.Tensor:
    """tridiag[-1, 2, -1] along `axis` of a grid-shaped array (Dirichlet):
    the pad/slice formula of ``lobpcg_tpu/operators/stencil_nd.py:
    _lap_along``, (2 X - X[+1]) - X[-1]."""
    n = Xg.shape[axis]
    Xp = torch.nn.functional.pad(Xg, (0, 0) * (Xg.dim() - 1 - axis) + (1, 1))
    return 2.0 * Xg - Xp.narrow(axis, 2, n) - Xp.narrow(axis, 0, n)


def stencil3d_matmat_reference(
    X: torch.Tensor, scale: float, grid_shape: tuple[int, int, int]
) -> torch.Tensor:
    """Plain version: scale times the sum of the three separable passes,
    ((axis 0 + axis 1) + axis 2), as the JAX package's separable
    ``LaplacianND`` computes it; a batch [b, n, k] passes along the grid
    axes after its leading one.  Any dtype; bf16 computes in f32 and
    rounds once, as the kernel does."""
    _check_args(X, grid_shape)
    out_dtype = X.dtype
    shape = X.shape
    if X.dtype == torch.bfloat16:
        X = X.float()
    lead = shape[:-2]
    Xg = X.reshape(*lead, *grid_shape, shape[-1])
    Y = lap_along(Xg, len(lead)) + lap_along(Xg, len(lead) + 1)
    Y = Y + lap_along(Xg, len(lead) + 2)
    return (scale * Y).reshape(shape).to(out_dtype)


def stencil3d_matmat(
    X: torch.Tensor, scale: float, grid_shape: tuple[int, int, int]
) -> torch.Tensor:
    """Y = scale * (7-point Dirichlet Laplacian) X on a 3-D grid; X is
    [n, k], or [b, n, k] for b problems on the same grid.

    CUDA tensor: launches ``csrc/stencil3d.cu`` on the current stream
    (f32 or bf16, contiguous, any grid and k, the whole batch in one
    launch), without synchronising, and counts the launch in
    ``stencil3d_matmat.launches``; anything the kernel does not take
    raises.  CPU tensor: the plain version.
    """
    _check_args(X, grid_shape)
    if X.device.type == "cpu":
        return stencil3d_matmat_reference(X, scale, grid_shape)
    if X.device.type != "cuda":
        raise ValueError(f"stencil3d_matmat: unsupported device {X.device}")
    if X.dtype not in KERNEL_DTYPES:
        raise TypeError(f"stencil3d_matmat: kernel takes f32/bf16, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("stencil3d_matmat: X must be contiguous")
    lib = _lib()
    nx, ny, nz = (int(g) for g in grid_shape)
    batch = X.shape[0] if X.dim() == 3 else 1
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, _SYMBOLS[X.dtype])(
            X.data_ptr(), Y.data_ptr(), float(scale), batch, nx, ny, nz,
            X.shape[-1], stream,
        )
    stencil3d_matmat.launches += 1
    check(lib, code, "stencil3d launch")
    return Y


stencil3d_matmat.launches = 0
