"""N-dimensional Dirichlet Laplacian stencils on 1-, 2- and 3-D grids
(port of ``lobpcg_tpu/operators/stencil_nd.py``).

Dispatch is on the grid's rank and the block's dtype, as in
``Laplacian1D``: a 3-D grid in f32/bf16 goes through the fused 7-point
kernel (``ops/cuda/stencil3d.py``, K2); 1-D and 2-D grids in f32/bf16
take one separable pass per axis through the segmented 1-D stencil
kernel (``ops/cuda/stencil.py``, K1); f64 and complex take the plain
pad/slice formula.  Each wrapper runs its plain version for a CPU
tensor.  Matches ``operators.sparse.laplacian_3d_csr`` numerically.

A batched X [b, n, k] (a lockstep batched solve) shares the grid and
the scale, as ``jax.vmap`` shares an unmapped operand: a 3-D grid is one
K2 launch over the batch; on a 1-D or 2-D grid the batch is a leading
grid axis that is never stenciled, so each axis pass is one K1 launch
for the batch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops.cuda import stencil3d as k2
from lobpcg_tpu_torch.ops.cuda.stencil import KERNEL_DTYPES, stencil_matmat
from lobpcg_tpu_torch.ops.cuda.stencil3d import lap_along


def _axis_pass(X: torch.Tensor, grid, axis: int, k: int,
               force_jnp: bool = False) -> torch.Tensor:
    """tridiag[-1, 2, -1] along one grid axis of flattened X ([n, k] or
    [b, n, k]), returned in X's shape: K1 on the
    [b * prod(grid[:axis+1]), rest * k] view, one segment per line along
    the axis (b * rows / grid[axis] of them).  (The JAX package's VMEM
    gate on the view's width is a TPU fact and is dropped.)"""
    lead = tuple(X.shape[:-2])
    rows = math.prod(lead) * math.prod(grid[: axis + 1])
    width = (math.prod(grid) // math.prod(grid[: axis + 1])) * k
    if not force_jnp and X.dtype in KERNEL_DTYPES:
        return stencil_matmat(
            X.reshape(rows, width), 1.0, num_segments=rows // grid[axis]
        ).reshape(X.shape)
    return lap_along(X.reshape(*lead, *grid, k),
                     len(lead) + axis).reshape(X.shape)


@dataclasses.dataclass
class LaplacianND(LinearOperator):
    """Dirichlet Laplacian on a structured grid, flattened C-order.

    grid: (nx,) / (nx, ny) / (nx, ny, nz); n = prod(grid).
    scale: 1/h^2 (uniform spacing), a Python float; ``dtype`` the
    operator's dtype.  Eigenvalues are sums of per-axis
    4*scale*sin^2(k*pi/(2*(n_axis+1))) terms (``laplacian_nd_eigs``).
    ``force_jnp`` (the JAX package's name, kept for API parity) selects
    the plain formula for every dtype.  X is [n, k], or [b, n, k] for b
    problems on this grid and scale (see the module docstring).
    """

    scale: float
    grid: tuple = ()
    force_jnp: bool = False
    dtype: torch.dtype = torch.float32

    def matmat(self, X):
        k = X.shape[-1]
        grid = tuple(int(g) for g in self.grid)
        use_kernels = not self.force_jnp and X.dtype in KERNEL_DTYPES
        if use_kernels:
            X = X.contiguous()
            if len(grid) == 3:
                return k2.stencil3d_matmat(X, self.scale, grid)
        Y = None
        for ax in range(len(grid)):
            p = _axis_pass(X, grid, ax, k, force_jnp=not use_kernels)
            Y = p if Y is None else Y + p
        return (self.scale * Y).reshape(X.shape)

    @property
    def shape(self):
        n = math.prod(self.grid)
        return (n, n)


def laplacian_nd_eigs(grid, scale: float, count: int) -> np.ndarray:
    """The `count` smallest exact eigenvalues of LaplacianND."""
    per_axis = [
        4.0 * scale * np.sin(np.arange(1, n + 1) * np.pi / (2 * (n + 1))) ** 2
        for n in grid
    ]
    acc = per_axis[0]
    for a in per_axis[1:]:
        acc = (acc[:, None] + a[None, :]).ravel()
        acc = np.sort(acc)[: max(count * 4, 64)]  # keep the low tail only
    return np.sort(acc)[:count]
