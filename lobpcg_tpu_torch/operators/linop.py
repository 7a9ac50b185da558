"""Matrix-free linear operators on [n, k] blocks (port of
``lobpcg_tpu/operators/linop.py``).

Operators are plain classes with ``matmat``, ``shape`` and ``dtype``;
their tensor fields live on the device the solve runs on.  The JAX
package's pytree registration has no role in torch and is dropped.

Batched blocks (a lockstep batched solve, ``solvers/lobpcg.py``): the
operators of this module take X as [b, n, k] too.  Their data may carry
a leading batch dimension, one problem each (``DenseOperator.A``
[b, n, n], ``DiagonalOperator.d`` / ``JacobiPreconditioner.d`` /
``BlockAntiDiagOperator.d`` [b, n], ``Laplacian1D.scale`` [b],
``CallableOperator.args`` marked by ``in_axes``); data without one is
shared by the whole batch, as ``jax.vmap`` shares an unmapped operand.
So do ``LaplacianND``, ``BSROperator``, the realified operators and the
sharded forms of ``parallel/`` (each rank's rows [b, n_loc, k]).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable

import torch

from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.cuda.stencil import (
    KERNEL_DTYPES,
    cheb_step,
    stencil_diag,
    stencil_matmat,
    stencil_matmat_reference,
)


class LinearOperator(abc.ABC):
    """Protocol: a Hermitian (or general) linear operator on [n, k] blocks."""

    @abc.abstractmethod
    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Apply the operator to a block of column vectors: Y = Op @ X."""

    @property
    @abc.abstractmethod
    def shape(self) -> tuple[int, int]:
        ...

    @property
    @abc.abstractmethod
    def dtype(self) -> torch.dtype:
        ...

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return self.matmat(X)

    def apply_width_ok(self, k: int) -> bool:
        """Does applying at block width k run this operator's fast path?

        The JAX package asks this for TPU lane economics (its kernels
        need 128-lane multiples, so two width-64 applies are packed into
        one).  The Hopper kernels take any width, so every operator
        answers True and ``ops.gram`` never packs.
        """
        del k
        return True

    # --- composition sugar -------------------------------------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator(self, other)

    def __mul__(self, scalar) -> "LinearOperator":
        return ScaledOperator(self, scalar)

    __rmul__ = __mul__

    def __matmul__(self, other: "LinearOperator") -> "LinearOperator":
        return ComposedOperator(self, other)


@dataclasses.dataclass
class DenseOperator(LinearOperator):
    """Dense matrix operator."""

    A: torch.Tensor  # [n, n], or [b, n, n]

    def matmat(self, X):
        return torch.matmul(self.A, X)

    @property
    def shape(self):
        return tuple(self.A.shape[-2:])

    @property
    def dtype(self):
        return self.A.dtype


@dataclasses.dataclass
class DiagonalOperator(LinearOperator):
    """Diagonal operator."""

    d: torch.Tensor  # [n], or [b, n]

    def matmat(self, X):
        return self.d.unsqueeze(-1) * X

    def row_scales(self) -> torch.Tensor:
        """d: this operator scales X's rows (``stencil_and_diagonals``)."""
        return self.d

    @property
    def shape(self):
        n = self.d.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype


@dataclasses.dataclass
class JacobiPreconditioner(LinearOperator):
    """T = diag(d)^{-1}; the standard preconditioner shape for LOBPCG."""

    d: torch.Tensor  # [n] diagonal of A (or an approximation), or [b, n]

    def matmat(self, X):
        return X / self.d.unsqueeze(-1)

    @property
    def shape(self):
        n = self.d.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype


@dataclasses.dataclass
class CallableOperator(LinearOperator):
    """Matrix-free operator from a user-supplied block function
    ``fn(X, *args) -> Y`` with X, Y of shape [n, k].

    A batched X [b, n, k] calls ``fn`` once per problem on its [n, k]
    block, as ``jax.vmap`` maps ``fn``, and stacks the results.
    ``in_axes`` says, per entry of ``args``, what ``jax.vmap``'s
    ``in_axes`` would: 0 for a tensor mapped over its leading dimension
    (problem i sees ``arg[i]``), None for an argument every problem
    shares.  ``in_axes`` None shares every argument."""

    args: Any
    fn: Callable = None
    n: int = 0
    _dtype: Any = torch.float32
    in_axes: Any = None

    def matmat(self, X):
        if X.dim() == 2:
            return self.fn(X, *self.args)
        args = tuple(self.args)
        axes = (None,) * len(args) if self.in_axes is None \
            else tuple(self.in_axes)
        if len(axes) != len(args) or any(a not in (0, None) for a in axes):
            raise ValueError(f"CallableOperator: in_axes {self.in_axes} must "
                             f"give 0 or None for each of the {len(args)} "
                             f"args")
        b = X.shape[0]
        for a, ax in zip(args, axes):
            if ax == 0 and not (isinstance(a, torch.Tensor) and a.dim() >= 1
                                and a.shape[0] == b):
                raise ValueError(f"CallableOperator: a mapped argument must "
                                 f"be a tensor of leading size {b}")
        return torch.stack([
            self.fn(X[i], *(a[i] if ax == 0 else a
                            for a, ax in zip(args, axes)))
            for i in range(b)])

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype


def apply_scale(stencil, scale):
    """``stencil(scale)`` for a float ``scale``; for a [b] tensor of
    per-problem scales, ``stencil(1.0)`` (a batch [b, n, k]) times each
    problem's scale: one broadcast multiply after the stencil."""
    if isinstance(scale, torch.Tensor) and scale.dim() == 1:
        Y = stencil(1.0)
        return Y * scale.to(Y.dtype)[:, None, None]
    return stencil(scale)


@dataclasses.dataclass
class Laplacian1D(LinearOperator):
    """Segmented 1-D Dirichlet Laplacian: block-diag of `segments`
    independent tridiag[-1, 2, -1] * scale stencils (scale = 1/h^2).

    ``scale`` is a Python float (read once, never per apply), or a [b]
    tensor of per-problem scales for a batch, and ``dtype`` the
    operator's dtype.  Dispatch is on the block's device and dtype only:
    f32/bf16 go through ``stencil_matmat`` (the CUDA kernel for a CUDA
    tensor, its plain version for a CPU tensor); other dtypes (f64,
    complex) take the plain pad/slice formula, as the JAX package does
    for dtypes its kernel does not take.  A batched X [b, n, k] is one
    [b*n, k] block of b*segments segments: one launch for the batch (a
    [b] scale is one broadcast multiply after it, at scale 1).
    ``pad_lanes`` is accepted for API parity and ignored: it padded
    widths to 128 TPU lanes, and the Hopper kernel takes any width.
    """

    scale: float
    n: int = 0
    segments: int = 1
    pad_lanes: bool = False
    dtype: torch.dtype = torch.float32

    def matmat(self, X):
        if X.dim() == 2:
            return self._apply(X, self.scale, self.segments)
        b, n, k = X.shape
        return apply_scale(lambda s: self._apply(
            X.reshape(b * n, k), s, b * self.segments).reshape(b, n, k),
            self.scale)

    @staticmethod
    def _apply(X, scale, segments):
        if X.dtype in KERNEL_DTYPES:
            return stencil_matmat(X.contiguous(), scale,
                                  num_segments=segments)
        return stencil_matmat_reference(X, scale, num_segments=segments)

    def stencil_frame(self, X, send_map=None):
        """The stencil's launch on X ([n, k] or a batch [b, n, k]): (X as
        one contiguous [rows, k] block, its segments, its edge rows (none:
        Dirichlet zeros), its problems), a batch folded over b * segments
        segments as ``matmat`` folds it.  ``send_map`` (the rows a sharded
        form sends its neighbours) has nothing to act on here."""
        del send_map
        b = X.shape[0] if X.dim() == 3 else 1
        return X.reshape(-1, X.shape[-1]).contiguous(), b * self.segments, \
            None, b

    @property
    def shape(self):
        return (self.n, self.n)


@dataclasses.dataclass
class BlockDiagOperator(LinearOperator):
    """A = diag(K, K, ..., K): `copies` stacked copies of `inner`."""

    inner: LinearOperator
    copies: int = 2

    def apply_width_ok(self, k):
        return self.inner.apply_width_ok(k)

    def matmat(self, X):
        swap = half_swap(self, X)
        if swap is not None:
            return tail.antidiag(X, *swap)
        m = self.inner.shape[0]
        parts = [
            self.inner.matmat(X[..., i * m : (i + 1) * m, :])
            for i in range(self.copies)
        ]
        return torch.cat(parts, dim=-2)

    def half_swap(self):
        """(d, copies) of copies of a BlockAntiDiagOperator (the
        split-real B), else None."""
        if isinstance(self.inner, BlockAntiDiagOperator):
            return self.inner.d, int(self.copies)
        return None

    @property
    def shape(self):
        n = self.inner.shape[0] * self.copies
        return (n, n)

    @property
    def dtype(self):
        return self.inner.dtype


@dataclasses.dataclass
class BlockDiag2Operator(LinearOperator):
    """diag(top, bottom) with distinct blocks (the BdG pencil's A =
    diag(M, K), ``physics/bdg.py``)."""

    top: LinearOperator
    bottom: LinearOperator

    def matmat(self, X):
        m = self.top.shape[0]
        return torch.cat(
            [self.top.matmat(X[..., :m, :]), self.bottom.matmat(X[..., m:, :])],
            dim=-2,
        )

    @property
    def shape(self):
        n = self.top.shape[0] + self.bottom.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.top.dtype


@dataclasses.dataclass
class BlockAntiDiagOperator(LinearOperator):
    """B = {{0, D}, {D, 0}} with D = diag(d): swaps halves and scales.
    A batched X swaps the halves of each problem (dim -2)."""

    d: torch.Tensor  # [m], n = 2m; or [b, m]

    def matmat(self, X):
        swap = half_swap(self, X)
        if swap is not None:
            return tail.antidiag(X, *swap)
        m = self.d.shape[-1]
        d = self.d.unsqueeze(-1)
        top = d * X[..., m:, :]
        bot = d * X[..., :m, :]
        return torch.cat([top, bot], dim=-2)

    def half_swap(self):
        """(d, 1): this B as one copy of the half swap."""
        return self.d, 1

    @property
    def shape(self):
        n = 2 * self.d.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype


@dataclasses.dataclass
class ShiftedOperator(LinearOperator):
    """op + sigma * I."""

    op: LinearOperator
    sigma: Any

    def apply_width_ok(self, k):
        return self.op.apply_width_ok(k)

    def matmat(self, X):
        return self.op.matmat(X) + self.sigma * X

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype


@dataclasses.dataclass
class ScaledOperator(LinearOperator):
    op: LinearOperator
    alpha: Any

    def apply_width_ok(self, k):
        return self.op.apply_width_ok(k)

    def matmat(self, X):
        return self.alpha * self.op.matmat(X)

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype


@dataclasses.dataclass
class SumOperator(LinearOperator):
    left: LinearOperator
    right: LinearOperator

    def apply_width_ok(self, k):
        return self.left.apply_width_ok(k) and self.right.apply_width_ok(k)

    def matmat(self, X):
        fused = stencil_diagonal(self)
        if fused is not None and fused.takes(X):
            return fused.matmat(X)
        return self.left.matmat(X) + self.right.matmat(X)

    @property
    def shape(self):
        return self.left.shape

    @property
    def dtype(self):
        return self.left.dtype


@dataclasses.dataclass
class ComposedOperator(LinearOperator):
    outer: LinearOperator
    inner: LinearOperator

    def apply_width_ok(self, k):
        return self.outer.apply_width_ok(k) and self.inner.apply_width_ok(k)

    def matmat(self, X):
        return self.outer.matmat(self.inner.matmat(X))

    @property
    def shape(self):
        return (self.outer.shape[0], self.inner.shape[1])

    @property
    def dtype(self):
        return self.outer.dtype


# --- the anti-diagonal B as one kernel pass -------------------------------------


def half_swap(op, X):
    """(d, copies) with which ``tail.antidiag(X, d, copies)`` applies the
    operator ``op`` to X: a BlockAntiDiagOperator, copies of one (the
    split-real B) or the sharded form whose rows are a local permutation
    (its ``half_swap`` method says); None for any other operator, and
    for per-problem scales [b, .] over an unbatched X (the chain's
    broadcast).  Inside ``chains.eager_chain()`` ``tail.antidiag`` runs
    its plain version, which has the bits of these operators' ``matmat``
    bodies."""
    found = getattr(op, "half_swap", lambda: None)() if op is not None else None
    if found is None or (found[0].dim() == 2 and X.dim() != 3):
        return None
    return found


# --- the BdG operator as one kernel pass ----------------------------------------


def stencil_and_diagonals(op):
    """(stencil, alpha, [d, ...]) of a sum of one segmented 1-D stencil (a
    node with ``stencil_frame``: Laplacian1D, parallel.SpmdLaplacian1D),
    plain (alpha None) or in a ScaledOperator by the number alpha, and
    diagonals (nodes with ``row_scales``: DiagonalOperator,
    parallel.LocalRows of one); None for any other tree."""
    terms, todo = [], [op]
    while todo:
        o = todo.pop()
        if isinstance(o, SumOperator):
            todo += [o.right, o.left]
        else:
            terms.append(o)
    stencils, diags = [], []
    for t in terms:
        if hasattr(t, "stencil_frame"):
            stencils.append((t, None))
        elif isinstance(t, ScaledOperator) and hasattr(t.op, "stencil_frame") \
                and isinstance(t.alpha, (int, float)):
            stencils.append((t.op, t.alpha))
        elif getattr(t, "row_scales", lambda: None)() is not None:
            diags.append(t.row_scales())
        else:
            return None
    if len(stencils) != 1:
        return None
    (st, alpha), = stencils
    return st, alpha, diags


@dataclasses.dataclass
class StencilDiagonal:
    """A = post * S + diag(d), S one segmented 1-D stencil at ``scale``:
    the BdG well operator ``Laplacian1D + DiagonalOperator`` (and its
    sharded form), found in an operator tree by ``stencil_diagonal``.  Its
    apply is one ``stencil_diag`` launch and each step of a Chebyshev
    filter on it one ``cheb_step`` launch, each with the bits of the eager
    chain it replaces (the kernels' plain versions are that chain; a CPU
    tensor runs them).  ``post``: None, ScaledOperator's number, or a
    Laplacian's per-problem [b] scales (the stencil then at scale 1, as
    ``apply_scale`` runs it)."""

    stencil: LinearOperator
    scale: float
    post: Any
    d: torch.Tensor

    def takes(self, X, *coefficients) -> bool:
        """Whether X and the per-problem ``coefficients`` (a filter's
        numbers or tensors) run the fused kernels: f32 or bf16 with the
        diagonal's dtype, on its device; per-problem data (a [b, n]
        diagonal, [b] scales or coefficients) only over a batch X
        [b, n, k] with one value a problem (or one for all)."""
        d = self.d
        if X.dtype not in KERNEL_DTYPES or X.dim() not in (2, 3) or \
                d.dtype != X.dtype or d.device != X.device or \
                d.shape[-1] != X.shape[-2] or d.dim() not in (1, 2):
            return False
        b = X.shape[0] if X.dim() == 3 else None
        if d.dim() == 2 and d.shape[0] != b:
            return False
        return all(b is not None and v.numel() in (1, b)
                   for v in (self.post, *coefficients)
                   if isinstance(v, torch.Tensor))

    def matmat(self, X):
        Xf, segments, edge, b = self.stencil.stencil_frame(X)
        return stencil_diag(Xf, self.scale, self.d, edge,
                            num_segments=segments, post=self.post,
                            problems=b).view(X.shape)

    def chebyshev(self, X, theta, steps):
        """``ChebyshevFilter``'s y on X: one cheb_step launch a step
        (c1, c2) of ``steps``, the first forming y = d = X / theta in the
        kernel, each later one writing its d' (the last its y') over d.
        A sharded stencil's halos are y's; the first step's are X's rows
        over theta, which its neighbours send."""
        y = d = Xf = None
        last = len(steps) - 1
        for i, (c1, c2) in enumerate(steps):
            if i == 0:
                Xf, segments, edge, b = self.stencil.stencil_frame(
                    X, lambda rows: rows / theta)
            else:
                y, segments, edge, b = self.stencil.stencil_frame(
                    y.view(X.shape))
            y, d = cheb_step(Xf, y, d, self.scale, self.d, c1, c2, edge,
                             num_segments=segments, post=self.post,
                             problems=b, theta=theta if i == 0 else None,
                             last=i == last, overwrite_d=True)
        return y.view(X.shape)


def stencil_diagonal(op):
    """The StencilDiagonal of ``op`` when its tree is one Laplacian1D or
    parallel.SpmdLaplacian1D (plain, or a ScaledOperator by a number) plus
    one DiagonalOperator (or parallel.LocalRows of one); None for any
    other tree (several diagonals, a realified diagonal, a sharded
    stencil asked for its plain formula, a scaled per-problem scale)."""
    found = stencil_and_diagonals(op)
    if found is None or len(found[2]) != 1:
        return None
    st, alpha, (d,) = found
    if getattr(st, "pallas", "auto") == "off":
        return None
    if isinstance(st.scale, torch.Tensor) and st.scale.dim() == 1:
        if alpha is not None:
            return None
        return StencilDiagonal(st, 1.0, st.scale, d)
    return StencilDiagonal(st, st.scale, alpha, d)
