"""Chebyshev approximate-inverse preconditioner (port of
``lobpcg_tpu/operators/chebyshev.py``).

T = p(A) ~ A^{-1} via the Chebyshev semi-iteration for A y = x over
[lo, hi] (Saad, Iterative Methods, Alg. 12.1): `degree - 1` operator
applications per T-apply, and p stays positive on [lo, hi], so T is an
SPD preconditioner.  When the operator is the BdG well's
``Laplacian1D + DiagonalOperator`` (or its sharded form) in f32 or bf16,
each step is one kernel pass (``ops/cuda/stencil.py: cheb_step``) with
the bits of the chain of operations below.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from lobpcg_tpu_torch.operators.linop import LinearOperator, stencil_diagonal


@dataclasses.dataclass
class ChebyshevFilter(LinearOperator):
    """T ~ A^{-1} on [lo, hi] by `degree` Chebyshev-iteration steps.

    ``lo`` / ``hi`` are Python floats, or [b] tensors of per-problem
    bounds for a batched X [b, n, k] (a sweep over the interval, as
    ``jax.vmap`` maps these data fields).  ``chunk``: apply the (linear)
    recurrence to one contiguous column chunk of that width at a time,
    which bounds the recurrence's ~4 live blocks to [n, chunk] each.
    """

    op: LinearOperator
    lo: float
    hi: float
    degree: int = 8
    chunk: int = 0  # 0 = whole block at once

    def apply_width_ok(self, k):
        return self.op.apply_width_ok(k)

    def matmat(self, X):
        k = X.shape[-1]
        if self.chunk and self.chunk < k and k % self.chunk == 0:
            Y = torch.empty_like(X)
            for j in range(0, k, self.chunk):
                Y[..., j : j + self.chunk] = self._apply(
                    X[..., j : j + self.chunk].contiguous()
                )
            return Y
        return self._apply(X)

    def _coefficients(self, X):
        """(theta, [(c1, c2), ...]): the first step's y = d = X / theta
        and each of the `degree - 1` steps' d = c1 d + c2 (X - A y), as the
        recurrence gives them: Python floats for float bounds, [b, 1, 1]
        tensors of X's dtype for per-problem ones."""
        lo, hi = self.lo, self.hi
        if any(isinstance(v, torch.Tensor) and v.dim() == 1 for v in (lo, hi)):
            # Per-problem bounds: the recurrence's scalars in float64, as
            # Python computes them for float bounds, cast to X's dtype
            # and broadcast over each problem's block.
            lo, hi = (torch.as_tensor(v, dtype=torch.float64,
                                      device=X.device).reshape(-1, 1, 1)
                      for v in (lo, hi))

            def coef(c):
                return c.to(X.dtype)
        else:
            def coef(c):
                return c
        theta = (hi + lo) / 2.0
        delta = (hi - lo) / 2.0
        sigma1 = theta / delta

        rho = 1.0 / sigma1
        steps = []
        for _ in range(self.degree - 1):
            rho_next = 1.0 / (2.0 * sigma1 - rho)
            steps.append((coef(rho_next * rho), coef(2.0 * rho_next / delta)))
            rho = rho_next
        return coef(theta), steps

    def _apply(self, X):
        theta, steps = self._coefficients(X)
        # A = Laplacian1D + DiagonalOperator (or its sharded form): each
        # step one kernel pass (operators/linop.py: StencilDiagonal).
        fused = stencil_diagonal(self.op) if steps else None
        if fused is not None and fused.takes(X, theta, *itertools.chain(*steps)):
            return fused.chebyshev(X, theta, steps)
        d = X / theta
        y = d
        for c1, c2 in steps:
            d = c1 * d + c2 * (X - self.op.matmat(y))
            y = y + d
        return y

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype
