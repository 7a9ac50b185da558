"""Split-real ("realified") complex solves (port of
``lobpcg_tpu/operators/realify.py``).

A complex Hermitian pencil A z = lambda B z with A = Ar + i Ai (Ar
symmetric, Ai antisymmetric) embeds into the real symmetric pencil

    M(A) w = lambda M(B) w,   M(H) = [[Hr, -Hi], [Hi, Hr]],

of twice the dimension, with every eigenvalue doubled: if z = x + i y is
an eigenvector then w1 = [x; y] and w2 = [-y; x] both are.  Solving the
real pencil for 2*nev pairs and folding each duplicated pair back gives
the nev complex eigenpairs in real arithmetic, through the real kernels
(a realified Laplacian1D is one stencil with doubled segments, K1 in
f32 on the card).

The JAX package needs this because its TPU runtime has no complex
dtype.  Torch has complex64/128 on CUDA, so the port also solves complex
problems natively; this module gives API parity and the cross-check.
Build the complex operators on the device the solve runs on: the
realified tensors stay there.

``realify_operator`` rewrites an operator tree (real-data operators
become diag(Op, Op); complex dense/diagonal data becomes the 2x2 real
block embedding), ``realify_problem`` converts (A, B, T, X0) and the
solver config, and ``derealify`` folds a real result back to complex
eigenpairs on the host.

A batch of complex problems (a lockstep batched solve, what
``jax.vmap`` over ``realify_problem`` and the solver gives the JAX
package) realifies the same way: the realified operators take X
[b, 2n, k] with their data shared ([n, n] / [n]) or per problem
([b, n, n] / [b, n]), and ``realify_x0`` turns [b, n, k] into
[b, 2n, 2k].  ``derealify`` stays per problem (host code, never mapped
in the JAX package): pass it one problem's slice of the result.

Caveat: for complex eigenvalues of multiplicity >= 2 the folded complex
eigenvectors within the cluster may need re-orthonormalization.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from lobpcg_tpu_torch.config import SolverConfig, as_torch_dtype, real_dtype
from lobpcg_tpu_torch.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    DenseOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    LinearOperator,
)


@dataclasses.dataclass
class RealEmbeddedDenseOperator(LinearOperator):
    """M = [[Ar, -Ai], [Ai, Ar]] applied to stacked [x; y] blocks (the
    halves on dim -2, so X may be [2n, k] or a batch [b, 2n, k])."""

    Ar: torch.Tensor  # [n, n] real part (symmetric for Hermitian A), or [b, n, n]
    Ai: torch.Tensor  # [n, n] imag part (antisymmetric), or [b, n, n]

    def matmat(self, X):
        n = self.Ar.shape[-1]
        x, y = X[..., :n, :], X[..., n:, :]
        return torch.cat(
            [self.Ar @ x - self.Ai @ y, self.Ai @ x + self.Ar @ y], dim=-2
        )

    @property
    def shape(self):
        n = 2 * self.Ar.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.Ar.dtype


@dataclasses.dataclass
class RealEmbeddedDiagonalOperator(LinearOperator):
    """diag(d) with complex d, realified (di = 0 for Hermitian); the
    halves on dim -2, so X may be [2n, k] or a batch [b, 2n, k]."""

    dr: torch.Tensor  # [n], or [b, n]
    di: torch.Tensor  # [n], or [b, n]

    def matmat(self, X):
        n = self.dr.shape[-1]
        x, y = X[..., :n, :], X[..., n:, :]
        dr, di = self.dr[..., None], self.di[..., None]
        return torch.cat([dr * x - di * y, di * x + dr * y], dim=-2)

    @property
    def shape(self):
        n = 2 * self.dr.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.dr.dtype


def _is_complex(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_complex()
    return isinstance(x, complex)


def _require_real_values(x, what: str) -> None:
    """Reject genuinely complex data where the embedding rule would
    silently discard the imaginary part."""
    if not _is_complex(x):
        return
    im = x.imag
    if bool(torch.any(im != 0)) if isinstance(x, torch.Tensor) else im != 0:
        raise NotImplementedError(
            f"realify_operator: {what} has nonzero imaginary part; this "
            "embedding rule only supports real-valued data: supply the "
            "2x2 real block embedding explicitly (DenseOperator or a "
            "CallableOperator on [2n, k])"
        )


def _real(x, rdt):
    """The real part of a tensor (cast to rdt) or of a Python number."""
    if isinstance(x, torch.Tensor):
        return (x.real if x.is_complex() else x).to(rdt)
    return float(x.real)


def _leaves(obj):
    """The tensors and numbers held anywhere in an operator tree (the
    counterpart of ``jax.tree_util.tree_leaves``)."""
    if isinstance(obj, (torch.Tensor, int, float, complex)):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))


def realify_operator(op: LinearOperator, rdt=None) -> LinearOperator:
    """Real embedding of an operator acting on stacked [re; im] blocks.

    Real-data operators embed as diag(Op, Op); complex dense/diagonal
    data gets the full 2x2 block embedding.  ``rdt`` overrides the real
    dtype (e.g. torch.float32 for a complex128-specified operator solved
    in f32).
    """
    rdt = as_torch_dtype(rdt) if rdt is not None else real_dtype(op.dtype)

    if isinstance(op, DenseOperator):
        A = op.A
        if A.is_complex():
            return RealEmbeddedDenseOperator(Ar=A.real.to(rdt), Ai=A.imag.to(rdt))
        return BlockDiagOperator(inner=DenseOperator(A.to(rdt)), copies=2)

    if isinstance(op, DiagonalOperator):
        d = op.d
        if d.is_complex():
            return RealEmbeddedDiagonalOperator(dr=d.real.to(rdt), di=d.imag.to(rdt))
        return BlockDiagOperator(inner=DiagonalOperator(d.to(rdt)), copies=2)

    if isinstance(op, JacobiPreconditioner):
        # T = diag(d)^-1 with Hermitian-positive d: real by definition.
        _require_real_values(op.d, "JacobiPreconditioner.d")
        return BlockDiagOperator(
            inner=JacobiPreconditioner(_real(op.d, rdt)), copies=2
        )

    if isinstance(op, Laplacian1D):
        # Real-coefficient stencil: diag(K, K) == one stencil with doubled
        # segments over the stacked layout.
        _require_real_values(op.scale, "Laplacian1D.scale")
        return Laplacian1D(scale=_real(op.scale, rdt), n=2 * op.n,
                           segments=2 * op.segments, dtype=rdt)

    if isinstance(op, BlockAntiDiagOperator):
        # B = antidiag(D, D) applies the same D both ways, which is
        # Hermitian only for real-valued D, so the embedding is diag(B, B)
        # over the stacked [re; im] layout.  A complex dtype may only
        # carry real values here (the BdG fixture pattern).
        _require_real_values(op.d, "BlockAntiDiagOperator.d")
        return BlockDiagOperator(
            inner=BlockAntiDiagOperator(d=_real(op.d, rdt)), copies=2
        )

    # Structural wrappers: rewrite children.  Block-stacking wrappers
    # change which rows a child sees; under the global [re; im] stacking a
    # recursed complex-data child embedding would be applied to
    # [re u1; re u2] instead of its own [re; im] block.  Homogeneous
    # real-data children are safe, so stacking wrappers are allowed only
    # when every leaf in the subtree is real-valued.
    if type(op).__name__ in ("BlockDiagOperator", "BlockDiag2Operator"):
        for leaf in _leaves(op):
            _require_real_values(leaf, f"{type(op).__name__} child data")

    if dataclasses.is_dataclass(op):
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, LinearOperator):
                changes[f.name] = realify_operator(v, rdt)
        if changes:
            # Scaled/Shifted carry scalar fields that must turn real too.
            for name in ("alpha", "sigma"):
                v = getattr(op, name, None)
                if _is_complex(v):
                    _require_real_values(v, f"{type(op).__name__}.{name}")
                    changes[name] = _real(v, rdt)
            return dataclasses.replace(op, **changes)

    raise NotImplementedError(
        f"realify_operator: no embedding rule for {type(op).__name__}; "
        "wrap the real form yourself (CallableOperator on [2n, k])"
    )


def realify_x0(X0: torch.Tensor, rdt=None) -> torch.Tensor:
    """Complex [n, k] start block -> real [2n, 2k]: columns [x; y] and
    [-y; x] per complex column, spanning both copies of each eigenspace.
    A batch [b, n, k] gives [b, 2n, 2k], each problem its own block."""
    rdt = as_torch_dtype(rdt) if rdt is not None else real_dtype(X0.dtype)
    x = (X0.real if X0.is_complex() else X0).to(rdt)
    y = X0.imag.to(rdt) if X0.is_complex() else torch.zeros_like(x)
    w1 = torch.cat([x, y], dim=-2)
    w2 = torch.cat([-y, x], dim=-2)
    *lead, n, k = X0.shape
    return torch.stack([w1, w2], dim=-1).reshape(*lead, 2 * n, 2 * k)


def realify_config(config: SolverConfig) -> SolverConfig:
    """Double nev / size_sub for the duplicated spectrum."""
    return dataclasses.replace(
        config, nev=2 * config.nev, size_sub=2 * config.size_sub
    )


def realify_problem(A, X0=None, B=None, T=None, *, config: SolverConfig,
                    rdt=None):
    """Convert a complex problem to its real embedding.

    Returns (A_r, X0_r, B_r, T_r, config_r)."""
    return (
        realify_operator(A, rdt),
        realify_x0(X0, rdt) if X0 is not None else None,
        realify_operator(B, rdt) if B is not None else None,
        realify_operator(T, rdt) if T is not None else None,
        realify_config(config),
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def derealify(result, nev: int, *, tol_pair: float = 1e-3):
    """Fold a real-embedded result back to nev complex eigenpairs (host).

    Eigenvalues arrive in (approximately) duplicated pairs; each pair's
    2-dim real eigenspace corresponds to one complex eigenvector
    z = w[:n] + i w[n:].  Returns numpy (eigenvalues [nev], eigenvectors
    [n, nev] complex, residual_norms [nev]).
    """
    lam = _host(result.eigenvalues)
    V = _host(result.eigenvectors)
    res = _host(result.residual_norms)
    n = V.shape[0] // 2

    out_lam = np.empty(nev, lam.dtype)
    cdt = np.complex64 if V.dtype == np.float32 else np.complex128
    out_vec = np.empty((n, nev), cdt)
    out_res = np.empty(nev, res.dtype)

    i = 0
    broken = 0
    for j in range(nev):
        paired = i + 1 < lam.shape[0] and abs(lam[i + 1] - lam[i]) <= (
            tol_pair * (1.0 + abs(lam[i]))
        )
        if paired:
            pair_res = (
                max(res[i], res[i + 1]) if i + 1 < res.shape[0] else res[i]
            )
        else:
            # Unpaired value (unconverged solve or spurious interleaved
            # eigenvalue): emit it but advance by one so subsequent
            # genuine pairs stay in sync.
            broken += 1
            pair_res = res[i] if i < res.shape[0] else np.nan
        out_lam[j] = lam[i]
        w = V[:, i]
        z = w[:n] + 1j * w[n:]
        nz = np.linalg.norm(z)
        if nz > 0:
            z = z / nz
        out_vec[:, j] = z
        out_res[j] = pair_res
        i += 2 if paired else 1
    if broken:
        warnings.warn(
            f"derealify: {broken} eigenvalue(s) arrived without their "
            "duplicated partner (unconverged or spurious); check "
            "result.converged before trusting the folded spectrum",
            stacklevel=2,
        )
    return out_lam, out_vec, out_res
