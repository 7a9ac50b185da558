"""Place a LOBPCG problem on a row mesh (port of
``lobpcg_tpu/parallel/sharding.py``).

In the JAX package the sharding rides on the arrays, and XLA inserts the
collectives an operator needs.  The port has no partitioner: each
operator class gets an explicit sharded form that takes and returns this
rank's rows and keeps the global ``shape``:

| Operator | Sharded form |
|---|---|
| DiagonalOperator, JacobiPreconditioner | ``LocalRows``: the local slice |
| Laplacian1D | ``SpmdLaplacian1D`` (halo exchange + K1) |
| BlockDiagOperator of Laplacian1D (+ diagonals) | one segmented stencil, then as above |
| LaplacianND | ``SpmdLaplacianND`` (plane exchange + the unsharded operator) |
| Sum/Scaled/Shifted/Composed, ChebyshevFilter | the same node over sharded children |
| DenseOperator | ``RowPanelOperator``: row panel times all-gathered X |
| BlockAntiDiagOperator | ``ShardedBlockAntiDiagOperator``: a swap with rank (r + nd/2) % nd |
| BlockDiagOperator of BlockAntiDiagOperator (realified B) | ``ShardedBlockAntiDiagOperator`` with ``copies``: one half swap inside each copy |
| RealEmbeddedDiagonalOperator | ``LocalRows`` of [dr; dr] plus ``ShardedBlockAntiDiagOperator`` of [-di; di] |
| RealEmbeddedDenseOperator | ``RowPanelOperator``: this rank's rows of [[Ar, -Ai], [Ai, Ar]] |
| BSROperator | ``ShardedBSROperator`` (edge-band halo + K6/K5, else K3 on the frame) |

Any other class raises ``NotImplementedError``: no operator computes a
wrong product in silence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lobpcg_tpu_torch.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu_torch.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    ComposedOperator,
    DenseOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    LinearOperator,
    ScaledOperator,
    ShiftedOperator,
    SumOperator,
)
from lobpcg_tpu_torch.operators.realify import (
    RealEmbeddedDenseOperator,
    RealEmbeddedDiagonalOperator,
)
from lobpcg_tpu_torch.operators.sparse import BSROperator
from lobpcg_tpu_torch.operators.stencil_nd import LaplacianND
from lobpcg_tpu_torch.parallel.mesh import (
    RowMesh,
    all_gather_rows,
    replicated,
    row_sharding,
    swap,
)
from lobpcg_tpu_torch.parallel.spmd_bsr import ShardedBSROperator
from lobpcg_tpu_torch.parallel.spmd_stencil import (
    SpmdLaplacian1D,
    SpmdLaplacianND,
    unroll_block_diag,
    use_spmd_stencils,
)


def _shardable(x: torch.Tensor, n_shards: int) -> bool:
    return x.dim() >= 1 and x.shape[0] % n_shards == 0 and x.shape[0] >= n_shards


def shard_array(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of ``x`` (the whole of ``x`` when its leading
    dimension does not divide over the ranks), on the mesh's device."""
    if _shardable(x, mesh.size):
        return row_sharding(mesh, x.dim()).local(x)
    return replicated(mesh).local(x)


def _rows_of(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of an operator's [n, ...] data; raises when n
    does not divide over the ranks (a replicated copy would compute
    another operator)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} operator rows do not divide over "
                         f"{mesh.size} ranks")
    return row_sharding(mesh, x.dim()).local(x)


@dataclasses.dataclass
class LocalRows(LinearOperator):
    """A row-local operator (a diagonal or Jacobi operator) holding this
    rank's rows only; ``shape`` stays the global (n, n)."""

    op: LinearOperator
    n: int = 0
    mesh: RowMesh = None

    def matmat(self, X):
        return self.op.matmat(X)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.op.dtype


@dataclasses.dataclass
class RowPanelOperator(LinearOperator):
    """A DenseOperator's rows of this rank ([n_loc, n]) times the
    all-gathered global block."""

    A: torch.Tensor
    mesh: RowMesh = None

    def matmat(self, X):
        return torch.matmul(self.A, all_gather_rows(self.mesh, X))

    @property
    def shape(self):
        n = self.A.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.A.dtype


def _ranks_per_copy(nd: int, copies: int, what: str) -> int:
    """p, the ranks one of ``copies`` half-swapped copies spans over nd
    ranks (1 when a rank holds whole copies); raises unless p is 1 or
    even."""
    if nd % copies == 0:
        p = nd // copies
    elif copies % nd == 0:
        p = 1
    else:
        raise NotImplementedError(
            f"{what}: {copies} copies over {nd} ranks; one of the two must "
            "divide the other")
    if p > 1 and p % 2:
        raise NotImplementedError(
            f"{what} over {nd} ranks: the half swap pairs rank r with the "
            f"rank {p}/2 away inside its copy, so the ranks a copy spans "
            f"({p}) must be even in number")
    return p


@dataclasses.dataclass
class ShardedBlockAntiDiagOperator(LinearOperator):
    """diag(B, ..., B), ``copies`` copies of B = {{0, D}, {D, 0}}, over a
    row mesh (one copy is BlockAntiDiagOperator, two are its split-real
    form).  Each copy's half swap, then a scale by this rank's rows ``d``
    of the row scales ([d; d] per copy).  A copy spans p = nd / copies
    ranks: at p = 1 every rank holds whole copies and swaps them
    locally; at an even p rank r swaps with the rank p/2 away inside its
    copy (one batch of a send and a receive); anything else raises."""

    d: torch.Tensor
    n: int = 0
    mesh: RowMesh = None
    copies: int = 1

    @classmethod
    def shard(cls, op: BlockAntiDiagOperator, mesh: RowMesh, copies: int = 1):
        c = int(copies)
        return cls.place(torch.cat([op.d, op.d]).repeat(c), mesh, c,
                         type(op).__name__)

    @classmethod
    def place(cls, scale: torch.Tensor, mesh: RowMesh, copies: int = 1,
              what: str = "BlockAntiDiagOperator"):
        """From the global row scales ``scale`` [n] (applied after the
        swap)."""
        _ranks_per_copy(mesh.size, int(copies), what)
        return cls(d=_rows_of(scale, mesh), n=scale.shape[0], mesh=mesh,
                   copies=int(copies))

    def matmat(self, X):
        nd, c = self.mesh.size, self.copies
        p = _ranks_per_copy(nd, c, "BlockAntiDiagOperator")
        if p == 1:
            m = self.n // (2 * c)
            k = X.shape[1]
            Xs = X.reshape(-1, 2, m, k).flip(1).reshape(X.shape)
            return self.d[:, None] * Xs
        r = self.mesh.rank
        partner = r - r % p + (r % p + p // 2) % p
        return self.d[:, None] * swap(self.mesh, X, partner)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.d.dtype


_SHARDED = (SpmdLaplacian1D, SpmdLaplacianND, ShardedBSROperator, LocalRows,
            RowPanelOperator, ShardedBlockAntiDiagOperator)


def _embedded_rows(Ar: torch.Tensor, Ai: torch.Tensor,
                   mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of [[Ar, -Ai], [Ai, Ar]], built from the rows of
    Ar and Ai it needs (the [2n, 2n] embedding is never formed)."""
    nr = Ar.shape[0]
    if (2 * nr) % mesh.size:
        raise ValueError(f"{2 * nr} operator rows do not divide over "
                         f"{mesh.size} ranks")
    n_loc = 2 * nr // mesh.size
    r0, r1 = mesh.rank * n_loc, (mesh.rank + 1) * n_loc
    parts = []
    if r0 < nr:
        top = slice(r0, min(r1, nr))
        parts.append(torch.cat([Ar[top], -Ai[top]], dim=1))
    if r1 > nr:
        bot = slice(max(r0, nr) - nr, r1 - nr)
        parts.append(torch.cat([Ai[bot], Ar[bot]], dim=1))
    return torch.cat(parts).to(mesh.device)


def shard_operator(op, mesh: RowMesh):
    """The sharded form of every node of an operator tree (the table of
    the module docstring); raises NotImplementedError on any other
    class."""
    if isinstance(op, _SHARDED):
        if op.mesh is not mesh:
            raise ValueError(f"{type(op).__name__} is sharded over another mesh")
        return op
    if isinstance(op, (DiagonalOperator, JacobiPreconditioner)):
        n = op.d.shape[0]
        return LocalRows(type(op)(_rows_of(op.d, mesh)), n=n, mesh=mesh)
    if isinstance(op, BlockAntiDiagOperator):
        return ShardedBlockAntiDiagOperator.shard(op, mesh)
    if isinstance(op, DenseOperator):
        return RowPanelOperator(_rows_of(op.A, mesh), mesh=mesh)
    if isinstance(op, RealEmbeddedDenseOperator):
        return RowPanelOperator(_embedded_rows(op.Ar, op.Ai, mesh), mesh=mesh)
    if isinstance(op, RealEmbeddedDiagonalOperator):
        # [[dr, -di], [di, dr]] = diag([dr; dr]) + diag([-di; di]) times
        # the half swap of the stacked [re; im] rows.
        dr, di = op.dr, op.di
        return SumOperator(
            LocalRows(DiagonalOperator(_rows_of(torch.cat([dr, dr]), mesh)),
                      n=2 * dr.shape[0], mesh=mesh),
            ShardedBlockAntiDiagOperator.place(
                torch.cat([-di, di]), mesh, 1, type(op).__name__))
    if isinstance(op, BSROperator):
        return ShardedBSROperator.shard(op, mesh)
    if isinstance(op, BlockDiagOperator):
        if isinstance(op.inner, BlockAntiDiagOperator):
            # Caught here, before unroll_block_diag: the copies' half swaps
            # have no unsharded single operator to unroll into.
            return ShardedBlockAntiDiagOperator.shard(op.inner, mesh,
                                                      copies=op.copies)
        return shard_operator(unroll_block_diag(op), mesh)
    if type(op) in (SumOperator, ScaledOperator, ShiftedOperator,
                    ComposedOperator, ChebyshevFilter):
        return dataclasses.replace(op, **{
            f.name: shard_operator(getattr(op, f.name), mesh)
            for f in dataclasses.fields(op)
            if isinstance(getattr(op, f.name), LinearOperator)})
    if isinstance(op, (Laplacian1D, LaplacianND)):
        return use_spmd_stencils(op, mesh)
    raise NotImplementedError(
        f"shard_operator: no sharded form of {type(op).__name__}")


def shard_problem(
    mesh: RowMesh,
    A,
    X0: Optional[torch.Tensor] = None,
    B=None,
    T=None,
):
    """(A, X0, B, T) placed on the mesh: the sharded operators and this
    rank's rows of X0.  The JAX package's ``spmd_stencil=False`` (let the
    partitioner derive the halos) has no counterpart: the port has no
    partitioner, so stencils always exchange explicitly."""

    def prep(op):
        return None if op is None else shard_operator(op, mesh)

    X0 = shard_array(X0, mesh) if X0 is not None else None
    return prep(A), X0, prep(B), prep(T)
