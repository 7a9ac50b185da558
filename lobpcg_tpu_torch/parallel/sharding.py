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
| BSROperator | ``ShardedBSROperator`` (edge-band halo + K6/K5) |

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


@dataclasses.dataclass
class ShardedBlockAntiDiagOperator(LinearOperator):
    """B = {{0, D}, {D, 0}} over a row mesh: the half swap sends rank r's
    rows to rank (r + nd/2) % nd and back (one batch of a send and a
    receive), then scales by this rank's rows of [d; d].  World size 1
    swaps locally; an odd number of ranks above 1 raises."""

    d: torch.Tensor
    n: int = 0
    mesh: RowMesh = None

    @classmethod
    def shard(cls, op: BlockAntiDiagOperator, mesh: RowMesh):
        m, nd = op.d.shape[0], mesh.size
        if nd > 1 and nd % 2:
            raise NotImplementedError(
                f"BlockAntiDiagOperator over {nd} ranks: the half swap pairs "
                "rank r with r + nd/2, so the ranks must be even in number")
        return cls(d=_rows_of(torch.cat([op.d, op.d]), mesh), n=2 * m,
                   mesh=mesh)

    def matmat(self, X):
        if self.mesh.size == 1:
            m = self.n // 2
            return self.d[:, None] * torch.cat([X[m:], X[:m]], dim=0)
        partner = (self.mesh.rank + self.mesh.size // 2) % self.mesh.size
        return self.d[:, None] * swap(self.mesh, X, partner)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.d.dtype


_SHARDED = (SpmdLaplacian1D, SpmdLaplacianND, ShardedBSROperator, LocalRows,
            RowPanelOperator, ShardedBlockAntiDiagOperator)


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
    if isinstance(op, BSROperator):
        return ShardedBSROperator.shard(op, mesh)
    if isinstance(op, BlockDiagOperator):
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
