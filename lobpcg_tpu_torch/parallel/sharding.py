"""Place a LOBPCG problem on a row mesh (port of
``lobpcg_tpu/parallel/sharding.py``).

In the JAX package the sharding rides on the arrays, and XLA inserts the
collectives an operator needs.  The port has no partitioner: each
operator class gets an explicit sharded form that takes and returns this
rank's rows and keeps the global ``shape``:

| Operator | Sharded form |
|---|---|
| any operator whose n does not divide over the ranks | the operator itself, whole on every rank: the solve runs replicated (``shard_array`` keeps X0 whole too) |
| DiagonalOperator, JacobiPreconditioner | ``LocalRows``: the local slice |
| Laplacian1D | ``SpmdLaplacian1D`` (halo exchange + K1) when its segments align with the shards (``segments_align``); else ``GatheredOperator``, the product XLA's partitioner gives the JAX package under ``spmd_stencil=False`` |
| BlockDiagOperator of Laplacian1D (+ diagonals) | one segmented stencil, then as above |
| LaplacianND | ``SpmdLaplacianND`` (plane exchange + the unsharded operator) when nx divides over the ranks, else ``GatheredOperator`` |
| Sum/Scaled/Shifted/Composed, ChebyshevFilter | the same node over sharded children |
| DenseOperator | ``RowPanelOperator``: row panel times all-gathered X |
| BlockAntiDiagOperator | ``ShardedBlockAntiDiagOperator``: the half swap as the row exchange of ``mesh.row_plan`` (one partner at an even rank count, none at one rank), then the scale; where the plan is local (no peer), the swap and the scale as one ``tail.antidiag`` pass |
| BlockDiagOperator of BlockAntiDiagOperator (realified B) | ``ShardedBlockAntiDiagOperator`` with ``copies``: one half swap inside each copy |
| RealEmbeddedDiagonalOperator | ``LocalRows`` of [dr; dr] plus ``ShardedBlockAntiDiagOperator`` of [-di; di] |
| RealEmbeddedDenseOperator | ``RowPanelOperator``: this rank's rows of [[Ar, -Ai], [Ai, Ar]] |
| BSROperator | ``ShardedBSROperator`` (edge-band halo + K6/K5, else K3 on the frame) when its block rows divide and its bandwidth stays inside a shard; ``BSRRowPanelOperator`` (this rank's block rows, K3 on the all-gathered X) when only the rows divide; else ``GatheredOperator`` |
| BlockDiag2Operator (the A of ``physics.bdg_operators``) | top and bottom each one same-shaped Laplacian1D (scaled or not) plus diagonals, with segments that align with the shards: one two-segment Laplacian1D plus [d_top; d_bottom], then as above; any other: ``GatheredOperator`` |
| CallableOperator | ``GatheredOperator``, its ``args`` whole on every rank |

``GatheredOperator`` all-gathers X's rows, applies the unsharded
operator to the whole block and keeps this rank's rows: what XLA's
partitioner falls back to.  It is a route of this table only, never a
retry after another form failed.  Any other class raises
``NotImplementedError``: no operator computes a wrong product in
silence.

Every sharded form takes a lockstep batch [b, n_loc, k] (each rank's
rows of b problems; the rows are axis -2) with one exchange for the
batch, and equals b lone applies bit for bit.  Per-problem data keeps
its batch axis in front and is cut along its row axis: a diagonal
[b, n] to [b, n_loc], a dense [b, n, n] to [b, n_loc, n], what
``jax.vmap`` gives the JAX package over its sharded problem.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lobpcg_tpu_torch.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu_torch.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiag2Operator,
    BlockDiagOperator,
    CallableOperator,
    ComposedOperator,
    DenseOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    LinearOperator,
    ScaledOperator,
    ShiftedOperator,
    SumOperator,
    half_swap,
)
from lobpcg_tpu_torch.operators.realify import (
    RealEmbeddedDenseOperator,
    RealEmbeddedDiagonalOperator,
)
from lobpcg_tpu_torch.operators.sparse import BSROperator
from lobpcg_tpu_torch.operators.stencil_nd import LaplacianND
from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.cuda.bsr import bsr_matmat, bsr_matmat_reference
from lobpcg_tpu_torch.parallel.mesh import (
    RowMesh,
    RowPlan,
    all_gather_rows,
    permute_rows,
    replicated,
    row_plan,
    row_sharding,
)
from lobpcg_tpu_torch.parallel.spmd_bsr import ShardedBSROperator, fitting_plan
from lobpcg_tpu_torch.parallel.spmd_stencil import (
    SpmdLaplacian1D,
    SpmdLaplacianND,
    _tile_rows,
    segments_align,
    unroll_block_diag,
    unroll_block_diag2,
    use_spmd_stencils,
)


def _shardable(x: torch.Tensor, n_shards: int, dim: int) -> bool:
    return (x.dim() >= 1 and x.shape[dim] % n_shards == 0
            and x.shape[dim] >= n_shards)


def shard_array(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of ``x`` (the whole of ``x`` when its rows do not
    divide over the ranks), on the mesh's device.  The rows are the first
    dimension, and the second of a 3-D block (a lockstep batch X0
    [b, n, k])."""
    dim = 1 if x.dim() == 3 else 0
    if _shardable(x, mesh.size, dim):
        return row_sharding(mesh, x.dim()).local(x, dim)
    return replicated(mesh).local(x)


def _rows_of(x: torch.Tensor, mesh: RowMesh, dim: int) -> torch.Tensor:
    """This rank's rows of an operator's data, the rows being dimension
    ``dim`` (-1 for a diagonal [n] or [b, n], -2 for a matrix [n, n] or
    [b, n, n]); raises when they do not divide over the ranks (a
    replicated copy would compute another operator)."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"{x.shape[dim]} operator rows do not divide over "
                         f"{mesh.size} ranks")
    return row_sharding(mesh, x.dim()).local(x, dim)


@dataclasses.dataclass
class LocalRows(LinearOperator):
    """A row-local operator (a diagonal or Jacobi operator) holding this
    rank's rows only; ``shape`` stays the global (n, n)."""

    op: LinearOperator
    n: int = 0
    mesh: RowMesh = None

    def matmat(self, X):
        return self.op.matmat(X)

    def row_scales(self):
        """This rank's rows of a DiagonalOperator's d (None for another
        operator): the fused stencil route reads it
        (``operators/linop.py: stencil_and_diagonals``)."""
        return self.op.row_scales() if type(self.op) is DiagonalOperator \
            else None

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.op.dtype


@dataclasses.dataclass
class RowPanelOperator(LinearOperator):
    """A DenseOperator's rows of this rank ([n_loc, n], or [b, n_loc, n]
    one matrix a problem) times the all-gathered global block."""

    A: torch.Tensor
    mesh: RowMesh = None

    def matmat(self, X):
        return torch.matmul(self.A, all_gather_rows(self.mesh, X))

    @property
    def shape(self):
        n = self.A.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.A.dtype


@dataclasses.dataclass
class BSRRowPanelOperator(LinearOperator):
    """A BSROperator's block rows of this rank (``block_cols`` keep the
    global block columns) times the all-gathered global block: K3 with
    the whole block as its frame (its plain version for a CPU tensor or
    another dtype than f32); a batch is one all-gather and one launch."""

    block_cols: torch.Tensor
    blocks: torch.Tensor
    n: int = 0
    mesh: RowMesh = None

    @classmethod
    def shard(cls, op: BSROperator, mesh: RowMesh):
        nb_loc = op.blocks.shape[0] // mesh.size
        rows = slice(mesh.rank * nb_loc, (mesh.rank + 1) * nb_loc)
        return cls(op.block_cols[rows].to(mesh.device, torch.int32),
                   op.blocks[rows].to(mesh.device), n=op.n, mesh=mesh)

    def matmat(self, X):
        Xg = all_gather_rows(self.mesh, X)
        if X.dtype == torch.float32 and self.blocks.dtype == torch.float32:
            return bsr_matmat(self.block_cols, self.blocks, Xg.contiguous(),
                              frame=True)
        return bsr_matmat_reference(self.block_cols, self.blocks, Xg)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype


def _half_swap_pieces(n: int, copies: int):
    """The half swap of each copy as (out_lo, out_hi, src_lo) row ranges."""
    m = n // (2 * copies)
    return [piece for j in range(copies) for piece in (
        (2 * j * m, (2 * j + 1) * m, (2 * j + 1) * m),
        ((2 * j + 1) * m, (2 * j + 2) * m, 2 * j * m))]


@dataclasses.dataclass
class ShardedBlockAntiDiagOperator(LinearOperator):
    """diag(B, ..., B), ``copies`` copies of B = {{0, D}, {D, 0}}, over a
    row mesh (one copy is BlockAntiDiagOperator, two are its split-real
    form).  Each copy's half swap, then a scale by this rank's rows ``d``
    of the row scales ([d; d] per copy).  ``plan`` (``mesh.row_plan``,
    worked out once on the host) names the ranks that hold this rank's
    swapped rows, and one batch of sends and receives brings them: none
    when a rank holds whole copies (a local permutation), one partner
    when a copy spans an even number of ranks, two when it spans an odd
    number, a few more when copies and ranks do not divide one
    another."""

    d: torch.Tensor
    plan: RowPlan
    n: int = 0
    mesh: RowMesh = None
    copies: int = 1

    @classmethod
    def shard(cls, op: BlockAntiDiagOperator, mesh: RowMesh, copies: int = 1):
        c = int(copies)
        return cls.place(_tile_rows(torch.cat([op.d, op.d], dim=-1), c), mesh, c)

    @classmethod
    def place(cls, scale: torch.Tensor, mesh: RowMesh, copies: int = 1):
        """From the global row scales ``scale`` [n] (applied after the
        swap; [b, n], one row scale a problem)."""
        n, c = scale.shape[-1], int(copies)
        return cls(d=_rows_of(scale, mesh, -1),
                   plan=row_plan(n, mesh.size, mesh.rank,
                                 _half_swap_pieces(n, c)),
                   n=n, mesh=mesh, copies=c)

    def matmat(self, X):
        swap = half_swap(self, X)
        if swap is not None:
            return tail.antidiag(X, *swap)
        return self.d[..., None] * permute_rows(self.mesh, X, self.plan)

    def half_swap(self):
        """(this rank's row scales, the copies it holds) when the plan is
        a local permutation (no peer: this rank holds whole copies), so
        that the swap and the scale run as one ``tail.antidiag`` pass;
        None when rows cross ranks, which keeps the chain: the exchange
        (``permute_rows``), then the scale as its own PyTorch pass."""
        if self.plan.sends or self.plan.recvs:
            return None
        rows = 2 * (self.n // (2 * self.copies))  # a copy's
        return self.d, self.d.shape[-1] // rows

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.d.dtype


def _placed(x, device):
    """``x`` (an operator tree, or a tensor, tuple or list inside one)
    with every tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if type(x) in (tuple, list):
        return type(x)(_placed(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _placed(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


@dataclasses.dataclass
class GatheredOperator(LinearOperator):
    """An unsharded operator over a row mesh: the all-gathered block
    through ``op``, whole on every rank, and this rank's rows of the
    product (XLA's fallback for an operator it cannot partition)."""

    op: LinearOperator
    mesh: RowMesh = None

    @classmethod
    def place(cls, op: LinearOperator, mesh: RowMesh):
        return cls(_placed(op, mesh.device), mesh=mesh)

    def matmat(self, X):
        n_loc, r = X.shape[-2], self.mesh.rank
        Y = self.op.matmat(all_gather_rows(self.mesh, X))
        return Y[..., r * n_loc : (r + 1) * n_loc, :]

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype


_SHARDED = (SpmdLaplacian1D, SpmdLaplacianND, ShardedBSROperator, LocalRows,
            RowPanelOperator, BSRRowPanelOperator, ShardedBlockAntiDiagOperator,
            GatheredOperator)


def _embedded_rows(Ar: torch.Tensor, Ai: torch.Tensor,
                   mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of [[Ar, -Ai], [Ai, Ar]] (of each problem's, for
    [b, n, n] data), built from the rows of Ar and Ai it needs (the
    [2n, 2n] embedding is never formed)."""
    nr = Ar.shape[-2]
    if (2 * nr) % mesh.size:
        raise ValueError(f"{2 * nr} operator rows do not divide over "
                         f"{mesh.size} ranks")
    n_loc = 2 * nr // mesh.size
    r0, r1 = mesh.rank * n_loc, (mesh.rank + 1) * n_loc
    parts = []
    if r0 < nr:
        top = slice(r0, min(r1, nr))
        parts.append(torch.cat([Ar[..., top, :], -Ai[..., top, :]], dim=-1))
    if r1 > nr:
        bot = slice(max(r0, nr) - nr, r1 - nr)
        parts.append(torch.cat([Ai[..., bot, :], Ar[..., bot, :]], dim=-1))
    return torch.cat(parts, dim=-2).to(mesh.device)


def shard_operator(op, mesh: RowMesh):
    """The sharded form of every node of an operator tree (the table of
    the module docstring); raises NotImplementedError on any other
    class."""
    if isinstance(op, _SHARDED):
        if op.mesh is not mesh:
            raise ValueError(f"{type(op).__name__} is sharded over another mesh")
        return op
    if op.shape[0] % mesh.size:
        return _placed(op, mesh.device)
    if isinstance(op, (DiagonalOperator, JacobiPreconditioner)):
        n = op.d.shape[-1]
        return LocalRows(type(op)(_rows_of(op.d, mesh, -1)), n=n, mesh=mesh)
    if isinstance(op, BlockAntiDiagOperator):
        return ShardedBlockAntiDiagOperator.shard(op, mesh)
    if isinstance(op, DenseOperator):
        return RowPanelOperator(_rows_of(op.A, mesh, -2), mesh=mesh)
    if isinstance(op, RealEmbeddedDenseOperator):
        return RowPanelOperator(_embedded_rows(op.Ar, op.Ai, mesh), mesh=mesh)
    if isinstance(op, RealEmbeddedDiagonalOperator):
        # [[dr, -di], [di, dr]] = diag([dr; dr]) + diag([-di; di]) times
        # the half swap of the stacked [re; im] rows.
        dr, di = op.dr, op.di
        return SumOperator(
            LocalRows(DiagonalOperator(_rows_of(torch.cat([dr, dr], dim=-1),
                                                mesh, -1)),
                      n=2 * dr.shape[-1], mesh=mesh),
            ShardedBlockAntiDiagOperator.place(torch.cat([-di, di], dim=-1),
                                               mesh))
    if isinstance(op, BSROperator):
        plan = fitting_plan(op, mesh.size, shards=[mesh.rank])
        if plan is not None:
            return ShardedBSROperator.place(op, mesh, plan)
        if op.blocks.shape[0] % mesh.size == 0:
            return BSRRowPanelOperator.shard(op, mesh)
        return GatheredOperator.place(op, mesh)
    if isinstance(op, BlockDiagOperator):
        if isinstance(op.inner, BlockAntiDiagOperator):
            # Caught here, before unroll_block_diag: the copies' half swaps
            # have no unsharded single operator to unroll into.
            return ShardedBlockAntiDiagOperator.shard(op.inner, mesh,
                                                      copies=op.copies)
        return shard_operator(unroll_block_diag(op), mesh)
    if isinstance(op, BlockDiag2Operator):
        flat, stencil = unroll_block_diag2(op)
        if flat is not None and segments_align(stencil.n, stencil.segments,
                                               mesh.size):
            return shard_operator(flat, mesh)
        return GatheredOperator.place(op, mesh)
    if type(op) in (SumOperator, ScaledOperator, ShiftedOperator,
                    ComposedOperator, ChebyshevFilter):
        return dataclasses.replace(op, **{
            f.name: shard_operator(getattr(op, f.name), mesh)
            for f in dataclasses.fields(op)
            if isinstance(getattr(op, f.name), LinearOperator)})
    if isinstance(op, Laplacian1D):
        if segments_align(op.n, op.segments, mesh.size):
            return use_spmd_stencils(op, mesh)
        return GatheredOperator.place(op, mesh)
    if isinstance(op, LaplacianND) and int(op.grid[0]) % mesh.size == 0:
        return use_spmd_stencils(op, mesh)
    if isinstance(op, (LaplacianND, CallableOperator)):
        return GatheredOperator.place(op, mesh)
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
    rank's rows of X0 (the whole problem on every rank when n does not
    divide over the ranks).  A lockstep batch passes X0 [b, n, k] and
    operators with per-problem data (a DiagonalOperator [b, n], Chebyshev
    bounds [b]); each rank gets its rows of every problem.  The JAX package's ``spmd_stencil`` flag has
    no counterpart: the port has no partitioner, so the route is the
    table's, by shape.  A stencil whose segments align with the shards
    exchanges halos explicitly (the JAX package's default); a
    Laplacian1D whose segment boundaries fall inside a shard is gathered
    (``GatheredOperator``), the product the JAX package's partitioner
    gives it under ``spmd_stencil=False``."""

    def prep(op):
        return None if op is None else shard_operator(op, mesh)

    X0 = shard_array(X0, mesh) if X0 is not None else None
    return prep(A), X0, prep(B), prep(T)
