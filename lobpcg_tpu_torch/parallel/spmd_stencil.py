"""Row-sharded stencils with an explicit halo exchange (port of
``lobpcg_tpu/parallel/spmd_stencil.py``).

``SpmdLaplacian1D``: each rank holds [n_loc, k] rows; one batch of sends
and receives brings the row above and the row below from the neighbours
(zeros at the ends of the chain, the Dirichlet boundary), and the local
product is K1 (``ops/cuda/stencil.py``) with those rows as its
``edge_rows``.  Segment boundaries (the BdG block structure
A = diag(K, ..., K)) must not couple: a halo row across a segment
boundary is zeroed, and boundaries inside a shard are K1's own segments.
The per-shard row count must divide the segment length or the reverse.
A lockstep batch [b, n_loc, k] is one exchange of every problem's halo
rows and one K1 launch over its b * segments segments, with the halos as
per-problem edge rows [b, 2, k].

``SpmdLaplacianND``: the JAX package lets the partitioner derive the
halos of its pad/slice formula (``_rewrite`` sets ``force_jnp``); the
port partitions the leading grid axis, exchanges one plane with each
neighbour, runs the unsharded operator (K2 for a 3-D f32 grid) on the
[nx_loc + 2, ...] extended slab and keeps the interior planes: the
slab's Dirichlet faces touch only the dropped halo planes.  A batch is one
plane exchange and one batched apply of the slab (one K2 launch).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lobpcg_tpu_torch.operators.linop import (
    BlockDiag2Operator,
    BlockDiagOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    LinearOperator,
    ScaledOperator,
    ShiftedOperator,
    SumOperator,
    apply_scale,
    stencil_and_diagonals,
)
from lobpcg_tpu_torch.operators.realify import RealEmbeddedDiagonalOperator
from lobpcg_tpu_torch.operators.stencil_nd import LaplacianND
from lobpcg_tpu_torch.ops.cuda.stencil import (
    KERNEL_DTYPES,
    stencil_matmat,
    stencil_matmat_reference,
)
from lobpcg_tpu_torch.parallel.mesh import RowMesh, halo_exchange

PALLAS_MODES = ("auto", "interpret", "off")


def segments_align(n: int, segments: int, nd: int) -> bool:
    """Whether ``SpmdLaplacian1D`` takes n rows in ``segments`` segments
    over nd ranks: the rows divide into segments x ranks, and every shard
    holds whole segments or every segment spans whole shards."""
    if n % (segments * nd):
        return False
    seg, local_rows = n // segments, n // nd
    return seg % local_rows == 0 or local_rows % seg == 0


def _spmd_frame(X, mesh: RowMesh, num_segments: int, n, send_map=None):
    """The local product's launch for this rank's rows X ([n_loc, k] or
    [b, n_loc, k]): (X as [rows, k], its segments, the halos as edge rows
    [2, k] or [b, 2, k], problems), after one halo exchange.  ``send_map``
    maps the rows a rank sends (its first and last, [..., 2, k]) before
    they leave: the neighbours then receive those rows mapped."""
    nd = mesh.size
    local_rows, k = X.shape[-2:]
    n = local_rows * nd if n is None else int(n)
    if n != local_rows * nd:
        raise ValueError(f"n={n} does not split into {nd} shards of "
                         f"{local_rows} rows")
    if n % (num_segments * nd):
        raise ValueError(
            f"n={n} must divide into {num_segments} segments x {nd} shards")
    seg = n // num_segments
    # Segment boundaries must align with the shard grid: every shard
    # holds whole segments (the kernel's own segments handle them) or
    # every segment spans whole shards (the halo zeroing handles them).
    if not segments_align(n, num_segments, nd):
        raise ValueError(
            f"segment length {seg} and shard rows {local_rows} must divide "
            "one another (segment boundaries would fall inside a shard)")

    sent = X
    if send_map is not None and nd > 1:
        sent = send_map(torch.cat([X[..., :1, :], X[..., -1:, :]], dim=-2))
    halo_up, halo_dn = halo_exchange(mesh, sent, 1)
    r = mesh.rank
    # Whether this shard starts a segment and the next one starts one is
    # the same for every problem of a batch.
    if (r * local_rows) % seg == 0:
        halo_up = torch.zeros_like(halo_up)
    if ((r + 1) * local_rows) % seg == 0:
        halo_dn = torch.zeros_like(halo_dn)
    edge = torch.cat([halo_up, halo_dn], dim=-2)  # [2, k] or [b, 2, k]
    problems = X.shape[0] if X.dim() == 3 else 1
    segs = problems * (local_rows // min(seg, local_rows))
    return X.reshape(problems * local_rows, k), segs, edge, problems


def stencil_matmat_spmd(
    X: torch.Tensor,
    scale: float,
    mesh: RowMesh,
    *,
    num_segments: int = 1,
    n=None,
    pallas: str = "auto",
) -> torch.Tensor:
    """Y = scale * tridiag[-1, 2, -1] X per row segment, for this rank's
    rows X [n_loc, k] of the global [n, k] block (``n`` defaults to
    n_loc times the ranks), or this rank's rows [b, n_loc, k] of b
    problems.

    ``pallas`` (the JAX package's name, kept for API parity): "auto" and
    "interpret" run the local product through ``stencil_matmat`` (K1 for
    a CUDA tensor in f32/bf16, its plain version for a CPU tensor);
    "off" runs the plain formula.  Other dtypes take the plain formula.
    """
    if pallas not in PALLAS_MODES:
        raise ValueError(f"pallas must be one of {PALLAS_MODES}, got {pallas!r}")
    Xf, segs, edge, _ = _spmd_frame(X, mesh, num_segments, n)
    if pallas != "off" and X.dtype in KERNEL_DTYPES:
        Y = stencil_matmat(Xf.contiguous(), scale, edge, num_segments=segs)
    else:
        Y = stencil_matmat_reference(Xf, scale, edge, num_segments=segs)
    return Y.reshape(X.shape)


@dataclasses.dataclass
class SpmdLaplacian1D(LinearOperator):
    """Laplacian1D over a row mesh, with the explicit halo exchange of
    ``stencil_matmat_spmd``.  Produced by ``use_spmd_stencils`` /
    ``shard_problem``; ``matmat`` takes and returns this rank's rows
    ([n_loc, k] or a batch [b, n_loc, k]), and ``shape`` is the global
    one.  ``scale`` is a float, or a [b] tensor of per-problem scales,
    applied as ``Laplacian1D`` applies it (``apply_scale``: one
    multiply after the stencil at scale 1)."""

    scale: float
    n: int = 0
    segments: int = 1
    mesh: RowMesh = None
    pallas: str = "auto"
    dtype: torch.dtype = torch.float32

    def matmat(self, X):
        return apply_scale(lambda s: stencil_matmat_spmd(
            X, s, self.mesh, num_segments=self.segments, n=self.n,
            pallas=self.pallas), self.scale)

    def stencil_frame(self, X, send_map=None):
        """The local product's launch on this rank's rows X, after its
        halo exchange (``Laplacian1D.stencil_frame``'s record, the halos
        as edge rows); ``send_map`` maps the rows sent to the neighbours
        (the first Chebyshev step sends X's rows over theta)."""
        Xf, segs, edge, b = _spmd_frame(X, self.mesh, self.segments, self.n,
                                        send_map)
        return Xf.contiguous(), segs, edge, b

    @property
    def shape(self):
        return (self.n, self.n)


@dataclasses.dataclass
class SpmdLaplacianND(LinearOperator):
    """LaplacianND over a row mesh: the leading grid axis is partitioned
    (nx must be divisible by the ranks), one plane is exchanged with each
    neighbour, and the unsharded operator runs on the extended slab."""

    scale: float
    grid: tuple = ()
    mesh: RowMesh = None
    force_jnp: bool = False
    dtype: torch.dtype = torch.float32

    def matmat(self, X):
        nx, rest = int(self.grid[0]), tuple(int(g) for g in self.grid[1:])
        nd = self.mesh.size
        if nx % nd:
            raise ValueError(f"grid {tuple(self.grid)}: nx={nx} does not "
                             f"divide over {nd} ranks")
        plane, nx_loc = math.prod(rest), nx // nd
        rows = X.shape[-2]
        if rows != nx_loc * plane:
            raise ValueError(f"X has {rows} rows, this rank holds "
                             f"{nx_loc * plane}")
        halo_up, halo_dn = halo_exchange(self.mesh, X, plane)
        slab = LaplacianND(scale=self.scale, grid=(nx_loc + 2,) + rest,
                           force_jnp=self.force_jnp, dtype=self.dtype)
        Y = slab.matmat(torch.cat([halo_up, X, halo_dn], dim=-2))
        return Y[..., plane : plane + rows, :]

    @property
    def shape(self):
        n = math.prod(self.grid)
        return (n, n)


def _holds_stencil(op) -> bool:
    if isinstance(op, Laplacian1D):
        return True
    return dataclasses.is_dataclass(op) and any(
        _holds_stencil(getattr(op, f.name)) for f in dataclasses.fields(op)
        if isinstance(getattr(op, f.name), LinearOperator))


def _tile_rows(d: torch.Tensor, c: int) -> torch.Tensor:
    """A diagonal [n] or [b, n] (one a problem) repeated c times along
    its rows."""
    return d.repeat((1,) * (d.dim() - 1) + (c,))


def unroll_block_diag(op: BlockDiagOperator) -> LinearOperator:
    """diag(K, ..., K) as one operator on the stacked rows, as
    ``benchmarks/solve_bdg.py:well_problem`` builds it: each Laplacian1D
    of K becomes one with ``copies`` times its segments, each diagonal is
    tiled.  K may be built of Laplacian1D, DiagonalOperator,
    JacobiPreconditioner, BlockDiagOperator, a RealEmbeddedDiagonalOperator
    of real values and Sum/Scaled/Shifted of them (what
    ``realify_operator`` makes of a real-valued K)."""
    c = int(op.copies)

    def unroll(o):
        if isinstance(o, Laplacian1D):
            return Laplacian1D(scale=o.scale, n=o.n * c,
                               segments=o.segments * c,
                               pad_lanes=o.pad_lanes, dtype=o.dtype)
        if isinstance(o, (DiagonalOperator, JacobiPreconditioner)):
            return type(o)(_tile_rows(o.d, c))
        if isinstance(o, SumOperator):
            return SumOperator(unroll(o.left), unroll(o.right))
        if isinstance(o, ScaledOperator):
            return ScaledOperator(unroll(o.op), o.alpha)
        if isinstance(o, ShiftedOperator):
            return ShiftedOperator(unroll(o.op), o.sigma)
        if isinstance(o, BlockDiagOperator):  # c copies of diag(J x c2)
            return unroll_block_diag(
                BlockDiagOperator(inner=o.inner, copies=c * int(o.copies)))
        if isinstance(o, RealEmbeddedDiagonalOperator) and not bool(
                torch.any(o.di != 0)):  # real data: diag([dr; dr])
            return DiagonalOperator(_tile_rows(o.dr, 2 * c))
        raise NotImplementedError(
            f"no sharded form of BlockDiagOperator over {type(o).__name__}")

    return unroll(op.inner)


def unroll_block_diag2(op: BlockDiag2Operator):
    """(flat, stencil): diag(top, bottom) as one Laplacian1D of twice the
    segments plus the diagonal [d_top; d_bottom], as
    ``benchmarks/solve_bdg.py:well_problem`` builds the well's A, when
    top and bottom are each one same-shaped Laplacian1D (scaled or not)
    plus DiagonalOperators (``physics.bdg_operators`` without
    ``dipolar``); (None, None) otherwise."""
    def parts(half):
        """(scale, Laplacian1D, [d, ...]) of one half, or None."""
        found = stencil_and_diagonals(half)
        if found is None or not isinstance(found[0], Laplacian1D):
            return None
        st, alpha, ds = found
        return (st.scale if alpha is None else float(alpha) * st.scale), st, ds

    top, bot = parts(op.top), parts(op.bottom)
    if top is None or bot is None:
        return None, None
    (s_t, l_t, d_t), (s_b, l_b, d_b) = top, bot
    if (s_t, l_t.n, l_t.segments, l_t.dtype) != (s_b, l_b.n, l_b.segments,
                                                  l_b.dtype):
        return None, None
    stencil = Laplacian1D(scale=s_t, n=2 * l_t.n, segments=2 * l_t.segments,
                          pad_lanes=l_t.pad_lanes, dtype=l_t.dtype)
    if not d_t and not d_b:
        return stencil, stencil

    def total(ds, like):
        return sum(ds[1:], ds[0]) if ds else torch.zeros_like(like)

    ref = (d_t or d_b)[0]
    diag = torch.cat([total(d_t, ref), total(d_b, ref)], dim=-1)
    return SumOperator(stencil, DiagonalOperator(diag)), stencil


def _rewrite(op, mesh: RowMesh):
    """Replace the stencils of an operator tree with their sharded forms;
    every other node is kept."""
    if isinstance(op, Laplacian1D):
        return SpmdLaplacian1D(scale=op.scale, n=op.n, segments=op.segments,
                               mesh=mesh, dtype=op.dtype)
    if isinstance(op, LaplacianND):
        return SpmdLaplacianND(scale=op.scale, grid=tuple(op.grid), mesh=mesh,
                               force_jnp=op.force_jnp, dtype=op.dtype)
    if isinstance(op, BlockDiagOperator) and _holds_stencil(op.inner):
        return _rewrite(unroll_block_diag(op), mesh)
    if dataclasses.is_dataclass(op):
        changes = {}
        for f in dataclasses.fields(op):
            child = getattr(op, f.name)
            if isinstance(child, LinearOperator):
                new = _rewrite(child, mesh)
                if new is not child:
                    changes[f.name] = new
        if changes:
            return dataclasses.replace(op, **changes)
    return op


def use_spmd_stencils(op, mesh: RowMesh):
    """A copy of the operator tree with every Laplacian1D and LaplacianND
    swapped for its sharded form, and every BlockDiagOperator of a
    Laplacian1D rewritten as one segmented stencil first; other nodes
    stay as they are (``shard_operator`` places them)."""
    return _rewrite(op, mesh)
