"""The row-sharded layer on ``torch.distributed`` (port of
``lobpcg_tpu/parallel``): explicit SPMD, one process per rank.

    mesh = row_mesh()                  # the card; world size 1 unless launched
    As, X0s, Bs, Ts = shard_problem(mesh, A, X0, B, T)
    with mesh:
        r = lobpcg(As, X0s, B=Bs, T=Ts, nev=...)   # r.eigenvectors: this rank's rows

``spawn(fn, world)`` runs ``fn(mesh, ...)`` on ``world`` processes, one
card each (NCCL); ``spawn(fn, world, device="cpu")`` runs them on gloo.
"""

from lobpcg_tpu_torch.parallel.mesh import (
    ROWS,
    RowMesh,
    replicated,
    row_mesh,
    row_sharding,
    spawn,
)
from lobpcg_tpu_torch.parallel.sharding import (
    shard_array,
    shard_operator,
    shard_problem,
)
from lobpcg_tpu_torch.parallel.spmd_bsr import ShardedBSROperator, plan_shards
from lobpcg_tpu_torch.parallel.spmd_stencil import (
    SpmdLaplacian1D,
    SpmdLaplacianND,
    stencil_matmat_spmd,
    use_spmd_stencils,
)

__all__ = [
    "ROWS",
    "row_mesh",
    "row_sharding",
    "replicated",
    "shard_array",
    "shard_operator",
    "shard_problem",
    "SpmdLaplacian1D",
    "ShardedBSROperator",
    "stencil_matmat_spmd",
    "use_spmd_stencils",
    # The port's own: the mesh object, the launcher, the sharded 3-D
    # stencil and the per-shard BSR planning.
    "RowMesh",
    "spawn",
    "SpmdLaplacianND",
    "plan_shards",
]
