"""lobpcg_tpu_torch — the PyTorch / CUDA port of lobpcg_tpu.

The same solvers, operators and config knobs as the JAX package
``lobpcg_tpu``, written for one NVIDIA H100: plain tensor code in
PyTorch, and every TPU kernel on the ported path a kernel written by
hand for Hopper (``csrc/``, built with nvcc at first use).  This package
imports torch, numpy and scipy, never jax.

``lobpcg``/``ilobpcg`` given an X0 of [b, n, m] solve b problems in
lockstep (the counterpart of ``jax.vmap`` over a solve): the operators
of ``operators/linop.py`` with shared or per-problem data,
``CallableOperator`` (``in_axes`` marks its mapped arguments),
``LaplacianND`` and ``BSROperator`` over a shared grid or matrix, the
realified operators, and a shared P0.  ``batched`` maps any function
over problems one at a time.
"""

from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.operators.linop import (
    BlockAntiDiagOperator,
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
)
from lobpcg_tpu_torch.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu_torch.operators.realify import (
    derealify,
    realify_operator,
    realify_problem,
    realify_x0,
)
from lobpcg_tpu_torch.operators.sparse import BSROperator, laplacian_3d_csr
from lobpcg_tpu_torch.operators.stencil_nd import LaplacianND, laplacian_nd_eigs
from lobpcg_tpu_torch.solvers.batched import batched
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg
from lobpcg_tpu_torch.solvers.lobpcg import lobpcg
from lobpcg_tpu_torch.solvers.state import (
    ILOBPCGResult,
    LOBPCGResult,
    SolveHistory,
)
from lobpcg_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    solve_checkpointed,
)
from lobpcg_tpu_torch.utils.plan import (
    estimate_peak_gb,
    plan_config,
    probe_hbm_gb,
)

# `klobpcg` is a pure alias of the standard solver, as in the JAX package.
klobpcg = lobpcg

__all__ = [
    "SolverConfig",
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "JacobiPreconditioner",
    "ChebyshevFilter",
    "CallableOperator",
    "Laplacian1D",
    "LaplacianND",
    "laplacian_nd_eigs",
    "BSROperator",
    "laplacian_3d_csr",
    "BlockDiagOperator",
    "BlockAntiDiagOperator",
    "ShiftedOperator",
    "ScaledOperator",
    "SumOperator",
    "ComposedOperator",
    "lobpcg",
    "ilobpcg",
    "klobpcg",
    # The counterpart of jax.vmap over the solvers (tests/test_vmap.py).
    "batched",
    "LOBPCGResult",
    "ILOBPCGResult",
    "SolveHistory",
    "realify_operator",
    "realify_problem",
    "realify_x0",
    "derealify",
    "save_checkpoint",
    "load_checkpoint",
    "solve_checkpointed",
    "estimate_peak_gb",
    "plan_config",
    "probe_hbm_gb",
]

__version__ = "0.1.0"
