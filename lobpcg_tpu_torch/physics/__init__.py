from lobpcg_tpu_torch.physics.bdg import (
    BlockDiag2Operator,
    bdg_operators,
    bdg_positive_start,
    bdg_preconditioner,
)

__all__ = [
    "BlockDiag2Operator",
    "bdg_operators",
    "bdg_positive_start",
    "bdg_preconditioner",
]
