"""Residuals, residual norms, and operator-norm estimation (port of
``lobpcg_tpu/ops/residual.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.gram import abs2, apply_block_op
from lobpcg_tpu_torch.ops.rows import row_sum
from lobpcg_tpu_torch.operators.linop import LinearOperator, half_swap


def col_norms(W: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Column 2-norms of a tall block, summed over the row group of a
    sharded solve."""
    return torch.sqrt(row_sum(torch.sum(abs2(W), dim=-2, keepdim=keepdim)))


def get_residual(
    X: torch.Tensor,
    AX: Optional[torch.Tensor],
    lam: torch.Tensor,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    BX: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """W = A X - B X diag(lam).  AX may be a cached A@X; BX likewise a
    pre-applied B@X.  One ``tail.residual`` pass: an anti-diagonal B
    (``linop.half_swap``) is read as X's partner rows, any other B is
    applied first."""
    W = apply_block_op(A, X, "A") if AX is None else AX
    swap = half_swap(B, X) if BX is None else None
    if BX is None and swap is None and B is not None:
        BX = apply_block_op(B, X)
    d, copies = swap if swap is not None else (None, 1)
    return tail.residual(W, X, lam, d, BX, copies)


def get_residual_norm(
    W: torch.Tensor,
    lam: torch.Tensor,
    a_norm: torch.Tensor,
    b_norm: torch.Tensor,
    nev: int,
    BW: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward-error style relative norms for the first nev columns:
    resNorm[i] = ||W[:, i]|| / (||A|| + |lam_i| * ||B||).  ``BW``
    (pre-applied B @ W[:, :nev]) switches the numerator to the
    B-seminorm sqrt(|w_i^H B w_i|).  Batched: the norms are [b]."""
    if BW is not None:
        nom = torch.sqrt(torch.abs(row_sum(
            torch.sum(W[..., :nev].conj() * BW[..., :nev], dim=-2).real
        )))
    else:
        nom = col_norms(W[..., :nev])
    b_norm = torch.where(b_norm > 0, b_norm, 1.0)
    denom = a_norm[..., None] + torch.abs(lam[..., :nev]).to(nom.dtype) \
        * b_norm[..., None]
    return (nom / denom).to(nom.dtype)


def estimate_norm(
    A: LinearOperator,
    v: torch.Tensor,
    iters: int = 10,
    role: str = "A",
) -> torch.Tensor:
    """||A|| estimate via power iteration from the random start block
    ``v`` ([n, block], or [b, n, block] for a batch; each column
    normalized independently, the estimate is the max per-column growth,
    one per problem).  The caller draws ``v`` (``utils.prng``), where the
    JAX package passes a key.  ``role``: the operator's span, as in
    ``gram.apply_block_op``."""
    nrm0 = col_norms(v, keepdim=True)
    v = v / torch.where(nrm0 > 0, nrm0, 1.0).to(v.dtype)
    nrm = nrm0
    for _ in range(iters):
        w = apply_block_op(A, v, role)
        nrm = col_norms(w, keepdim=True)
        v = torch.where(
            nrm > 0, w / torch.where(nrm > 0, nrm, 1.0).to(w.dtype), w
        )
    return torch.amax(nrm, dim=(-2, -1))
