"""SVQB orthonormalization (Duersch & Ye 2018, Alg. 4), fixed-shape
(port of ``lobpcg_tpu/ops/svqb.py``).

The Gram eigendecomposition runs on the tiny k x k matrix, and column
dropping is a stable argsort compaction over a fixed width; the kept
count is an int.  Dead coordinates are decoupled by identity injection,
so the transform is the identity on them and their columns stay zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.gram import gram_self, gram_self_mat, mm, scale_diag
from lobpcg_tpu_torch.ops.linalg import eigh
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.utils.profiling import ORTHO, spanned


def _svqb_transform(G, count, tau, drop, dtype):
    """From a Gram matrix (live block only; dead zero) to the fused
    transform T = D * V * D_final with drop compaction.  Internal math
    runs in G's dtype; T is cast to `dtype`.  Returns (T [k,k], n_kept);
    batched, T is [b, k, k] and n_kept [b] lanes."""
    rdt = G.real.dtype if G.is_complex() else G.dtype
    G = masking.inject_diag(G, count, 1.0)

    D, Gs = scale_diag(G)
    D = D.to(rdt)

    w, V = eigh(Gs)

    # Sentinel eigenpairs live on dead coordinates; identify by mass.
    sent = masking.dead_mass(V, count) > 0.5

    absw = torch.abs(w)
    live_absw = torch.where(sent, 0.0, absw)
    maxeig = torch.amax(live_absw, dim=-1, keepdim=True)
    thresh = tau * maxeig

    if drop:
        dropped = (absw < thresh) | sent
    else:
        dropped = sent

    floor = torch.maximum(
        absw, torch.clamp(thresh, min=torch.finfo(rdt).tiny)
    )
    df = 1.0 / torch.sqrt(floor)
    T = (D[..., :, None] * V) * df[..., None, :].to(V.dtype)

    perm, n_kept = masking.compact_by_flag(dropped)
    T = masking.permute_cols(T, perm)
    T = masking.mask_cols(T, n_kept)
    return T.to(dtype), n_kept


def svqb(
    U: torch.Tensor,
    count,
    B: Optional[LinearOperator] = None,
    *,
    tau: float,
    drop: bool,
    rr_dtype=None,
):
    """B-orthonormalize the first `count` columns of U (SVQB).
    Returns (U_new, n_kept); columns >= n_kept of U_new are zero."""
    U = masking.mask_cols(U, count)
    G = gram_self(U, B, out_dtype=rr_dtype)
    T, n_kept = _svqb_transform(G, count, tau, drop, U.dtype)
    U_new = mm(U, T)
    return masking.mask_cols(U_new, n_kept), n_kept


@spanned(ORTHO)
def robust_basis_init(X, B, refill, *, tau, rr_dtype=None):
    """Full-rank B-orthonormal start basis from an arbitrary X0: SVQB
    with dropping, dropped slots refilled with random data, and one more
    SVQB pass.  ``refill`` is a zero-argument function returning the
    random [n, m] block (where the JAX package takes a key); it is
    called only when a column was dropped (batched: in some problem, and
    every problem gets the same draws, as under ``jax.vmap``)."""
    m = X.shape[-1]
    X1, kept = svqb(X, m, B, tau=tau, drop=True, rr_dtype=rr_dtype)
    if lanes.all_(kept == m):
        X2 = X1
    else:
        live = masking.as_mask(m, kept, X.device)
        X2 = torch.where(live[..., None, :], X1, refill().to(X.dtype))
    X3, _ = svqb(X2, m, B, tau=tau, drop=False, rr_dtype=rr_dtype)
    return X3


def svqb_mat(
    U: torch.Tensor,
    mat: torch.Tensor,
    *,
    tau: float,
):
    """SVQB against an explicit dense metric; never drops.  All columns
    live; runs entirely in U's dtype."""
    k = U.shape[-1]
    G = gram_self_mat(U, mat)
    T, _ = _svqb_transform(G, k, tau, False, U.dtype)
    return mm(U, T)
