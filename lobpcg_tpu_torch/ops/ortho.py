"""Robust basis maintenance: ortho_drop / ortho_indefinite (+_mat)
(port of ``lobpcg_tpu/ops/ortho.py``).

The outer/inner structure (project against V, SVQB-orthonormalize,
check Frobenius errors, exit early) is the JAX package's; its
``lax.while_loop``s are host loops here, with the same early exits and
the same caps.  Each loop test reads one device boolean.  Batched, a
loop runs until every problem is done and a done problem is frozen
(``ops/lanes.py``), as under a vmapped ``while_loop``: the test still
reads once for the whole batch.  Each entry point is a ``lobpcg.ortho``
span (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.gram import (
    _hdot,
    abs2,
    apply_block_op,
    as_blocks,
    b_mm_update,
    bh_dot,
    frob_norm,
    gram_blocks,
    gram_cross_mat,
    gram_self_mat,
    herm_tile_gram,
    mm,
    mm_masked,
    ortho_err,
    tall_frob_norm,
)
from lobpcg_tpu_torch.ops.cuda.linalg import scale_diag
from lobpcg_tpu_torch.ops.rows import row_sum
from lobpcg_tpu_torch.ops.svqb import _svqb_transform, svqb_mat
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.utils.profiling import ORTHO, spanned


def _guard(x, eps):
    """Norms below eps are replaced by 1 to avoid dividing by ~0."""
    return torch.where(x < eps, torch.ones_like(x), x)


def _bnorm(B, vb):
    """||B V||_F over V's column blocks — one [n, m] B-application
    transient at a time."""
    total = None
    for b in vb:
        Bb = apply_block_op(B, b)
        t = torch.sum(abs2(Bb), dim=(-2, -1))
        total = t if total is None else total + t
    return torch.sqrt(row_sum(total))


def _bv_norm(Bvb, eps_ortho):
    """||B V||_F from the pre-applied blocks (B@X, B@P)."""
    bv2 = row_sum(sum(torch.sum(abs2(Bb), dim=(-2, -1)) for Bb in Bvb))
    return _guard(torch.sqrt(bv2), eps_ortho)


def _inner_err_ok(U, BU, G, nu, B, eps_ortho, *, indefinite):
    """The inner-loop convergence criterion: ortho_drop normalizes by
    ||B U||*||U||; ortho_indefinite by ||U||^2."""
    err = ortho_err(G, nu)
    U_norm = _guard(tall_frob_norm(U), eps_ortho)
    if indefinite:
        denom = U_norm * U_norm
    else:
        BU_norm = U_norm if B is None else _guard(tall_frob_norm(BU), eps_ortho)
        denom = BU_norm * U_norm
    return err / denom < eps_ortho


def _svqb_inner_loop(
    U, BU0, G0, nu, B, eps_ortho, eps_drop, max_inner, *, indefinite,
    rr_dtype=None, seed_done=False
):
    """Repeat svqb until ||U^H B U - I_sig|| is small (at most max_inner
    passes).  The Gram and the application BU are carried, so each pass
    costs one operator application, and on exit BU matches the returned
    U.  ``seed_done``: test the criterion on the seed state first, so an
    already-orthonormal entry skips the SVQB pass.  Returns (U, BU, nu).
    """
    done = (
        lanes.read(_inner_err_ok(U, BU0, G0, nu, B, eps_ortho,
                                 indefinite=indefinite))
        if seed_done else False
    )
    BU, G = BU0, G0
    i = 0
    while i < max_inner and not lanes.all_(done):
        # Lanes that are done keep their state (only a batch holds it).
        kept = (U, BU, G, nu) if lanes.is_lanes(done) else None
        T, nu = _svqb_transform(G, nu, eps_drop, True, U.dtype)
        U = mm_masked(U, T, nu)
        BU = apply_block_op(B, U)
        G = _hdot(U, BU, rr_dtype)
        if kept is not None:
            U, BU, G, nu = lanes.select(done, kept, (U, BU, G, nu))
            del kept
        done = done | lanes.read(_inner_err_ok(U, BU, G, nu, B, eps_ortho,
                                               indefinite=indefinite))
        i += 1
    return U, BU, nu


def _entry_state(U, nu, B, vb, Bvb, BV_norm, eps_ortho, eps_drop,
                 rr_dtype, *, indefinite):
    """ortho_skip entry check: is U already B-orthonormal up to column
    scaling, and B-orthogonal to V?  Returns (U_scaled, B@U_scaled,
    skip bool).  The skip also requires every live |G_ii| above an
    eps_drop-scale floor relative to the largest, so near-B-null columns
    still reach the dropping SVQB."""
    BU = apply_block_op(B, U)
    G = _hdot(U, BU, rr_dtype)
    D, Gs = scale_diag(G)
    Dc = D.to(U.dtype)
    U = U * Dc[..., None, :]
    BU = BU * Dc[..., None, :]
    gd = torch.abs(torch.diagonal(G, dim1=-2, dim2=-1))
    live = masking.as_mask(gd.shape[-1], nu, gd.device)
    gmax = torch.amax(torch.where(live, gd, 0.0), dim=-1)
    gmin = torch.amin(torch.where(live, gd, float("inf")), dim=-1)
    floor_ok = gmin >= eps_drop * gmax
    ok_self = floor_ok & _inner_err_ok(
        U, BU, Gs, nu, B, eps_ortho, indefinite=indefinite
    )
    coef = (
        bh_dot(Bvb, U, rr_dtype) if Bvb is not None
        else bh_dot(vb, BU, rr_dtype)
    )
    U_norm = _guard(tall_frob_norm(U), eps_ortho)
    rerr = frob_norm(coef) / (BV_norm * U_norm)
    return U, BU, lanes.read(ok_self & (rerr < eps_ortho))


def _outer_loop(U, nu, vb, B, Bvb, BV_norm, sig, eps_ortho, eps_drop,
                max_outer, max_inner, rr_dtype, entry_check, indefinite):
    """The shared outer loop of ortho_drop / ortho_indefinite: project
    (through ``sig`` when indefinite), run the SVQB inner loop, check
    ||V^H B U||.  Returns (U, nu, BU)."""
    if entry_check:
        U, BU, done = _entry_state(
            U, nu, B, vb, Bvb, BV_norm, eps_ortho, eps_drop, rr_dtype,
            indefinite=indefinite,
        )
    else:
        BU, done = None, False  # the body always runs at least once
    outer = 0
    while outer < max_outer and not lanes.all_(done):
        # Lanes that are done keep their state (only a batch holds it).
        kept = (U, BU, nu) if lanes.is_lanes(done) else None
        coef = (
            bh_dot(Bvb, U) if Bvb is not None else
            bh_dot(vb, apply_block_op(B, U))
        )
        if indefinite:
            coef = mm(sig, coef)
        U = b_mm_update(U, vb, coef, nu)
        BU = apply_block_op(B, U)
        G0 = _hdot(U, BU, rr_dtype)
        U, BU, nu = _svqb_inner_loop(
            U, BU, G0, nu, B, eps_ortho, eps_drop, max_inner,
            indefinite=indefinite, rr_dtype=rr_dtype, seed_done=entry_check,
        )
        if kept is not None:
            U, BU, nu = lanes.select(done, kept, (U, BU, nu))
            del kept
        coef2 = bh_dot(vb, BU)
        U_norm = _guard(tall_frob_norm(U), eps_ortho)
        rerr = frob_norm(coef2) / (BV_norm * U_norm)
        done = done | lanes.read(rerr < eps_ortho)
        outer += 1
    if BU is None:  # max_outer == 0: U is returned as it came
        BU = apply_block_op(B, U)
    return U, nu, BU


@spanned(ORTHO)
def ortho_drop(
    U: torch.Tensor,
    nu,
    V,
    nv,
    B: Optional[LinearOperator] = None,
    *,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
    rr_dtype=None,
    Bvb=None,
    return_bu: bool = False,
    entry_check: bool = False,
):
    """B-orthogonalize U against V (B positive semi-definite), with
    column dropping.  Returns (U_new, retained_count[, B@U_new]).

    V is a [n, kv] tensor or a tuple of blocks (X, P) whose dead columns
    are exactly zero.  ``Bvb`` — pre-applied (B@X, B@P) — replaces the
    projector's B application and sources ||B V||; ``return_bu=True``
    also returns the exit B@U.
    """
    nu = lanes.count(nu)
    del nv
    vb = as_blocks(V, U.shape[-1])
    U = masking.mask_cols(U, nu)
    if Bvb is not None:
        BV_norm = _bv_norm(Bvb, eps_ortho)
    else:
        BV_norm = _guard(_bnorm(B, vb), eps_ortho)
    U, nu, BU = _outer_loop(
        U, nu, vb, B, Bvb, BV_norm, None, eps_ortho, eps_drop, max_outer,
        max_inner, rr_dtype, entry_check, indefinite=False,
    )
    if return_bu:
        return U, nu, BU
    return U, nu


@spanned(ORTHO)
def ortho_indefinite(
    U: torch.Tensor,
    nu,
    V,
    nv,
    B: Optional[LinearOperator] = None,
    sig: Optional[torch.Tensor] = None,
    *,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
    rr_dtype=None,
    Bvb=None,
    return_bu: bool = False,
    entry_check: bool = False,
):
    """Signature-weighted B-orthogonalization of U against V (B
    indefinite): the projector is V sig (V^H B U) with sig = V^H B V
    (computed when not supplied).  ``Bvb`` / ``return_bu`` as in
    ortho_drop."""
    nu = lanes.count(nu)
    del nv
    vb = as_blocks(V, U.shape[-1])
    U = masking.mask_cols(U, nu)
    if Bvb is not None:
        if sig is None:
            sig = herm_tile_gram(vb, Bvb)
        BV_norm = _bv_norm(Bvb, eps_ortho)
    else:
        if sig is None:
            sig = gram_blocks(vb, B)
        BV_norm = _guard(_bnorm(B, vb), eps_ortho)
    U, nu, BU = _outer_loop(
        U, nu, vb, B, Bvb, BV_norm, sig, eps_ortho, eps_drop, max_outer,
        max_inner, rr_dtype, entry_check, indefinite=True,
    )
    if return_bu:
        return U, nu, BU
    return U, nu


@spanned(ORTHO)
def ortho_indefinite_mat(
    U: torch.Tensor,
    V: torch.Tensor,
    mat: torch.Tensor,
    *,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
) -> torch.Tensor:
    """Coefficient-space orthogonalization against an explicit dense
    indefinite metric, with the double projection
    U -= V (V^H mat V) (V^H mat U) applied as two single projections.
    No dropping."""
    MV_norm = _guard(frob_norm(mm(mat, V)), eps_ortho)

    def inner(U):
        i, done = 0, False
        while i < max_inner and not lanes.all_(done):
            U = lanes.select(done, U, svqb_mat(U, mat, tau=eps_drop))
            G = gram_self_mat(U, mat)
            err = ortho_err(G)
            U_norm = _guard(frob_norm(U), eps_ortho)
            done = done | lanes.read(err / (U_norm * U_norm) < eps_ortho)
            i += 1
        return U

    outer, done = 0, False
    while outer < max_outer and not lanes.all_(done):
        c1 = gram_cross_mat(V, U, mat)
        t1 = mm(V, c1)
        c2 = gram_cross_mat(V, t1, mat)
        U = lanes.select(done, U, inner(U - mm(V, c2)))
        c3 = gram_cross_mat(V, U, mat)
        U_norm = _guard(frob_norm(U), eps_ortho)
        rerr = frob_norm(c3) / (MV_norm * U_norm)
        done = done | lanes.read(rerr < eps_ortho)
        outer += 1
    return U
