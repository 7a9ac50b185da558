"""Indefinite Rayleigh-Ritz, Kressner-Pandur-Shao family (port of
``lobpcg_tpu/ops/indefinite.py``).

The projected pencil solve runs through ops.pencil; the signature sort
(positives ascending, then negatives descending, then zero-signature
entries last) is two stable argsorts, since torch has no lexsort.
Sentinel (masked-coordinate) eigenpairs are detected by their coordinate
mass, get signature 0, and therefore sort last.  Batched (``ops/lanes.py``),
``quality`` and ``rr_ok`` are [b] lanes and the dual-basis stabilization
runs when some problem needs it.  Each entry point is a ``lobpcg.rr``
span (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.gram import (
    as_blocks,
    blocks_dtype,
    frob_norm,
    gram_blocks,
    gram_blocks_pre,
    gram_self,
    mm,
)
from lobpcg_tpu_torch.ops.ortho import ortho_indefinite_mat
from lobpcg_tpu_torch.ops.pencil import pencil_eig
from lobpcg_tpu_torch.ops.rayleigh import _a_gram
from lobpcg_tpu_torch.ops.svqb import svqb_mat
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.utils.profiling import RR, spanned


class IndefiniteRRResult(NamedTuple):
    Cx: torch.Tensor  # [k, nx] accurate eigenvector coefficients
    Cp: torch.Tensor  # [k, nx] = [0; lower block of Cx], orthogonalized
    Cx_ortho: torch.Tensor  # [k, nx] stabilized basis (== Cx when quality ok)
    lam: torch.Tensor  # [nx] real
    sig: torch.Tensor  # [k] i32 signature, sorted order (0 = dead sentinel)
    quality: int  # 1 good, 5 poor (dual-basis projection); [b] lanes
    rr_ok: bool  # projected pencil solve succeeded; [b] lanes


def signature_sort(lam: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """Permutation: sig>0 ascending by lam, then sig<0 descending by lam,
    then sig==0 last (stable) — a lexsort on (group, value) written as
    two stable argsorts, the secondary key first."""
    group = torch.where(sig > 0, 0, torch.where(sig < 0, 1, 2)).to(torch.int32)
    val = torch.where(sig > 0, lam, torch.where(sig < 0, -lam, 0.0))
    by_val = torch.argsort(val, dim=-1, stable=True)
    by_group = torch.argsort(torch.take_along_dim(group, by_val, dim=-1),
                             dim=-1, stable=True)
    return torch.take_along_dim(by_val, by_group, dim=-1)


def _b_normalize(V: torch.Tensor, GB: torch.Tensor, tiny: float):
    """Scale columns by 1/sqrt(|diag(V^H GB V)|).  Returns (V_scaled,
    diag); diag carries the signature information."""
    GBV = mm(GB, V)
    d = torch.sum(V.conj() * GBV, dim=-2)
    ad = torch.abs(d)
    big = ad > tiny
    scale = torch.where(big, 1.0 / torch.sqrt(torch.where(big, ad, 1.0)), 1.0)
    return V * scale[..., None, :].to(V.dtype), d


@spanned(RR)
def indefinite_rayleigh_ritz(
    X: torch.Tensor,
    A: LinearOperator,
    B: LinearOperator,
    *,
    method: str,
    tiny: float,
    rr_dtype=None,
):
    """Initial indefinite RR on a full-width block.  Returns (Cx [m,m],
    lam [m] real sorted, sig [m] i32 sorted, ok 0-d bool)."""
    GA = gram_self(X, A, out_dtype=rr_dtype, role="A")
    GB = gram_self(X, B, out_dtype=rr_dtype)
    lam, V, ok = pencil_eig(GA, GB, method=method, tiny=tiny)
    V, d = _b_normalize(V, GB, tiny)
    sig = torch.where(d.real >= 0, 1, -1).to(torch.int32)
    perm = signature_sort(lam, sig)
    return (
        masking.permute_cols(V, perm).to(X.dtype),
        torch.take_along_dim(lam, perm, dim=-1),
        torch.take_along_dim(sig, perm, dim=-1),
        ok,
    )


@spanned(RR)
def indefinite_rayleigh_ritz_modified(
    S,
    AX: Optional[torch.Tensor],
    np_act: int,
    nw_act: int,
    A: LinearOperator,
    B: LinearOperator,
    *,
    nx: int,
    method: str,
    tiny: float,
    quality_tol: float,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
    rr_dtype=None,
    Bblocks=None,
    pack=True,
) -> IndefiniteRRResult:
    """Per-iteration indefinite RR over the masked [X|P|W] subspace:
    double B-normalization, B-orthogonality quality check, signature
    sort, Cx / Cp = [0; Z2] extraction, and the quality=5 dual-basis
    fallback (svqb_mat-stabilized Cx_ortho).  ``Bblocks``: pre-applied
    (B@X, B@P, B@W)."""
    blocks = as_blocks(S, nx)
    k = sum(b.shape[-1] for b in blocks)
    m = nx
    dev = blocks[0].device
    live = masking.blocks_mask((m, m, k - 2 * m), (m, np_act, nw_act), dev)
    sdt = blocks_dtype(S)

    GA = _a_gram(blocks, AX, A, out_dtype=rr_dtype, pack=pack)
    GB = (
        gram_blocks(blocks, B, out_dtype=rr_dtype) if Bblocks is None
        else gram_blocks_pre(blocks, Bblocks, out_dtype=rr_dtype)
    )
    # Dead coordinates: unit pencil eigenpair, forced to sig = 0 below.
    GA = masking.inject_diag(GA, live, 1.0)
    GB = masking.inject_diag(GB, live, 1.0)

    lam_all, V, rr_ok = pencil_eig(
        GA, GB, method=method, tiny=tiny, live=live
    )

    # Double B-normalization.
    V, _ = _b_normalize(V, GB, tiny)
    V, d2 = _b_normalize(V, GB, tiny)
    sig = torch.where(d2.real >= 0, 1, -1).to(torch.int32)

    sent = masking.dead_mass(V, live) > 0.5
    sig = torch.where(sent, 0, sig).to(torch.int32)

    # Quality check over live eigenvectors.
    live_cols = (~sent)[..., None, :].to(V.dtype)
    Vl = V * live_cols
    GBVl = mm(GB, Vl)
    G2 = mm(Vl.mH, GBVl)
    g2d = torch.diagonal(G2, dim1=-2, dim2=-1)
    dd = torch.abs(g2d) - torch.where(sent, 0.0, 1.0)
    E = G2 - masking.diag(g2d) + masking.diag(dd.to(G2.dtype))
    eerr = frob_norm(E)
    cerr = frob_norm(Vl)
    bcerr = frob_norm(GBVl)
    quality_ok = (bcerr < tiny) | (eerr <= quality_tol * cerr * bcerr)
    # One host read for both branch flags (none for lanes).
    q_ok, rr_ok = lanes.read_pair(quality_ok, rr_ok)

    perm = signature_sort(lam_all, sig)
    V = masking.permute_cols(V, perm)
    lam_all = torch.take_along_dim(lam_all, perm, dim=-1)
    sig = torch.take_along_dim(sig, perm, dim=-1)

    Cx = V[..., :nx]
    lam = lam_all[..., :nx]
    Cp0 = Cx.clone()
    Cp0[..., :nx, :] = 0

    # Poor quality: iterate a stabilized basis (the dual-basis fallback).
    Cx_o = lanes.cond(q_ok, lambda: Cx,
                      lambda: svqb_mat(Cx, GB, tau=eps_drop))
    Cp = ortho_indefinite_mat(
        Cp0, Cx_o, GB,
        eps_ortho=eps_ortho, eps_drop=eps_drop,
        max_outer=max_outer, max_inner=max_inner,
    )
    return IndefiniteRRResult(
        Cx.to(sdt), Cp.to(sdt), Cx_o.to(sdt), lam, sig,
        lanes.select(q_ok, 1, 5), rr_ok,
    )
