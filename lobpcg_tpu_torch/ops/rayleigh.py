"""Rayleigh-Ritz projected eigensolves, standard family (port of
``lobpcg_tpu/ops/rayleigh.py``).

The B-Gram whitening is spectral (eigh of the Jacobi-scaled Gram,
DiR = D U s^{-1/2}), block-upper-triangular over [X | P W] so the Cp
extraction reads X-content from the first nx rows; non-definiteness
(s_min <= 0) raises the retry flag 2.  Dead subspace coordinates carry
identity in the B-Gram and a sentinel above every live Ritz value.
Batched (``ops/lanes.py``), the flag and counts are [b] lanes and the
ortho / Cholesky branch is chosen per problem.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.gram import (
    applied_blocks,
    as_blocks,
    blocks_dtype,
    frob_norm,
    gram_blocks,
    gram_blocks_pre,
    gram_self,
    herm_tile_gram,
    mm,
    scale_diag,
)
from lobpcg_tpu_torch.ops.linalg import eigh
from lobpcg_tpu_torch.operators.linop import LinearOperator


class RRResult(NamedTuple):
    Cx: torch.Tensor  # [k, nx]
    Cp: torch.Tensor  # [k, nx] — columns >= p_count are zero
    lam: torch.Tensor  # [nx] real
    flag: int  # 0/1 = ok (value of useOrtho), 2 = retry needed ([b] lanes)
    p_count: int  # number of valid Cp columns ([b] lanes)


def _whiten_block(M):
    """Spectral whitening of one Hermitian block: F = D U s^{-1/2} from
    eigh(D M D) = U s U^H satisfies F^H M F = I when M is HPD.
    Returns (F, ok, s_min, s_max) over the full scaled spectrum."""
    D, Ms = scale_diag(M)
    s, U = eigh(Ms)  # ascending
    ok = torch.isfinite(s[..., 0]) & (s[..., 0] > 0) & (s[..., -1] > 0)
    s_safe = torch.where(s > 0, s, 1.0)
    F = (D[..., :, None].to(U.dtype) * U) \
        * torch.rsqrt(s_safe)[..., None, :].to(U.dtype)
    return F, ok, s_safe[..., 0], s_safe[..., -1]


def _block_dinv_r(G, nx: int):
    """Whitening transform for the B-Gram over [X | P W]: DiR with
    DiR^H G DiR = I, block-upper-triangular with the block boundary at
    nx (whiten X, B-orthogonalize [P W] against it through the Schur
    complement, whiten that).  Returns (DiR [k,k], ok, rcond)."""
    k = G.shape[-1]
    Fx, ok1, s1_lo, s1_hi = _whiten_block(G[..., :nx, :nx])
    E = mm(Fx.mH, G[..., :nx, nx:])
    Sc = G[..., nx:, nx:] - mm(E.mH, E)
    Sc = 0.5 * (Sc + Sc.mH)
    Fs, ok2, s2_lo, s2_hi = _whiten_block(Sc)
    top = torch.cat([Fx, -mm(Fx, mm(E, Fs))], dim=-1)
    bot = torch.cat(
        [Fs.new_zeros(Fs.shape[:-2] + (k - nx, nx)), Fs],
        dim=-1,
    )
    DiR = torch.cat([top, bot], dim=-2)
    ok = ok1 & ok2
    rcond = torch.where(
        ok,
        torch.sqrt(torch.minimum(s1_lo, s2_lo) / torch.maximum(s1_hi, s2_hi)),
        0.0,
    )
    return DiR, ok, rcond


def _sentinel(H, live):
    """Inject big*I into dead coordinates; big > any live eigenvalue."""
    big = 2.0 * frob_norm(H) + 1.0
    return masking.inject_diag(H, live, big.to(H.dtype))


def _cp_extract(Z, nx: int, DiR: Optional[torch.Tensor], n_live: int):
    """Duersch Alg. 7: Cp = [D_inv_R] V_perp Q, Q = QR-basis of Z1_perp^T
    (plain transpose).  Only the live unwanted eigenvectors (the first
    n_live - nx columns of Z_perp) take part; the result has
    p_count = clip(n_live - nx, 0, nx) columns.  Kept on QR, for the
    reason the JAX package's docstring gives.  Returns (Cp, p_count)."""
    k = Z.shape[-1]
    Zp = Z[..., nx:]
    zp_live = lanes.clip(n_live - nx, 0, k - nx)
    p_count = lanes.clip(n_live - nx, 0, nx)
    Zp = masking.mask_cols(Zp, zp_live)
    Z1t = Zp[..., :nx, :].transpose(-2, -1)
    Q, _ = torch.linalg.qr(Z1t)
    Cp = mm(Zp, Q)
    if DiR is not None:
        Cp = mm(DiR, Cp)
    return masking.mask_cols(Cp, p_count), p_count


def rayleigh_ritz(
    X: torch.Tensor,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    rr_dtype=None,
):
    """Initial RR on a full-width block: returns (Cx [m,m], lam [m]).
    A non-definite start Gram poisons the outputs with NaN."""
    G = gram_self(X, B, out_dtype=rr_dtype)
    DiR, def_ok, _, _ = _whiten_block(G)
    DiR = torch.where(def_ok[..., None, None], DiR, float("nan"))
    Ap = gram_self(X, A, out_dtype=rr_dtype)
    T1 = mm(Ap, DiR)
    H = mm(DiR.mH, T1)
    w, V = eigh(H)
    Cx = mm(DiR, V)
    return Cx.to(X.dtype), w


def _a_gram(blocks, AX, A, out_dtype=None, pack=True):
    """G_A = S^H A S per column block of S = [X | P | W], reusing the AX
    cache for the X block; upper-triangle contractions only."""
    pre = {0: AX} if AX is not None else {}
    applied = applied_blocks(A, blocks, pre, pack=pack)
    return herm_tile_gram(blocks, applied, out_dtype)


def rayleigh_ritz_modified(
    S,
    AX: Optional[torch.Tensor],
    np_act: int,
    nw_act: int,
    use_ortho: int,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    *,
    nx: int,
    tol_skip: float = 5e-3,
    rr_dtype=None,
    Bblocks=None,
    pack=True,
) -> RRResult:
    """Per-iteration RR over the masked [X|P|W] subspace (a [n, 3m]
    tensor or the blocks (X, P, W)).  ``use_ortho`` >= 1 takes the ortho
    branch; the Cholesky branch reports flag=2 when the B-Gram is not
    definite or rcond < tol_skip.  ``Bblocks``: pre-applied (B@X, B@P,
    B@W).  Batched, ``np_act``, ``nw_act`` and ``use_ortho`` may be
    [b] lanes."""
    blocks = as_blocks(S, nx)
    k = sum(b.shape[-1] for b in blocks)
    m = nx
    dev = blocks[0].device
    live = masking.blocks_mask((m, m, k - 2 * m), (m, np_act, nw_act), dev)
    n_live = m + lanes.count(np_act) + lanes.count(nw_act)
    GA = masking.inject_diag(
        _a_gram(blocks, AX, A, out_dtype=rr_dtype, pack=pack), live, 0.0
    )
    sdt = blocks_dtype(S)

    def ortho_branch():
        H = _sentinel(GA, live)
        w, Z = eigh(H)
        Cx = Z[..., :nx]
        lam = w[..., :nx]
        Cp, p_cnt = _cp_extract(Z, nx, None, n_live)
        return RRResult(Cx.to(sdt), Cp.to(sdt), lam, 1, p_cnt)

    def cholesky_branch():
        GB = (
            gram_blocks(blocks, B, out_dtype=rr_dtype) if Bblocks is None
            else gram_blocks_pre(blocks, Bblocks, out_dtype=rr_dtype)
        )
        GB = masking.inject_diag(GB, live, 1.0)
        DiR, def_ok, rcond = _block_dinv_r(GB, nx)
        ok = def_ok & (rcond >= tol_skip)
        DiR = torch.where(
            def_ok[..., None, None], DiR,
            torch.eye(k, dtype=DiR.dtype, device=DiR.device)
        )
        T1 = mm(GA, DiR)
        H = mm(DiR.mH, T1)
        H = 0.5 * (H + H.mH)
        # Dead-coordinate sentinels in pencil form: H + big * K^H K with
        # K the dead rows of DiR; big a Gershgorin bound off the actual H.
        gersh = torch.amax(torch.sum(torch.abs(H), dim=-1), dim=-1)
        big = (2.0 * gersh + 1.0).to(H.dtype)
        dead_rows = (~live).to(DiR.dtype)
        K = DiR * dead_rows[..., :, None]
        H = H + big[..., None, None] * mm(K.mH, K)
        w, Z = eigh(H)
        Cx = mm(DiR, Z[..., :nx])
        lam = w[..., :nx]
        Cp, p_cnt = _cp_extract(Z, nx, DiR, n_live)
        flag = lanes.select(lanes.read(ok), 0, 2)
        return RRResult(Cx.to(sdt), Cp.to(sdt), lam, flag, p_cnt)

    return lanes.cond(use_ortho >= 1, ortho_branch, cholesky_branch)
