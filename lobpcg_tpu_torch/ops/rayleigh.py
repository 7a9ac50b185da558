"""Rayleigh-Ritz projected eigensolves, standard family (port of
``lobpcg_tpu/ops/rayleigh.py``).

The B-Gram whitening is spectral (eigh of the Jacobi-scaled Gram,
DiR = D U s^{-1/2}), block-upper-triangular over [X | P W] so the Cp
extraction reads X-content from the first nx rows; non-definiteness
(s_min <= 0) raises the retry flag 2.  Dead subspace coordinates carry
identity in the B-Gram and a sentinel above every live Ritz value.
Batched (``ops/lanes.py``), the flag and counts are [b] lanes and the
ortho / Cholesky branch is chosen per problem.  The Cholesky branch's
k x k stage, from the Grams to the Ritz coefficients and the flag, is
``ops/cuda/rr.py:cholesky_stage`` (one launch of csrc/rr.cu on the card).
Each entry point is a ``lobpcg.rr`` span (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.cuda import rr as rr_kernel
from lobpcg_tpu_torch.ops.cuda.linalg import eigh
from lobpcg_tpu_torch.ops.cuda.rr import cp_extract, whiten_block
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
)
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.utils.profiling import RR, spanned


class RRResult(NamedTuple):
    Cx: torch.Tensor  # [k, nx]
    Cp: torch.Tensor  # [k, nx] — columns >= p_count are zero
    lam: torch.Tensor  # [nx] real
    flag: int  # 0/1 = ok (value of useOrtho), 2 = retry needed ([b] lanes)
    p_count: int  # number of valid Cp columns ([b] lanes)


def _sentinel(H, live):
    """Inject big*I into dead coordinates; big > any live eigenvalue."""
    big = 2.0 * frob_norm(H) + 1.0
    return masking.inject_diag(H, live, big.to(H.dtype))


@spanned(RR)
def rayleigh_ritz(
    X: torch.Tensor,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    rr_dtype=None,
):
    """Initial RR on a full-width block: returns (Cx [m,m], lam [m]).
    A non-definite start Gram poisons the outputs with NaN."""
    G = gram_self(X, B, out_dtype=rr_dtype)
    DiR, def_ok, _, _ = whiten_block(G)
    DiR = torch.where(def_ok[..., None, None], DiR, float("nan"))
    Ap = gram_self(X, A, out_dtype=rr_dtype, role="A")
    T1 = mm(Ap, DiR)
    H = mm(DiR.mH, T1)
    w, V = eigh(H)
    Cx = mm(DiR, V)
    return Cx.to(X.dtype), w


def _a_gram(blocks, AX, A, out_dtype=None, pack=True):
    """G_A = S^H A S per column block of S = [X | P | W], reusing the AX
    cache for the X block; upper-triangle contractions only."""
    pre = {0: AX} if AX is not None else {}
    applied = applied_blocks(A, blocks, pre, pack=pack, role="A")
    return herm_tile_gram(blocks, applied, out_dtype)


@spanned(RR)
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
    GA = _a_gram(blocks, AX, A, out_dtype=rr_dtype, pack=pack)
    sdt = blocks_dtype(S)

    def ortho_branch():
        live = masking.blocks_mask((m, m, k - 2 * m), (m, np_act, nw_act), dev)
        n_live = m + lanes.count(np_act) + lanes.count(nw_act)
        H = _sentinel(masking.inject_diag(GA, live, 0.0), live)
        w, Z = eigh(H)
        Cx = Z[..., :nx]
        lam = w[..., :nx]
        Cp, p_cnt = cp_extract(Z, nx, None, n_live)
        return RRResult(Cx.to(sdt), Cp.to(sdt), lam, 1, p_cnt)

    def cholesky_branch():
        GB = (
            gram_blocks(blocks, B, out_dtype=rr_dtype) if Bblocks is None
            else gram_blocks_pre(blocks, Bblocks, out_dtype=rr_dtype)
        )
        Cx, Cp, lam, ok, p_cnt = rr_kernel.cholesky_stage(
            GA, GB, np_act, nw_act, nx=nx, tol_skip=tol_skip, out_dtype=sdt)
        flag = lanes.select(lanes.read(ok), 0, 2)
        return RRResult(Cx, Cp, lam, flag, p_cnt)

    return lanes.cond(use_ortho >= 1, ortho_branch, cholesky_branch)
