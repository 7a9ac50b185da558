"""The eager chains that the hand-written tail and projection kernels
replace, written out operation for operation as the call sites ran them
before the kernels, with nothing of the package: the independent
references that the kernels' plain versions, the routed call sites and
the call sites inside ``chains.eager_chain()`` are held to bit for bit
(``test_torch_tail.py``, ``test_torch_proj_kernel.py``,
``test_torch_gpu.py``).

- ``mask``: ``masking.mask_cols``, a multiply by the live mask cast to
  the block's dtype;
- ``shift``: ``masking.shift_cols``, the clamp-index gather (per problem
  for [b] shifts), then ``mask``;
- ``antidiag``: ``BlockAntiDiagOperator.matmat``, d times each half's
  partner half and a ``cat`` (``BlockDiagOperator`` runs it a copy at a
  time and ``cat``s the copies); ``scaled_swap``, the sharded form with
  its rows local: the swapped rows, then a multiply by the row scales;
- ``residual``: ``get_residual``, AX - BX * lam cast to BX's dtype;
- ``b_mm``: a ``torch.matmul`` a term, added left to right by ``+``;
  ``b_mm_update``: ``mask(U - b_mm)``; ``mm_masked``: ``mask(U @ T)``;
- ``rr_cholesky``: the standard Rayleigh-Ritz's Cholesky branch from its
  Grams GA and GB to (Cx, Cp, lam, ok, p_count), as ``ops/rayleigh.py``
  ran it before ``csrc/rr.cu``: the blocks' live mask, the dead diagonals
  injected, the block whitening through two ``eigh`` of Jacobi-scaled
  blocks, H = DiR^T GA DiR with dead-row sentinels, ``eigh``, and Cp from
  a QR (``eigh``: ``ops/linalg.py``'s, the finite check, the symmetrized
  matrix solved in float64 and rounded back, NaN where not finite).
"""

import torch


def live_mask(width: int, live, device=None) -> torch.Tensor:
    """The boolean [width] ([b, width]) mask of a count, [b] counts or a
    boolean mask."""
    if isinstance(live, torch.Tensor):
        if live.dtype == torch.bool:
            return live
        if live.dim() >= 1:
            return torch.arange(width, device=live.device) < live[..., None]
        live = live.item()
    return torch.arange(width, device=device) < int(live)


def mask(U: torch.Tensor, live) -> torch.Tensor:
    m = live_mask(U.shape[-1], live, U.device)
    return U * m[..., None, :].to(U.dtype)


def shift(U: torch.Tensor, shift, live) -> torch.Tensor:
    w = U.shape[-1]
    ar = torch.arange(w, device=U.device)
    if isinstance(shift, torch.Tensor) and shift.dim() >= 1:
        src = torch.clamp(ar + shift[..., None], 0, w - 1)
        out = torch.take_along_dim(U, src[..., None, :], dim=-1)
    else:
        out = U[..., torch.clamp(ar + int(shift), 0, w - 1)]
    return mask(out, live)


def antidiag(X: torch.Tensor, d: torch.Tensor, copies: int = 1) -> torch.Tensor:
    h = d.shape[-1]
    dd = d.unsqueeze(-1)

    def one(Xc):
        return torch.cat([dd * Xc[..., h:, :], dd * Xc[..., :h, :]], dim=-2)

    if copies == 1:
        return one(X)
    return torch.cat([one(X[..., 2 * h * i:2 * h * (i + 1), :])
                      for i in range(copies)], dim=-2)


def scaled_swap(X: torch.Tensor, s: torch.Tensor, copies: int = 1) -> torch.Tensor:
    """s[:, None] * X with each copy's two halves of rows swapped (the
    swap a copy of indices: no arithmetic)."""
    h = X.shape[-2] // (2 * copies)
    src = torch.cat([torch.cat([torch.arange(h) + (2 * i + 1) * h,
                                torch.arange(h) + 2 * i * h])
                     for i in range(copies)]).to(X.device)
    return s[..., None] * X[..., src, :]


def residual(AX: torch.Tensor, BX: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    return AX - BX * lam[..., None, :].to(BX.dtype)


def b_mm(blocks, C: torch.Tensor) -> torch.Tensor:
    out, j = None, 0
    for b in blocks:
        w = b.shape[-1]
        t = torch.matmul(b, C[..., j:j + w, :])
        out = t if out is None else out + t
        j += w
    return out


def b_mm_update(U: torch.Tensor, blocks, C: torch.Tensor, live) -> torch.Tensor:
    return mask(U - b_mm(blocks, C), live)


def mm_masked(U: torch.Tensor, T: torch.Tensor, live) -> torch.Tensor:
    return mask(torch.matmul(U, T), live)


def _clip(x, lo, hi):
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.clamp(x, min=lo), max=hi)
    return min(max(x, lo), hi)


def eigh(M: torch.Tensor):
    finite = torch.isfinite(M).flatten(-2).all(-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Msafe = torch.where(finite[..., None, None], 0.5 * (M + M.mH), eye)
    wide = {torch.float32: torch.float64,
            torch.complex64: torch.complex128}.get(M.dtype, M.dtype)
    w, V = torch.linalg.eigh(Msafe.to(wide))
    rdt = M.dtype.to_real() if M.is_complex() else M.dtype
    w = torch.where(finite[..., None], w.to(rdt), float("nan"))
    V = torch.where(finite[..., None, None], V.to(M.dtype), float("nan"))
    return w, V


def _inject(G: torch.Tensor, lm: torch.Tensor, val: float) -> torch.Tensor:
    keep = (lm[..., :, None] & lm[..., None, :]).to(G.dtype)
    dead = (~lm).to(G.dtype)
    return G * keep + val * (torch.diag(dead) if dead.dim() == 1
                             else torch.diag_embed(dead))


def _whiten(M: torch.Tensor):
    gd = torch.abs(torch.diagonal(M, dim1=-2, dim2=-1))
    pos = gd > 0
    D = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, gd, 1.0)), 1.0)
    s, U = eigh((D[..., :, None] * M) * D[..., None, :])
    ok = torch.isfinite(s[..., 0]) & (s[..., 0] > 0) & (s[..., -1] > 0)
    s_safe = torch.where(s > 0, s, 1.0)
    F = (D[..., :, None] * U) * torch.rsqrt(s_safe)[..., None, :]
    return F, ok, s_safe[..., 0], s_safe[..., -1]


def rr_cholesky(GA, GB, np_act, nw_act, nx, tol_skip, out_dtype):
    k, m = GA.shape[-1], nx
    parts = [live_mask(m, m, GA.device), live_mask(m, np_act, GA.device),
             live_mask(k - 2 * m, nw_act, GA.device)]
    lead = max((q.shape[:-1] for q in parts), key=len)
    lm = torch.cat([q.expand(lead + q.shape[-1:]) for q in parts], dim=-1)
    n_live = m + (np_act if isinstance(np_act, torch.Tensor) and np_act.dim()
                  else int(np_act)) \
        + (nw_act if isinstance(nw_act, torch.Tensor) and nw_act.dim()
           else int(nw_act))
    GA = _inject(GA, lm, 0.0)
    GB = _inject(GB, lm, 1.0)
    Fx, ok1, lo1, hi1 = _whiten(GB[..., :nx, :nx])
    E = torch.matmul(Fx.mH, GB[..., :nx, nx:])
    Sc = GB[..., nx:, nx:] - torch.matmul(E.mH, E)
    Sc = 0.5 * (Sc + Sc.mH)
    Fs, ok2, lo2, hi2 = _whiten(Sc)
    top = torch.cat([Fx, -torch.matmul(Fx, torch.matmul(E, Fs))], dim=-1)
    bot = torch.cat([Fs.new_zeros(Fs.shape[:-2] + (k - nx, nx)), Fs], dim=-1)
    DiR = torch.cat([top, bot], dim=-2)
    def_ok = ok1 & ok2
    rcond = torch.where(
        def_ok, torch.sqrt(torch.minimum(lo1, lo2) / torch.maximum(hi1, hi2)),
        0.0)
    ok = def_ok & (rcond >= tol_skip)
    DiR = torch.where(def_ok[..., None, None], DiR,
                      torch.eye(k, dtype=DiR.dtype, device=DiR.device))
    H = torch.matmul(DiR.mH, torch.matmul(GA, DiR))
    H = 0.5 * (H + H.mH)
    big = 2.0 * torch.amax(torch.sum(torch.abs(H), dim=-1), dim=-1) + 1.0
    K = DiR * (~lm).to(DiR.dtype)[..., :, None]
    H = H + big[..., None, None] * torch.matmul(K.mH, K)
    w, Z = eigh(H)
    Cx = torch.matmul(DiR, Z[..., :nx])
    Zp = mask(Z[..., nx:], _clip(n_live - nx, 0, k - nx))
    Q, _ = torch.linalg.qr(Zp[..., :nx, :].transpose(-2, -1))
    p_count = _clip(n_live - nx, 0, nx)
    Cp = mask(torch.matmul(DiR, torch.matmul(Zp, Q)), p_count)
    return (Cx.to(out_dtype), Cp.to(out_dtype), w[..., :nx], ok, p_count)
