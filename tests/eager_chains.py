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
  ``b_mm_update``: ``mask(U - b_mm)``; ``mm_masked``: ``mask(U @ T)``.
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
