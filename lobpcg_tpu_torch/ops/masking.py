"""Active-column masking (port of ``lobpcg_tpu/ops/masking.py``).

Every column block keeps its full width; a live count (a Python int:
columns [0, count) live) or a boolean live-mask says which columns are
live, and dead columns are exactly zero.  Gram matrices over masked
blocks get identity (or sentinel) diagonals injected in the dead
coordinates so the k x k eigensolves stay well-posed.
"""

from __future__ import annotations

import torch


def as_mask(width: int, live, device=None) -> torch.Tensor:
    """Normalize `live` to a boolean [width] mask.

    `live` may be an int (prefix count) or a boolean tensor.
    """
    if isinstance(live, torch.Tensor) and live.dim() == 1:
        return live.to(torch.bool)
    return torch.arange(width, device=device) < int(live)


def blocks_mask(widths: tuple[int, ...], counts, device=None) -> torch.Tensor:
    """Live mask for concatenated blocks, each with its own prefix count."""
    parts = [as_mask(w, c, device) for w, c in zip(widths, counts)]
    return torch.cat(parts)


def mask_cols(U: torch.Tensor, live) -> torch.Tensor:
    """Zero the dead columns of U."""
    m = as_mask(U.shape[1], live, U.device)
    return U * m[None, :].to(U.dtype)


def shift_cols(U: torch.Tensor, shift: int, new_count: int) -> torch.Tensor:
    """Drop the first `shift` columns and compact the rest to the front:
    output column j = U[:, j+shift] for j < new_count, zero otherwise."""
    w = U.shape[1]
    src = torch.clamp(torch.arange(w, device=U.device) + int(shift), 0, w - 1)
    out = U[:, src]
    return mask_cols(out, new_count)


def permute_cols(U: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder columns by an index vector."""
    return U[:, perm]


def inject_diag(G: torch.Tensor, live, diag_val) -> torch.Tensor:
    """Replace dead rows/cols of a Gram matrix with diag_val * e_j e_j^T."""
    k = G.shape[0]
    lm = as_mask(k, live, G.device)
    keep = (lm[:, None] & lm[None, :]).to(G.dtype)
    dead_diag = (~lm).to(G.dtype)
    if isinstance(diag_val, torch.Tensor):
        diag_val = diag_val.to(G.dtype)
    return G * keep + diag_val * torch.diag(dead_diag)


def dead_mass(V: torch.Tensor, live) -> torch.Tensor:
    """Per-eigenvector mass on dead coordinates: [k] real vector."""
    k = V.shape[0]
    dead = ~as_mask(k, live, V.device)
    w = torch.abs(V) ** 2
    return torch.sum(w * dead[:, None], dim=0)


def compact_by_flag(drop_flag: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Stable permutation putting kept (flag False) columns first.

    Returns (perm, n_kept); kept columns preserve their relative order.
    """
    key = drop_flag.to(torch.int32)
    perm = torch.argsort(key, stable=True)
    n_kept = int(torch.sum(1 - key))
    return perm, n_kept


def prefix_count(ok: torch.Tensor) -> int:
    """Length of the True-prefix of a boolean vector."""
    all_prefix = torch.cumprod(ok.to(torch.int32), dim=0)
    return int(torch.sum(all_prefix))
