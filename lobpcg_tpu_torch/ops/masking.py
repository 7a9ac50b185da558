"""Active-column masking (port of ``lobpcg_tpu/ops/masking.py``).

Every column block keeps its full width; a live count (columns [0, count)
live) or a boolean live-mask says which columns are live, and dead
columns are exactly zero.  Gram matrices over masked blocks get identity
(or sentinel) diagonals injected in the dead coordinates so the k x k
eigensolves stay well-posed.

Batched (``ops/lanes.py``): blocks and Grams may carry a leading batch
dimension, counts may be [b] integer tensors and masks [b, w] boolean
tensors, one per problem.  An unbatched count is a Python int; a count
read from the device is read through ``lanes.read``.
"""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.ops import lanes
from lobpcg_tpu_torch.ops.cuda import tail


def as_mask(width: int, live, device=None) -> torch.Tensor:
    """Normalize `live` to a boolean [width] mask ([b, width] for lanes).

    `live` may be an int (prefix count), a boolean mask, or an integer
    tensor of per-problem prefix counts [b].
    """
    if isinstance(live, torch.Tensor):
        if live.dtype == torch.bool:
            return live
        if live.dim() >= 1:
            ar = torch.arange(width, device=live.device)
            return ar < live[..., None]
    return torch.arange(width, device=device) < int(lanes.read(live))


def blocks_mask(widths: tuple[int, ...], counts, device=None) -> torch.Tensor:
    """Live mask for concatenated blocks, each with its own prefix count."""
    parts = [as_mask(w, c, device) for w, c in zip(widths, counts)]
    lead = max((p.shape[:-1] for p in parts), key=len)
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], dim=-1)


def mask_cols(U: torch.Tensor, live, out=None) -> torch.Tensor:
    """Zero the dead columns of U (one ``tail.compact`` pass; the eager
    multiply inside ``tail.eager_chain()``).  ``out``: where the kernel
    may write the result, U itself when U is the caller's scratch."""
    if not tail.eager():
        return tail.compact(U, 0, live, out)
    m = as_mask(U.shape[-1], live, U.device)
    return U * m[..., None, :].to(U.dtype)


def shift_cols(U: torch.Tensor, shift, new_count) -> torch.Tensor:
    """Drop the first `shift` columns and compact the rest to the front:
    output column j = U[..., j+shift] for j < new_count, zero otherwise
    (per problem for [b] shifts).  One ``tail.compact`` pass; inside
    ``tail.eager_chain()`` the eager gather, then ``mask_cols``."""
    if not tail.eager():
        return tail.compact(U, shift, new_count)
    w = U.shape[-1]
    ar = torch.arange(w, device=U.device)
    if isinstance(shift, torch.Tensor) and shift.dim() >= 1:
        src = torch.clamp(ar + shift[..., None], 0, w - 1)
        out = torch.take_along_dim(U, src[..., None, :], dim=-1)
    else:
        out = U[..., torch.clamp(ar + int(lanes.read(shift)), 0, w - 1)]
    return mask_cols(out, new_count)


def permute_cols(U: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder columns by an index vector ([b, k] for lanes)."""
    if perm.dim() == 1:
        return U[..., perm]
    return torch.take_along_dim(U, perm[..., None, :], dim=-1)


def diag(v: torch.Tensor) -> torch.Tensor:
    """The diagonal matrix of v [k] (or of each row of v [..., k])."""
    return torch.diag(v) if v.dim() == 1 else torch.diag_embed(v)


def inject_diag(G: torch.Tensor, live, diag_val) -> torch.Tensor:
    """Replace dead rows/cols of a Gram matrix with diag_val * e_j e_j^T
    (``diag_val`` a number, or one per problem)."""
    k = G.shape[-1]
    lm = as_mask(k, live, G.device)
    keep = (lm[..., :, None] & lm[..., None, :]).to(G.dtype)
    dead_diag = (~lm).to(G.dtype)
    if isinstance(diag_val, torch.Tensor):
        diag_val = diag_val.to(G.dtype)
        if diag_val.dim():
            diag_val = diag_val[..., None, None]
    return G * keep + diag_val * diag(dead_diag)


def dead_mass(V: torch.Tensor, live) -> torch.Tensor:
    """Per-eigenvector mass on dead coordinates: [k] real vector."""
    k = V.shape[-2]
    dead = ~as_mask(k, live, V.device)
    w = torch.abs(V) ** 2
    return torch.sum(w * dead[..., :, None], dim=-2)


def compact_by_flag(drop_flag: torch.Tensor):
    """Stable permutation putting kept (flag False) columns first.

    Returns (perm, n_kept); kept columns preserve their relative order.
    n_kept is an int, or [b] lanes for a [b, k] flag.
    """
    key = drop_flag.to(torch.int32)
    perm = torch.argsort(key, dim=-1, stable=True)
    n_kept = torch.sum(1 - key, dim=-1)
    return perm, (n_kept if n_kept.dim() else int(lanes.read(n_kept)))


def prefix_count(ok: torch.Tensor):
    """Length of the True-prefix of a boolean vector: an int, or [b]
    lanes for a [b, k] input (no host read)."""
    all_prefix = torch.cumprod(ok.to(torch.int32), dim=-1)
    n = torch.sum(all_prefix, dim=-1)
    return n if n.dim() else int(lanes.read(n))
