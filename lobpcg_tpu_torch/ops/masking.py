"""Active-column masking (port of ``lobpcg_tpu/ops/masking.py``).

Every column block keeps its full width; a live count (columns [0, count)
live) or a boolean live-mask says which columns are live, and dead
columns are exactly zero.  Gram matrices over masked blocks get identity
(or sentinel) diagonals injected in the dead coordinates so the k x k
eigensolves stay well-posed.

Batched (``ops/lanes.py``): blocks and Grams may carry a leading batch
dimension, counts may be [b] integer tensors and masks [b, w] boolean
tensors, one per problem.  An unbatched count is a Python int; a count
read from the device is read through ``lanes.read``.  ``as_mask``,
``blocks_mask``, ``diag`` and ``inject_diag`` are ``ops/cuda/chains.py``'s,
shared with the kernel layer's plain versions.
"""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.ops import lanes
from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.cuda.chains import (
    as_mask,
    blocks_mask,
    diag,
    inject_diag,
)


def mask_cols(U: torch.Tensor, live, out=None) -> torch.Tensor:
    """Zero the dead columns of U (one ``tail.compact`` pass).  ``out``:
    where the kernel may write the result, U itself when U is the
    caller's scratch."""
    return tail.compact(U, 0, live, out)


def shift_cols(U: torch.Tensor, shift, new_count) -> torch.Tensor:
    """Drop the first `shift` columns and compact the rest to the front:
    output column j = U[..., j+shift] for j < new_count, zero otherwise
    (per problem for [b] shifts).  One ``tail.compact`` pass."""
    return tail.compact(U, shift, new_count)


def permute_cols(U: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder columns by an index vector ([b, k] for lanes)."""
    if perm.dim() == 1:
        return U[..., perm]
    return torch.take_along_dim(U, perm[..., None, :], dim=-1)


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
