"""The eager chains the hand-written kernels replace: the switch that
makes the kernels' wrappers run them, and the plain PyTorch pieces the
wrappers share.

Every wrapper of this package decides between its kernel and its plain
version from what it can observe (device, dtype, shape, strides) and
falls back on its own; the callers just call it.

``eager_chain()`` is the A/B switch of ``chip_smoke.py`` and the tests:
while it is open, each wrapper it governs runs its plain version, the
eager chain its call site ran before the kernel (one PyTorch pass an
operation), whatever the device: the four tail kernels
(``tail.antidiag``, ``tail.residual``, ``tail.combine``,
``tail.compact``) and the tall projection (``proj.project``).  No module
above this layer asks it.  The tall Gram is not governed.  The solver
never opens the switch.

``read``, ``as_mask`` and ``mm``, the live counts' helpers (``is_lanes``,
``count``, ``minimum``, ``maximum``, ``clip``) and the Gram masks
(``blocks_mask``, ``diag``, ``inject_diag``) are pieces of those chains
that the layers above use too (``ops/lanes.py``, ``ops/masking.py`` and
``ops/gram.py`` take them from here).
"""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.utils.profiling import SYNC_READ, span

_EAGER = [False]


class eager_chain:
    """Context manager: the wrappers run their call sites' eager chains
    while it is open; restores the previous state on exit."""

    def __enter__(self):
        self._old = _EAGER[0]
        _EAGER[0] = True
        return self

    def __exit__(self, *exc):
        _EAGER[0] = self._old
        return False


def eager() -> bool:
    """Is ``eager_chain`` open?"""
    return _EAGER[0]


def read(t):
    """A per-problem device value as the loop uses it: a 0-d tensor is
    read to a Python scalar (one host read); lanes stay on the device."""
    if isinstance(t, torch.Tensor) and t.dim() == 0:
        with span(SYNC_READ):
            return t.item()
    return t


def is_lanes(x) -> bool:
    """Is ``x`` a per-problem [b] (or [b, ...]) tensor of a batched solve?"""
    return isinstance(x, torch.Tensor) and x.dim() >= 1


def count(x):
    """A live count: a Python int, or lanes of counts."""
    return x if is_lanes(x) else int(read(x))


def minimum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, max=a)
    return min(a, b)


def maximum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, min=a)
    return max(a, b)


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


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
    return torch.arange(width, device=device) < int(read(live))


def blocks_mask(widths: tuple[int, ...], counts, device=None) -> torch.Tensor:
    """Live mask for concatenated blocks, each with its own prefix count."""
    parts = [as_mask(w, c, device) for w, c in zip(widths, counts)]
    lead = max((p.shape[:-1] for p in parts), key=len)
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], dim=-1)


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


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Numerically-sensitive matmul at the context's precision; the
    result has B's dtype (the JAX package's preferred_element_type)."""
    if A.dtype != B.dtype:
        dt = torch.promote_types(A.dtype, B.dtype)
        return torch.matmul(A.to(dt), B.to(dt)).to(B.dtype)
    return torch.matmul(A, B)
