"""Per-problem control flow of a lockstep batched solve.

A batched solve holds its blocks as [b, n, k] and its per-problem counts
and flags as [b] tensors on the device ("lanes"), where an unbatched
solve holds Python ints and bools read back from the device.  The
helpers here take either form, so the solvers and ops are written once:

- on Python values they do what the unbatched host loop always did, with
  no launch and no host read of their own;
- on [b] tensors they do what ``jax.vmap`` makes of the JAX package's
  ``lax.cond`` and ``lax.while_loop``: ``cond`` computes a branch for the
  whole batch when some problem takes it and selects per problem, and
  ``select`` freezes the problems a loop is done with.

A host read of a lanes tensor is one read for the whole batch, so the
reads an iteration makes do not grow with b.  Each read of a tensor is a
``lobpcg.sync.read`` span (``utils/profiling.py``); a Python value opens
none.  ``is_lanes``, ``count``, ``minimum``, ``maximum`` and ``clip`` are
``ops/cuda/chains.py``'s, shared with the kernel layer's plain versions.
"""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.ops.cuda.chains import (
    clip,
    count,
    is_lanes,
    maximum,
    minimum,
    read,
)
from lobpcg_tpu_torch.utils.profiling import SYNC_READ, span


def read_pair(a, b):
    """``read`` of two 0-d values in one host read; lanes unchanged."""
    if is_lanes(a):
        return a, b
    with span(SYNC_READ):
        return torch.stack([a, b]).tolist()


def any_(flag) -> bool:
    """Does some problem take ``flag``?  (A host read for lanes.)"""
    if not isinstance(flag, torch.Tensor):
        return bool(flag)
    with span(SYNC_READ):
        return bool(flag.any())


def all_(flag) -> bool:
    """Does every problem take ``flag``?  (A host read for lanes.)"""
    if not isinstance(flag, torch.Tensor):
        return bool(flag)
    with span(SYNC_READ):
        return bool(flag.all())


def not_(flag):
    return ~flag if isinstance(flag, torch.Tensor) else not flag


def as_int(flag):
    """A flag as a 0/1 count."""
    return flag.long() if isinstance(flag, torch.Tensor) else int(flag)


def zeros(lanes: int | None, device):
    """Zero counts: the Python 0 (unbatched, ``lanes`` None) or [lanes]."""
    if lanes is None:
        return 0
    return torch.zeros(lanes, dtype=torch.int64, device=device)


def col(x):
    """A per-problem scalar made to broadcast over a trailing axis: [b]
    becomes [b, 1]; Python and 0-d values are returned as they are."""
    return x[..., None] if is_lanes(x) else x


def status(flag):
    """(some, every): does some / every problem take ``flag``?  One host
    read for lanes."""
    if not isinstance(flag, torch.Tensor):
        return bool(flag), bool(flag)
    with span(SYNC_READ):
        some, every = torch.stack([flag.any(), flag.all()]).tolist()
    return some, every


def settle(flag, live):
    """``flag`` with the problems that are not ``live`` (frozen, their
    results discarded) following the live ones: they take the branch iff
    some live problem takes it, so ``cond`` computes no branch for a
    frozen problem alone."""
    if not isinstance(live, torch.Tensor) or not isinstance(flag, torch.Tensor):
        return flag
    return torch.where(live, flag, (flag & live).any())


def _where(flag: torch.Tensor, a, b):
    if a is None or b is None:
        if a is not None or b is not None:
            raise ValueError("select: a branch value is None for one side only")
        return None
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        if a == b:
            return a
        return torch.where(flag, a, b)
    dim = max(x.dim() for x in (a, b) if isinstance(x, torch.Tensor))
    return torch.where(flag.reshape(flag.shape + (1,) * max(dim - 1, 0)),
                       a, b)


def select(flag, a, b):
    """``a`` where ``flag`` else ``b``, per problem, through tuples and
    NamedTuples.  A Python flag picks one side whole (no launch)."""
    if not isinstance(flag, torch.Tensor):
        return a if flag else b
    if isinstance(a, tuple):
        parts = [select(flag, x, y) for x, y in zip(a, b)]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)
    return _where(flag, a, b)


def cond(flag, then, other):
    """``lax.cond(flag, then, other)`` as ``jax.vmap`` runs it: a Python
    flag calls one branch; lanes call each branch that some problem takes
    (one host read) and select per problem."""
    if not isinstance(flag, torch.Tensor):
        return then() if flag else other()
    some, every = status(flag)
    if every:
        return then()
    if not some:
        return other()
    return select(flag, then(), other())
