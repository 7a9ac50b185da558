"""Reductions over the rows of a row-sharded solve.

The JAX package shards the tall blocks over a device mesh and lets XLA's
partitioner turn every contraction over rows into local partial products
plus a ``psum``.  Eager PyTorch has no partitioner, so the port writes
each of those reductions out: ``row_sum`` and ``row_max`` all-reduce over
the active row group (``parallel.RowMesh``) and return their argument
unchanged when no group is active.  A reduction over rows is every sum
over the leading axis of a tall [n, k] block: the Grams (``ops/gram.py``
``_hdot``), Frobenius and column norms of tall blocks (``tall_frob_norm``,
``ops/residual.py``, ``ops/ortho.py``, the solvers).  Sums over k x k
coefficient matrices are replicated work and never reduce.

Entering a mesh (``with mesh:``) makes it the active group for the
solves inside, the way ``ops.gram.precision_ctx`` sets the Gram
precision; a solve that finds no active group takes the mesh of a
sharded operator in its trees (``find_mesh``).
"""

from __future__ import annotations

import dataclasses

import torch

# The active row group of a sharded solve (a parallel.RowMesh), or None.
_MESH = [None]


class rows_ctx:
    """Context manager: make ``mesh`` (a ``parallel.RowMesh`` or None)
    the active row group, restoring the previous one on exit."""

    def __init__(self, mesh):
        self._new = mesh

    def __enter__(self):
        self._old = _MESH[0]
        _MESH[0] = self._new
        return self._new

    def __exit__(self, *exc):
        _MESH[0] = self._old
        return False


def active():
    """The active row group, or None for an unsharded solve."""
    return _MESH[0]


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of the ranks' partial sums ``t``: one all-reduce over the
    active row group (issued at world size 1 too); ``t`` without one."""
    mesh = _MESH[0]
    return t if mesh is None else mesh.all_reduce(t, "sum")


def row_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise max of the ranks' partial maxima ``t``."""
    mesh = _MESH[0]
    return t if mesh is None else mesh.all_reduce(t, "max")


def find_mesh(*ops):
    """The mesh of the first sharded operator (one with a ``mesh``
    field) in the operator trees ``ops``, or None."""
    for op in ops:
        if op is None:
            continue
        mesh = getattr(op, "mesh", None)
        if mesh is not None:
            return mesh
        if dataclasses.is_dataclass(op):
            found = find_mesh(*(getattr(op, f.name)
                                for f in dataclasses.fields(op)))
            if found is not None:
                return found
    return None
