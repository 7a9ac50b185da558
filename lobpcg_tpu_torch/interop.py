"""Carry operators and configs across from the JAX package.

``operator_from_reference`` turns a ``lobpcg_tpu`` operator tree into
the port's equivalent (sharded for one rank, given the port's mesh);
``config_from_reference`` converts a ``lobpcg_tpu.SolverConfig``.  Neither imports jax: dataclass fields are
read with ``np.asarray`` and dispatch is on the class name, so the same
numpy bytes reach both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lobpcg_tpu_torch.config import SolverConfig
from lobpcg_tpu_torch.operators import linop
from lobpcg_tpu_torch.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu_torch.operators.realify import (
    RealEmbeddedDenseOperator,
    RealEmbeddedDiagonalOperator,
)
from lobpcg_tpu_torch.operators.sparse import BSROperator
from lobpcg_tpu_torch.operators.stencil_nd import LaplacianND
from lobpcg_tpu_torch.physics.bdg import BlockDiag2Operator


def _tensor(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = torch.from_numpy(np.array(np.asarray(x)))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _scalar(x) -> float:
    return float(np.asarray(x).real)


def _dtype_of(x, dtype: Optional[torch.dtype]) -> torch.dtype:
    """``dtype`` when given, else the torch dtype of the array ``x``."""
    if dtype is not None:
        return dtype
    return torch.from_numpy(np.zeros((), np.asarray(x).dtype)).dtype


def _scalar_like(x, dtype):
    """A scalar operator coefficient: a Python number (complex kept)."""
    a = np.asarray(x)
    if np.iscomplexobj(a) or (dtype is not None and dtype.is_complex):
        return complex(a)
    return float(a)


def operator_from_reference(op, *, device, dtype: Optional[torch.dtype] = None,
                            mesh=None):
    """The port's counterpart of a JAX-package operator tree.

    Handles Laplacian1D, LaplacianND, BSROperator, DiagonalOperator,
    JacobiPreconditioner, BlockAntiDiagOperator, BlockDiagOperator,
    SumOperator, ScaledOperator, ShiftedOperator, ComposedOperator,
    DenseOperator, ChebyshevFilter, BlockDiag2Operator,
    RealEmbeddedDenseOperator and RealEmbeddedDiagonalOperator, and the
    sharded SpmdLaplacian1D and ShardedBSROperator.  ``dtype`` (optional)
    casts every floating-point tensor field; index arrays keep their
    dtype.

    ``mesh`` (a port ``parallel.RowMesh``): the tree is converted, then
    sharded for this rank (``parallel.shard_operator``); a JAX sharded
    operator keeps its own planning (the JAX ShardedBSROperator's
    windows, cut to this rank), and needs a mesh of the same size.
    """
    top = _convert(op, device, dtype, mesh)
    if mesh is None:
        return top
    from lobpcg_tpu_torch.parallel.sharding import shard_operator

    return shard_operator(top, mesh)


def _sharded_from_reference(op, name, device, dtype, mesh):
    """A JAX SpmdLaplacian1D / ShardedBSROperator on the port's mesh."""
    from lobpcg_tpu_torch.parallel import ShardedBSROperator, SpmdLaplacian1D

    if mesh is None:
        raise ValueError(f"operator_from_reference: the JAX {name} is "
                         "sharded; pass the port's mesh (mesh=)")
    nd = int(op.mesh.shape[op.axis])
    if nd != mesh.size:
        raise ValueError(f"operator_from_reference: the JAX {name} is "
                         f"sharded over {nd} devices, the mesh has "
                         f"{mesh.size} ranks")
    pallas = str(op.pallas)
    if name == "SpmdLaplacian1D":
        return SpmdLaplacian1D(
            scale=_scalar(op.scale), n=int(op.n), segments=int(op.segments),
            mesh=mesh, pallas=pallas, dtype=_dtype_of(op.scale, dtype))
    cols = np.asarray(op.block_cols)
    nb_loc = cols.shape[0] // nd
    rows = slice(mesh.rank * nb_loc, (mesh.rank + 1) * nb_loc)
    win = op.win_lo is not None
    return ShardedBSROperator(
        block_cols=_tensor(cols[rows], device, None),
        blocks=_tensor(np.asarray(op.blocks)[rows], device, dtype),
        win_lo=_tensor(np.asarray(op.win_lo)[mesh.rank], device, None)
        if win else None,
        win_vals=_tensor(np.asarray(op.win_vals)[mesh.rank], device, dtype)
        if win else None,
        n=int(op.n), bs=int(op.bs), halo=int(op.halo), mesh=mesh,
        pallas=pallas)


def _convert(op, device, dtype, mesh):
    name = type(op).__name__

    def sub(o):
        return _convert(o, device, dtype, mesh)

    if name in ("SpmdLaplacian1D", "ShardedBSROperator"):
        return _sharded_from_reference(op, name, device, dtype, mesh)

    if name == "Laplacian1D":
        return linop.Laplacian1D(
            scale=_scalar(op.scale), n=int(op.n), segments=int(op.segments),
            pad_lanes=bool(op.pad_lanes), dtype=_dtype_of(op.scale, dtype),
        )
    if name == "LaplacianND":
        return LaplacianND(
            scale=_scalar(op.scale), grid=tuple(int(g) for g in op.grid),
            force_jnp=bool(op.force_jnp), dtype=_dtype_of(op.scale, dtype),
        )
    if name == "BSROperator":
        def opt(x, dt):
            return None if x is None else _tensor(x, device, dt)

        return BSROperator(
            block_cols=_tensor(op.block_cols, device, None),
            blocks=_tensor(op.blocks, device, dtype),
            win_lo=opt(op.win_lo, None), win_vals=opt(op.win_vals, dtype),
            n=int(op.n),
        )
    if name in ("DiagonalOperator", "JacobiPreconditioner",
                "BlockAntiDiagOperator"):
        return getattr(linop, name)(_tensor(op.d, device, dtype))
    if name == "DenseOperator":
        return linop.DenseOperator(_tensor(op.A, device, dtype))
    if name == "BlockDiagOperator":
        return linop.BlockDiagOperator(sub(op.inner), int(op.copies))
    if name == "SumOperator":
        return linop.SumOperator(sub(op.left), sub(op.right))
    if name == "ComposedOperator":
        return linop.ComposedOperator(sub(op.outer), sub(op.inner))
    if name == "ScaledOperator":
        return linop.ScaledOperator(sub(op.op), _scalar_like(op.alpha, dtype))
    if name == "ShiftedOperator":
        return linop.ShiftedOperator(sub(op.op), _scalar_like(op.sigma, dtype))
    if name == "BlockDiag2Operator":
        return BlockDiag2Operator(sub(op.top), sub(op.bottom))
    if name == "RealEmbeddedDenseOperator":
        return RealEmbeddedDenseOperator(_tensor(op.Ar, device, dtype),
                                         _tensor(op.Ai, device, dtype))
    if name == "RealEmbeddedDiagonalOperator":
        return RealEmbeddedDiagonalOperator(_tensor(op.dr, device, dtype),
                                            _tensor(op.di, device, dtype))
    if name == "ChebyshevFilter":
        return ChebyshevFilter(
            sub(op.op), lo=_scalar(op.lo), hi=_scalar(op.hi),
            degree=int(op.degree), chunk=int(op.chunk),
        )
    raise TypeError(f"operator_from_reference: no counterpart for {name}")


def config_from_reference(cfg) -> SolverConfig:
    """A port SolverConfig with the same field values."""
    return SolverConfig(**dataclasses.asdict(cfg))
