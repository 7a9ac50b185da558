"""Row-sharded block-ELL (BSR) SpMM with a neighbour halo exchange (port
of ``lobpcg_tpu/parallel/spmd_bsr.py``).

For a banded matrix (RCM-reorder a general sparse one first,
``utils/native.py:rcm_order``) every remote block row a shard needs lies
within ``halo`` block rows of its boundary, so the exchange is one batch
of sends and receives of ``halo * bs`` edge rows with each neighbour.

Host planning (numpy, the JAX package's code): nb block rows split evenly
over the ranks; the halo is the largest |block_col - block_row| over the
stored blocks and must be smaller than a shard's block rows; each shard's
rows are re-expanded into the strip-window format against its
halo-EXTENDED local column frame [halo_up | X_local | halo_dn], with one
window width across the shards.  ``plan_shards`` does this for any set
of shards of an operator, so one process can plan every shard.

On the card, an f32 apply with a window plan runs K6
(``bsr_window_matmat_edges``) on X and two small edge buffers when the
halo is non-empty and the window fits the local rows, else K5
(``bsr_window_matmat``) on the concatenated frame (on the H100 the edge
buffers and K6 take less time than building the frame and running K5:
PERF.md).  Without a window plan an f32 apply runs K3
(``bsr_matmat(..., frame=True)``) on the block columns remapped into the
extended frame, where the JAX package runs its plain gather + einsum;
f64 (or ``pallas="off"``) runs that gather + einsum (K3's plain
version).  The JAX package's TPU gates (k % 128, the VMEM budget) do not
apply: the kernels take any k.

A lockstep batch [b, n_loc, k] is one halo exchange and one launch of the
same kernel, on edge buffers or a frame [b, rows, k] (the rows are axis
-2); each problem's product equals its lone apply's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops.cuda.bsr import (
    bsr_matmat,
    bsr_matmat_reference,
    bsr_window_matmat,
    bsr_window_matmat_edges,
    bsr_window_widths,
    ell_to_strip_window,
)
from lobpcg_tpu_torch.parallel.mesh import RowMesh, halo_exchange
from lobpcg_tpu_torch.parallel.spmd_stencil import PALLAS_MODES


def _ell_halo_width(block_cols: np.ndarray, blocks: np.ndarray) -> int:
    """Max |block_col - block_row| over stored (non-padding) blocks."""
    nb, R = block_cols.shape
    rows = np.arange(nb)[:, None]
    nonpad = np.abs(blocks).reshape(nb, R, -1).sum(-1) > 0
    reach = np.abs(block_cols - rows) * nonpad
    return int(reach.max()) if nb else 0


def _safe_cols(cols: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Re-point zero-valued (padding) blocks at their row's first real
    block column (its own row index if the row is empty): the global ELL
    convention 'padding = col 0' breaks under the shift into a shard's
    extended local frame — col 0 remaps to an arbitrary offset and would
    inflate the window span.  Zero values keep padding contributing
    nothing wherever it points."""
    nb, R = cols.shape
    val_nz = np.abs(blocks).reshape(nb, R, -1).any(axis=2)
    big = np.int64(1) << 40
    first = np.where(val_nz, cols.astype(np.int64), big).min(axis=1)
    first = np.where(first == big, np.arange(nb), first)
    return np.where(val_nz, cols, first[:, None]).astype(cols.dtype)


@dataclasses.dataclass
class ShardPlan:
    """The sharding of a block-ELL matrix over row shards: block rows a
    shard, the halo (block rows), the strip (rows), the window width
    ``width`` (block columns; None when the matrix is not windowed) and
    the extended-frame windows ``lo[d]``, ``win[d]`` of the planned
    shards d."""

    nb_loc: int
    halo: int
    strip: int
    width: Optional[int]
    lo: dict
    win: dict


def fitting_plan(op, nd: int, shards=None) -> Optional[ShardPlan]:
    """``plan_shards``' plan, or None where the matrix does not fit nd
    row shards: its block rows do not divide, or its block bandwidth
    reaches past a shard.  One copy of the matrix to the host."""
    cols = torch.as_tensor(op.block_cols).cpu().numpy()
    blocks = torch.as_tensor(op.blocks).cpu().numpy()
    nb, R, bs, _ = blocks.shape
    if nb % nd:
        return None
    halo = _ell_halo_width(cols, blocks)
    nb_loc = nb // nd
    if halo >= nb_loc:
        return None
    nb_ext = nb_loc + 2 * halo
    strip = bs * (-(-256 // bs))
    safe = _safe_cols(cols, blocks)

    def local(d):
        sl = slice(d * nb_loc, (d + 1) * nb_loc)
        return safe[sl] - np.int64(d * nb_loc - halo), blocks[sl]

    span = max(bsr_window_widths(*local(d), strip=strip) for d in range(nd))
    step = math.lcm(bs, 128) // bs
    Wb = -(-span // step) * step
    # The window rule of BSROperator.from_csr, on the raw span: padding
    # every strip to the largest span must not blow up storage.
    if not (span * bs <= 4096 and span <= 4 * R + 16 and Wb <= nb_ext):
        return ShardPlan(nb_loc, halo, strip, None, {}, {})
    lo, win = {}, {}
    for d in range(nd) if shards is None else shards:
        lo[d], win[d] = ell_to_strip_window(*local(d), strip=strip,
                                            ncols=nb_ext, force_width=Wb)
    return ShardPlan(nb_loc, halo, strip, Wb, lo, win)


def plan_shards(op, nd: int, shards=None) -> ShardPlan:
    """Plan a BSROperator (``block_cols``, ``blocks``) for ``nd`` row
    shards, building the windows of ``shards`` (default: all).  Raises
    when the block rows do not divide or the bandwidth reaches past a
    shard."""
    plan = fitting_plan(op, nd, shards)
    if plan is None:
        raise ValueError(
            f"{op.blocks.shape[0]} block rows over {nd} shards: the block "
            "rows must divide and the block bandwidth must stay under a "
            "shard's block rows; RCM-reorder the matrix "
            "(utils.native.rcm_order) or use fewer shards")
    return plan


@dataclasses.dataclass
class ShardedBSROperator(LinearOperator):
    """Block-ELL sparse operator, block-row sharded with a halo exchange.

    Build with ``ShardedBSROperator.shard(op, mesh)`` from a
    BSROperator.  Holds this rank's block rows (``block_cols`` keep the
    global block-column indices) and its extended-frame window plan
    (``win_lo`` [ns] i32, ``win_vals`` [ns, strip, W]; None when the
    matrix is not windowed).  ``pallas`` (the JAX package's name): "auto"
    and "interpret" run the window kernels (K6/K5 on the card, their
    plain versions on the CPU) when a plan exists, else K3 on the
    extended frame; "off" always runs the gather + einsum.
    """

    block_cols: torch.Tensor
    blocks: torch.Tensor
    win_lo: Optional[torch.Tensor] = None
    win_vals: Optional[torch.Tensor] = None
    n: int = 0
    bs: int = 0
    halo: int = 0
    mesh: RowMesh = None
    pallas: str = "auto"

    @classmethod
    def shard(cls, op, mesh: RowMesh,
              pallas: str = "auto") -> "ShardedBSROperator":
        """Plan a BSROperator and place this rank's part on its device."""
        return cls.place(op, mesh, plan_shards(op, mesh.size,
                                               shards=[mesh.rank]), pallas)

    @classmethod
    def place(cls, op, mesh: RowMesh, plan: ShardPlan,
              pallas: str = "auto") -> "ShardedBSROperator":
        """This rank's part of a BSROperator planned for the mesh (``plan``
        covers this rank's shard), on its device."""
        if pallas not in PALLAS_MODES:
            raise ValueError(f"pallas must be one of {PALLAS_MODES}, got "
                             f"{pallas!r}")
        r, nb_loc = mesh.rank, plan.nb_loc
        rows = slice(r * nb_loc, (r + 1) * nb_loc)
        dev = mesh.device
        win_lo = win_vals = None
        if plan.width is not None:
            win_lo = torch.from_numpy(plan.lo[r]).to(dev)
            win_vals = torch.from_numpy(plan.win[r]).to(dev)
        return cls(
            block_cols=op.block_cols[rows].to(dev, torch.int32),
            blocks=op.blocks[rows].to(dev), win_lo=win_lo, win_vals=win_vals,
            n=op.n, bs=op.blocks.shape[2], halo=plan.halo, mesh=mesh,
            pallas=pallas)

    def _kernel_ok(self, k: int) -> bool:
        """The window kernels run when a plan exists, the operator is f32
        and ``pallas`` is not "off" (the kernels take any k)."""
        del k
        return (self.win_vals is not None and self.pallas != "off"
                and self.dtype == torch.float32)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        bs, H = self.bs, self.halo
        nb_loc = self.blocks.shape[0]
        n_loc, k = X.shape[-2:]
        hrows = H * bs
        use_kernel = self._kernel_ok(k) and X.dtype == torch.float32
        if H > 0:
            halo_up, halo_dn = halo_exchange(self.mesh, X, hrows)
        if use_kernel:
            W = self.win_vals.shape[2]
            X = X.contiguous()
            if H > 0 and W <= n_loc:
                # K6: X and two [hrows + W, k] edge buffers, no frame.
                edge_top = torch.cat([halo_up, X[..., :W, :]], dim=-2)
                edge_bot = torch.cat([X[..., -W:, :], halo_dn], dim=-2)
                return bsr_window_matmat_edges(
                    self.win_lo, self.win_vals, X, edge_top, edge_bot,
                    bs=bs, hrows=hrows, out_rows=n_loc)
            x_ext = torch.cat([halo_up, X, halo_dn], dim=-2) if H > 0 else X
            return bsr_window_matmat(self.win_lo, self.win_vals, x_ext, bs=bs,
                                     out_rows=n_loc)
        # The global block columns remapped into the extended local frame;
        # padding blocks are zero, so a clamped index is harmless.
        x_ext = torch.cat([halo_up, X, halo_dn], dim=-2) if H > 0 else X
        first = self.mesh.rank * nb_loc - H
        loc = torch.clamp(self.block_cols - first, 0,
                          nb_loc + 2 * H - 1).to(torch.int32)
        if (self.pallas != "off" and self.dtype == torch.float32
                and X.dtype == torch.float32):
            # K3 on the frame (its plain version for a CPU tensor).
            return bsr_matmat(loc, self.blocks, x_ext.contiguous(), frame=True)
        return bsr_matmat_reference(loc, self.blocks, x_ext)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype
