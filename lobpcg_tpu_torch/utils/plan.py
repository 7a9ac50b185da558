"""Device-memory-aware solve planning (port of ``lobpcg_tpu/utils/plan.py``):
estimate a solve's peak device memory and fit the fastest SolverConfig
inside a budget.

The anchors are the card's own: ``tools/plan_anchors.py`` runs short
ilobpcg solves of the 4M x 64 f32 BdG well for each memory knob
combination and reads ``torch.cuda.max_memory_allocated``.  The JAX
package's anchors are TPU-compiled peaks, where XLA counted both
branches of every ``lax.cond``; eager torch allocates only the branch
that runs.  The well never trips the quality-5 test, so the tool also
forces the dual-basis branch on every iteration, and with dual_basis on
each anchor is the larger of the two peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# The fixed term of every solve's peak: the cuBLAS workspace, which
# PyTorch allocates through its caching allocator at the first GEMM and
# keeps (32 MiB; itemised by ``tools/plan_anchors.py --fixed`` on an
# NVIDIA H100 80GB HBM3, 700.00 W).  It is all of a toy solve's peak.
FIXED_GB_H100 = 32 / 1024

# Peak less FIXED_GB_H100 in units of one [n, size_sub] operator-dtype
# block, keyed by (dual_basis, use_b_cache, use_ax_cache):
# tools/plan_anchors.py at n 4M, size_sub 64, f32, 5 iterations (NVIDIA
# H100 80GB HBM3, 700.00 W), the same with the Chebyshev preconditioner
# (chunk 16) and without one.  Since the tail kernels (ops/cuda/tail.py)
# hold no transients, each anchor is one block below the eager chain's,
# and the dual-basis branch (quality 5 forced), which held one block more
# with the b-cache off and the ax-cache on, holds none.  Whole solves
# peak at the anchors too (chip_smoke.py: the flagship 12.452 GiB in 31
# iterations, 1M x 150 13.02 blocks): a filter applied whole (chunk 0)
# writes each step over its scratch (StencilDiagonal.chebyshev), and a
# second SVQB pass its mask over its GEMM output (ops/ortho.py).
# pack_applies does not enter: the port never packs two applies into one
# (ops/gram.py), so it cannot change the allocations.
PEAK_BLOCKS_H100 = {
    (True, True, True): 13.025,
    (True, True, False): 12.024,
    (True, False, True): 11.024,
    (True, False, False): 10.024,
    (False, True, True): 13.024,
    (False, True, False): 12.024,
    (False, False, True): 11.024,
    (False, False, False): 10.024,
}

# The blocks a lockstep batch (b > 1) holds beyond its problems' lone
# peaks, in units of the batch's [b, n_loc, size_sub] block: the frozen
# problems' state (X, AX, P, W) kept while the others run, and the
# per-problem select's output.  Fitted on one configuration: the BdG well
# pencil (ilobpcg with B and a degree-3 Chebyshev T, default knobs,
# size_sub 30, f32), chip_smoke.py's lockstep_sharded phases on an
# NVIDIA H100 80GB HBM3, 700.00 W: 19.046 blocks at 8 x 1M x 30 and
# 19.052 at 4 x 4M x 30 (the same peaks before and after the tail
# kernels), against the 13.025 of the anchor.
# chip_smoke.py prints it beside peaks outside the fit: lockstep_small
# (that pencil at 32 x 65,536 x 30), lockstep_nd and lockstep_bsr
# (lobpcg without B or T on the 160^3 grid, where it over-estimates).
LOCKSTEP_BLOCKS_H100 = 6.03

# Knob combinations from the fastest to the leanest, the JAX package's
# order without its packing rungs and its dual-basis rungs: neither
# packing nor turning the dual basis off saves memory here (the anchors
# above); each entry overrides SolverConfig fields.
_LADDER = (
    {},
    {"use_b_cache": False},
    {"use_b_cache": False, "use_ax_cache": False},
)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def estimate_peak_gb(n: int, size_sub: int, dtype, config,
                     pad_lanes: bool = False, *, batch: int = 1,
                     ranks: int = 1) -> float:
    """Peak device memory (GiB) of an ilobpcg/lobpcg solve on one card:
    the fixed term plus the measured 4M x 64 f32 anchors scaled by the
    block size batch * n_loc * size_sub * itemsize, for a lockstep batch
    of ``batch`` problems (plus ``LOCKSTEP_BLOCKS_H100`` when batch > 1)
    and a row group of ``ranks`` (n_loc = n / ranks rows a card; n when
    the rows do not divide, as the problem is then replicated).  k x k
    scratch is not modelled.  ``pad_lanes`` is
    accepted for parity and adds nothing (the Hopper stencil takes any
    width).  Exact at the measured corner, proportional elsewhere: keep a
    margin.
    """
    del pad_lanes
    key = (bool(config.dual_basis), bool(config.use_b_cache),
           bool(config.use_ax_cache))
    n_loc = n // ranks if n % ranks == 0 else n
    block_gb = batch * n_loc * size_sub * _itemsize(dtype) / (1 << 30)
    blocks = PEAK_BLOCKS_H100[key] + (LOCKSTEP_BLOCKS_H100 if batch > 1 else 0.0)
    return FIXED_GB_H100 + blocks * block_gb


def probe_hbm_gb(device=None) -> float:
    """The card's free device memory in GiB (``torch.cuda.mem_get_info``;
    nothing is allocated).  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_hbm_gb: no CUDA device")
    free, _ = torch.cuda.mem_get_info(device)
    return free / (1 << 30)


def plan_config(
    config,
    n: int,
    dtype=torch.float32,
    *,
    hbm_gb: Optional[float] = None,
    margin: float = 0.95,
):
    """The first variant of ``config`` along the ladder (full -> b-cache
    off -> b-cache and ax-cache off) whose estimated peak fits ``margin *
    hbm_gb``; ``hbm_gb`` None means the card's free memory now
    (``probe_hbm_gb``).

    Knobs the caller already disabled stay disabled.  Raises
    ``ValueError`` if even the leanest configuration does not fit.
    """
    budget = margin * (probe_hbm_gb() if hbm_gb is None else hbm_gb)
    for rung in _LADDER:
        kw = dict(rung)
        for field in ("use_b_cache", "dual_basis", "use_ax_cache"):
            if not getattr(config, field):
                kw[field] = False  # never re-enable a knob the caller turned off
        cand = dataclasses.replace(config, **kw)
        if estimate_peak_gb(n, config.size_sub, dtype, cand) <= budget:
            return cand
    raise ValueError(
        f"no single-card configuration fits: dim {n} x size_sub "
        f"{config.size_sub} needs >= "
        f"{estimate_peak_gb(n, config.size_sub, dtype, cand):.2f} GB "
        f"(budget {budget:.2f} GB); shrink size_sub or shard the problem."
    )
