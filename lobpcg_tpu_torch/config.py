"""Solver configuration and dtype policy (PyTorch port of
``lobpcg_tpu/config.py``).

The knob surface is the same frozen dataclass, field for field, so a
JAX-package config converts with ``dataclasses.asdict``
(``interop.config_from_reference``).  The per-dtype tables are keyed by
``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Per-dtype default tolerance: 1e-5 single precision, 1e-12 double.
EPS_TOL = {
    torch.float32: 1e-5,
    torch.complex64: 1e-5,
    torch.float64: 1e-12,
    torch.complex128: 1e-12,
}

# Guard threshold for the indefinite solver's beta ~ 0 and |diag| ~ 0
# checks, per dtype.
TINY = {
    torch.float32: 1e-20,
    torch.complex64: 1e-20,
    torch.float64: 1e-30,
    torch.complex128: 1e-30,
}

# Quality tolerance for the indefinite RR B-orthogonality check.
QUALITY_TOL = {
    torch.float32: 1e-5,
    torch.complex64: 1e-5,
    torch.float64: 1e-12,
    torch.complex128: 1e-12,
}

# Relative magnitude of the stall-reset perturbation (SolverConfig.stall_reset).
STALL_NOISE = 1e-2

# Projected-pencil width (3 * size_sub) beyond which single-precision
# Gram/RR math is auto-escalated to float64.
RR_WIDTH_ESCALATE = {
    torch.float32: 512,
    torch.complex64: 512,
}

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) dtype."""
    return dtype.to_real() if dtype.is_complex else dtype


def eps_tol(dtype) -> float:
    return EPS_TOL[dtype]


def tiny(dtype) -> float:
    return TINY[dtype]


def quality_tol(dtype) -> float:
    return QUALITY_TOL[dtype]


def as_torch_dtype(name_or_dtype) -> torch.dtype:
    """``"float64"`` / ``torch.float64`` / a numpy dtype -> torch dtype."""
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    name = getattr(name_or_dtype, "name", None) or str(name_or_dtype)
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype: {name_or_dtype!r}")
    return dt


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the CUDA card.  Without a card it raises rather than fall back to
    the CPU; pass ``device="cpu"`` to run the plain versions there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: lobpcg_tpu_torch runs on the card by default; "
            "pass X0 on the CPU or device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs; the same fields and defaults as
    ``lobpcg_tpu.SolverConfig`` (see that class for each knob's
    rationale).  Both ``gram_precision`` values run the Gram
    contractions in full f32 on the GPU, TF32 off (see
    ``ops.gram.precision_ctx``)."""

    nev: int
    size_sub: int
    max_iter: int = 100
    tol: float = 1e-5
    eps_ortho: Optional[float] = None
    eps_drop: Optional[float] = None
    tol_skip: float = 5e-3
    max_outer: int = 3
    max_inner: int = 3
    norm_iters: int = 10
    norm_block: int = 8
    residual_norm: str = "2"
    rr_method: str = "cholesky"
    gram_precision: str = "highest"
    use_ax_cache: bool = True
    use_b_cache: bool = True
    dual_basis: bool = True
    # Accepted for parity: the port applies each block on its own either
    # way (ops/gram.py:applied_blocks), so it moves no allocation or bit.
    pack_applies: bool = True
    ortho_skip: bool = False
    stall_reset: int = 0
    rr_dtype: Optional[str] = None
    rr_chunk_rows: Optional[int] = None
    verbosity: int = 0
    record_history: bool = False

    def __post_init__(self):
        if self.nev > self.size_sub:
            raise ValueError(
                f"nev ({self.nev}) > size_sub ({self.size_sub})"
            )
        if self.rr_method not in ("cholesky", "qz", "auto"):
            raise ValueError(f"unknown rr_method: {self.rr_method!r}")
        if self.gram_precision not in ("highest", "high"):
            raise ValueError(
                f"unknown gram_precision: {self.gram_precision!r}"
            )
        if self.residual_norm not in ("2", "b"):
            raise ValueError(
                f"unknown residual_norm: {self.residual_norm!r}"
            )
        if self.norm_block < 1:
            raise ValueError(f"norm_block must be >= 1: {self.norm_block}")
        if self.stall_reset < 0:
            raise ValueError(
                f"stall_reset must be >= 0: {self.stall_reset}"
            )

    def resolved_eps(self, dtype) -> tuple[float, float]:
        e = eps_tol(dtype)
        return (
            self.eps_ortho if self.eps_ortho is not None else e,
            self.eps_drop if self.eps_drop is not None else e,
        )

    def resolved_rr_dtype(self, op_dtype) -> Optional[torch.dtype]:
        """The dtype for Gram/RR math, matched to the operator dtype's
        complexness; None when mixed precision is off.

        rr_dtype=None means AUTO: single-precision solves whose projected
        pencil width 3*size_sub exceeds RR_WIDTH_ESCALATE use float64
        Gram/RR math.  (float64 always exists in torch, so the JAX
        package's x64-disabled warning has no counterpart here.)
        """
        if self.rr_dtype is None:
            thr = RR_WIDTH_ESCALATE.get(op_dtype)
            if thr is None or 3 * self.size_sub <= thr:
                return None
            rr = torch.float64
        else:
            rr = as_torch_dtype(self.rr_dtype)
        if op_dtype.is_complex and not rr.is_complex:
            rr = _COMPLEX_OF[rr]
        return rr


def validate_problem(n: int, config: SolverConfig) -> None:
    """Entry validation: the [X|P|W] subspace must fit the problem."""
    if 3 * config.size_sub > n:
        raise ValueError(
            f"3*size_sub ({3 * config.size_sub}) > problem size ({n})"
        )
