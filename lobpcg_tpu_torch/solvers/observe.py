"""Observability of the host solve loop (port of
``lobpcg_tpu/solvers/observe.py``): ``print`` gated on
``SolverConfig.verbosity``, and fixed-shape history tensors filled row by
row when ``record_history`` is set."""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.solvers.state import SolveHistory


def history_init(config, m: int, lam_dtype, res_dtype, device):
    """Zeroed [max_iter, ...] trace tensors, or None when disabled."""
    if not config.record_history:
        return None
    return SolveHistory(
        eigenvalues=torch.zeros((config.max_iter, m), dtype=lam_dtype,
                                device=device),
        residual_norms=torch.zeros((config.max_iter, config.nev),
                                   dtype=res_dtype, device=device),
        converged=torch.zeros((config.max_iter,), dtype=torch.int32,
                              device=device),
        flags=torch.zeros((config.max_iter,), dtype=torch.int32,
                          device=device),
    )


def history_update(hist, it: int, lam, res, conv: int, flag=None):
    """Write row `it` in place; no-op (None) when recording is off."""
    if hist is None:
        return None
    hist.eigenvalues[it] = lam
    hist.residual_norms[it] = res
    hist.converged[it] = conv
    if flag is not None:
        hist.flags[it] = flag
    return hist


def log_iteration(config, name: str, it: int, lam, res, conv: int):
    """Per-iteration logging when verbosity >= 1 (eigenvalues too at 2)."""
    if config.verbosity >= 1:
        print(f"[{name}] iter {it}: converged {conv}/{config.nev}"
              f"  max_res {float(torch.max(res)):.3e}")
    if config.verbosity >= 2:
        print(f"[{name}] iter {it}: eigvals {lam.tolist()}")


def log_start(config, name: str, a_norm, b_norm):
    """Pre-loop operator-norm printout when verbosity >= 1."""
    if config.verbosity >= 1:
        print(f"[{name}] ||A|| ~ {float(a_norm):.6e}"
              f"  ||B|| ~ {float(b_norm):.6e}")
