"""Observability of the host solve loop (port of
``lobpcg_tpu/solvers/observe.py``): ``print`` gated on
``SolverConfig.verbosity``, and fixed-shape history tensors filled row by
row when ``record_history`` is set."""

from __future__ import annotations

import torch

from lobpcg_tpu_torch.ops import lanes
from lobpcg_tpu_torch.solvers.state import SolveHistory


def history_init(config, m: int, lam_dtype, res_dtype, device, lead=()):
    """Zeroed [max_iter, ...] trace tensors ([b, max_iter, ...] for a
    lockstep batch), or None when disabled."""
    if not config.record_history:
        return None

    def zeros(*shape, dtype):
        return torch.zeros(lead + (config.max_iter,) + shape, dtype=dtype,
                           device=device)

    return SolveHistory(
        eigenvalues=zeros(m, dtype=lam_dtype),
        residual_norms=zeros(config.nev, dtype=res_dtype),
        converged=zeros(dtype=torch.int32),
        flags=zeros(dtype=torch.int32),
    )


def history_update(hist, it: int, lam, res, conv, flag=None, live=True):
    """Write row `it` in place; no-op (None) when recording is off.  In a
    lockstep batch, only the ``live`` problems' rows are written."""
    if hist is None:
        return None
    rows = [(hist.eigenvalues, lam), (hist.residual_norms, res),
            (hist.converged, conv)]
    if flag is not None:
        rows.append((hist.flags, flag))
    batched = hist.converged.dim() == 2
    for dst, val in rows:
        if batched:
            dst[:, it] = lanes.select(live, val, dst[:, it])
        else:
            dst[it] = val
    return hist


def _fmt(x, spec: str) -> str:
    """A value for a log line: one number, or a list (one per problem)."""
    if lanes.is_lanes(x):
        return "[" + ", ".join(format(v, spec) for v in x.tolist()) + "]"
    return format(x if isinstance(x, int) else float(x), spec)


def log_iteration(config, name: str, it: int, lam, res, conv):
    """Per-iteration logging when verbosity >= 1 (eigenvalues too at 2)."""
    if config.verbosity >= 1:
        print(f"[{name}] iter {it}: converged {_fmt(conv, 'd')}/{config.nev}"
              f"  max_res {_fmt(torch.amax(res, dim=-1), '.3e')}")
    if config.verbosity >= 2:
        print(f"[{name}] iter {it}: eigvals {lam.tolist()}")


def log_start(config, name: str, a_norm, b_norm):
    """Pre-loop operator-norm printout when verbosity >= 1."""
    if config.verbosity >= 1:
        print(f"[{name}] ||A|| ~ {_fmt(a_norm, '.6e')}"
              f"  ||B|| ~ {_fmt(b_norm, '.6e')}")
