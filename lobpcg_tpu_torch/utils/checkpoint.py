"""Checkpoint / resume for long eigensolves (port of
``lobpcg_tpu/utils/checkpoint.py``).

LOBPCG is restart-friendly: the [n, size_sub] X basis alone restarts the
solve, and the P momentum block resumes it at full speed.

- ``save_checkpoint`` / ``load_checkpoint``: atomic .npz snapshots of the
  basis, eigenvalues and bookkeeping, with the JAX package's keys and
  format version, so a snapshot written by either package resumes in the
  other.
- ``solve_checkpointed``: the solver run in chunks of ``every``
  iterations, with a snapshot at each chunk boundary.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional

import numpy as np
import torch

from lobpcg_tpu_torch.config import SolverConfig, resolve_device

_FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, basis, eigenvalues=None, *, iterations: int = 0,
                    momentum=None, meta: Optional[dict] = None) -> None:
    """Atomically snapshot a solve: basis [n, size_sub] (+ eigenvalues,
    + the P momentum block for exact-speed resume).  Tensors on any
    device or numpy arrays.

    Atomic = write to ``<path>.tmp`` then rename, so a crash mid-write
    never corrupts the previous snapshot.
    """
    path = pathlib.Path(path)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "basis": _host(basis),
        "iterations": np.int64(iterations),
    }
    if momentum is not None:
        payload["momentum"] = _host(momentum)
    if eigenvalues is not None:
        payload["eigenvalues"] = _host(eigenvalues)
    for k, v in (meta or {}).items():
        payload["meta_" + k] = _host(v)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """Load a snapshot; returns {basis, iterations, eigenvalues?,
    momentum?, meta_*} as numpy arrays (iterations an int)."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    v = int(out.pop("version", _FORMAT_VERSION))
    if v > _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {v} is newer than supported")
    out["iterations"] = int(out["iterations"])
    return out


def solve_checkpointed(
    solve_fn,
    A,
    X0: Optional[torch.Tensor] = None,
    B=None,
    T=None,
    *,
    config: SolverConfig,
    path,
    every: int = 10,
    generator: Optional[torch.Generator] = None,
    resume: bool = True,
    device=None,
):
    """Run ``solve_fn`` (lobpcg / ilobpcg) in chunks of ``every``
    iterations, snapshotting the basis and momentum to ``path`` at each
    chunk boundary.

    If ``resume`` and ``path`` exists, the solve continues from the
    stored basis, momentum and iteration count, on X0's device, or
    ``device``, or the card.  Returns the final result with
    ``iterations`` the cumulative count across chunks (including any
    from resumed snapshots).  The first chunk passes no momentum; the
    JAX package passes a zero block there to keep one compile, which the
    solvers treat the same as none.  One problem only: a lockstep batch
    (an X0 of [b, n, m]) raises, as its snapshots are host I/O that
    ``jax.vmap`` cannot map in the JAX package either.
    """
    if X0 is not None and X0.dim() == 3:
        raise NotImplementedError(
            "solve_checkpointed takes one problem, an X0 of [n, size_sub]: "
            "its snapshots are host I/O, which jax.vmap of the JAX "
            "package's solve_checkpointed cannot map either")
    path = pathlib.Path(path)
    total_it = 0
    X, P = X0, None
    if resume and path.exists():
        ck = load_checkpoint(path)
        dev = X0.device if X0 is not None else resolve_device(device)
        X = torch.from_numpy(ck["basis"]).to(device=dev, dtype=A.dtype)
        if "momentum" in ck:
            P = torch.from_numpy(ck["momentum"]).to(device=dev, dtype=A.dtype)
        total_it = ck["iterations"]

    cfg = dataclasses.replace(config, max_iter=every)

    def chunk_solve(it_cap):
        return solve_fn(A, X, B, T, config=cfg, generator=generator, P0=P,
                        it_cap=it_cap, device=device if X is None else None)

    result = None
    while total_it < config.max_iter:
        result = chunk_solve(min(every, config.max_iter - total_it))
        total_it += result.iterations
        X, P = result.basis, result.momentum
        save_checkpoint(path, X, result.eigenvalues, iterations=total_it,
                        momentum=P, meta={"converged": result.converged})
        if result.converged >= config.nev or result.iterations == 0:
            break
    if result is None:  # already past max_iter when resumed
        result = chunk_solve(1)
    return result._replace(iterations=total_it)
