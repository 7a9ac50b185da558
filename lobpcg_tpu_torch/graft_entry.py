"""Entry points (port of ``__graft_entry__.py``): a small solve
step, the dry run of the sharded layer, and the reference's two headline
gates.

- ``entry()``: the BdG indefinite solve step at m 64 (``fn, (X0,)``).
- ``dryrun_multichip(n)``: ilobpcg, lobpcg and a block-sparse SpMM, each
  one step, sharded over an n-rank row mesh.
- ``dryrun_headline()``: the dim-4M, 150-pair BdG pencil, size_sub 160,
  f32, two iterations on the row mesh.
- ``dryrun_headline_complex()``: the same pencil specified in complex64
  and solved through its split-real embedding (f32 storage, float64
  Gram/RR math by the width rule), two iterations.

Each function returns its record as a dict; ``main`` prints them as JSON
lines and writes no file::

    python -m lobpcg_tpu_torch.graft_entry                     # the card: entry + dry run
    python -m lobpcg_tpu_torch.graft_entry --device cpu --ranks 4
    python -m lobpcg_tpu_torch.graft_entry --headline --headline-complex

The mesh is ``parallel.row_mesh``: on the card a world-size-1 NCCL group
(one card), on the CPU a gloo group of ``--ranks`` processes
(``parallel.spawn``).
"""

from __future__ import annotations

import argparse
import json
from typing import Mapping, Optional

import numpy as np
import torch

from lobpcg_tpu_torch.config import (
    SolverConfig,
    as_torch_dtype,
    real_dtype,
    resolve_device,
)
from lobpcg_tpu_torch.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    Laplacian1D,
)
from lobpcg_tpu_torch.operators.realify import realify_config, realify_operator
from lobpcg_tpu_torch.operators.sparse import BSROperator
from lobpcg_tpu_torch.parallel import (
    ShardedBSROperator,
    row_mesh,
    shard_array,
    shard_problem,
    spawn,
)
from lobpcg_tpu_torch.solvers.ilobpcg import ilobpcg
from lobpcg_tpu_torch.solvers.lobpcg import lobpcg
from lobpcg_tpu_torch.utils.plan import estimate_peak_gb

# Rows of the complex gate's start block made on the host at a time.
X0_CHUNK_ROWS = 1 << 16


def _realified_duplicated_rows(
    ur: np.ndarray, ui: np.ndarray, r0: int, r1: int
) -> np.ndarray:
    """Rows [r0, r1) of realify_x0(concat([u, u])) for u = ur + i*ui,
    made without any full-size intermediate (the complex gate's start
    block, built chunk by chunk)."""
    m = ur.shape[0]
    n_c = 2 * m  # complex rows of [u; u]
    rows = np.arange(r0, r1)
    is_im = (rows >= n_c)[:, None]
    urow = (rows % n_c) % m
    re, im = ur[urow], ui[urow]
    out = np.empty((r1 - r0, 2 * ur.shape[1]), np.float32)
    out[:, 0::2] = np.where(is_im, im, re)
    out[:, 1::2] = np.where(is_im, re, -im)
    return out


def _bdg_operators(m: int, dtype, device):
    """A = diag(K, K) with K the 1-D Laplacian scaled by 1/h^2 (the scale
    rounded to the dtype's precision), and B = antidiag(I, I)."""
    dtype = as_torch_dtype(dtype)
    h = 1.0 / (m + 1)
    scale = torch.tensor(1.0 / (h * h), dtype=real_dtype(dtype)).item()
    A = BlockDiagOperator(inner=Laplacian1D(scale=scale, n=m, dtype=dtype),
                          copies=2)
    B = BlockAntiDiagOperator(d=torch.ones((m,), dtype=dtype, device=device))
    return A, B


def _bdg_problem(m: int, size_sub: int, dtype, device=None):
    """(A, B, X0) of the BdG pencil of dimension 2m: X0 = [u; u] with u
    uniform(-0.5, 0.5) [m, size_sub] from RandomState(42)."""
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    A, B = _bdg_operators(m, dtype, dev)
    u = np.random.RandomState(42).uniform(-0.5, 0.5, size=(m, size_sub))
    ud = torch.from_numpy(u).to(device=dev, dtype=dtype)
    return A, B, torch.cat([ud, ud], dim=0)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _peak_gib(device) -> Optional[float]:
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _rr_name(cfg: SolverConfig, dtype) -> str:
    """The dtype of the solve's Gram/RR math (the storage dtype unless the
    config or the width rule widens it)."""
    return str(cfg.resolved_rr_dtype(dtype) or dtype).replace("torch.", "")


def entry(device=None):
    """(fn, (X0,)): the ilobpcg step on the BdG pencil at m 64, nev 3,
    size_sub 5, tol 1e-3, max_iter 25, f32.

    ``fn`` is the counterpart of the JAX entry's jittable step (the port
    has no compile step: fn runs eagerly).  ``fn(X0, draws=None)``
    returns (eigenvalues, residual_norms) and keeps the whole result of
    its last call as ``fn.result``; its random fills come from a
    generator seeded 0, except the named blocks in ``draws``
    (``utils.prng.Draws``)."""
    m, nev, ss = 64, 3, 5
    A, B, X0 = _bdg_problem(m, ss, torch.float32, device)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-3, max_iter=25)

    def fn(X0, draws: Optional[Mapping] = None):
        r = ilobpcg(A, X0, B, config=cfg, generator=_generator(0, X0.device),
                    draws=draws)
        fn.result = r
        return r.eigenvalues, r.residual_norms

    return fn, (X0,)


def dryrun_multichip(n_devices: int, device=None,
                     draws: Optional[Mapping] = None) -> dict:
    """Shard the solvers over an n_devices row mesh and run one step
    each: indefinite BdG (halo-exchange stencil), standard LOBPCG on the
    1-D Laplacian, and the sharded block-ELL SpMM against the dense
    product.  ``draws``: the two solves' random blocks by solver name
    (``"ilobpcg"``, ``"lobpcg"``), as the parity tests hand over the JAX
    solvers'.  Returns this rank's record."""
    draws = draws or {}
    mesh = row_mesh(n_devices, device=device)
    dev, dtype = mesh.device, torch.float32
    m = 16 * n_devices  # tiny; divisible by the mesh
    nev, ss = 2, 4
    A, B, X0 = _bdg_problem(m, ss, dtype, dev)
    As, X0s, Bs, _ = shard_problem(mesh, A, X0, B)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-2, max_iter=1)
    _reset_peak(dev)
    with mesh:
        r = ilobpcg(As, X0s, Bs, config=cfg, generator=_generator(0, dev),
                    draws=draws.get("ilobpcg"))
    lam = r.eigenvalues.double().cpu().numpy()
    assert np.all(np.isfinite(lam)), lam
    assert r.basis.shape[0] * mesh.size == 2 * m, tuple(r.basis.shape)

    # Standard solver over the same mesh (sharded stencil path).
    n2 = 32 * n_devices
    K2 = Laplacian1D(scale=float(n2) ** 2, n=n2, dtype=dtype)
    X2 = torch.from_numpy(
        np.random.RandomState(1).uniform(-0.5, 0.5, (n2, ss))).to(dev, dtype)
    K2s, X2s, _, _ = shard_problem(mesh, K2, X2)
    with mesh:
        r2 = lobpcg(K2s, X2s, config=cfg, generator=_generator(1, dev),
                    draws=draws.get("lobpcg"))
    lam2 = r2.eigenvalues.double().cpu().numpy()
    assert np.all(np.isfinite(lam2)), lam2

    # Sharded BSR SpMM (block-row halo exchange).
    nb = 2 * n_devices
    n3 = nb * 8
    tri = (np.diag(2.0 * np.ones(n3)) - np.diag(np.ones(n3 - 1), 1)
           - np.diag(np.ones(n3 - 1), -1))
    bsr = BSROperator.from_dense(tri, block_size=8, dtype=dtype, device=dev)
    sbsr = ShardedBSROperator.shard(bsr, mesh)
    X3 = np.random.RandomState(2).randn(n3, 3).astype(np.float32)
    Y3 = sbsr.matmat(shard_array(torch.from_numpy(X3), mesh))
    want = shard_array(torch.from_numpy(tri @ X3), mesh)
    err = float((Y3.double() - want).abs().max())
    assert err <= 1e-4, err

    return {"gate": "dryrun_multichip", "ranks": mesh.size,
            "rank": mesh.rank, "ilobpcg_eigenvalues": lam.tolist(),
            "ilobpcg_iterations": r.iterations,
            "ilobpcg_max_residual": float(r.residual_norms.max()),
            "basis_rows": r.basis.shape[0], "lobpcg_eigenvalues": lam2.tolist(),
            "lobpcg_iterations": r2.iterations,
            "bsr_window": sbsr.win_vals is not None,
            "bsr_max_abs_err": err,
            "rr_dtype": _rr_name(cfg, dtype),
            "estimate_peak_gib": estimate_peak_gb(2 * m, ss, dtype, cfg),
            "max_memory_allocated_gib": _peak_gib(dev)}


def dryrun_headline(
    n_devices: int = 1,
    n: int = 4_000_000,
    nev: int = 150,
    size_sub: int = 160,
    max_iter: int = 2,
    device=None,
) -> dict:
    """The reference's headline shape: the dim-4M, 150-pair BdG pencil,
    size_sub 160, f32, on an n_devices row mesh for ``max_iter``
    iterations.  One card holds it unsharded in the row sense (world
    size 1): [4M, 160] f32 is 2.38 GiB a block.  Asserts finite
    residuals and a basis over ``mesh.size`` ranks; returns the JAX
    gate's fields plus the peak device memory of the solve beside
    ``estimate_peak_gb``."""
    mesh = row_mesh(n_devices, device=device)
    dev, dtype = mesh.device, torch.float32
    A, B, X0 = _bdg_problem(n // 2, size_sub, dtype, dev)
    As, X0s, Bs, _ = shard_problem(mesh, A, X0, B)
    del X0
    cfg = SolverConfig(nev=nev, size_sub=size_sub, tol=1e-5,
                       max_iter=max_iter)
    _reset_peak(dev)
    with mesh:
        r = ilobpcg(As, X0s, Bs, config=cfg, generator=_generator(0, dev))
    res = r.residual_norms.double().cpu().numpy()
    assert np.all(np.isfinite(res)), res
    assert r.basis.shape[0] * mesh.size == n, tuple(r.basis.shape)
    return {"gate": "dryrun_headline", "n": n, "size_sub": size_sub,
            "nev": nev, "dtype": "float32", "ranks": mesh.size,
            "iterations": r.iterations, "converged": r.converged,
            "basis_rows": r.basis.shape[0], "max_residual": float(res.max()),
            "rr_dtype": _rr_name(cfg, dtype),
            "estimate_peak_gib": estimate_peak_gb(n, size_sub, dtype, cfg),
            "max_memory_allocated_gib": _peak_gib(dev)}


def dryrun_headline_complex(
    n_devices: int = 1,
    n_complex: int = 2_000_000,
    nev: int = 150,
    size_sub: int = 160,
    max_iter: int = 2,
    device=None,
) -> dict:
    """The headline pencil in its complex form, solved split-real: the
    complex64 pencil of dimension ``n_complex`` becomes 2 * n_complex
    real rows, nev 150 -> 300 pairs, size_sub 160 -> 320; f32 storage
    with the memory-lean knobs (ax-cache, b-cache and dual basis off),
    and float64 Gram/RR math, which the width rule switches on (3 x 320 =
    960 > RR_WIDTH_ESCALATE 512).  The start block is made in row chunks
    of ``_realified_duplicated_rows`` straight onto the device.

    Cut: ``n_complex`` defaults to 2M, half the JAX gate's 4M.  At 4M
    the realified block is [8M, 320] f32 (9.54 GiB) and the lean solve
    holds about 10.06 blocks (``utils/plan.py``), ~96 GiB, more than
    one 80 GB card; at 2M it holds about 48 GiB."""
    mesh = row_mesh(n_devices, device=device)
    dev = mesh.device
    m = n_complex // 2
    A, B = _bdg_operators(m, torch.complex64, dev)
    cfg = SolverConfig(nev=nev, size_sub=size_sub, tol=1e-5,
                       max_iter=max_iter, use_ax_cache=False,
                       use_b_cache=False, dual_basis=False)
    Ar = realify_operator(A, torch.float32)
    Br = realify_operator(B, torch.float32)
    cfgr = realify_config(cfg)
    rrdt = cfgr.resolved_rr_dtype(torch.float32)
    assert rrdt == torch.float64, rrdt  # the width rule engaged

    rng = np.random.RandomState(7)
    ur = rng.uniform(-0.5, 0.5, size=(m, size_sub)).astype(np.float32)
    ui = rng.uniform(-0.5, 0.5, size=(m, size_sub)).astype(np.float32)
    n_real = 2 * (2 * m)  # realified rows of X0c = [u; u]
    n_loc = n_real // mesh.size
    r0 = mesh.rank * n_loc
    X0s = torch.empty((n_loc, 2 * size_sub), dtype=torch.float32, device=dev)
    for c0 in range(r0, r0 + n_loc, X0_CHUNK_ROWS):
        c1 = min(c0 + X0_CHUNK_ROWS, r0 + n_loc)
        X0s[c0 - r0 : c1 - r0] = torch.from_numpy(
            _realified_duplicated_rows(ur, ui, c0, c1)).to(dev)
    del ur, ui

    As, _, Bs, _ = shard_problem(mesh, Ar, None, Br)
    _reset_peak(dev)
    with mesh:
        r = ilobpcg(As, X0s, Bs, config=cfgr, generator=_generator(0, dev))
    res = r.residual_norms.double().cpu().numpy()
    assert np.all(np.isfinite(res)), res
    assert r.basis.shape[0] * mesh.size == n_real, tuple(r.basis.shape)
    return {"gate": "dryrun_headline_complex", "n_complex": n_complex,
            "n_real": n_real, "size_sub": 2 * size_sub, "nev": 2 * nev,
            "dtype": "complex64 -> split-real float32", "ranks": mesh.size,
            "iterations": r.iterations, "converged": r.converged,
            "basis_rows": r.basis.shape[0], "max_residual": float(res.max()),
            "rr_dtype": _rr_name(cfgr, torch.float32),
            "estimate_peak_gib": estimate_peak_gb(n_real, 2 * size_sub,
                                                  torch.float32, cfgr),
            "max_memory_allocated_gib": _peak_gib(dev),
            "cut": "n_complex 4,000,000 -> 2,000,000 (one 80 GB card)"}


def _multichip_rank(mesh, n_devices):
    return dryrun_multichip(n_devices, device=mesh.device.type)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when not given")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of dryrun_multichip (one process each)")
    ap.add_argument("--headline", action="store_true",
                    help="run dryrun_headline instead")
    ap.add_argument("--headline-complex", action="store_true",
                    help="run dryrun_headline_complex instead")
    ap.add_argument("--headline-complex-n", type=int, default=2_000_000)
    a = ap.parse_args(argv)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    if a.headline or a.headline_complex:
        if a.headline:
            emit(dryrun_headline(device=a.device))
        if a.headline_complex:
            emit(dryrun_headline_complex(n_complex=a.headline_complex_n,
                                         device=a.device))
        return
    fn, args = entry(a.device)
    lam, res = fn(*args)
    emit({"gate": "entry", "eigenvalues": lam.double().cpu().tolist(),
          "residual_norms": res.double().cpu().tolist()})
    if a.ranks == 1:
        emit(dryrun_multichip(1, device=a.device))
    else:
        for rec in spawn(_multichip_rank, a.ranks, a.ranks, device=a.device):
            emit(rec)


if __name__ == "__main__":
    main()
