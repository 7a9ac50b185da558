"""Indefinite LOBPCG solver, Kressner-Pandur-Shao (port of
``lobpcg_tpu/solvers/ilobpcg.py``).

The same host-loop skeleton as solvers.lobpcg plus: initial SVQB
B-orthonormalization, the pencil RR with signature tracking
(ops.indefinite), signature-weighted W orthogonalization every
iteration, the quality=5 dual-basis projection, the B-application cache,
rr-fail recovery and the optional stall reset.  Beyond the reads the
ortho loops' early exits and the SVQB kept counts need, each iteration
reads the RR's two branch flags together and the residual norms once.
A 3-D X0 runs a lockstep batch, as in ``solvers/lobpcg.py``: the stall
reset, the rr-fail recovery and the quality-5 dual basis are computed
for the batch when some live problem takes them and selected per
problem.  Its spans under a profiler are those of ``solvers/lobpcg.py``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from lobpcg_tpu_torch.config import STALL_NOISE, SolverConfig, quality_tol, tiny
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.gram import (
    apply_block_op,
    apply_block_op_pair,
    b_mm,
    mm,
)
from lobpcg_tpu_torch.ops.indefinite import (
    indefinite_rayleigh_ritz,
    indefinite_rayleigh_ritz_modified,
)
from lobpcg_tpu_torch.ops.ortho import ortho_indefinite
from lobpcg_tpu_torch.ops.residual import (
    col_norms,
    get_residual,
    get_residual_norm,
)
from lobpcg_tpu_torch.ops.svqb import robust_basis_init
from lobpcg_tpu_torch.solvers import observe
from lobpcg_tpu_torch.solvers.lobpcg import (
    _batch,
    _config_of,
    _local_rows,
    _norms,
    _start_block,
    _start_momentum,
    solve_entry,
)
from lobpcg_tpu_torch.solvers.state import ILOBPCGResult
from lobpcg_tpu_torch.utils.prng import Draws
from lobpcg_tpu_torch.utils.profiling import ITER, UPDATE, span


def _ilobpcg_impl(A, B, T, X0, rng: Draws, config: SolverConfig, device,
                  P0=None, p0_cnt=0, it_cap=None) -> ILOBPCGResult:
    n = A.shape[0]  # global: the random draws are [n, .], cut to n_loc
    n_loc, _ = _local_rows(n)
    m = config.size_sub
    nev = config.nev
    dtype = A.dtype
    lead = _batch(X0)  # (b,) for a lockstep batch
    nb = lead[0] if lead else None
    eps_ortho, eps_drop = config.resolved_eps(dtype)
    rrdt = config.resolved_rr_dtype(dtype)
    tn = tiny(dtype if rrdt is None else rrdt)
    qt = quality_tol(dtype)

    a_norm, b_norm = _norms(A, B, rng, config, n, dtype, device, lead)

    def res_norm(W, lam):
        BW = (
            apply_block_op(B, W[..., :nev])
            if config.residual_norm == "b" else None
        )
        return get_residual_norm(W, lam, a_norm, b_norm, nev, BW)

    observe.log_start(config, "ilobpcg", a_norm, b_norm)

    X = _start_block(X0, rng, n, m, dtype, device)
    X = robust_basis_init(
        X, B, lambda: rng.fill("refill", (n, m), dtype, device),
        tau=eps_drop, rr_dtype=rrdt,
    )

    Cx0, lam, sig, rr_ok0 = indefinite_rayleigh_ritz(
        X, A, B, method=config.rr_method, tiny=tn, rr_dtype=rrdt
    )
    with span(UPDATE):
        X = mm(X, Cx0)
        AX = apply_block_op(A, X, "A")
        W = get_residual(X, AX, lam, A, B)
        res = res_norm(W, lam)

    P, p_cnt = _start_momentum(P0, p0_cnt, lead, n_loc, m, dtype, device)
    conv = it = q5 = stall = lanes.zeros(nb, device)
    rr_fail = lanes.as_int(lanes.not_(lanes.read(rr_ok0)))
    res_best = lanes.read(torch.amax(res, dim=-1))
    hist = observe.history_init(config, m, lam.dtype, res.dtype, device, lead)
    if not config.use_ax_cache:
        AX = None

    limit = config.max_iter if it_cap is None else min(it_cap, config.max_iter)
    g = 0  # lockstep iterations: every live problem's ``it``
    while True:
        run = (it < limit) & (conv < nev)
        some, every = lanes.status(run)
        if not some:
            break
        with span(ITER):
            # Problems that are done stay frozen (see solvers/lobpcg.py).
            live = True if every else run
            old = None if every else (X, AX, P, W, lam, sig, res, conv,
                                      p_cnt, it, q5, stall, rr_fail,
                                      res_best)
            np_act = lanes.minimum(p_cnt, m - conv)
            nw = lanes.select(it == 0, m, m - conv)

            # Stagnation stabilizer (SolverConfig.stall_reset): perturb W
            # with column-norm-scaled noise; dead (zero) columns stay zero.
            # Every live problem of a batch is at iteration g.
            tripped = False
            if config.stall_reset:
                tripped = lanes.settle(stall >= config.stall_reset, live)

            def perturb():
                z = rng.fill(f"stall{g}", (n, m), dtype, device)
                nrm = col_norms(W, keepdim=True).to(dtype)
                return W + z * (STALL_NOISE * nrm)

            W = lanes.cond(tripped, perturb, lambda: W)

            if T is not None:
                W = masking.mask_cols(apply_block_op(T, W, "T"), nw)

            # Indefinite orthogonalization against [X, P_active] every
            # iteration.  With use_b_cache, B@X and B@P are applied once
            # and feed the ortho projector and the RR B-Gram; the ortho
            # pass returns B@W.
            if config.use_b_cache:
                if config.pack_applies:
                    BX, BP = apply_block_op_pair(B, X, P)
                else:
                    BX, BP = apply_block_op(B, X), apply_block_op(B, P)
                W, nw, BW = ortho_indefinite(
                    W, nw, (X, P), m + np_act, B,
                    eps_ortho=eps_ortho, eps_drop=eps_drop,
                    max_outer=config.max_outer, max_inner=config.max_inner,
                    rr_dtype=rrdt, Bvb=(BX, BP), return_bu=True,
                    entry_check=config.ortho_skip,
                )
                Bblocks = (BX, BP, BW)
                del BX, BP, BW
            else:
                W, nw = ortho_indefinite(
                    W, nw, (X, P), m + np_act, B,
                    eps_ortho=eps_ortho, eps_drop=eps_drop,
                    max_outer=config.max_outer, max_inner=config.max_inner,
                    rr_dtype=rrdt, entry_check=config.ortho_skip,
                )
                Bblocks = None
            blocks = (X, P, W)

            rr = indefinite_rayleigh_ritz_modified(
                blocks, AX, np_act, nw, A, B,
                nx=m, method=config.rr_method, tiny=tn, quality_tol=qt,
                eps_ortho=eps_ortho, eps_drop=eps_drop,
                max_outer=config.max_outer, max_inner=config.max_inner,
                rr_dtype=rrdt, Bblocks=Bblocks, pack=config.pack_applies,
            )
            del Bblocks

            def project_good():
                Xn = b_mm(blocks, rr.Cx)
                Pn = b_mm(blocks, rr.Cp)
                AXn = apply_block_op(A, Xn, "A")
                Wres = get_residual(Xn, AXn, rr.lam, A, B)
                return Xn, Pn, AXn if config.use_ax_cache else None, Wres

            def project_poor():
                # Dual basis: residual from the accurate basis, iterate
                # the stable one.
                X_acc = b_mm(blocks, rr.Cx)
                Xn = b_mm(blocks, rr.Cx_ortho)
                Pn = b_mm(blocks, rr.Cp)
                AXn = (apply_block_op(A, Xn, "A") if config.use_ax_cache
                       else None)
                return Xn, Pn, AXn, get_residual(X_acc, None, rr.lam, A, B)

            def update():
                if not config.dual_basis:
                    return project_good()
                return lanes.cond(lanes.settle(rr.quality == 1, live),
                                  project_good, project_poor)

            def recover():
                # The projected pencil solve failed: discard the update,
                # keep X and its eigenvalues, reset the momentum, rebuild
                # W from X.
                Wres = get_residual(X, AX, lam, A, B)
                return X, torch.zeros_like(P), AX, Wres

            with span(UPDATE):
                rr_ok = lanes.settle(rr.rr_ok, live)
                Xn, Pn, AXn, Wres = lanes.cond(rr_ok, update, recover)
                lam_n = lanes.select(rr_ok, rr.lam, lam)
                sig_n = lanes.select(rr_ok, rr.sig[..., :m], sig)
                del blocks, W

                res = res_norm(Wres, lam_n)
                res_max = lanes.read(torch.amax(res, dim=-1))
                convn = masking.prefix_count(res <= config.tol)

                act = m - convn
                p_next = lanes.select(rr_ok, act, 0)
                P = masking.shift_cols(Pn, convn, p_next)
                W = masking.shift_cols(Wres, convn, act)
                del Pn, Wres

                observe.log_iteration(config, "ilobpcg", g, lam_n, res,
                                      convn)
                failed = lanes.as_int(lanes.not_(rr_ok))
                flag = rr.quality + 8 * failed + 16 * lanes.as_int(tripped)
                hist = observe.history_update(hist, g, lam_n, res, convn,
                                              flag, live)

                # Stall accounting: progress = the converged prefix grew or
                # the worst residual improved 10% on the best seen; an
                # rr-failed iteration jumps straight to the threshold.
                improved = (convn > conv) | (res_max < 0.9 * res_best)
                K = max(config.stall_reset, 1)
                stall = lanes.select(improved | tripped, 0,
                                     lanes.minimum(stall + 1 + K * failed,
                                                   2 * K))
                q5 = q5 + lanes.as_int((rr.quality == 5) & rr_ok)
                rr_fail = rr_fail + failed
                res_best = lanes.minimum(res_best, res_max)
                X, AX, lam, sig, conv, p_cnt = (Xn, AXn, lam_n, sig_n, convn,
                                                p_next)
                it = it + 1
                if old is not None:
                    (X, AX, P, W, lam, sig, res, conv, p_cnt, it, q5, stall,
                     rr_fail, res_best) = lanes.select(
                        live, (X, AX, P, W, lam, sig, res, conv, p_cnt, it,
                               q5, stall, rr_fail, res_best), old)
                    del old
            g += 1

    return ILOBPCGResult(
        eigenvalues=lam[..., :nev],
        eigenvectors=X[..., :nev],
        residual_norms=res,
        signature=sig[..., :nev],
        converged=conv,
        iterations=it,
        basis=X,
        momentum=P,
        history=hist,
        quality5_count=q5,
        rr_fail_count=rr_fail,
    )


def ilobpcg(
    A: LinearOperator,
    X0: Optional[torch.Tensor] = None,
    B: Optional[LinearOperator] = None,
    T: Optional[LinearOperator] = None,
    *,
    P0: Optional[torch.Tensor] = None,
    nev: Optional[int] = None,
    size_sub: Optional[int] = None,
    tol: float = 1e-5,
    max_iter: int = 100,
    generator: Optional[torch.Generator] = None,
    config: Optional[SolverConfig] = None,
    device=None,
    draws: Optional[Mapping] = None,
    it_cap: Optional[int] = None,
) -> ILOBPCGResult:
    """Solve A x = lambda B x with **indefinite** B for the eigenvalues
    closest to the positive spectrum edge (KPS ordering: positive
    ascending first).  B is required.  Device, ``generator``, ``draws``
    and the lockstep batch (a 3-D X0) as in ``lobpcg``.
    """
    if B is None:
        raise ValueError("ilobpcg: B operator must not be None")
    config = _config_of(config, nev, size_sub, tol, max_iter)
    return solve_entry(_ilobpcg_impl, A, B, T, X0, P0, config, generator,
                       device, draws, it_cap)
