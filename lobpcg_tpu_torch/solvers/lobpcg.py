"""Standard / generalized LOBPCG solver (port of
``lobpcg_tpu/solvers/lobpcg.py``).

The JAX package's one jitted ``lax.while_loop`` is a host loop here and
its ``lax.cond``s are Python ``if``s on values read from the device;
blocks keep the JAX package's fixed [n, m] shapes with dead columns
exactly zero, and the live-column counts are Python ints.  Beyond the
reads the ortho loops' early exits and the SVQB kept counts need, each
iteration reads the RR's retry flag and the residual norms once.
``live_cols`` counts the live W and P columns each Rayleigh-Ritz takes,
summed over the iterations (a Python int; [b] lanes in a batch): the
tall work runs on all 2 m columns of W and P, the others dead.

Lockstep batched solves (what ``jax.vmap`` gives the JAX package): an
X0 of shape [b, n, m] solves b problems in one loop, one set of launches
for the batch.  The per-problem counts and flags are then [b] tensors on
the device, each branch is computed for the batch when some live problem
takes it and selected per problem, and a converged or capped problem is
frozen while the others run (``ops/lanes.py``).  The loop is the same
code: on a 2-D X0 the helpers reduce to the unbatched host loop.  The
host reads of an iteration do not grow with b.

Under a row group a lockstep batch's X0 is [b, n_loc, m], each rank's
rows of the b problems (``parallel.shard_problem``).  Every per-problem
branch is decided from row-summed values (the all-reduced Grams and
norms), so every rank takes the same branches; a reduction is one
all-reduce for the batch, so a batch makes as many collectives an
iteration as one problem.  The random draws are the unsharded lockstep
solve's, cut to this rank's rows.

Under a profiler a solve is a ``lobpcg.solve`` span and each pass of the
loop a ``lobpcg.iter`` span; the operator applies, the orthogonalization
and the Rayleigh-Ritz are spans of their own (``ops/gram.py``,
``ops/ortho.py``, ``ops/rayleigh.py``), and the projection, residual and
convergence block is ``lobpcg.update`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from lobpcg_tpu_torch.config import (
    SolverConfig,
    resolve_device,
    validate_problem,
)
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops import lanes, masking, rows
from lobpcg_tpu_torch.ops.gram import (
    apply_block_op,
    apply_block_op_pair,
    b_mm,
    mixed_chunk_ctx,
    precision_ctx,
)
from lobpcg_tpu_torch.ops.ortho import ortho_drop
from lobpcg_tpu_torch.ops.rayleigh import rayleigh_ritz, rayleigh_ritz_modified
from lobpcg_tpu_torch.ops.residual import (
    estimate_norm,
    get_residual,
    get_residual_norm,
)
from lobpcg_tpu_torch.ops.svqb import robust_basis_init
from lobpcg_tpu_torch.solvers import observe
from lobpcg_tpu_torch.solvers.state import LOBPCGResult
from lobpcg_tpu_torch.utils.prng import Draws
from lobpcg_tpu_torch.utils.profiling import (
    ITER,
    SOLVE,
    SYNC_COPY,
    UPDATE,
    span,
)


def _local_rows(n: int):
    """(rows this rank holds, their slice of an [n, .] global block) under
    the active row group; (n, None) for an unsharded solve."""
    mesh = rows.active()
    if mesh is None:
        return n, None
    n_loc = n // mesh.size
    return n_loc, slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)


def _batch(X0):
    """The leading shape of a lockstep batched solve: (b,) for an X0 of
    [b, n, m], () otherwise."""
    return tuple(X0.shape[:-2]) if X0 is not None else ()


def _prepare_p0(P0, A, config, lead=()):
    """Validate and prefix-compact a warm-restart momentum block (this
    rank's rows under a row group): the live P columns must form a
    zero-padded prefix, so nonzero columns move to the front (stable) and
    are counted.  Returns (P0, count).

    A lockstep batch (``lead`` (b,)) takes one P0 [n, m] shared by its
    problems, as ``jax.vmap`` shares an unmapped P0: it is compacted
    once here and every problem starts from it."""
    if P0 is None:
        return None, 0
    if lead and P0.dim() != 2:
        raise NotImplementedError(
            f"P0 of shape {tuple(P0.shape)}: the lockstep batched solve takes "
            "one P0 [n, size_sub] shared by the batch, not a warm restart per "
            "problem; jax.vmap of the JAX package's solve refuses a mapped P0 "
            "too (its _prepare_p0 reads P0 on the host)")
    n_loc, _ = _local_rows(A.shape[0])
    if tuple(P0.shape) != (n_loc, config.size_sub):
        raise ValueError(
            f"P0 has shape {tuple(P0.shape)}, expected "
            f"({n_loc}, {config.size_sub})"
        )
    nonzero = rows.row_max(torch.amax(torch.abs(P0), dim=0)) > 0
    with span(SYNC_COPY):
        nonzero = nonzero.cpu().numpy()
    order = np.argsort(~nonzero, kind="stable")
    p0_cnt = int(nonzero.sum())
    if not (order == np.arange(order.size)).all():
        P0 = P0[:, torch.as_tensor(order, device=P0.device)]
    return P0, p0_cnt


def _norms(A, B, rng, config, n, dtype, device, lead=()):
    """(||A||, ||B||) estimates from the draws "norm_a" / "norm_b"
    (one per problem of a batch, every problem starting from the same
    draws: this rank's rows of them under a row group); ||B|| = 1 when B
    is None."""
    shape = (n, config.norm_block)

    def start(name):
        v = rng.fill(name, shape, dtype, device)
        return v.expand(lead + tuple(v.shape)) if lead else v

    a_norm = estimate_norm(A, start("norm_a"), config.norm_iters)
    if B is None:
        return a_norm, torch.ones((), dtype=a_norm.dtype, device=device)
    b_norm = estimate_norm(B, start("norm_b"), config.norm_iters, role="B")
    return a_norm, b_norm


def _start_block(X0, rng, n, m, dtype, device):
    if X0 is None:
        return rng.fill("x0", (n, m), dtype, device)
    return X0.to(device=device, dtype=dtype)


def _start_momentum(P0, p0_cnt, lead, n_loc, m, dtype, device):
    """(P, its live-column count) at the start of a solve: zeros and 0,
    or the prepared P0 and its count; a lockstep batch starts every
    problem from its one shared P0."""
    if P0 is None:
        return (torch.zeros(lead + (n_loc, m), dtype=dtype, device=device),
                lanes.zeros(lead[0] if lead else None, device))
    P = P0.to(device=device, dtype=dtype)
    if not lead:
        return P, p0_cnt
    return (P.expand(lead + (n_loc, m)).contiguous(),
            torch.full(lead, p0_cnt, dtype=torch.int64, device=device))


def _check_inputs(A, X0, config, it_cap, device):
    """Entry validation shared by lobpcg and ilobpcg; returns the device
    of the solve: X0's, or ``device`` when X0 is None, or the CUDA card
    when neither is given (raises without one)."""
    validate_problem(A.shape[0], config)
    n_loc, _ = _local_rows(A.shape[0])
    if X0 is not None:
        if X0.dim() not in (2, 3):
            raise ValueError(f"X0 must be [n, size_sub] or [b, n, size_sub], "
                             f"got {tuple(X0.shape)}")
        if X0.shape[-1] != config.size_sub:
            raise ValueError(
                f"X0 has {X0.shape[-1]} columns, expected "
                f"size_sub={config.size_sub}"
            )
        if X0.shape[-2] != n_loc:
            raise ValueError(
                f"X0 has {X0.shape[-2]} rows, expected {n_loc} (A.shape[0]="
                f"{A.shape[0]}{'' if rows.active() is None else ', this rank'})"
            )
        if device is not None and torch.device(device) != X0.device:
            raise ValueError(
                f"device={device} but X0 lies on {X0.device}"
            )
        device = X0.device
    elif device is None and rows.active() is not None:
        device = rows.active().device
    if it_cap is not None and it_cap > config.max_iter:
        raise ValueError(
            f"it_cap ({it_cap}) > config.max_iter ({config.max_iter})"
        )
    return resolve_device(device)


def _check_rr_chunk_unsharded(config: SolverConfig, mesh) -> None:
    """The JAX package refuses rr_chunk_rows with row-sharded inputs
    (its chunking reshape conflicts with a sharded leading axis); the
    port keeps that contract for groups of more than one rank."""
    if config.rr_chunk_rows and mesh is not None and mesh.size > 1:
        raise ValueError(
            "rr_chunk_rows is set but the inputs are row-sharded over "
            f"{mesh.size} ranks: unset rr_chunk_rows for sharded solves"
        )


def solve_entry(impl, A, B, T, X0, P0, config, generator, device, draws,
                it_cap):
    """The entry steps lobpcg and ilobpcg share: find the row group (the
    active mesh, or the mesh of a sharded operator in A, B or T; none
    when n does not divide over its ranks), check
    the inputs against this rank's rows, and run ``impl`` under the
    config's precision with the random draws cut to this rank's rows.
    A 3-D X0 runs the batch in lockstep (under a row group, this rank's
    rows of each problem)."""
    mesh = rows.active() or rows.find_mesh(A, B, T)
    if mesh is not None and A.shape[0] % mesh.size:
        # Rows that do not divide: shard_problem placed the whole problem
        # on every rank, and each rank solves all of it with no row group
        # (the JAX package's replicated arrays).
        if device is None and X0 is None:
            device = mesh.device
        mesh = None
    with span(SOLVE), rows.rows_ctx(mesh):
        _check_rr_chunk_unsharded(config, mesh)
        device = _check_inputs(A, X0, config, it_cap, device)
        P0, p0_cnt = _prepare_p0(P0, A, config, _batch(X0))
        rng = Draws(generator, draws, rows=_local_rows(A.shape[0])[1])
        with precision_ctx(config.gram_precision), \
                mixed_chunk_ctx(config.rr_chunk_rows):
            return impl(A, B, T, X0, rng, config, device, P0, p0_cnt, it_cap)


def _config_of(config, nev, size_sub, tol, max_iter):
    if config is not None:
        return config
    if nev is None:
        raise ValueError("either nev or config must be given")
    return SolverConfig(
        nev=nev,
        size_sub=size_sub if size_sub is not None else nev,
        tol=tol,
        max_iter=max_iter,
    )


def _lobpcg_impl(A, B, T, X0, rng: Draws, config: SolverConfig, device,
                 P0=None, p0_cnt=0, it_cap=None) -> LOBPCGResult:
    n = A.shape[0]  # global: the random draws are [n, .], cut to n_loc
    n_loc, _ = _local_rows(n)
    m = config.size_sub
    nev = config.nev
    dtype = A.dtype
    lead = _batch(X0)  # (b,) for a lockstep batch
    nb = lead[0] if lead else None
    eps_ortho, eps_drop = config.resolved_eps(dtype)
    rrdt = config.resolved_rr_dtype(dtype)

    a_norm, b_norm = _norms(A, B, rng, config, n, dtype, device, lead)

    def res_norm(W, lam):
        BW = (
            apply_block_op(B, W[..., :nev])
            if config.residual_norm == "b" and B is not None else None
        )
        return get_residual_norm(W, lam, a_norm, b_norm, nev, BW)

    observe.log_start(config, "lobpcg", a_norm, b_norm)

    X = _start_block(X0, rng, n, m, dtype, device)
    X = robust_basis_init(
        X, B, lambda: rng.fill("refill", (n, m), dtype, device),
        tau=eps_drop, rr_dtype=rrdt,
    )

    Cx0, lam = rayleigh_ritz(X, A, B, rr_dtype=rrdt)
    with span(UPDATE):
        X = b_mm((X,), Cx0)
        AX = apply_block_op(A, X, "A")
        W = get_residual(X, AX, lam, A, B)
        res = res_norm(W, lam)
    if not config.use_ax_cache:
        AX = None

    P, p_cnt = _start_momentum(P0, p0_cnt, lead, n_loc, m, dtype, device)
    conv = use_ortho = it = retries = live_cols = lanes.zeros(nb, device)
    hist = observe.history_init(config, m, lam.dtype, res.dtype, device, lead)
    cache_b = config.use_b_cache and B is not None

    def do_ortho(W, nw, X, P, np_act, Bvb=None):
        return ortho_drop(
            W, nw, (X, P), m + np_act, B,
            eps_ortho=eps_ortho, eps_drop=eps_drop,
            max_outer=config.max_outer, max_inner=config.max_inner,
            rr_dtype=rrdt, Bvb=Bvb, return_bu=cache_b,
            entry_check=config.ortho_skip,
        )

    def rr_modified(W, nw, use_ortho, Bblocks):
        return rayleigh_ritz_modified(
            (X, P, W), AX, np_act, nw, use_ortho, A, B,
            nx=m, tol_skip=config.tol_skip, rr_dtype=rrdt,
            Bblocks=Bblocks, pack=config.pack_applies,
        )

    limit = config.max_iter if it_cap is None else min(it_cap, config.max_iter)
    g = 0  # lockstep iterations: every live problem's ``it``
    while True:
        run = (it < limit) & (conv < nev)
        some, every = lanes.status(run)
        if not some:
            break
        with span(ITER):
            # Problems that are done stay frozen: their old state is
            # selected back at the end of the iteration.
            live = True if every else run
            old = None if every else (X, AX, P, W, lam, res, conv, p_cnt,
                                      use_ortho, it, retries, live_cols)
            np_act = lanes.minimum(p_cnt, m - conv)
            nw = lanes.select(it == 0, m, m - conv)

            if T is not None:
                W = masking.mask_cols(apply_block_op(T, W, "T"), nw)

            # With cache_b, B@X and B@P are applied once and threaded
            # through the ortho projector and the RR B-Gram.
            orth = lanes.settle(use_ortho >= 1, live)
            Bvb = None
            if cache_b:
                if config.pack_applies:
                    BX, BP = apply_block_op_pair(B, X, P)
                else:
                    BX, BP = apply_block_op(B, X), apply_block_op(B, P)
                Bvb = (BX, BP)
                W, nw, BW = lanes.cond(
                    orth, lambda: do_ortho(W, nw, X, P, np_act, Bvb=Bvb),
                    lambda: (W, nw, apply_block_op(B, W)))
                Bblocks = (BX, BP, BW)
            else:
                W, nw = lanes.cond(orth,
                                   lambda: do_ortho(W, nw, X, P, np_act),
                                   lambda: (W, nw))
                Bblocks = None

            rr = rr_modified(W, nw, lanes.as_int(orth), Bblocks)
            flag0 = rr.flag
            retried = lanes.settle(flag0 == 2, live)
            if lanes.any_(retried):
                # Cholesky/cond failure: orthogonalize W and retry with the
                # ortho branch (in a batch, for the problems that failed).
                kept = (rr, W, nw) if lanes.is_lanes(retried) else None
                if cache_b:
                    W, nw, BW2 = do_ortho(W, nw, X, P, np_act, Bvb=Bvb)
                    Bblocks = (BX, BP, BW2)
                else:
                    W, nw = do_ortho(W, nw, X, P, np_act)
                    Bblocks = None
                rr = rr_modified(W, nw, 1, Bblocks)
                if kept is not None:
                    rr, W, nw = lanes.select(retried, (rr, W, nw), kept)
                    del kept
            use_ortho = lanes.select(retried, 1,
                                     lanes.maximum(use_ortho, rr.flag))
            retries = retries + lanes.as_int(flag0 == 2)
            live_cols = live_cols + nw + np_act
            Bvb = Bblocks = None

            with span(UPDATE):
                blocks = (X, P, W)
                Xn = b_mm(blocks, rr.Cx)
                Pn = b_mm(blocks, rr.Cp)
                del blocks
                AXn = apply_block_op(A, Xn, "A")
                Wres = get_residual(Xn, AXn, rr.lam, A, B)
                if not config.use_ax_cache:
                    AXn = None
                res = res_norm(Wres, rr.lam)
                convn = masking.prefix_count(res <= config.tol)

                # Soft-locking compaction for the next iteration.
                act = m - convn
                p_next = lanes.minimum(lanes.maximum(rr.p_count - convn, 0),
                                       act)
                P = masking.shift_cols(Pn, convn, p_next)
                W = masking.shift_cols(Wres, convn, act)
                del Pn, Wres

                observe.log_iteration(config, "lobpcg", g, rr.lam, res,
                                      convn)
                hist = observe.history_update(hist, g, rr.lam, res, convn,
                                              flag0, live)
                X, AX, lam, conv, p_cnt = Xn, AXn, rr.lam, convn, p_next
                it = it + 1
                if old is not None:
                    (X, AX, P, W, lam, res, conv, p_cnt, use_ortho, it,
                     retries, live_cols) = lanes.select(
                        live, (X, AX, P, W, lam, res, conv, p_cnt, use_ortho,
                               it, retries, live_cols), old)
                    del old
            g += 1

    return LOBPCGResult(
        eigenvalues=lam[..., :nev],
        eigenvectors=X[..., :nev],
        residual_norms=res,
        converged=conv,
        iterations=it,
        basis=X,
        momentum=P,
        history=hist,
        ortho_retries=retries,
        live_cols=live_cols,
    )


def lobpcg(
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
) -> LOBPCGResult:
    """Solve A x = lambda B x for the nev smallest eigenpairs.

    B=None gives the standard problem, T is an optional preconditioner,
    X0 an optional initial guess ([n, size_sub]); an X0 of
    [b, n, size_sub] solves b problems in lockstep (operator data with a
    leading batch dimension, ``operators/linop.py``; a P0 [n, size_sub]
    shared by the batch) and every field of the result gains a leading
    batch dimension.  Under a row group (``parallel.shard_problem``) the
    row counts are this rank's, n_loc for n.  The solve runs on
    X0's device, or on ``device`` when X0 is None, or on the CUDA card
    when neither is given.  Random fills come
    from ``generator`` (a ``torch.Generator`` on that device; None = the
    global one), except the named blocks given in ``draws`` (see
    ``utils.prng.Draws``).  ``it_cap``: an iteration cap <= max_iter.
    """
    config = _config_of(config, nev, size_sub, tol, max_iter)
    return solve_entry(_lobpcg_impl, A, B, T, X0, P0, config, generator,
                       device, draws, it_cap)
