"""The port's spans (``lobpcg_tpu_torch/utils/profiling.py``) on the CPU.

With no profiler recording, a solve enters no ``record_function`` and
runs the same operations in the same order as under the profiler, to
the same bits.  Under the profiler the spans form one tree a solve:
``lobpcg.solve`` holds the ``lobpcg.iter`` spans, one a pass of the host
loop; every phase (``apply.*``, ``ortho``, ``rr``, ``update``) lies in
the solve, and those after the loop's start in an iteration; every read
of a tensor to the host (``aten::_local_scalar_dense``) lies in a
``lobpcg.sync.*`` span, and every call of an operator's ``matmat`` in an
``apply.*`` span.  This file imports no JAX.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.operators.linop import LinearOperator
from lobpcg_tpu_torch.ops.cuda import stencil, tail
from lobpcg_tpu_torch.utils import profiling

F64 = torch.float64
PHASES = ("lobpcg.apply.", "lobpcg.ortho", "lobpcg.rr", "lobpcg.update")
MATMAT = "test.matmat"


def well(n=400, well_sites=24, barrier=1.0, shift=1.0, b=None):
    """The BdG well pencil (A = diag(K, K), B = antidiag(I, I), T =
    Chebyshev degree 3 in column chunks of 4) and a B-positive start
    [u; u] inside the well ([b, n, 8] for a lockstep batch of b barriers
    from ``barrier`` up)."""
    m = n // 2
    lo = (m - well_sites) // 2
    barriers = [barrier] if b is None else [barrier + 0.5 * i for i in range(b)]
    V = torch.full((len(barriers), m), 0.0, dtype=F64)
    for i, bar in enumerate(barriers):
        V[i] = bar + shift
        V[i, lo:lo + well_sites] = shift
    VV = torch.cat([V, V], dim=-1)
    A = tl.Laplacian1D(1.0, n, segments=2, dtype=F64) + tl.DiagonalOperator(
        VV[0] if b is None else VV)
    hi = 4.0 + max(barriers) + shift + 0.1
    T = tl.ChebyshevFilter(op=A, lo=2.0, hi=hi, degree=3, chunk=4)
    B = tl.BlockAntiDiagOperator(torch.ones(m, dtype=F64))
    u = torch.zeros((m, 8), dtype=F64)
    u[lo:lo + well_sites] = torch.from_numpy(
        np.random.default_rng(42).uniform(-0.5, 0.5, (well_sites, 8)))
    X0 = torch.cat([u, u])
    if b is not None:
        X0 = X0.expand(b, n, 8).contiguous()
    return A, B, T, X0


def solve_well(b=None, **knobs):
    A, B, T, X0 = well(b=b)
    cfg = tl.SolverConfig(nev=4, size_sub=8, tol=1e-8, max_iter=300, **knobs)
    return tl.ilobpcg(A, X0, B, T, config=cfg,
                      generator=torch.Generator().manual_seed(3))


def solve_laplacian():
    """Generalized lobpcg: A = Laplacian1D + diagonal, B a positive
    diagonal, T Chebyshev degree 3."""
    n = 300
    A = tl.Laplacian1D(1.0, n, dtype=F64) + tl.DiagonalOperator(
        torch.linspace(0.0, 1.0, n, dtype=F64))
    B = tl.DiagonalOperator(torch.linspace(1.0, 2.0, n, dtype=F64))
    T = tl.ChebyshevFilter(op=A, lo=0.5, hi=6.0, degree=3)
    cfg = tl.SolverConfig(nev=3, size_sub=6, tol=1e-8, max_iter=400)
    return tl.lobpcg(A, None, B, T, config=cfg,
                     generator=torch.Generator().manual_seed(5), device="cpu")


SOLVES = {"ilobpcg": solve_well, "lobpcg": solve_laplacian,
          "lockstep": lambda: solve_well(b=3),
          # The host QZ (its copies to the host) and the stall reset.
          "ilobpcg_qz_stall": lambda: solve_well(rr_method="qz",
                                                 stall_reset=1)}


class OpLog(TorchDispatchMode):
    """The name of every ATen operation dispatched, in order (the
    profiler's own range operations left out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("profiler."):
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _launches():
    return [f.launches for f in (stencil.stencil_matmat, stencil.stencil_diag,
                                 stencil.cheb_step, tail.antidiag,
                                 tail.residual, tail.combine, tail.compact)]


def _run(kind):
    before = _launches()
    with OpLog() as log:
        r = SOLVES[kind]()
    launches = [a - b for a, b in zip(_launches(), before)]
    return r, log.ops, launches


@pytest.mark.parametrize("kind", sorted(SOLVES))
def test_spans_are_free_without_a_profiler(kind, monkeypatch, tmp_path):
    """No profiler: no record_function entered.  Under the profiler the
    same ATen operations run in the same order (no launch and no read
    added), to the same eigenvalues and iterations, bit for bit."""
    entered = []
    real = torch.profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    assert profiling.span("lobpcg.x") is profiling.span("lobpcg.y")
    r0, ops0, launches0 = _run(kind)
    assert entered == []
    with profiling.trace(tmp_path):
        r1, ops1, launches1 = _run(kind)
    assert entered and all(name.startswith("lobpcg.") for name in entered)
    assert ops0 == ops1
    assert launches0 == launches1
    assert torch.equal(r0.eigenvalues, r1.eigenvalues)
    assert torch.equal(r0.residual_norms, r1.residual_norms)
    assert torch.equal(torch.as_tensor(r0.iterations),
                       torch.as_tensor(r1.iterations))


def _matmats_ranged(monkeypatch):
    """Every operator class's matmat called inside a range of its own."""
    def walk(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from walk(sub)

    for cls in set(walk(LinearOperator)):
        if "matmat" not in vars(cls):
            continue

        def ranged(self, X, _fn=vars(cls)["matmat"]):
            with torch.profiler.record_function(MATMAT):
                return _fn(self, X)
        monkeypatch.setattr(cls, "matmat", ranged)


def _host_events(path):
    """(ts, end, name) of the host events on the thread of lobpcg.solve,
    sorted by start."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in (
                  "user_annotation", "cpu_op")]
    tid = next(e["tid"] for e in events if e["name"] == profiling.SOLVE)
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e["tid"] == tid)


def _inside(ev, spans):
    return any(s <= ev[0] and ev[1] <= e for s, e, _ in spans)


@pytest.mark.parametrize("kind", sorted(SOLVES))
def test_span_tree_of_a_solve(kind, monkeypatch, tmp_path):
    _matmats_ranged(monkeypatch)
    with profiling.trace(tmp_path):
        r = SOLVES[kind]()
    host = _host_events(tmp_path / "trace.json")
    solve = [h for h in host if h[2] == profiling.SOLVE]
    iters = [h for h in host if h[2] == profiling.ITER]
    phases = [h for h in host if h[2].startswith(PHASES)]
    syncs = [h for h in host if h[2].startswith("lobpcg.sync.")]
    assert len(solve) == 1 and phases and syncs
    assert {h[2] for h in host if h[2].startswith("lobpcg.")} <= {
        profiling.SOLVE, profiling.ITER, profiling.ORTHO, profiling.RR,
        profiling.UPDATE, profiling.SYNC_READ, profiling.SYNC_EIGH,
        profiling.SYNC_COPY, *profiling.APPLY.values()}
    assert len(iters) == int(torch.as_tensor(r.iterations).max())
    assert all(_inside(h, solve) for h in iters + phases + syncs)
    # The start (norm estimates, basis, first Rayleigh-Ritz) runs before
    # the loop; from the loop's start on, every phase is in an iteration.
    assert all(_inside(h, iters) for h in phases if h[0] >= iters[0][0])
    # (lobpcg orthogonalizes W only after a failed Cholesky, which this
    # well-conditioned problem does not meet.)
    assert {h[2] for h in phases if h[0] >= iters[0][0]} >= {
        profiling.RR, profiling.UPDATE, *profiling.APPLY.values()} | (
            set() if kind == "lobpcg" else {profiling.ORTHO})
    reads = [h for h in host if h[2] == "aten::_local_scalar_dense"
             and _inside(h, solve)]
    assert reads and all(_inside(h, syncs) for h in reads)
    matmats = [h for h in host if h[2] == MATMAT]
    applies = [h for h in phases if h[2].startswith("lobpcg.apply.")]
    assert matmats and all(_inside(h, applies) for h in matmats)
    # Ranges nest: no two spans of the solve overlap but by containment.
    spans = sorted((h for h in host if h[2].startswith("lobpcg.")),
                   key=lambda h: (h[0], -h[1]))
    stack = []
    for h in spans:
        while stack and stack[-1][1] <= h[0]:
            stack.pop()
        assert not stack or h[1] <= stack[-1][1]
        stack.append(h)


def test_reads_of_the_definite_ladder_are_spans(tmp_path):
    """An indefinite GA takes the pencil's definite-combination ladder,
    whose host-to-device copies and index read block on a card: each is
    a lobpcg.sync.* span."""
    from lobpcg_tpu_torch.ops.pencil import pencil_eig_cholesky

    GA = torch.diag(torch.tensor([1.0, -1.0, 2.0, -3.0], dtype=F64))
    GB = torch.eye(4, dtype=F64) + 0.1 * torch.ones(4, 4, dtype=F64)
    with profiling.trace(tmp_path):
        with profiling.span(profiling.SOLVE):
            lam, _, ok = pencil_eig_cholesky(GA, GB, 1e-30)
    assert bool(ok) and torch.isfinite(lam).all()
    host = _host_events(tmp_path / "trace.json")
    syncs = [h for h in host if h[2].startswith("lobpcg.sync.")]
    assert {h[2] for h in syncs} >= {profiling.SYNC_COPY, profiling.SYNC_READ,
                                     profiling.SYNC_EIGH}
    reads = [h for h in host if h[2] == "aten::_local_scalar_dense"]
    assert reads and all(_inside(h, syncs) for h in reads)
