"""The Rayleigh-Ritz stage kernel (lobpcg_tpu_torch/ops/cuda/rr.py,
csrc/rr.cu) on the CPU, where the wrapper runs its plain version.

- The C entry point against ``SIGNATURES`` and the constants against
  the source.
- Which stage ``cholesky_stage`` launches the kernel for: its predicate
  ``takes`` over device, dtype, k, the batch and the counts' form; off
  the card every stage is the plain version.
- The plain version is the Cholesky branch's old chain (written out in
  ``eager_chains.rr_cholesky``), bit for bit, routed and called alone,
  and so is ``rayleigh_ritz_modified``'s Cholesky branch on the CPU.
- An emulation of csrc/rr.cu's algorithm in float64 (its one-sided
  round-robin Jacobi sweeps with their shift, rotation test and the pass
  that stops them, the sort, LAPACK's geqr2 and
  org2r, the stage's steps in its order) against the plain version in
  float64: at k 12, 30, 48 and MAX_K, with dead P and W columns,
  p_count 0 and nx, a non-finite GA, a non-definite GB and rcond below
  tol_skip; the Ritz values to 1e-12 relative, the Ritz and momentum
  subspaces by their projectors, the flags and p_count equal.
- The kernel's device time lands in ``cusolver_ms_per_iter``.

The kernel itself runs on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from lobpcg_tpu_torch.ops import rayleigh
from lobpcg_tpu_torch.ops.cuda import chains
from lobpcg_tpu_torch.ops.cuda import rr as krr
from lobpcg_tpu_torch.ops.gram import gram_blocks
from lobpcg_tpu_torch.operators.linop import DenseOperator

import eager_chains as ec

torch.set_num_threads(2)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "lobpcg_tpu_torch" / "csrc"
F32, F64 = torch.float32, torch.float64
TOL_SKIP = 5e-3

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64, "double": ctypes.c_double}


def test_ctypes_signatures_match_the_source():
    """SIGNATURES equals csrc/rr.cu's C entry point's parameter list (a
    mismatch shows only on the card, as a crash)."""
    text = (CSRC / "rr.cu").read_text()
    protos = dict(re.findall(r"^int (lobpcg_\w+)\(([^)]*)\)", text, re.M))
    assert set(protos) == set(krr.SIGNATURES)
    for sym, params in protos.items():
        types = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                 for p in params.split(",")]
        assert types == krr.SIGNATURES[sym], sym


def test_constants_match_the_source():
    text = (CSRC / "rr.cu").read_text()
    assert f"kThreads = {krr.THREADS};" in text
    assert f"kMaxK = {krr.MAX_K};" in text
    assert f"kMaxSweeps = {krr.MAX_SWEEPS};" in text


def _smem_bytes(k):
    """csrc/rr.cu's smem_bytes: three k x (k | 1) f64 matrices, four k
    vectors, a warp's partial sum each and the scalars; k ints."""
    return 8 * (3 * k * (k | 1) + 4 * k + krr.THREADS // 32 + 8) + 4 * k


def test_max_k_is_the_widest_solver_width_that_fits():
    """MAX_K = 3 size_sub fits the block's 227 KB of shared memory; the
    next solver width does not."""
    text = (CSRC / "rr.cu").read_text()
    assert "return 8 * (3 * (int64_t)k * pitch(k) + 4 * (int64_t)k + kWarps + " \
           "kScalars) + 4 * (int64_t)k;" in text
    assert "kWarps = kThreads / 32;" in text and "kScalars = 8;" in text
    assert krr.MAX_K % 3 == 0
    assert _smem_bytes(krr.MAX_K) <= 227 * 1024 < _smem_bytes(krr.MAX_K + 3)


# --- the route -----------------------------------------------------------------


def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _case(name, k, nx, *, dtype=F32, out=F32, lead=(), counts=None,
          gb=None, sliced=False, takes):
    GA = _meta(lead + (k, k + 2), dtype)[..., :k] if sliced \
        else _meta(lead + (k, k), dtype)
    GB = _meta(lead + (k, k), dtype) if gb is None else gb
    np_act, nw_act = counts if counts is not None else (nx, nx)
    return (name, GA, GB, np_act, nw_act, nx, out, takes)


_B4 = torch.tensor([3, 4, 0, 16])
# (case, GA, GB, np_act, nw_act, nx, out dtype, the kernel takes it on the card)
ROUTE_CASES = [
    _case("lap3d_160.nd: k 48, f32", 48, 16, takes=True),
    _case("dead P and W", 48, 16, counts=(0, 3), takes=True),
    _case("f64 Grams", 48, 16, dtype=F64, out=F64, takes=True),
    _case("f64 Grams, f32 blocks", 48, 16, dtype=F64, out=F32, takes=True),
    _case("k 3", 3, 1, takes=True),
    _case("k 12", 12, 4, takes=True),
    _case("k 30", 30, 10, takes=True),
    _case("MAX_K", krr.MAX_K, krr.MAX_K // 3, takes=True),
    _case("k 2 nx (no W)", 32, 16, counts=(16, 0), takes=True),
    _case("a lockstep batch [4, 48, 48], [4] counts", 48, 16, lead=(4,),
          counts=(_B4, _B4.flip(0)), takes=True),
    _case("a batch with int counts", 48, 16, lead=(2,), takes=True),
    _case("an int32 count a problem", 48, 16, lead=(4,),
          counts=(_B4.int(), 5), takes=True),
    _case("MAX_K + 3", krr.MAX_K + 3, krr.MAX_K // 3 + 1, takes=False),
    _case("4M x 150's 492", 492, 164, takes=False),
    _case("2 nx > k", 30, 16, counts=(14, 0), takes=False),
    _case("complex64", 48, 16, dtype=torch.complex64, out=torch.complex64,
          takes=False),
    _case("complex128", 12, 4, dtype=torch.complex128, out=torch.complex128,
          takes=False),
    _case("bf16 Grams", 48, 16, dtype=torch.bfloat16, takes=False),
    _case("complex blocks", 48, 16, out=torch.complex64, takes=False),
    _case("GB of another dtype", 48, 16, gb=_meta((48, 48), F64), takes=False),
    _case("GB of another shape", 48, 16, gb=_meta((45, 45)), takes=False),
    _case("GA a column slice", 48, 16, sliced=True, takes=False),
    _case("a count in a 0-d tensor", 48, 16, counts=(torch.tensor(3), 16),
          takes=False),
    _case("counts of another batch", 48, 16, lead=(2,), counts=(_B4, 16),
          takes=False),
    _case("a float count", 48, 16, lead=(4,), counts=(_B4.double(), 16),
          takes=False),
    _case("a boolean mask for a count", 48, 16, lead=(4,),
          counts=(_B4 > 0, 16), takes=False),
]


@pytest.mark.parametrize("case,GA,GB,np_act,nw_act,nx,out,on_card", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_dispatch_predicate(monkeypatch, case, GA, GB, np_act, nw_act, nx, out,
                            on_card):
    """``takes`` is the kernel's route on the card; Grams off the card
    (meta here) take the plain version whatever their shape, uncounted."""
    assert krr.takes(GA, GB, np_act, nw_act, nx, out) is on_card, case
    routes = []
    monkeypatch.setattr(krr, "_launch", lambda *a, **k: routes.append("kernel"))
    monkeypatch.setattr(krr, "cholesky_stage_reference",
                        lambda *a, **k: routes.append("plain"))
    counts = (krr.cholesky_stage.launches, krr.cholesky_stage.fallbacks)
    krr.cholesky_stage(GA, GB, np_act, nw_act, nx=nx, tol_skip=TOL_SKIP,
                       out_dtype=out)
    assert routes == ["plain"], case
    assert (krr.cholesky_stage.launches, krr.cholesky_stage.fallbacks) == counts


def test_wrapper_refuses_other_devices_and_stages():
    """launch refuses Grams off the card; GA and GB on two devices raise."""
    G = torch.eye(12)
    with pytest.raises(ValueError):
        krr.launch(G, G, 4, 4, nx=4, tol_skip=TOL_SKIP, out_dtype=F32)
    with pytest.raises(ValueError):
        krr.cholesky_stage(G, _meta((12, 12)), 4, 4, nx=4, tol_skip=TOL_SKIP,
                           out_dtype=F32)


# --- problems --------------------------------------------------------------------


def _problem(seed, m, np_act, nw_act, wk=None, n=None, dtype=F64, lead=(),
             orthonormal=True):
    """Grams of a random SPD A over S = [X | P | W] (X orthonormal, as the
    solver holds it, or random; P and W random with their dead columns
    zero), as the solver assembles them: (blocks, A, GA, GB).  ``wk``: W's
    width (m)."""
    wk = m if wk is None else wk
    n = n or 4 * (2 * m + wk)
    g = np.random.default_rng(seed)
    M = g.standard_normal((n, n))
    A = M @ M.T / n + np.diag(np.linspace(0.5, 4.0, n))
    b = int(np.prod(lead))
    blocks = ([], [], [])
    for t in range(b):
        X = g.standard_normal((n, m))
        if orthonormal:
            X = np.linalg.qr(X)[0]
        P = g.standard_normal((n, m))
        W = g.standard_normal((n, wk))
        npt = int(np_act[t]) if isinstance(np_act, torch.Tensor) else np_act
        nwt = int(nw_act[t]) if isinstance(nw_act, torch.Tensor) else nw_act
        P[:, npt:] = 0.0
        W[:, nwt:] = 0.0
        for lst, B in zip(blocks, (X, P, W)):
            lst.append(B)
    blocks = tuple(torch.from_numpy(np.stack(lst).reshape(lead + lst[0].shape))
                   .to(dtype) for lst in blocks)
    Aop = DenseOperator(torch.from_numpy(A).to(dtype))
    GA = rayleigh._a_gram(blocks, None, Aop)
    GB = gram_blocks(blocks)
    return blocks, Aop, GA, GB


def _results_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(torch.nan_to_num(x, nan=7.0),
                               torch.nan_to_num(y, nan=7.0))
            assert torch.equal(torch.isnan(x), torch.isnan(y))
        else:
            assert x == y


STAGES = [  # (m, np_act, nw_act, W's width, lead, Grams' dtype)
    (4, 4, 4, None, (), F32),
    (4, 2, 3, None, (), F32),
    (4, 0, 0, None, (), F64),
    (5, 5, 1, None, (), F64),
    (3, 1, 2, 6, (), F32),
    (4, torch.tensor([4, 1, 0]), torch.tensor([2, 4, 0]), None, (3,), F32),
    (4, torch.tensor([3, 0]), 4, None, (2,), F64),
]


@pytest.mark.parametrize("m,np_act,nw_act,wk,lead,dtype", STAGES)
def test_plain_version_is_the_old_chain_bit_for_bit(m, np_act, nw_act, wk,
                                                     lead, dtype):
    """The plain version and ``cholesky_stage`` on the CPU are the
    Cholesky branch's chain written out in ``eager_chains``, bit for bit:
    f32 and f64 Grams, dead columns, p_count 0, a lockstep batch with [b]
    counts."""
    _, _, GA, GB = _problem(7, m, np_act, nw_act, wk, dtype=dtype, lead=lead)
    want = ec.rr_cholesky(GA, GB, np_act, nw_act, m, TOL_SKIP, F32)
    counts = (krr.cholesky_stage.launches, krr.cholesky_stage.fallbacks)
    kw = dict(nx=m, tol_skip=TOL_SKIP, out_dtype=F32)
    _results_equal(krr.cholesky_stage_reference(GA, GB, np_act, nw_act, **kw), want)
    _results_equal(krr.cholesky_stage(GA, GB, np_act, nw_act, **kw), want)
    assert (krr.cholesky_stage.launches, krr.cholesky_stage.fallbacks) == counts


@pytest.mark.parametrize("m,np_act,nw_act,wk,lead,dtype", STAGES[:3] + STAGES[5:6])
def test_cholesky_branch_is_the_old_chain_on_cpu(m, np_act, nw_act, wk, lead,
                                                  dtype):
    """``rayleigh_ritz_modified``'s Cholesky branch (use_ortho 0) on the
    CPU is the old chain on its own Grams: the flag 0 or 2 read from ok,
    p_count as the counts are."""
    blocks, Aop, GA, GB = _problem(11, m, np_act, nw_act, wk, dtype=dtype,
                                   lead=lead)
    zero = torch.zeros(lead, dtype=torch.int64) if lead else 0
    rr = rayleigh.rayleigh_ritz_modified(blocks, None, np_act, nw_act, zero,
                                         Aop, None, nx=m, tol_skip=TOL_SKIP)
    Cx, Cp, lam, ok, p_count = ec.rr_cholesky(GA, GB, np_act, nw_act, m,
                                              TOL_SKIP, dtype)
    _results_equal((rr.Cx, rr.Cp, rr.lam), (Cx, Cp, lam))
    if lead:
        assert torch.equal(rr.flag, torch.where(ok, 0, 2))
        assert torch.equal(rr.p_count, p_count)
    else:
        assert rr.flag == (0 if bool(ok) else 2) and rr.p_count == p_count


# --- an emulation of csrc/rr.cu -------------------------------------------------


def player(pos, r, N):
    return 0 if pos == 0 else 1 + (pos - 1 + r) % (N - 1)


@pytest.mark.parametrize("n", [2, 3, 4, 7, 16, 33, 96])
def test_round_robin_meets_every_pair_once_a_sweep(n):
    N = n + n % 2
    seen = []
    for r in range(N - 1):
        rnd = [(player(t, r, N), player(N - 1 - t, r, N)) for t in range(N // 2)]
        flat = [x for pair in rnd for x in pair]
        assert sorted(flat) == list(range(N))  # disjoint: one phase a round
        seen += [tuple(sorted(p)) for p in rnd if max(p) < n]
    assert sorted(seen) == [(p, q) for p in range(n) for q in range(p + 1, n)]


def jacobi(A):
    """csrc/rr.cu's jacobi: one-sided cyclic Jacobi on A + sigma I (sigma
    the least Gershgorin shift to diagonal dominance); before each sweep,
    stop when no column pair has |gamma| > 3 n eps sqrt(alpha beta);
    round-robin rounds of disjoint pairs, each rotated when |gamma| > n eps
    sqrt(alpha beta) (c and s from two reciprocal square roots), at most
    MAX_SWEEPS sweeps; returns (the Rayleigh quotients, V)."""
    n = A.shape[0]
    off = A.abs().sum(1) - torch.diagonal(A).abs()
    sigma = max(0.0, float((off - torch.diagonal(A)).max()))
    U = A + sigma * torch.eye(n, dtype=F64)
    V = torch.eye(n, dtype=F64)
    N = n + n % 2
    tol2 = (n * torch.finfo(F64).eps) ** 2
    for _ in range(krr.MAX_SWEEPS):
        G = U.T @ U
        d = torch.diagonal(G)
        if not bool(torch.triu(G * G > 9.0 * tol2 * d[:, None] * d[None, :], 1).any()):
            break
        for r in range(N - 1):
            pq = [(player(t, r, N), player(N - 1 - t, r, N)) for t in range(N // 2)]
            pq = [(min(a, b), max(a, b)) for a, b in pq if max(a, b) < n]
            p = torch.tensor([a for a, _ in pq])
            q = torch.tensor([b for _, b in pq])
            alpha = (U[:, p] ** 2).sum(0)
            beta = (U[:, q] ** 2).sum(0)
            gamma = (U[:, p] * U[:, q]).sum(0)
            rot = gamma * gamma > tol2 * alpha * beta
            if not bool(rot.any()):
                continue
            p, q, alpha, beta, gamma = p[rot], q[rot], alpha[rot], beta[rot], gamma[rot]
            dd = beta - alpha
            h = 1.0 / torch.sqrt(dd * dd + 4.0 * gamma * gamma)
            u = 0.5 + 0.5 * dd.abs() * h
            g = 1.0 / torch.sqrt(u)
            c = u * g
            s = torch.where(dd >= 0, 1.0, -1.0).to(F64) * gamma * h * g
            for M in (U, V):
                Mp, Mq = M[:, p].clone(), M[:, q].clone()
                M[:, p] = c * Mp - s * Mq
                M[:, q] = s * Mp + c * Mq
    return (V * U).sum(0) - sigma, V


def eigh_emulated(A):
    """csrc/rr.cu's eigh: NaN for a non-finite A, else symmetrize, Jacobi,
    sort ascending (ties by index)."""
    n = A.shape[0]
    if not bool(torch.isfinite(A).all()):
        return torch.full((n,), float("nan"), dtype=F64), \
            torch.full((n, n), float("nan"), dtype=F64)
    w, V = jacobi(0.5 * (A + A.T))
    order = torch.tensor(sorted(range(n), key=lambda j: (float(w[j]), j)))
    return w[order], V[:, order]


def whiten_emulated(G):
    g = torch.diagonal(G).abs()
    D = torch.where(g > 0, 1.0 / torch.sqrt(torch.where(g > 0, g, 1.0)), 1.0)
    w, U = eigh_emulated((D[:, None] * G) * D[None, :])
    ok = bool(torch.isfinite(w[0]) and w[0] > 0 and w[-1] > 0)
    s = torch.where(w > 0, w, 1.0)
    return (D[:, None] * U) * (1.0 / torch.sqrt(s))[None, :], ok, float(s[0]), float(s[-1])


def householder_q(A):
    """csrc/rr.cu's geqr2 then org2r on the m x n A (m >= n)."""
    A = A.clone()
    m, n = A.shape
    tau = torch.zeros(n, dtype=F64)
    for j in range(n):
        xnorm2 = float((A[j + 1:, j] ** 2).sum())
        alpha = float(A[j, j])
        if xnorm2 == 0.0:
            continue
        beta = -np.copysign(np.sqrt(alpha * alpha + xnorm2), alpha)
        tau[j] = (beta - alpha) / beta
        A[j + 1:, j] *= 1.0 / (alpha - beta)
        A[j, j] = beta
        v = torch.cat([torch.ones(1, dtype=F64), A[j + 1:, j]])
        w = v @ A[j:, j + 1:]
        A[j:, j + 1:] -= tau[j] * torch.outer(v, w)
    for j in range(n - 1, -1, -1):
        if j < n - 1 and tau[j] != 0.0:
            v = torch.cat([torch.ones(1, dtype=F64), A[j + 1:, j]])
            w = v @ A[j:, j + 1:]
            A[j:, j + 1:] -= tau[j] * torch.outer(v, w)
        A[j + 1:, j] *= -tau[j]
        A[:j, j] = 0.0
        A[j, j] = 1.0 - tau[j]
    return A


def stage_emulated(GA, GB, np_act, nw_act, nx, tol_skip):
    """csrc/rr.cu's kernel for one problem, step by step in float64."""
    GA, GB = GA.to(F64), GB.to(F64)
    k, nr = GA.shape[-1], GA.shape[-1] - nx
    lm = torch.tensor([j < nx or (j - nx < np_act if j < 2 * nx
                                  else j - 2 * nx < nw_act) for j in range(k)])
    keep = (lm[:, None] & lm[None, :]).to(F64)
    dead = torch.diag((~lm).to(F64))
    B = GB * keep + dead
    Fx, ok1, lo1, hi1 = whiten_emulated(B[:nx, :nx])
    E = Fx.T @ B[:nx, nx:]
    Sc = B[nx:, nx:] - E.T @ E
    Fs, ok2, lo2, hi2 = whiten_emulated(0.5 * (Sc + Sc.T))
    DiR = torch.zeros((k, k), dtype=F64)
    DiR[:nx, :nx], DiR[nx:, nx:] = Fx, Fs
    DiR[:nx, nx:] = -(Fx @ (E @ Fs))
    def_ok = ok1 and ok2
    rcond = float(np.sqrt(min(lo1, lo2) / max(hi1, hi2))) if def_ok else 0.0
    ok = def_ok and rcond >= tol_skip
    if not def_ok:
        DiR = torch.eye(k, dtype=F64)
    H = DiR.T @ ((GA * keep + 0.0 * dead) @ DiR)
    H = 0.5 * (H + H.T)
    big = 2.0 * float(H.abs().sum(dim=1).max()) + 1.0
    K = DiR[~lm]
    H = H + big * (K.T @ K)
    w, Z = eigh_emulated(H)
    Cx = DiR @ Z[:, :nx]
    above = np_act + nw_act
    zp_live, p_count = min(max(above, 0), nr), min(max(above, 0), nx)
    Zp = Z[:, nx:] * (torch.arange(nr) < zp_live).to(F64)
    Q = householder_q(Zp[:nx, :].T.contiguous())
    Cp = (DiR @ (Zp @ Q)) * (torch.arange(nx) < p_count).to(F64)
    return Cx, Cp, w[:nx], ok, p_count


def _projector(C, G):
    """The G-orthogonal projector onto span(C) (G the B-Gram)."""
    M = C.T @ G @ C
    return C @ torch.linalg.solve(M, C.T @ G)


EMULATED = [  # (name, k, nx, np_act, nw_act, how)
    ("k 12", 12, 4, 4, 4, None),
    ("k 12, X orthonormal", 12, 4, 4, 4, "orthonormal"),
    ("k 12, dead P and W", 12, 4, 1, 2, None),
    ("k 30", 30, 10, 10, 10, None),
    ("k 30, p_count 0", 30, 10, 0, 0, None),
    ("k 48, the cell's", 48, 16, 16, 16, None),
    ("k 48, X orthonormal", 48, 16, 16, 16, "orthonormal"),
    ("k 48, dead P and W", 48, 16, 5, 9, None),
    ("k 48, p_count nx with W dead", 48, 16, 16, 0, None),
    ("MAX_K", krr.MAX_K, krr.MAX_K // 3, krr.MAX_K // 3, krr.MAX_K // 3, None),
    ("MAX_K, dead P and W", krr.MAX_K, krr.MAX_K // 3, 20, 7, None),
    ("k 48, a non-finite GA", 48, 16, 16, 16, "nan_ga"),
    ("k 30, a non-definite GB", 30, 10, 10, 10, "indefinite_gb"),
    ("k 30, rcond below tol_skip", 30, 10, 10, 10, "ill_gb"),
]


@pytest.mark.parametrize("name,k,nx,np_act,nw_act,how", EMULATED,
                         ids=[c[0] for c in EMULATED])
def test_emulated_kernel_is_the_plain_stage(name, k, nx, np_act, nw_act, how):
    """The emulation of csrc/rr.cu against the plain version in float64:
    flags and p_count equal; the Ritz values to 1e-12 of the largest;
    span(Cx) and span(Cp) by their GB-orthogonal projectors, and Cp's
    columns up to sign (LAPACK's QR convention) where X's Gram has
    distinct eigenvalues.  (With X orthonormal, as in a solve, X's Gram
    is the identity, its whitening basis any orthonormal one, and only
    span(Cp) is determined.)"""
    wk = k - 2 * nx
    blocks, _, GA, GB = _problem(k + np_act + nw_act, nx, np_act, nw_act, wk,
                                 orthonormal=how == "orthonormal")
    if how == "nan_ga":
        GA = GA.clone()
        GA[1, 2] = float("nan")
    elif how == "indefinite_gb":
        GB = GB.clone()
        GB[-1, -1] = -GB[-1, -1]
    elif how == "ill_gb":
        X, P, W = blocks
        W = W.clone()
        W[:, 0] = X[:, 0] + 1e-4 * P[:, 0]
        GB = gram_blocks((X, P, W))
    Cx, Cp, lam, ok, p_count = krr.cholesky_stage_reference(
        GA, GB, np_act, nw_act, nx=nx, tol_skip=TOL_SKIP, out_dtype=F64)
    eCx, eCp, elam, eok, ep = stage_emulated(GA, GB, np_act, nw_act, nx, TOL_SKIP)
    assert bool(ok) == eok and p_count == ep
    assert eok == (how not in ("indefinite_gb", "ill_gb"))
    if how == "nan_ga":
        for a, b in ((Cx, eCx), (Cp, eCp), (lam, elam)):
            assert bool(torch.isnan(a).all()) and bool(torch.isnan(b).all())
        return
    scale = float(lam.abs().max())
    assert float((lam - elam).abs().max()) <= 1e-12 * scale, name
    lm = chains.blocks_mask((nx, nx, wk), (nx, np_act, nw_act))
    # DiR = I where GB is not definite: Cx is then orthonormal.
    G = torch.eye(k, dtype=F64) if how == "indefinite_gb" else ec._inject(GB, lm, 1.0)
    assert float((_projector(Cx, G) - _projector(eCx, G)).abs().max()) <= 1e-9
    if p_count:
        Pc, ePc = Cp[:, :p_count], eCp[:, :p_count]
        assert float((_projector(Pc, G) - _projector(ePc, G)).abs().max()) <= 1e-9
        if how != "orthonormal":
            sign = torch.sign((Pc * ePc).sum(0))
            assert float((Pc - ePc * sign).abs().max()) <= \
                1e-9 * float(Pc.abs().max())
    assert torch.equal(Cp[:, p_count:], torch.zeros_like(Cp[:, p_count:]))
    assert torch.equal(eCp[:, p_count:], torch.zeros_like(eCp[:, p_count:]))


@pytest.mark.parametrize("cell", ["lap3d_160.nd", "bdg_well_4M.nev56",
                                  "bdg_well_4M.nev150"])
def test_kernel_time_goes_to_cusolver_ms_per_iter(cell):
    """The benchmark's layers claim a kernel by a pattern in its name, the
    first metric in BENCHMARK.json's order: the stage kernel's name holds
    ``jacobi``, so its time is the k x k layer's (``cusolver_ms_per_iter``,
    where the cuSOLVER eigh it replaces went), not elementwise."""
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    from bench_port import spec, trace

    text = (CSRC / "rr.cu").read_text()
    assert "__global__ void __launch_bounds__(kThreads, 1) " \
           "lobpcg_rr_jacobi_kernel(const Args a)" in text
    # As the card's profiler names it (a trace of lap3d_160.nd, H100).
    name = "(anonymous namespace)::lobpcg_rr_jacobi_kernel((anonymous namespace)::Args)"
    spec_cell = spec.load_cell(repo, cell)
    partition = [(m["name"], spec_cell.layer(m["name"]).KERNELS)
                 for m in spec_cell.all_per_layer
                 if hasattr(spec_cell.layer(m["name"]), "KERNELS")]
    tr = trace.Trace(kernels={name: [1.0, 1]}, busy_s=1.0, window_s=1.0,
                     idle_gaps=[])
    assert trace.claim(tr, partition) == ({"cusolver_ms_per_iter": 1.0}, None)
