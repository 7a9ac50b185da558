"""K1's fused forms (lobpcg_tpu_torch/ops/cuda/stencil.py: stencil_diag,
the BdG operator Laplacian1D + DiagonalOperator in one pass, and
cheb_step, one step of ChebyshevFilter on it) on the CPU, where the
wrappers run their plain versions.

- The plain versions against the JAX package on the same numpy inputs:
  ``(Laplacian1D + DiagonalOperator).matmat`` and
  ``ChebyshevFilter(...).matmat`` under ``jax.jit``, and under
  ``jax.vmap`` for per-problem diagonals and bounds.  Tolerances: f64
  1e-12 relative to the largest output; f32 ``_f32_tol``: 8 ulp of
  ||A||_inf max|y| for an apply, and for a filter 8 ulp of the largest
  term each step adds (|c2| ||A||_inf max|y|, y growing to ~max|X| / lo):
  the JAX package rounds its coefficients to f32 arrays where the port
  keeps Python floats, and XLA fuses the chain otherwise.
- The plain versions against the port's eager chain (a tree the fused
  route does not take), bit for bit, in f32 and bf16, with per-problem
  scales, coefficients and edge rows.
- Which trees the operator layer sends to the fused kernels.

- The sharded forms on 2 and 4 gloo ranks: the filter's first step
  sends X's rows over theta as y's halos; every rank's rows equal the
  unsharded product and the sharded chain's, bit for bit.

The kernels themselves run on the card (tests/test_torch_gpu.py,
chip_smoke.py), each against the same plain versions and chains.  The
ranks of a gloo group import this module, so it imports JAX only inside
the tests that use it.
"""

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch import parallel
from lobpcg_tpu_torch.interop import operator_from_reference
from lobpcg_tpu_torch.operators import linop
from lobpcg_tpu_torch.operators.realify import RealEmbeddedDiagonalOperator
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.parallel import mesh as pmesh
from lobpcg_tpu_torch.parallel.sharding import LocalRows
from lobpcg_tpu_torch.parallel.spmd_stencil import SpmdLaplacian1D

torch.set_num_threads(2)

N, SCALE, LO, HI = 64, 3.0, 2.0, 20.0
F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16


class _ChainDiagonal(tl.DiagonalOperator):
    """A DiagonalOperator that the fused route does not take: the port's
    eager chain."""

    def row_scales(self):
        return None


def _data(seed, k, b=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    X = rng.uniform(-0.5, 0.5, lead + (N, k)).astype(dtype)
    d = rng.uniform(1.0, 3.0, lead + (N,)).astype(dtype)
    return X, d


def _f32_tol(X, d, scale=SCALE, degree=None, hi=HI):
    """8 ulp of the largest term: ||A||_inf max|y| for an apply; for a
    filter the same a step, y up to max|X| / LO and the step's c2 up to
    2 / (hi - LO), summed over the degree - 1 steps."""
    norm_a = 4 * abs(scale) + float(np.abs(d).max())
    ymax = float(np.abs(X).max())
    if degree is None:
        return 8 * np.finfo(np.float32).eps * norm_a * ymax
    step = 2 / (hi - LO) * norm_a * ymax / LO + ymax / LO
    return 8 * np.finfo(np.float32).eps * step * (degree - 1)


def _jax():
    import jax
    import jax.numpy as jnp

    import lobpcg_tpu as jl
    return jax, jnp, jl


def _port(X, d, dtype, segments=2, scale=SCALE):
    A = tl.Laplacian1D(scale, N, segments=segments) \
        + tl.DiagonalOperator(torch.from_numpy(d).to(dtype))
    return A, torch.from_numpy(X).to(dtype)


# --- the plain versions against the JAX package -------------------------------


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("k", [1, 6, 16])
def test_plain_apply_matches_jax(prec, k):
    """stencil_diag_reference and the port's operator (the fused route,
    its plain version on the CPU) against jax.jit of the JAX package's
    Laplacian1D + DiagonalOperator, carried across by
    interop.operator_from_reference."""
    jax, jnp, jl = _jax()
    npdt, tdt = (np.float64, F64) if prec == "f64" else (np.float32, F32)
    X, d = _data(k, k, dtype=npdt)
    A_jax = jl.Laplacian1D(scale=jnp.asarray(npdt(SCALE)), n=N, segments=2) \
        + jl.DiagonalOperator(jnp.asarray(d))
    want = np.asarray(jax.jit(lambda x: A_jax.matmat(x))(jnp.asarray(X)))
    A = operator_from_reference(A_jax, device="cpu")
    Xt = torch.from_numpy(X)
    got = [k1.stencil_diag_reference(Xt, SCALE, torch.from_numpy(d),
                                     num_segments=2), A.matmat(Xt)]
    for g in got:
        assert g.dtype == tdt
        if prec == "f64":
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())
        else:
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=_f32_tol(X, d))


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("degree", [2, 3, 5])
def test_plain_filter_matches_jax(prec, degree):
    """cheb_step_reference, step by step, and the port's filter (the
    fused route) against jax.jit of the JAX package's ChebyshevFilter."""
    jax, jnp, jl = _jax()
    npdt = np.float64 if prec == "f64" else np.float32
    X, d = _data(degree, 8, dtype=npdt)
    A_jax = jl.Laplacian1D(scale=jnp.asarray(npdt(SCALE)), n=N, segments=2) \
        + jl.DiagonalOperator(jnp.asarray(d))
    T_jax = jl.ChebyshevFilter(op=A_jax, lo=jnp.asarray(npdt(LO)),
                               hi=jnp.asarray(npdt(HI)), degree=degree)
    want = np.asarray(jax.jit(lambda x: T_jax.matmat(x))(jnp.asarray(X)))
    T = operator_from_reference(T_jax, device="cpu")
    T = tl.ChebyshevFilter(op=T.op, lo=LO, hi=HI, degree=degree)
    Xt, dt = torch.from_numpy(X), torch.from_numpy(d)
    theta, steps = T._coefficients(Xt)
    y = dd = None
    for i, (c1, c2) in enumerate(steps):
        y, dd = k1.cheb_step_reference(
            Xt, y, dd, SCALE, dt, c1, c2, num_segments=2,
            theta=theta if i == 0 else None, last=i == len(steps) - 1)
    for g in (y, T.matmat(Xt)):
        if prec == "f64":
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())
        else:
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=_f32_tol(X, d, degree=degree))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_batched_filter_matches_jax_vmap(prec):
    """A batch of 3 problems with per-problem diagonals [3, n] and upper
    bounds [3]: the port's A and filter (one fused apply for the batch)
    against jax.vmap of the JAX package's, per problem."""
    jax, jnp, jl = _jax()
    npdt, tdt = (np.float64, F64) if prec == "f64" else (np.float32, F32)
    X, d = _data(11, 5, b=3, dtype=npdt)
    his = np.array([12.0, 20.0, 31.0])

    def jax_apply(dv, hi, x):
        A = jl.Laplacian1D(scale=jnp.asarray(npdt(SCALE)), n=N, segments=2) \
            + jl.DiagonalOperator(dv)
        T = jl.ChebyshevFilter(op=A, lo=jnp.asarray(npdt(LO)),
                               hi=hi.astype(npdt), degree=3)
        return A.matmat(x), T.matmat(x)

    wa, wt = (np.asarray(v) for v in jax.jit(jax.vmap(jax_apply))(
        jnp.asarray(d), jnp.asarray(his), jnp.asarray(X)))
    A, Xt = _port(X, d, tdt)
    T = tl.ChebyshevFilter(op=A, lo=LO, hi=torch.from_numpy(his), degree=3)
    for got, want, deg in ((A.matmat(Xt), wa, None), (T.matmat(Xt), wt, 3)):
        assert got.shape == (3, N, 5)
        for i in range(3):
            atol = (1e-12 * np.abs(want[i]).max() if prec == "f64" else
                    _f32_tol(X[i], d[i], degree=deg, hi=his[i]))
            np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                       atol=atol)


# --- the plain versions are the port's eager chain, bit for bit ---------------


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("form", ["plain", "scaled", "per_problem",
                                  "shared_diag"])
def test_fused_route_is_the_eager_chain(dtype, form):
    """Laplacian1D (or a ScaledOperator of it, or per-problem scales) plus
    a DiagonalOperator, and a degree-4 filter on it: the fused route
    equals the eager chain bit for bit, with per-problem coefficients for
    a batch."""
    batched = form in ("per_problem", "shared_diag")
    X, d = _data(21, 7, b=3 if batched else None)
    if form == "shared_diag":
        d = d[0]
    Xt, dt = torch.from_numpy(X).to(dtype), torch.from_numpy(d).to(dtype)
    if form == "per_problem":
        lap = tl.Laplacian1D(torch.tensor([SCALE, 0.5, 7.25], dtype=F64), N,
                             segments=2)
    else:
        lap = tl.Laplacian1D(SCALE, N, segments=2)
    if form == "scaled":
        lap = tl.ScaledOperator(lap, 0.37)
    A, chain = lap + tl.DiagonalOperator(dt), lap + _ChainDiagonal(dt)
    assert linop.stencil_diagonal(A) is not None
    assert linop.stencil_diagonal(chain) is None
    hi = torch.tensor([9.0, 15.0, 22.0], dtype=F64) if batched else HI
    T = tl.ChebyshevFilter(op=A, lo=LO, hi=hi, degree=4)
    Tc = tl.ChebyshevFilter(op=chain, lo=LO, hi=hi, degree=4)
    assert torch.equal(A.matmat(Xt), chain.matmat(Xt))
    assert torch.equal(T.matmat(Xt), Tc.matmat(Xt))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_steps_with_edge_rows_are_the_chain(dtype):
    """Edge rows [3, 2, k] (a sharded lockstep batch's halos), per-problem
    scales and coefficients: stencil_diag_reference and each kind of
    cheb_step_reference (first with a number and with per-problem theta,
    middle, last) equal the chain written with K1's wrapper and PyTorch's
    operations, bit for bit."""
    rng = np.random.default_rng(3)
    b, k, segs = 3, 4, 6

    def block(shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape)).to(dtype)

    X, y, dd, E = block((b * N, k)), block((b * N, k)), block((b * N, k)), \
        block((b, 2, k))
    diag = torch.from_numpy(rng.uniform(1, 3, (b, N))).to(dtype)
    post = torch.tensor([1.5, 0.25, 3.0]).to(dtype)
    per = dict(num_segments=segs, post=post, problems=b)

    def chain_apply(Y):
        S = k1.stencil_matmat(Y, SCALE, E, num_segments=segs).view(b, N, k)
        return (S * post[:, None, None] + diag.unsqueeze(-1) * Y.view(b, N, k)
                ).view(b * N, k)

    assert torch.equal(k1.stencil_diag(X, SCALE, diag, E, **per), chain_apply(X))
    c1, c2 = (torch.tensor(v).to(dtype).view(b, 1, 1)
              for v in ([0.3, 0.6, 0.9], [0.11, 0.05, 0.2]))
    X3 = X.view(b, N, k)
    for theta in (4.05, torch.tensor([3.5, 4.0, 4.75]).to(dtype).view(b, 1, 1)):
        # The first step's edge rows are y's: X's halo rows over theta.
        y0 = (X3 / theta).view(b * N, k)
        d1 = c1 * y0.view(b, N, k) + c2 * (X3 - chain_apply(y0).view(b, N, k))
        got = k1.cheb_step(X, None, None, SCALE, diag, c1, c2, E, theta=theta,
                           **per)
        assert torch.equal(got[1], d1.view(b * N, k))
        assert torch.equal(got[0], (y0.view(b, N, k) + d1).view(b * N, k))
    for last in (False, True):
        d2 = c1 * dd.view(b, N, k) + c2 * (X3 - chain_apply(y).view(b, N, k))
        got = k1.cheb_step(X, y, dd, SCALE, diag, c1, c2, E, last=last, **per)
        assert torch.equal(got[0], (y.view(b, N, k) + d2).view(b * N, k))
        assert got[1] is None if last else torch.equal(got[1], d2.view(b * N, k))


def test_host_scalars_are_the_card_rules():
    """The f32 values the kernels take for Python numbers: the number's
    own f32 value (not rounded to bf16), and for X / theta the f32 value
    of theta's float64 reciprocal (PyTorch's CUDA rules, measured on the
    H100: tests/test_torch_gpu.py holds the kernels to the chain)."""
    assert k1.host_scalar(4.05) == float(np.float32(4.05))
    assert k1.host_scalar(0.37) != float(torch.tensor(0.37).to(BF16).float())
    assert k1.host_reciprocal(4.05) == float(np.float32(1.0 / 4.05))
    assert k1.host_reciprocal(4.05) != float(np.float32(1.0) / np.float32(4.05))
    assert k1.host_reciprocal(-0.0) == -np.inf


def test_fused_wrappers_check_their_arguments():
    X = torch.zeros((64, 4))
    d = torch.ones(64)
    with pytest.raises(ValueError):
        k1.stencil_diag(X, 1.0, torch.ones(32))  # diag of another length
    with pytest.raises(ValueError):
        k1.stencil_diag(X, 1.0, torch.ones((2, 32)), problems=3)
    with pytest.raises(ValueError):
        k1.stencil_diag(X, 1.0, d, torch.zeros((2, 2, 4)), num_segments=2)
    with pytest.raises(ValueError):
        k1.cheb_step(X, None, None, 1.0, d, 0.5, 0.5)  # first without theta
    with pytest.raises(ValueError):
        k1.cheb_step(X, X, X, 1.0, d, 0.5, 0.5, theta=4.0)
    before = (k1.stencil_diag.launches, k1.cheb_step.launches)
    k1.stencil_diag(X, 1.0, d)
    k1.cheb_step(X, None, None, 1.0, d, 0.5, 0.5, theta=4.0)
    assert (k1.stencil_diag.launches, k1.cheb_step.launches) == before


# --- which trees take the fused route ---------------------------------------


def _lap(**kw):
    return tl.Laplacian1D(SCALE, N, segments=2, **kw)


def _diag(dtype=F32, shape=(N,)):
    return tl.DiagonalOperator(torch.ones(shape, dtype=dtype))


TREES = {
    "lap+diag": (lambda: _lap() + _diag(), True),
    "diag+lap": (lambda: _diag() + _lap(), True),
    "scaled+diag": (lambda: tl.ScaledOperator(_lap(), 2.0) + _diag(), True),
    "per_problem_scale": (lambda: tl.Laplacian1D(
        torch.tensor([1.0, 2.0]), N) + _diag(shape=(2, N)), True),
    "sharded": (lambda: tl.SumOperator(
        SpmdLaplacian1D(SCALE, N, segments=2),
        LocalRows(_diag(), n=N)), True),
    "two_diagonals": (lambda: _lap() + _diag() + _diag(), False),
    "jacobi": (lambda: _lap() + tl.JacobiPreconditioner(torch.ones(N)), False),
    "scaled_per_problem": (lambda: tl.ScaledOperator(tl.Laplacian1D(
        torch.tensor([1.0, 2.0]), N), 2.0) + _diag(shape=(2, N)), False),
    "tensor_alpha": (lambda: tl.ScaledOperator(_lap(), torch.tensor(2.0))
                     + _diag(), False),
    "sharded_plain_formula": (lambda: tl.SumOperator(
        SpmdLaplacian1D(SCALE, N, segments=2, pallas="off"),
        LocalRows(_diag(), n=N)), False),
    "realified": (lambda: _lap() + RealEmbeddedDiagonalOperator(
        torch.ones(N // 2), torch.zeros(N // 2)), False),
    "local_jacobi": (lambda: tl.SumOperator(
        SpmdLaplacian1D(SCALE, N, segments=2),
        LocalRows(tl.JacobiPreconditioner(torch.ones(N)), n=N)), False),
}


@pytest.mark.parametrize("name", list(TREES))
def test_which_trees_decompose(name):
    make, fused = TREES[name]
    assert (linop.stencil_diagonal(make()) is not None) == fused


def _counted(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapper(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapper

    for name in ("stencil_matmat", "stencil_diag", "cheb_step"):
        monkeypatch.setattr(linop, name, spy(name, getattr(linop, name)))
    return calls


@pytest.mark.parametrize("case,want", [
    ("f32", ["stencil_diag"]),
    ("bf16", ["stencil_diag"]),
    ("f64", []),  # the kernels take f32 and bf16: the chain's plain formula
    ("complex", []),
    ("diag_of_other_dtype", ["stencil_matmat"]),
    ("per_problem_data_unbatched", None),
    ("two_diagonals", ["stencil_diag"]),  # the inner sum fuses, the outer adds
])
def test_operator_dispatch(monkeypatch, case, want):
    """What A.matmat launches (spied on the CPU, where the wrappers run
    their plain versions): the fused apply for f32/bf16 with a matching
    diagonal, the chain otherwise."""
    calls = _counted(monkeypatch)
    dt = {"bf16": BF16, "f64": F64, "complex": torch.complex128}.get(case, F32)
    X = torch.ones((N, 3), dtype=dt)
    A = _lap() + _diag(dtype=F64 if case == "diag_of_other_dtype" else dt)
    if case == "two_diagonals":
        A = A + _diag()
    if case == "per_problem_data_unbatched":
        A = _lap() + _diag(shape=(2, N))
        # [2, n] data on an unbatched X: the chain, which broadcasts.
        assert A.matmat(X).shape == (2, N, 3)
        assert calls == ["stencil_matmat"]
        return
    A.matmat(X)
    assert calls == want


@pytest.mark.parametrize("degree,want", [(1, []), (2, ["cheb_step"]),
                                         (4, ["cheb_step"] * 3)])
def test_filter_dispatch(monkeypatch, degree, want):
    """A filter of degree d on Laplacian1D + DiagonalOperator: d - 1
    cheb_step launches and no other stencil launch (degree 1 is X / theta
    alone)."""
    calls = _counted(monkeypatch)
    T = tl.ChebyshevFilter(op=_lap() + _diag(), lo=LO, hi=HI, degree=degree)
    T.matmat(torch.ones((N, 3)))
    assert calls == want


# --- the sharded forms on gloo ranks -----------------------------------------


def _sharded_rank(mesh):
    """On each rank: the sharded A and filter (unbatched, and a batch of 3
    with per-problem diagonals and bounds) against the unsharded ones and
    against the sharded chain, this rank's rows; halo exchanges of each."""
    rng = np.random.default_rng(17)
    n_loc = N // mesh.size
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    out = {}
    for batch in (None, 3):
        X, d = _data(5, 5, b=batch, dtype=np.float32)
        Xt, dt = torch.from_numpy(X), torch.from_numpy(d)
        hi = HI if batch is None else torch.from_numpy(
            rng.uniform(10.0, 30.0, batch))
        lap = tl.Laplacian1D(SCALE, N, segments=2)
        res = {}
        for label, diag in (("fused", tl.DiagonalOperator(dt)),
                            ("chain", _ChainDiagonal(dt))):
            A = lap + diag
            T = tl.ChebyshevFilter(op=A, lo=LO, hi=hi, degree=3)
            As, Ts = parallel.shard_operator(A, mesh), parallel.shard_operator(T, mesh)
            Xl = Xt[..., rows, :].contiguous()
            e0 = pmesh.halo_exchange.launches
            res[label] = (As.matmat(Xl), Ts.matmat(Xl),
                          pmesh.halo_exchange.launches - e0,
                          linop.stencil_diagonal(As) is not None)
            res["whole"] = (A.matmat(Xt)[..., rows, :],
                            T.matmat(Xt)[..., rows, :])
        fused, chain, whole = res["fused"], res["chain"], res["whole"]
        out[batch] = {
            "routes": [fused[3], chain[3]],
            "equal_whole": [bool(torch.equal(fused[i], whole[i])) for i in (0, 1)],
            "equal_chain": [bool(torch.equal(fused[i], chain[i])) for i in (0, 1)],
            "exchanges": [fused[2], chain[2]]}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fused_route_is_the_chain(world):
    """SpmdLaplacian1D + LocalRows(DiagonalOperator) over 2 and 4 gloo
    ranks (segment boundaries at a shard edge and inside the chain): the
    fused route is taken, each rank's A and filter rows equal the
    unsharded product and the sharded chain's bit for bit, with as many
    halo exchanges as the chain (one an apply, the first filter step's
    carrying X's rows over theta)."""
    for rec in parallel.spawn(_sharded_rank, world, device="cpu"):
        for batch in (None, 3):
            r = rec[batch]
            assert r["routes"] == [True, False]
            assert r["equal_whole"] == [True, True]
            assert r["equal_chain"] == [True, True]
            assert r["exchanges"][0] == r["exchanges"][1] == 3
