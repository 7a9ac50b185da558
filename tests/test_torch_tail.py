"""The solver's tall elementwise tail (lobpcg_tpu_torch/ops/cuda/tail.py:
antidiag, residual, combine, compact) on the CPU, where the wrappers run
their plain versions.

- The plain versions and the port's call sites against the JAX package
  on the same numpy inputs, under ``jax.jit`` (``jax.vmap`` for
  per-problem data): ``BlockAntiDiagOperator.matmat`` and its realified
  form, ``get_residual`` with B anti-diagonal and with B None,
  ``mask_cols`` and ``shift_cols``, ``ortho.py``'s projection update and
  ``b_mm``.  f64, 1e-12 relative to the largest output (XLA may contract
  a multiply and a subtraction into one FMA), or exactly where the chain
  only moves and masks.
- The plain versions against the port's eager chain (the call sites
  inside ``chains.eager_chain()``), bit for bit in f32 and f64 on inputs
  holding NaN, +-Inf and -0 (NaN where NaN, every other bit equal).
- Which call sites take the kernels' route: a plain B, B with copies 2,
  B None, per-problem d and lam, [b] shifts and counts, and the sharded
  forms on 2 and 4 gloo ranks (the local plan through antidiag, an
  exchange through the chain).
- A ``lobpcg`` and an ``ilobpcg`` solve (and a lockstep batch) keep the
  bits of the eager chain.
- The dropped ``abs`` before ``** 2`` on real blocks is bit-equal.

The kernels themselves run on the card (tests/test_torch_gpu.py,
chip_smoke.py), each against the same plain versions.  The ranks of a
gloo group import this module, so it imports JAX only inside the tests
that use it.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch import parallel
from lobpcg_tpu_torch.benchmarks.solve_bdg import well_problem
from lobpcg_tpu_torch.operators import linop
from lobpcg_tpu_torch.ops import gram, masking, ortho, residual
from lobpcg_tpu_torch.ops.cuda import chains, tail
from lobpcg_tpu_torch.parallel import mesh as pmesh

import eager_chains as ec

torch.set_num_threads(2)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "lobpcg_tpu_torch" / "csrc"
M, K = 24, 7  # rows of a half, columns
F32, F64 = torch.float32, torch.float64


def _jax():
    import jax
    import jax.numpy as jnp

    import lobpcg_tpu as jl
    from lobpcg_tpu.ops import gram as jgram
    from lobpcg_tpu.ops import masking as jmasking
    from lobpcg_tpu.ops import residual as jresidual
    return jax, jnp, jl, jgram, jmasking, jresidual


def _rand(seed, shape, dtype=np.float64, special=False):
    """Uniform(-1, 1) values; ``special``: NaN, +-Inf, -0 and +0 at random
    places (a tenth of the entries)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    if special:
        where = rng.random(shape) < 0.1
        x[where] = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0],
                              size=int(where.sum()))
    return x.astype(dtype)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def same_bits(a, b) -> bool:
    """Equal shape and dtype, NaN where NaN, every other bit equal (-0 is
    not +0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a.contiguous().view(ints)[~nan],
                       b.contiguous().view(ints)[~nan])


def _close(got, want, exact=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


# --- the plain versions against the JAX package -------------------------------


@pytest.mark.parametrize("batch", [None, 3])
def test_antidiag_matches_jax(batch):
    """BlockAntiDiagOperator.matmat (through tail.antidiag) and
    antidiag_reference against jax.jit of the JAX package's operator,
    jax.vmap of it over per-problem d; exact (a swap and one multiply)."""
    jax, jnp, jl, *_ = _jax()
    lead = () if batch is None else (batch,)
    X, d = _rand(1, lead + (2 * M, K)), _rand(2, lead + (M,))
    f = lambda d, x: jl.BlockAntiDiagOperator(d=d).matmat(x)  # noqa: E731
    f = jax.jit(f if batch is None else jax.vmap(f))
    want = np.asarray(f(jnp.asarray(d), jnp.asarray(X)))
    B = tl.BlockAntiDiagOperator(d=_t(d))
    _close(B.matmat(_t(X)), want, exact=True)
    _close(tail.antidiag_reference(_t(X), _t(d)), want, exact=True)


def test_realified_antidiag_matches_jax():
    """The split-real B (realify_operator of a complex anti-diagonal B:
    two copies of the half swap) against the JAX package's realified
    operator under jax.jit; exact."""
    jax, jnp, jl, *_ = _jax()
    from lobpcg_tpu.operators.realify import realify_operator as jrealify

    from lobpcg_tpu_torch.operators.realify import realify_operator
    d = _rand(3, (M,))
    X = _rand(4, (4 * M, K))
    Bj = jrealify(jl.BlockAntiDiagOperator(d=jnp.asarray(d, jnp.complex128)),
                  jnp.float64)
    want = np.asarray(jax.jit(lambda x: Bj.matmat(x))(jnp.asarray(X)))
    B = realify_operator(tl.BlockAntiDiagOperator(d=_t(d).to(torch.complex128)),
                         F64)
    assert isinstance(B, tl.BlockDiagOperator) and B.half_swap()[1] == 2
    _close(B.matmat(_t(X)), want, exact=True)
    _close(tail.antidiag_reference(_t(X), _t(d), 2), want, exact=True)


@pytest.mark.parametrize("b_kind", ["antidiag", "none"])
@pytest.mark.parametrize("batch", [None, 3])
def test_residual_matches_jax(b_kind, batch):
    """get_residual (through tail.residual) and residual_reference against
    jax.jit of the JAX package's get_residual, jax.vmap of it over
    per-problem lam and d; f64 to 1e-12 relative."""
    jax, jnp, jl, _, _, jres = _jax()
    lead = () if batch is None else (batch,)
    X, AX = _rand(5, lead + (2 * M, K)), _rand(6, lead + (2 * M, K))
    lam, d = _rand(7, lead + (K,)) * 30, _rand(8, lead + (M,))
    A = jl.DiagonalOperator(d=jnp.ones(2 * M))

    def f(x, ax, lam, d):
        B = jl.BlockAntiDiagOperator(d=d) if b_kind == "antidiag" else None
        return jres.get_residual(x, ax, lam, A, B)

    f = jax.jit(f if batch is None else jax.vmap(f))
    want = np.asarray(f(*map(jnp.asarray, (X, AX, lam, d))))
    B = tl.BlockAntiDiagOperator(d=_t(d)) if b_kind == "antidiag" else None
    got = residual.get_residual(_t(X), _t(AX), _t(lam), None, B)
    _close(got, want)
    _close(tail.residual_reference(_t(AX), _t(X), _t(lam),
                                   _t(d) if B is not None else None), want)


@pytest.mark.parametrize("live", ["count", "mask"])
@pytest.mark.parametrize("batch", [None, 3])
def test_mask_cols_matches_jax(live, batch):
    """mask_cols (through tail.compact) against the JAX package's, under
    jax.jit / jax.vmap over per-problem counts or masks; exact."""
    jax, jnp, _, _, jm, _ = _jax()
    lead = () if batch is None else (batch,)
    U = _rand(9, lead + (2 * M, K))
    rng = np.random.default_rng(10)
    if live == "count":
        lv = rng.integers(0, K + 1, lead) if batch else 4
    else:
        lv = rng.random(lead + (K,)) < 0.5
    f = jm.mask_cols if batch is None else jax.vmap(jm.mask_cols)
    want = np.asarray(jax.jit(f)(jnp.asarray(U), jnp.asarray(lv)))
    lv_t = torch.as_tensor(lv) if batch or live == "mask" else lv
    _close(masking.mask_cols(_t(U), lv_t), want, exact=True)
    _close(tail.compact_reference(_t(U), 0, lv_t), want, exact=True)


@pytest.mark.parametrize("shift", [0, 3, K + 2])
@pytest.mark.parametrize("batch", [None, 3])
def test_shift_cols_matches_jax(shift, batch):
    """shift_cols (through tail.compact) against the JAX package's (the
    clamp, the gather, the mask), under jax.jit / jax.vmap over
    per-problem shifts and counts; exact."""
    jax, jnp, _, _, jm, _ = _jax()
    lead = () if batch is None else (batch,)
    U = _rand(11, lead + (2 * M, K))
    if batch is None:
        sh, cnt = shift, K - 2
        want = jax.jit(jm.shift_cols, static_argnums=(1, 2))(
            jnp.asarray(U), sh, cnt)
        args = (sh, cnt)
    else:
        sh = np.array([shift, 1, 0])
        cnt = np.array([K - 3, K, 0])
        want = jax.jit(jax.vmap(jm.shift_cols))(*map(jnp.asarray, (U, sh, cnt)))
        args = (torch.as_tensor(sh), torch.as_tensor(cnt))
    _close(masking.shift_cols(_t(U), *args), want, exact=True)
    _close(tail.compact_reference(_t(U), *args), want, exact=True)


@pytest.mark.parametrize("nblocks", [1, 2, 3, 5])
@pytest.mark.parametrize("batch", [None, 2])
def test_b_mm_matches_jax(nblocks, batch):
    """b_mm (GEMMs, then tail.combine passes of up to three terms) and
    combine_reference against jax.jit of the JAX package's b_mm (jax.vmap
    for a batch); f64 to 1e-12 relative."""
    jax, jnp, _, jgram, _, _ = _jax()
    lead = () if batch is None else (batch,)
    widths = [4, 6, 3, 5, 2][:nblocks]
    blocks = [_rand(20 + i, lead + (2 * M, w)) for i, w in enumerate(widths)]
    C = _rand(30, lead + (sum(widths), K))
    f = jgram.b_mm if batch is None else jax.vmap(jgram.b_mm, in_axes=(0, 0))
    want = np.asarray(jax.jit(f)(tuple(map(jnp.asarray, blocks)),
                                 jnp.asarray(C)))
    tb = [_t(b) for b in blocks]
    _close(gram.b_mm(tb, _t(C)), want)
    terms, j = [], 0
    for b in tb:
        terms.append(gram.mm(b, _t(C)[..., j:j + b.shape[-1], :]))
        j += b.shape[-1]
    _close(tail.combine_reference(terms), want)


@pytest.mark.parametrize("batch", [None, 2])
def test_projection_update_matches_jax(batch):
    """The ortho projection update, mask_cols(U - b_mm(V, coef), nu)
    (gram.b_mm_update: one combine pass after the GEMMs), against the JAX
    package's functions under jax.jit / jax.vmap; f64 to 1e-12
    relative."""
    jax, jnp, _, jgram, jm, _ = _jax()
    lead = () if batch is None else (batch,)
    U = _rand(40, lead + (2 * M, K))
    vb = [_rand(41, lead + (2 * M, 5)), _rand(42, lead + (2 * M, 5))]
    coef = _rand(43, lead + (10, K))
    nu = np.array([5, K]) if batch else 5

    def f(U, v0, v1, coef, nu):
        return jm.mask_cols(U - jgram.b_mm((v0, v1), coef), nu)

    f = jax.jit(f if batch is None else jax.vmap(f))
    want = np.asarray(f(*map(jnp.asarray, (U, *vb, coef, nu))))
    nu_t = torch.as_tensor(nu) if batch else nu
    _close(gram.b_mm_update(_t(U), [_t(v) for v in vb], _t(coef), nu_t), want)
    terms = [gram.mm(_t(vb[0]), _t(coef)[..., :5, :]),
             gram.mm(_t(vb[1]), _t(coef)[..., 5:, :])]
    _close(tail.combine_reference(terms, _t(U), nu_t), want)


# --- the plain versions against the port's eager chain, bit for bit ------------


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("form", ["plain", "copies2", "batched", "per_row"])
def test_antidiag_plain_is_the_chain(dtype, form):
    """antidiag_reference (a flip of each copy's half axis, times d) is
    the eager chain (two multiplies and a cat, each copy apart, written
    out in ``eager_chains``) bit for bit, on inputs with NaN, +-Inf and
    -0; so are the operators' routes, and the operators inside
    ``chains.eager_chain()``."""
    lead = (3,) if form == "batched" else ()
    copies = 2 if form == "copies2" else 1
    X = _t(_rand(50, lead + (2 * copies * M, K), special=True), dtype)
    d = _t(_rand(51, lead + (M,), special=True), dtype)
    if form == "per_row":
        s = _t(_rand(52, (2 * M,), special=True), dtype)
        chain = ec.scaled_swap(X, s)
        assert same_bits(chain, s[..., None] * torch.cat([X[M:], X[:M]]))
        assert same_bits(tail.antidiag_reference(X, s), chain)
        assert same_bits(tail.antidiag(X, s), chain)
        with chains.eager_chain():
            assert same_bits(tail.antidiag(X, s), chain)
        return
    B = tl.BlockAntiDiagOperator(d=d)
    if copies == 2:
        B = tl.BlockDiagOperator(inner=B, copies=2)
    chain = ec.antidiag(X, d, copies)
    with chains.eager_chain():
        eager = B.matmat(X)
    for got in (tail.antidiag_reference(X, d, copies), B.matmat(X), eager):
        assert same_bits(got, chain)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("b_kind", ["antidiag", "copies2", "none", "dense",
                                    "batched"])
def test_residual_plain_is_the_chain(dtype, b_kind):
    """residual_reference and get_residual, routed and inside
    ``chains.eager_chain()``, are the eager chain (B X, times lam cast to
    the block's dtype, subtracted; written out in ``eager_chains``) bit
    for bit, with NaN, +-Inf and -0 in AX, X, lam and d; a B that is not
    anti-diagonal is applied first and enters as BX."""
    lead = (3,) if b_kind == "batched" else ()
    copies = 2 if b_kind == "copies2" else 1
    n = 2 * copies * M
    X = _t(_rand(60, lead + (n, K), special=True), dtype)
    AX = _t(_rand(61, lead + (n, K), special=True), dtype)
    lam = _t(_rand(62, lead + (K,), special=True))  # f64, cast by the chain
    d = _t(_rand(63, lead + (M,), special=True), dtype)
    B = {"antidiag": tl.BlockAntiDiagOperator(d=d),
         "batched": tl.BlockAntiDiagOperator(d=d),
         "copies2": tl.BlockDiagOperator(tl.BlockAntiDiagOperator(d=d), 2),
         "dense": tl.DenseOperator(_t(_rand(64, (n, n)), dtype)),
         "none": None}[b_kind]
    BX = {"antidiag": lambda: ec.antidiag(X, d), "batched": lambda: ec.antidiag(X, d),
          "copies2": lambda: ec.antidiag(X, d, 2),
          "dense": lambda: torch.matmul(B.A, X), "none": lambda: X}[b_kind]()
    chain = ec.residual(AX, BX, lam)
    with chains.eager_chain():
        eager = residual.get_residual(X, AX, lam, None, B)
    assert same_bits(eager, chain)
    assert same_bits(residual.get_residual(X, AX, lam, None, B), chain)
    if b_kind in ("antidiag", "batched", "copies2"):
        plain = tail.residual_reference(AX, X, lam, d, None, copies)
    elif b_kind == "dense":
        plain = tail.residual_reference(AX, X, lam, BX=B.matmat(X))
    else:
        plain = tail.residual_reference(AX, X, lam)
    assert same_bits(plain, chain)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("case", ["int", "int_big", "negative", "lanes",
                                  "mask", "mask_lanes", "zero_dim"])
def test_compact_plain_is_the_chain(dtype, case):
    """compact_reference and masking's calls, routed and inside
    ``chains.eager_chain()``, are the eager chain (the clamp-index gather,
    then the multiply by the live mask; written out in ``eager_chains``)
    bit for bit: a dead column of NaN/Inf gives NaN, of a negative value
    -0; Python and [b] shifts and counts, boolean masks."""
    lanes = case in ("lanes", "mask_lanes")
    lead = (3,) if lanes else ()
    U = _t(_rand(70, lead + (2 * M, K), special=True), dtype)
    shift, live = {
        "int": (2, K - 3), "int_big": (K + 5, 1), "negative": (-2, K),
        "lanes": (torch.tensor([0, 3, K + 1]), torch.tensor([K, 2, 0])),
        "mask": (0, torch.tensor([True, False] * 3 + [False])),
        "mask_lanes": (torch.tensor([1, 0, 2]),
                       torch.from_numpy(np.random.default_rng(71).random(
                           (3, K)) < 0.5)),
        "zero_dim": (torch.tensor(2), torch.tensor(K - 1)),
    }[case]
    chain_shift, chain_mask = ec.shift(U, shift, live), ec.mask(U, live)
    with chains.eager_chain():
        assert same_bits(masking.shift_cols(U, shift, live), chain_shift)
        assert same_bits(masking.mask_cols(U, live), chain_mask)
    assert same_bits(masking.shift_cols(U, shift, live), chain_shift)
    assert same_bits(tail.compact_reference(U, shift, live), chain_shift)
    assert same_bits(masking.mask_cols(U, live), chain_mask)
    assert same_bits(tail.compact_reference(U, 0, live), chain_mask)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("nblocks", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("lanes", [False, True])
def test_combine_plain_is_the_chain(dtype, nblocks, lanes):
    """b_mm and b_mm_update (the GEMMs, then combine passes of up to three
    terms, the last with U and the mask), routed and inside
    ``chains.eager_chain()``, are the eager chain (the GEMMs and adds one
    at a time, the subtraction, the mask; written out in
    ``eager_chains``) bit for bit, with NaN, +-Inf and -0 in the blocks;
    so is combine_reference."""
    lead = (2,) if lanes else ()
    blocks = [_t(_rand(80 + i, lead + (2 * M, 3), special=True), dtype)
              for i in range(nblocks)]
    C = _t(_rand(90, lead + (3 * nblocks, K)), dtype)
    U = _t(_rand(91, lead + (2 * M, K), special=True), dtype)
    nu = torch.tensor([K - 2, 3]) if lanes else K - 2
    chain_sum, chain_update = ec.b_mm(blocks, C), ec.b_mm_update(U, blocks, C, nu)
    with chains.eager_chain():
        assert same_bits(gram.b_mm(blocks, C), chain_sum)
        assert same_bits(gram.b_mm_update(U, blocks, C, nu), chain_update)
    assert same_bits(gram.b_mm(blocks, C), chain_sum)
    assert same_bits(gram.b_mm_update(U, blocks, C, nu), chain_update)
    terms = [gram.mm(b, C[..., 3 * i:3 * i + 3, :]) for i, b in enumerate(blocks)]
    assert same_bits(tail.combine_reference(terms), chain_sum)
    assert same_bits(tail.combine_reference(terms, U, nu), chain_update)


# --- the dispatch --------------------------------------------------------------


def _spy(monkeypatch):
    """Record the tail wrappers the call sites reach (name, and the
    anti-diagonal's copies or the residual's B form)."""
    calls = []

    def spy(name, fn):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    for name in ("antidiag", "residual", "combine", "compact"):
        monkeypatch.setattr(tail, name, spy(name, getattr(tail, name)))
    return calls


@pytest.mark.parametrize("case,want", [
    ("plain", ["antidiag"]),
    ("copies2", ["antidiag"]),
    ("batched", ["antidiag"]),
    ("complex", ["antidiag"]),  # the wrapper's dtype route: the plain version
    ("per_problem_d_unbatched", []),  # the chain's broadcast
    ("eager", ["antidiag"]),  # the wrapper runs its plain version
])
def test_antidiag_dispatch(monkeypatch, case, want):
    calls = _spy(monkeypatch)
    lead = (2,) if case == "batched" else ()
    dt = torch.complex128 if case == "complex" else F32
    d = torch.ones(lead + (M,), dtype=dt)
    X = torch.ones(lead + (2 * M, K), dtype=dt)
    B = tl.BlockAntiDiagOperator(d=d)
    if case == "copies2":
        B, X = tl.BlockDiagOperator(B, 2), torch.ones((4 * M, K))
    if case == "per_problem_d_unbatched":
        B = tl.BlockAntiDiagOperator(d=torch.ones((2, M)))
        assert B.matmat(X).shape == (2, 2 * M, K)
    elif case == "eager":
        with chains.eager_chain():
            B.matmat(X)
    else:
        B.matmat(X)
    assert calls == want


@pytest.mark.parametrize("case", ["antidiag", "copies2", "none", "dense",
                                  "batched", "bx_given", "eager"])
def test_residual_dispatch(monkeypatch, case):
    """get_residual: one tail.residual call whatever B is (an
    anti-diagonal B as its d, any other B applied first as BX), with no
    antidiag launch of its own, inside eager_chain() too (where the
    wrapper runs its plain version)."""
    seen = []
    real = tail.residual

    def spy(AX, X, lam, d=None, BX=None, copies=1):
        seen.append((d is not None, BX is not None, copies))
        return real(AX, X, lam, d, BX, copies)

    monkeypatch.setattr(tail, "residual", spy)
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tail, "residual", spy)
    lead = (3,) if case == "batched" else ()
    n = 4 * M if case == "copies2" else 2 * M
    X, AX = torch.ones(lead + (n, K)), torch.ones(lead + (n, K))
    lam = torch.ones(lead + (K,))
    B = {"antidiag": tl.BlockAntiDiagOperator(d=torch.ones(M)),
         "batched": tl.BlockAntiDiagOperator(d=torch.ones((3, M))),
         "copies2": tl.BlockDiagOperator(tl.BlockAntiDiagOperator(d=torch.ones(M)), 2),
         "dense": tl.DenseOperator(torch.eye(n)),
         "none": None, "bx_given": None, "eager": tl.BlockAntiDiagOperator(
             d=torch.ones(M))}[case]
    BX = torch.ones(lead + (n, K)) if case == "bx_given" else None
    if case == "eager":
        with chains.eager_chain():
            residual.get_residual(X, AX, lam, None, B, BX)
        assert seen == [(True, False, 1)] and "antidiag" not in calls
        return
    residual.get_residual(X, AX, lam, None, B, BX)
    want = {"antidiag": (True, False, 1), "batched": (True, False, 1),
            "copies2": (True, False, 2), "dense": (False, True, 1),
            "none": (False, False, 1), "bx_given": (False, True, 1)}[case]
    assert seen == [want]
    assert "antidiag" not in calls


def test_masking_and_projection_dispatch(monkeypatch):
    """mask_cols and shift_cols are one compact call each (int or [b]
    shifts and counts), b_mm of three blocks and the projection update of
    two one combine call each; inside eager_chain() mask_cols is still
    compact's (which runs its plain version) and b_mm calls no combine
    (the projection's eager chain adds)."""
    calls = _spy(monkeypatch)
    U = torch.ones((2, 2 * M, K))
    masking.mask_cols(U, torch.tensor([1, 2]))
    masking.shift_cols(U, torch.tensor([1, 0]), torch.tensor([3, 4]))
    masking.shift_cols(U[0], 2, 3)
    blocks = [torch.ones((2 * M, 3))] * 3
    gram.b_mm(blocks, torch.ones((9, K)))
    gram.b_mm_update(U[0], blocks[:2], torch.ones((6, K)), 4)
    gram.b_mm(blocks[:1], torch.ones((3, K)))  # one term: no pass
    assert calls == ["compact"] * 3 + ["combine"] * 2
    with chains.eager_chain():
        masking.mask_cols(U, 3)
        gram.b_mm(blocks, torch.ones((9, K)))
    assert calls == ["compact"] * 3 + ["combine"] * 2 + ["compact"]


def test_ortho_update_goes_through_combine(monkeypatch):
    """ortho_indefinite's projection update (ops/ortho.py) is a combine
    call with U and the live count."""
    seen = []
    real = tail.combine

    def spy(terms, U=None, live=None, out=None):
        seen.append((len(terms), U is not None, live))
        return real(terms, U, live, out)

    monkeypatch.setattr(tail, "combine", spy)
    rng = np.random.default_rng(3)
    n = 2 * M
    B = tl.BlockAntiDiagOperator(d=torch.ones(M, dtype=F64))
    V = torch.linalg.qr(_t(rng.standard_normal((n, 4))))[0]
    U = _t(rng.standard_normal((n, 3)))
    ortho.ortho_indefinite(U, 3, (V[:, :2], V[:, 2:]), 4, B, eps_ortho=1e-12,
                           eps_drop=1e-12, max_outer=1, max_inner=1)
    assert (2, True, 3) in seen


# --- solves keep their bits ----------------------------------------------------


def _solve_pair(solve):
    """The solve through the tail's route and inside eager_chain()."""
    got = solve()
    with chains.eager_chain():
        chain = solve()
    return got, chain


@pytest.mark.parametrize("dtype", [F32, F64])
def test_ilobpcg_solve_keeps_its_bits(dtype):
    """The BdG well pencil (A = Laplacian1D + diagonal, B anti-diagonal,
    Chebyshev T) at n 4096: the tail's route gives the eager chain's
    eigenvalues, eigenvectors, residual norms and iterations exactly."""
    A, B, T, X0, _, _ = well_problem(4096, 6, 10, dtype=dtype, cheb=3,
                                     precond=True, device="cpu")
    cfg = tl.SolverConfig(nev=6, size_sub=10, tol=1e-5, max_iter=40)
    got, chain = _solve_pair(lambda: tl.ilobpcg(
        A, X0, B, T, config=cfg, generator=torch.Generator().manual_seed(0)))
    assert got.iterations == chain.iterations and got.converged == chain.converged
    for f in ("eigenvalues", "eigenvectors", "residual_norms"):
        assert torch.equal(getattr(got, f), getattr(chain, f)), f


@pytest.mark.parametrize("B_kind", [None, "diagonal"])
def test_lobpcg_solve_keeps_its_bits(B_kind):
    """lobpcg on a 1-D Laplacian (B None: the residual reads X itself; a
    diagonal B: applied first, entering the residual as BX), f32: the
    tail's route gives the eager chain's results exactly."""
    n = 512
    A = tl.Laplacian1D(scale=float((n + 1) ** 2), n=n, dtype=F32)
    B = None if B_kind is None else tl.DiagonalOperator(
        _t(np.linspace(1.0, 2.0, n), F32))
    X0 = _t(_rand(5, (n, 8)), F32)
    cfg = tl.SolverConfig(nev=4, size_sub=8, tol=1e-4, max_iter=60)
    got, chain = _solve_pair(lambda: tl.lobpcg(
        A, X0, B, config=cfg, generator=torch.Generator().manual_seed(0)))
    assert got.iterations == chain.iterations
    assert torch.equal(got.eigenvalues, chain.eigenvalues)
    assert torch.equal(got.eigenvectors, chain.eigenvectors)


def test_lockstep_solve_keeps_its_bits():
    """A lockstep ilobpcg of 3 barriers (X0 [3, n, k], [3, n] diagonals,
    per-problem Chebyshev bounds): [b] shifts, counts and lam through the
    tail, the eager chain's results exactly."""
    diags, his = [], []
    for barrier in (1.0, 2.0, 4.0):
        A, B, T, X0, _, _ = well_problem(2048, 4, 8, dtype=F32, cheb=3,
                                         precond=True, device="cpu",
                                         barrier=barrier)
        diags.append(A.right.d)
        his.append(T.hi)
    A = A.left + tl.DiagonalOperator(torch.stack(diags))
    T = tl.ChebyshevFilter(op=A, lo=T.lo, hi=torch.tensor(his, dtype=F64),
                           degree=3)
    X0 = X0.expand(3, *X0.shape).contiguous()
    cfg = tl.SolverConfig(nev=4, size_sub=8, tol=1e-5, max_iter=40)
    got, chain = _solve_pair(lambda: tl.ilobpcg(
        A, X0, B, T, config=cfg, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(got.iterations, chain.iterations)
    assert torch.equal(got.eigenvalues, chain.eigenvalues)
    assert torch.equal(got.eigenvectors, chain.eigenvectors)


# --- the sharded forms on gloo ranks ------------------------------------------


def _sharded_rank(mesh):
    """On each rank: the sharded anti-diagonal B (one copy, and the
    split-real two copies) applied to this rank's rows, unbatched and a
    batch of 3 with per-problem d, against the unsharded product's rows
    and the sharded chain (the exchange, then the scale), routed and
    inside ``chains.eager_chain()``; the route it took, its exchanges; and
    the residual through it against the chain's."""
    n_loc = 4 * M // mesh.size
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    out = {}
    for copies in (1, 2):
        for batch in (None, 3):
            lead = () if batch is None else (batch,)
            h = 2 * M // copies
            X = _t(_rand(100, lead + (4 * M, K), special=True), F32)
            d = _t(_rand(101, lead + (h,), special=True), F32)
            lam = _t(_rand(102, lead + (K,)), F32)
            B = tl.BlockAntiDiagOperator(d=d)
            if copies == 2:
                B = tl.BlockDiagOperator(B, 2)
            Bs = parallel.shard_operator(B, mesh)
            Xl = X[..., rows, :].contiguous()
            e0, a0 = pmesh.permute_rows.launches, []
            got = Bs.matmat(Xl)
            exchanges = pmesh.permute_rows.launches - e0
            chain = Bs.d[..., None] * pmesh.permute_rows(mesh, Xl, Bs.plan)
            res_chain = ec.residual(Xl, chain, lam)
            with chains.eager_chain():
                eager = Bs.matmat(Xl)
                res_eager = residual.get_residual(Xl, Xl, lam, None, Bs)
            res = residual.get_residual(Xl, Xl, lam, None, Bs)
            del a0
            out[(copies, batch)] = {
                "local": Bs.half_swap() is not None,
                "equal_whole": same_bits(got, B.matmat(X)[..., rows, :]),
                "equal_chain": same_bits(got, chain) and same_bits(eager, chain),
                "residual_equal_chain": (same_bits(res, res_chain)
                                         and same_bits(res_eager, res_chain)),
                "exchanges": exchanges}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_antidiag_routes(world):
    """ShardedBlockAntiDiagOperator over 2 and 4 gloo ranks: where a rank
    holds whole copies (two copies on two ranks) the plan is local and
    the swap and scale run as one antidiag pass with no exchange; where a
    copy spans ranks the chain's exchange runs.  Every rank's rows equal
    the unsharded product and the sharded chain bit for bit (NaN, +-Inf,
    -0 included), and so does the residual through it."""
    for rec in parallel.spawn(_sharded_rank, world, device="cpu"):
        for (copies, batch), r in rec.items():
            local = copies == 2 and world == 2
            assert r["local"] == local, (copies, batch)
            assert r["exchanges"] == (0 if local else 1), (copies, batch)
            assert r["equal_whole"] and r["equal_chain"], (copies, batch)
            assert r["residual_equal_chain"], (copies, batch)


# --- the real blocks' |x|^2 -----------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, F64])
def test_abs2_of_a_real_block_is_abs_squared(dtype):
    """x ** 2 is abs(x) ** 2 for real blocks, elementwise and summed over
    rows and over the whole block (col_norms, tall_frob_norm, _bnorm,
    _bv_norm), on blocks holding NaN, +-Inf and -0; complex blocks keep
    abs."""
    X = _t(_rand(110, (4096, 9), special=True), dtype)
    X[:50] = _t(_rand(111, (50, 9)), dtype)  # finite columns too
    old = torch.abs(X) ** 2
    assert same_bits(gram.abs2(X), old)
    assert same_bits(torch.sum(gram.abs2(X), dim=-2), torch.sum(old, dim=-2))
    assert same_bits(residual.col_norms(X), torch.sqrt(torch.sum(old, dim=-2)))
    assert same_bits(gram.tall_frob_norm(X),
                     torch.sqrt(torch.sum(old, dim=(-2, -1))))
    assert same_bits(ortho._bv_norm((X, X[:, :4]), 0.0), torch.sqrt(
        torch.sum(old, dim=(-2, -1)) + torch.sum(old[:, :4], dim=(-2, -1))))
    B = tl.BlockAntiDiagOperator(d=torch.ones(2048, dtype=dtype))
    BX = B.matmat(X)
    assert same_bits(ortho._bnorm(B, (X,)),
                     torch.sqrt(torch.sum(torch.abs(BX) ** 2, dim=(-2, -1))))
    Z = torch.complex(X, X.flip(0))
    assert torch.equal(torch.isnan(gram.abs2(Z)), torch.isnan(torch.abs(Z) ** 2))
    fin = ~torch.isnan(gram.abs2(Z))
    assert torch.equal(gram.abs2(Z)[fin], (torch.abs(Z) ** 2)[fin])


# --- the wrappers' own contract -------------------------------------------------


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64}


def test_ctypes_signatures_match_the_source():
    """SIGNATURES equals csrc/tail.cu's C entry points' parameter lists (a
    mismatch shows only on the card, as a crash)."""
    text = (CSRC / "tail.cu").read_text()
    protos = dict(re.findall(r"^int (lobpcg_\w+)\(([^)]*)\)", text, re.M))
    assert set(protos) == set(tail.SIGNATURES)
    for sym, params in protos.items():
        types = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                 for p in params.split(",")]
        assert types == tail.SIGNATURES[sym], sym


@pytest.mark.parametrize("k,ops,want", [
    (64, [(4096, 0, 64, 1)], 4),
    (30, [(4096, 0, 30, 1)], 2),
    (7, [(4096, 0, 7, 1)], 1),
    (64, [(4096, 0, 64, 1), (4096 + 8, 0, 64, 1)], 2),  # a base 8 bytes on
    (16, [(4096, 0, 64, 1)], 4),  # a column slice of a [n, 64] block
    (16, [(4096, 0, 66, 1)], 2),  # a row stride of 66
    (16, [(4096, 0, 1, 64)], 1),  # a transposed view
    (16, [(4096, 48, 16, 1)], 4),
    (16, [(4096, 50, 16, 1)], 2),  # a batch stride of 50
])
def test_item_width(k, ops, want):
    assert tail.item_width(k, 4, ops) == want


def test_f64_items_are_at_most_two():
    assert tail.item_width(64, 8, [(4096, 0, 64, 1)]) == 2


def test_wrappers_check_their_arguments():
    X = torch.ones((2 * M, K))
    with pytest.raises(ValueError):
        tail.antidiag(X, torch.ones(M + 1))
    with pytest.raises(ValueError):
        tail.antidiag(torch.ones((2 * M + 2, K)), torch.ones(M), copies=2)
    with pytest.raises(ValueError):
        tail.combine([X] * 5)
    with pytest.raises(ValueError):
        tail.combine([X, torch.ones((2 * M, K + 1))])
    with pytest.raises(ValueError):
        tail.compact(X, 1)
    with pytest.raises(ValueError):
        tail.residual(X, X, torch.ones(K), d=torch.ones(M), BX=X)
    with pytest.raises(ValueError):
        tail.residual(X, torch.ones((2 * M, K + 1)), torch.ones(K))


def test_cpu_tensors_never_move_launch_counters():
    before = [getattr(tail, f).launches
              for f in ("antidiag", "residual", "combine", "compact")]
    X = torch.ones((2 * M, K))
    tail.antidiag(X, torch.ones(M))
    tail.residual(X, X, torch.ones(K), d=torch.ones(M))
    tail.combine([X, X], X, 3)
    tail.compact(X, 1, 3)
    assert [getattr(tail, f).launches
            for f in ("antidiag", "residual", "combine", "compact")] == before


def test_out_is_left_alone_by_the_plain_versions():
    """On the CPU, combine's and compact's ``out`` (where the kernel may
    write) is not written: the plain version returns a new block."""
    X = _t(_rand(120, (2 * M, K)), F32)
    before = X.clone()
    got = tail.compact(X, 0, 3, out=X)
    assert torch.equal(X, before) and same_bits(got, tail.compact_reference(X, 0, 3))
    got = tail.combine([X, X], None, 2, out=X)
    assert torch.equal(X, before) and same_bits(got, tail.combine_reference([X, X],
                                                                          None, 2))


def test_eager_chain_restores_on_exit():
    assert not chains.eager()
    with chains.eager_chain():
        assert chains.eager()
        with chains.eager_chain():
            assert chains.eager()
        assert chains.eager()
    assert not chains.eager()
