"""The port's segmented 1-D stencil (lobpcg_tpu_torch/ops/cuda/stencil.py)
against the JAX package's Pallas kernel (interpret mode) and its
Laplacian1D, on the same numpy inputs; plus the wrapper's contract.

Tolerance against the Pallas kernel: 2 ulp of the largest possible
output, 2 * eps_f32 * 4 * |scale| * max|X|.  The Pallas kernel subtracts
the row above first and the plain formula the row below first; the two
f32 orders differ by up to that much.  Against the JAX Laplacian1D
fallback (the same pad/slice formula, same order) the match is exact.

The CUDA kernel runs only on the card; here its item width
(``k1.items_per_load``) is checked over widths, dtypes and base offsets,
and its blocks are run on the host, thread lanes as numpy vectors,
against the plain version bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as lt
import lobpcg_tpu_torch as tl
from lobpcg_tpu.ops.pallas.stencil import stencil_matmat_pallas
from lobpcg_tpu_torch.benchmarks import solve_bdg
from lobpcg_tpu_torch.operators import linop
from lobpcg_tpu_torch.operators.linop import Laplacian1D
from lobpcg_tpu_torch.ops.cuda import stencil as k1
from lobpcg_tpu_torch.tools import stencil_widths

torch.set_num_threads(2)

N = 256
SCALE = 3.7
# Widths: the solver's and the gates' (8, 64, 128), the README's size_sub
# 6, the sweeps' size_sub 30, and widths that are not whole 16-byte
# vectors (1, 3, 78).  Segments: up to the lockstep fold's b * 2 = 16.
WIDTHS = [1, 3, 6, 8, 30, 64, 78, 128]
SEGMENTS = [1, 2, 4, 16]


def _inputs(seed, k, edges, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.5, 0.5, (N, k)).astype(dtype)
    E = rng.uniform(-0.5, 0.5, (2, k)).astype(dtype) if edges else None
    return X, E


def _tol(X, scale=SCALE):
    return 2 * np.finfo(np.float32).eps * 4 * abs(scale) * np.abs(X).max()


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("segments", SEGMENTS)
@pytest.mark.parametrize("edges", [False, True])
def test_plain_stencil_matches_pallas_interpret(k, segments, edges):
    X, E = _inputs(100 * segments + k, k, edges)
    y_jax = np.asarray(stencil_matmat_pallas(
        jnp.asarray(X), jnp.asarray(np.float32(SCALE)),
        None if E is None else jnp.asarray(E),
        num_segments=segments, interpret=True,
    ))
    y = k1.stencil_matmat(
        torch.from_numpy(X), SCALE,
        None if E is None else torch.from_numpy(E), num_segments=segments,
    )
    assert y.dtype == torch.float32 and tuple(y.shape) == (N, k)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=0, atol=_tol(X))


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("segments", SEGMENTS)
def test_laplacian1d_matches_jax_laplacian1d(k, segments):
    X, _ = _inputs(7 * segments + k, k, False)
    A_jax = lt.Laplacian1D(scale=jnp.asarray(np.float32(SCALE)), n=N,
                           segments=segments)
    A = Laplacian1D(scale=SCALE, n=N, segments=segments, dtype=torch.float32)
    y_jax = np.asarray(A_jax.matmat(jnp.asarray(X)))
    np.testing.assert_array_equal(A.matmat(torch.from_numpy(X)).numpy(), y_jax)


@pytest.mark.parametrize("segments", [1, 2])
def test_laplacian1d_f64_plain_formula(segments):
    """f64 takes the plain formula (the kernel has no f64), exactly as
    the JAX package's fallback computes it."""
    X, _ = _inputs(3, 16, False, np.float64)
    A_jax = lt.Laplacian1D(scale=jnp.asarray(SCALE), n=N, segments=segments)
    A = Laplacian1D(scale=SCALE, n=N, segments=segments, dtype=torch.float64)
    np.testing.assert_array_equal(
        A.matmat(torch.from_numpy(X)).numpy(),
        np.asarray(A_jax.matmat(jnp.asarray(X))),
    )


def test_bf16_plain_version_rounds_once_from_f32():
    X, E = _inputs(11, 64, True)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    Eb = torch.from_numpy(E).to(torch.bfloat16)
    y = k1.stencil_matmat(Xb, SCALE, Eb, num_segments=2)
    want = k1.stencil_matmat(Xb.float(), SCALE, Eb.float(), num_segments=2)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want.to(torch.bfloat16))


def test_cpu_tensor_never_moves_launch_counter():
    X, E = _inputs(5, 64, True)
    before = k1.stencil_matmat.launches
    k1.stencil_matmat(torch.from_numpy(X), SCALE, torch.from_numpy(E),
                      num_segments=2)
    Laplacian1D(scale=SCALE, n=N, segments=2).matmat(torch.from_numpy(X))
    assert k1.stencil_matmat.launches == before


@pytest.mark.parametrize("bad", ["segments", "edge_shape", "rank"])
def test_wrapper_rejects_bad_arguments(bad):
    X = torch.zeros((N, 8))
    with pytest.raises(ValueError):
        if bad == "segments":
            k1.stencil_matmat(X, 1.0, num_segments=3)
        elif bad == "edge_shape":
            k1.stencil_matmat(X, 1.0, torch.zeros((2, 7)))
        else:
            k1.stencil_matmat(X[:, 0], 1.0)


# --- the CUDA kernel's items and its blocks, on the host ---------------------


@pytest.mark.parametrize("itemsize,offset", [(4, b) for b in range(0, 16, 4)]
                         + [(2, b) for b in range(0, 16, 2)])
def test_items_tile_every_row_once_on_their_boundaries(itemsize, offset):
    """For k 1-257 and X ``offset`` bytes past a 16-byte boundary (Y and
    the edge rows on one): the item is the widest power of two up to 16
    bytes that divides k and puts every base on an item boundary, so no
    item straddles two rows; the blocks' chunks cover every item, and so
    every row, exactly once."""
    for k in range(1, 258):
        w = k1.items_per_load(k, itemsize, 4096 + offset, 8192, 512)
        assert w & (w - 1) == 0 and w * itemsize <= 16
        assert k % w == 0 and offset % (w * itemsize) == 0
        if w * itemsize < 16:  # the next width up breaks a condition
            assert k % (2 * w) or offset % (2 * w * itemsize)
        n = 3 * k1.THREADS // k + 5
        chunk = k1.THREADS * k1.items_per_thread(w, itemsize)
        nitems = n * k // w
        blocks = -(-nitems // chunk)
        items = (np.arange(blocks)[:, None, None] * chunk
                 + np.arange(k1.items_per_thread(w, itemsize))[None, :, None]
                 * k1.THREADS + np.arange(k1.THREADS)[None, None, :]).ravel()
        items = items[items < nitems]
        assert np.array_equal(np.sort(items), np.arange(nitems))
        rows = np.repeat(np.arange(n), k // w)
        assert np.array_equal(np.bincount(rows[items], minlength=n),
                              np.full(n, k // w))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_offsets_inside_a_chunk_fit_32_bits_at_the_widest_gate(itemsize):
    """At n * k = 2.56e9 (the complex gate's [8M, 320] at the JAX size)
    and at n * k > 2^32 with k 1, item indices need 64 bits but what the
    kernel keeps in 32 (items a row, the column of a chunk's first item
    plus the thread, rows and columns stepped inside a chunk, edge
    offsets) and the block count fit."""
    for n, k in ((8_000_000, 320), (5_000_000_000, 1), (1 << 20, 50_000)):
        w = k1.items_per_load(k, itemsize, 0)
        kw, chunk = k // w, k1.THREADS * k1.items_per_thread(w, itemsize)
        blocks = -(-n * kw // chunk)
        inside = [kw + k1.THREADS, (kw + k1.THREADS) * w + k,
                  chunk // kw + 2, blocks]
        assert max(inside) < 2**31
        assert n * k > 2**31 or k > 2**15


def _wrap(sp, seg):
    """csrc/stencil1d.cu's wrap of a segment counter."""
    sp = np.where(sp >= seg, sp - seg, sp)
    return np.where(sp >= seg, sp % seg, sp)


def _emulate_kernel(X, scale, E, seg, w, itemsize):
    """csrc/stencil1d.cu run on the host: each block in turn, its threads
    as numpy lanes, items of ``w`` elements (J = items_per_thread a
    lane), with its running row, column and segment counters, its zeros
    and edge items and its f32 operation order.  Each output element
    must be written once."""
    n, k = X.shape
    x = X.reshape(-1)
    kw, NT = k // w, k1.THREADS
    J = k1.items_per_thread(w, itemsize)
    nitems, chunk = n * kw, NT * J
    Y = np.full(n * k, np.nan, np.float32)
    written = np.zeros(n * k, np.int64)
    lane = np.arange(NT)
    dr, dc = divmod(NT, kw)
    two, sc = np.float32(2.0), np.float32(scale)
    for b in range(-(-nitems // chunk)):
        base = b * chunk
        r0 = base // kw
        q = base - r0 * kw + lane
        r, c = q // kw, q % kw
        sp = _wrap(r0 % seg + r, seg)
        loads = []
        for j in range(J):
            idx = base + lane + j * NT
            live = idx < nitems
            elems = idx[:, None] * w + np.arange(w)  # the item's elements
            xv = x[np.where(live[:, None], elems, 0)]
            up = np.zeros_like(xv)
            dn = np.zeros_like(xv)
            has_up, has_dn = (sp != 0) & live, (sp != seg - 1) & live
            up[has_up] = x[elems[has_up] - k]
            dn[has_dn] = x[elems[has_dn] + k]
            if E is not None:
                top = ~has_up & live & (r0 + r == 0)
                bot = ~has_dn & live & (r0 + r == n - 1)
                cols = c[:, None] * w + np.arange(w)
                up[top] = E[0][cols[top]]
                dn[bot] = E[1][cols[bot]]
            loads.append((live, elems, xv, up, dn))
            c = c + dc
            inc = np.full(NT, dr)
            inc[c >= kw] += 1
            c[c >= kw] -= kw
            r = r + inc
            sp = _wrap(sp + inc, seg)
        for live, elems, xv, up, dn in loads:
            out = sc * ((two * xv - dn) - up)
            Y[elems[live]] = out[live]
            np.add.at(written, elems[live].ravel(), 1)
    assert (written == 1).all()
    return Y.reshape(n, k)


@pytest.mark.parametrize("n,k,segments,edges,itemsize,offset", [
    (4096, 1, 1, True, 4, 0),
    (2048, 3, 16, True, 4, 4),
    (512, 6, 512, False, 4, 8),      # one-row segments
    (1024, 30, 16, True, 4, 0),      # the lockstep fold at k 30: pairs
    (600, 78, 2, True, 4, 12),
    (300, 64, 4, True, 4, 0),        # 16-byte vectors
    (4096, 4, 1024, True, 4, 0),     # four-row segments
    (200, 129, 8, True, 2, 2),       # bf16
    (1200, 8, 16, True, 2, 0),       # bf16 vectors
    (900, 30, 6, True, 2, 6),
    (40, 1500, 4, True, 4, 4),       # wide rows
])
def test_kernel_emulated_on_host_matches_plain(n, k, segments, edges, itemsize,
                                                offset):
    rng = np.random.default_rng(n + k)
    X = rng.uniform(-0.5, 0.5, (n, k)).astype(np.float32)
    E = rng.uniform(-0.5, 0.5, (2, k)).astype(np.float32) if edges else None
    w = k1.items_per_load(k, itemsize, 4096 + offset, 8192, 512)
    y = _emulate_kernel(X, SCALE, E, n // segments, w, itemsize)
    want = k1.stencil_matmat_reference(
        torch.from_numpy(X), SCALE, None if E is None else torch.from_numpy(E),
        num_segments=segments)
    np.testing.assert_array_equal(y, want.numpy())


def test_width_sweep_points():
    """The card's width sweep (tools/stencil_widths.py, chip_smoke.py's K1
    phase): every width that is not a whole 16-byte vector among them, at
    ~256 MiB of X over whole segments, and a row-sliced X with edges."""
    cases = stencil_widths.sweep_cases()
    def nbytes(c):
        return c["n"] * c["k"] * torch.finfo(c["dtype"]).bits // 8

    sized = [c for c in cases if (255 << 20) <= nbytes(c) <= (256 << 20)]
    assert {c["k"] for c in sized if c["dtype"] == torch.float32} \
        == set(stencil_widths.F32_WIDTHS)
    assert {c["k"] for c in sized if c["dtype"] == torch.bfloat16} \
        == set(stencil_widths.BF16_WIDTHS)
    assert all(c["n"] % c["segments"] == 0 for c in cases)
    sliced = [c for c in cases if c["sliced"]]
    assert sliced and all(c["edges"] and c["k"] * 4 % 16 for c in sliced)
    assert (8_000_000, 30, 16) in {(c["n"], c["k"], c["segments"]) for c in cases}


def test_lockstep_solve_applies_k1_by_width(monkeypatch):
    """What the launches of K1 and its fused forms (stencil_diag for A,
    cheb_step for each Chebyshev step: one where K1 alone was launched)
    on a lockstep sweep are made of (the sweeps of chip_smoke.py, here at
    n 8,192 on 2 barriers): the norm estimates' norm_iters applies at
    norm_block columns, and at the block's 30 columns 2 before the loop
    and 5 an iteration of the longest problem (PERF.md counts the
    kernels' time on the sweeps from this)."""
    widths = []

    def counted(fn):
        def launch(X, *args, **kwargs):
            widths.append(X.shape[1])
            return fn(X, *args, **kwargs)
        return launch

    for name in ("stencil_matmat", "stencil_diag", "cheb_step"):
        monkeypatch.setattr(linop, name, counted(getattr(k1, name)))
    diags, his = [], []
    for barrier in (1.0, 4.0):
        A, B, T, X0, _, _ = solve_bdg.well_problem(
            8192, 16, 30, dtype=torch.float32, cheb=3, precond=True,
            device="cpu", barrier=barrier)
        diags.append(A.right.d)
        his.append(T.hi)
    A = A.left + tl.DiagonalOperator(torch.stack(diags))
    T = dataclasses.replace(T, op=A, hi=torch.tensor(his, dtype=torch.float64))
    cfg = tl.SolverConfig(nev=16, size_sub=30, tol=1e-5, max_iter=300)
    r = tl.ilobpcg(A, X0.expand(2, *X0.shape).contiguous(), B, T, config=cfg,
                   generator=torch.Generator().manual_seed(0))
    assert (r.converged == 16).all()
    iters = int(r.iterations.max())
    assert widths.count(cfg.norm_block) == cfg.norm_iters
    assert widths.count(30) == 2 + 5 * iters
    assert len(widths) == cfg.norm_iters + 2 + 5 * iters
