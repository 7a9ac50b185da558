"""The tall projection kernel (lobpcg_tpu_torch/ops/cuda/proj.py,
csrc/proj.cu) on the CPU, where the wrapper runs its plain version.

- The C entry point against ``SIGNATURES`` and the constants against
  the source.
- Which product ``project`` runs: its predicate ``takes`` over shape,
  dtype, layout, terms and the live mask, each case with its route; off
  the card every route is the library chain (the GEMMs and the tail's
  wrappers), on CPU tensors with the bits it had.
- The plain version is the eager chain (``torch.matmul`` a term added
  left to right, U - sum, the mask; written out in ``eager_chains``),
  bit for bit, and so are ``project``, ``library``, ``b_mm``,
  ``b_mm_update`` and ``mm_masked`` on the CPU, routed and inside
  ``chains.eager_chain()``.
- The launch plan over every m the kernel takes.
- A host emulation of csrc/proj.cu (its stage copies, the threads' 8 x 8
  register tiles read at the kernel's shared-memory offsets, each term's
  sum and the epilogue), on integer entries where every sum is exact: it
  must give live * (U - sum) exactly, write every output once and read
  every term element once, so an offset, a mask or a bound the kernel
  gets wrong shows here.

The kernel itself runs on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from lobpcg_tpu_torch.ops import gram, masking
from lobpcg_tpu_torch.ops.cuda import chains
from lobpcg_tpu_torch.ops.cuda import proj as kp
from lobpcg_tpu_torch.ops.cuda import tail

import eager_chains as ec

torch.set_num_threads(2)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "lobpcg_tpu_torch" / "csrc"
TALL = kp.MIN_ROWS
F32 = torch.float32

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64}


def test_ctypes_signatures_match_the_source():
    """SIGNATURES equals csrc/proj.cu's C entry point's parameter list (a
    mismatch shows only on the card, as a crash)."""
    text = (CSRC / "proj.cu").read_text()
    protos = dict(re.findall(r"^int (lobpcg_\w+)\(([^)]*)\)", text, re.M))
    assert set(protos) == set(kp.SIGNATURES)
    for sym, params in protos.items():
        types = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                 for p in params.split(",")]
        assert types == kp.SIGNATURES[sym], sym


def test_constants_match_the_source():
    text = (CSRC / "proj.cu").read_text()
    assert f"kMaxThreads = {kp.MAX_THREADS};" in text
    assert f"kStages = {kp.STAGES};" in text
    assert f"kMaxTerms = {kp.MAX_TERMS};" in text
    assert f"kPad = {kp.PAD};" in text
    assert kp.MAX_TERMS == tail.MAX_TERMS


# --- the route -----------------------------------------------------------------


def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _blocks(n, widths, dtype=F32, lead=(), sliced=False):
    if sliced:  # column slices of one wider block, row stride sum + 8
        S = _meta(lead + (n, sum(widths) + 8), dtype)
        out, j = [], 4
        for w in widths:
            out.append(S[..., j:j + w])
            j += w
        return out
    return [_meta(lead + (n, w), dtype) for w in widths]


def _case(name, widths, m, n=TALL, *, dtype=F32, c_dtype=None, u=False,
          live=None, lead=(), sliced=False, c_rows=None, c_sliced=False,
          transposed=False, takes):
    blocks = _blocks(n, widths, dtype, lead, sliced)
    if transposed:
        blocks[0] = _meta(lead + (widths[0], n), dtype).mT
    rows = sum(widths) if c_rows is None else c_rows
    c_dt = c_dtype or dtype
    C = _meta(lead + (rows, m + 4), c_dt)[..., 2:2 + m] if c_sliced \
        else _meta(lead + (rows, m), c_dt)
    U = _meta(lead + (n, m), dtype) if u else None
    return (name, blocks, C, U, live, takes)


# (case, blocks, C, U, live, the kernel takes it on the card)
ROUTE_CASES = [
    _case("4M x 150 Xn: 3 x [n, 164]", [164] * 3, 164, takes=True),
    _case("4M x 56 Xn: 3 x [n, 64]", [64] * 3, 64, takes=True),
    _case("160^3: 3 x [n, 16]", [16] * 3, 16, takes=True),
    _case("ortho update: U, 2 terms, count", [164, 164], 164, u=True, live=150,
          takes=True),
    _case("ortho update, count on the device", [64, 64], 64, u=True,
          live=torch.tensor(40), takes=True),
    _case("SVQB: 1 term, boolean mask", [16], 16,
          live=torch.ones(16, dtype=torch.bool), takes=True),
    _case("X Cx0: 1 term", [164], 164, takes=True),
    _case("4 terms", [16, 16, 16, 16], 16, takes=True),
    _case("width 4", [4] * 3, 4, takes=True),
    _case("width 96", [96] * 2, 96, takes=True),
    _case("width 128", [128] * 3, 128, takes=True),
    _case("width 129 (cuBLAS's: the generic tile)", [129] * 3, 129, takes=False),
    _case("width 160 (cuBLAS's)", [160], 160, takes=False),
    _case("width 161", [161] * 2, 161, takes=True),
    _case("width 168", [168], 168, takes=True),
    _case("odd widths 7 and 13", [7, 13], 13, takes=True),
    _case("column slices of one block", [64, 64, 64], 64, sliced=True, takes=True),
    _case("C a column slice", [30, 30], 30, c_sliced=True, takes=True),
    _case("width 3 (cuBLAS's)", [3] * 3, 3, takes=False),
    _case("width 169", [169], 169, takes=False),
    _case("5 terms", [16] * 5, 16, takes=False),
    _case("n one short of tall", [64] * 3, 64, n=TALL - 1, takes=False),
    _case("k x k coefficients", [164] * 3, 164, n=492, takes=False),
    _case("batched [2, n, 30]", [30] * 3, 30, lead=(2,), takes=False),
    _case("f64", [64] * 3, 64, dtype=torch.float64, takes=False),
    _case("complex64", [16] * 3, 16, dtype=torch.complex64, takes=False),
    _case("f64 coefficients", [16] * 3, 16, c_dtype=torch.float64, takes=False),
    _case("C rows differ from the widths", [16] * 3, 16, c_rows=40, takes=False),
    _case("column stride n (a transpose)", [16], 16, transposed=True, takes=False),
    _case("per-problem mask [1, m]", [16], 16,
          live=torch.ones((1, 16), dtype=torch.bool), takes=False),
    _case("two counts", [16], 16, live=torch.tensor([3, 4]), takes=False),
    _case("one count a problem, [1]", [16], 16, live=torch.tensor([3]), takes=False),
]


@pytest.mark.parametrize("case,blocks,C,U,live,on_card", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_dispatch_predicate(monkeypatch, case, blocks, C, U, live, on_card):
    """``takes`` is the kernel's route on the card; tensors off the card
    (meta here) take the library chain whatever their shape, uncounted."""
    assert kp.takes(blocks, C, U, live) is on_card, case
    routes = []
    monkeypatch.setattr(kp, "_launch", lambda *a, **k: routes.append("kernel"))
    monkeypatch.setattr(kp, "library", lambda *a, **k: routes.append("library"))
    fallbacks = kp.project.fallbacks
    kp.project(blocks, C, U, live)
    assert routes == ["library"] and kp.project.fallbacks == fallbacks, case


def test_u_of_another_shape_or_dtype_is_not_taken():
    blocks = _blocks(TALL, [64, 64])
    C = _meta((128, 64))
    assert not kp.takes(blocks, C, _meta((TALL, 60)), 10)
    assert not kp.takes(blocks, C, _meta((TALL, 64), torch.float64), 10)
    assert not kp.takes(blocks, C, None, torch.ones(60, dtype=torch.bool))
    assert not kp.takes(blocks, C, None, torch.tensor(1.5))


# --- the plain version and the CPU routes --------------------------------------


def _cpu_operands(n, widths, m, seed, sliced=False):
    g = torch.Generator().manual_seed(seed)
    if sliced:
        S = torch.randn((n, sum(widths) + 5), generator=g)
        blocks, j = [], 3
        for w in widths:
            blocks.append(S[:, j:j + w])
            j += w
    else:
        blocks = [torch.randn((n, w), generator=g) for w in widths]
    C = torch.randn((sum(widths), m + 3), generator=g)[:, 1:1 + m]
    U = torch.randn((n, m), generator=g)
    return blocks, C, U


def _old_chain(blocks, C, U=None, live=None):
    """The projection as the port computed it before the kernel, written
    out in ``eager_chains``: a torch.matmul a term added left to right,
    U - sum, the mask."""
    S = ec.b_mm(blocks, C)
    if U is not None:
        S = U - S
    return S if live is None else ec.mask(S, live)


LIVES = [None, 7, torch.tensor(5), torch.tensor([9]),
         torch.tensor([True, False] * 8)]


@pytest.mark.parametrize("live", LIVES, ids=["none", "int", "0-d", "[1]", "bool"])
@pytest.mark.parametrize("with_u", [False, True])
@pytest.mark.parametrize("widths", [(16,), (16, 8), (16, 16, 16), (4, 8, 12, 16)])
def test_plain_version_is_the_old_chain_bit_for_bit(live, with_u, widths):
    blocks, C, U = _cpu_operands(300, widths, 16, seed=len(widths), sliced=True)
    U = U if with_u else None
    want = _old_chain(blocks, C, U, live)
    before = kp.project.launches
    assert torch.equal(kp.project_reference(blocks, C, U, live), want)
    assert torch.equal(kp.project(blocks, C, U, live), want)
    assert kp.project.launches == before
    counts = (kp.project.launches, kp.project.fallbacks)
    assert torch.equal(kp.library(blocks, C, U, live), want)
    assert torch.equal(kp.library(blocks, C, U, live, in_place=False), want)
    assert (kp.project.launches, kp.project.fallbacks) == counts


def test_cpu_call_sites_keep_their_bits():
    """On the CPU, b_mm, b_mm_update and mm_masked, routed and inside
    chains.eager_chain(), are the eager chains they replace (written out
    in ``eager_chains``), at a tall n and at a small one."""
    for n in (TALL + 3, 257):
        blocks, C, U = _cpu_operands(n, (24, 24, 24), 24, seed=n)
        chain = (ec.b_mm(blocks, C), ec.b_mm_update(U, blocks[:2], C[:48], 20),
                 ec.mm_masked(U, C[:24], 11), ec.mm_masked(U, C[:24], 11))

        def sites():
            return (gram.b_mm(blocks, C), gram.b_mm_update(U, blocks[:2], C[:48], 20),
                    gram.mm_masked(U, C[:24], 11),
                    gram.mm_masked(U, C[:24], 11, in_place=False))

        with chains.eager_chain():
            eager = sites()
        for a, b, c in zip(sites(), eager, chain):
            assert torch.equal(a, c) and torch.equal(b, c)
        got = sites()
        assert torch.equal(got[2], masking.mask_cols(torch.matmul(U, C[:24]), 11))


def test_wrapper_refuses_other_devices_and_shapes():
    """Off the card project is the library chain (meta in, meta out) and
    launch refuses; operands on two devices, and no terms, raise."""
    V = torch.zeros((8, 4), device="meta")
    Y = kp.project([V], torch.zeros((4, 4), device="meta"))
    assert Y.device == V.device and Y.shape == (8, 4)
    with pytest.raises(ValueError):
        kp.launch([V], torch.zeros((4, 4), device="meta"))
    with pytest.raises(ValueError):
        kp.project([V], torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        kp.project([], torch.zeros((4, 4)))


# --- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("m", range(1, kp.MAX_M + 1))
def test_plan_fits_a_block_and_covers_m(m):
    p = kp.plan(m)
    assert p.hn % 4 == 0 and 2 * p.hn - 8 < m <= 2 * p.hn
    assert 1 <= p.threads <= kp.MAX_THREADS
    assert p.bk in (8, 16, 32) and (p.bk == 8) >= (m <= 24)
    assert p.stage_bytes() <= kp.STAGE_BYTES
    assert kp.STAGES * p.stage_bytes() <= 227 * 1024
    assert kp.plan(m) is p  # cached


def test_plan_at_the_solves_widths():
    """m 164 (4M x 150): 21 x 12 threads, 96 rows, 32 of K a stage; m 64
    (4M x 56): 8 x 32 threads, 256 rows, 32 of K; m 16 (160^3): 2 x 128,
    1,024 rows, 8 of K (csrc/proj.cu fixes these three at compile time)."""
    assert kp.plan(164) == kp.Plan(84, 12, 32)
    assert kp.plan(64) == kp.Plan(32, 32, 32)
    assert kp.plan(16) == kp.Plan(8, 128, 8)
    assert kp.plan(164).threads == 252 and kp.plan(64).threads == 256
    text = (CSRC / "proj.cu").read_text()
    for m in (164, 64, 16):
        p = kp.plan(m)
        assert f"lobpcg_proj_sgemm_kernel<4, {p.bk}, {p.hn}, {p.tms}>" in text


def test_plan_refuses_other_widths():
    for m in (0, kp.MAX_M + 1):
        with pytest.raises(ValueError):
            kp.plan(m)


@pytest.mark.parametrize("ld,off,k,want", [
    (164, 0, 164, 4), (492, 164, 164, 4), (30, 0, 30, 2), (64, 2, 30, 2),
    (63, 0, 63, 1), (64, 1, 16, 1), (16, 0, 16, 4),
])
def test_vector_width(ld, off, k, want):
    buf = torch.zeros(off + 64 * ld)
    V = buf[off:off + 64 * ld].view(64, ld)[:, :k]
    C = torch.zeros((k, 16))
    assert kp.vector_width([V, C], [k, 16]) == want


# --- the kernel, emulated -------------------------------------------------------


def term_chunks(t, w, bk):
    """csrc/proj.cu's chunks of term t's K: (t, first K, K) of bk each,
    a rest of up to PAD joined to the chunk before it."""
    whole, rest = divmod(w, bk)
    n = whole if rest == 0 or (rest <= kp.PAD and whole > 0) else whole + 1
    return [(t, j * bk, bk if j + 1 < n else w - j * bk) for j in range(n)]


def test_term_chunks_cover_each_term_once():
    for w in range(1, 200):
        for bk in (8, 16, 32):
            ch = term_chunks(0, w, bk)
            assert [k0 for _, k0, _ in ch] == [j * bk for j in range(len(ch))]
            assert sum(n for _, _, n in ch) == w
            assert all(1 <= n <= bk + kp.PAD for _, _, n in ch)


def emulate(blocks, C, U=None, live=None):
    """csrc/proj.cu on the host, in float64, block by block: every
    shared-memory write of the stage copies and every read of the threads'
    tiles at the kernel's offsets (an element never written reads NaN),
    each term's chain added to the running sum where the next term starts,
    and the epilogue.  Returns Y and how often each output was written and each
    term element read."""
    n = blocks[0].shape[0]
    m = C.shape[1]
    widths = [b.shape[1] for b in blocks]
    p = kp.plan(m)
    w = kp.vector_width(list(blocks) + [C] + ([] if U is None else [U]),
                        widths + [m])
    bk, bkp, tms, hn = p.bk, p.bk + kp.PAD, p.tms, p.hn
    tnc = hn // 4
    bm, bn = 8 * tms, 2 * hn
    stage = (bm + bn) * bkp
    kbeg = np.cumsum([0] + widths[:-1])
    chunks = [c for t, wt in enumerate(widths) for c in term_chunks(t, wt, bk)]
    Vb = [b.double().numpy() for b in blocks]
    Cb = C.double().numpy()
    Ub = None if U is None else U.double().numpy()
    kind = kp._live_kind(live)
    if kind == "mask":
        live_cols = live.numpy().astype(np.float64)
    elif kind == "count":
        count = int(live) if not isinstance(live, torch.Tensor) else int(live.reshape(-1)[0])
        live_cols = (np.arange(m) < count).astype(np.float64)
    else:
        live_cols = np.ones(m)
    Y = np.full((n, m), np.nan)
    writes = np.zeros((n, m), int)
    reads = [np.zeros(v.shape, int) for v in Vb]
    tid = np.arange(p.threads)
    tm, tn = tid // tnc, tid % tnc
    four = np.arange(4)
    vc = bn // w
    for blk in range(-(-n // bm)):
        r0 = blk * bm
        smem = np.full(kp.STAGES * stage, np.nan)
        acc = np.zeros((p.threads, 8, 8))
        part = np.zeros_like(acc)
        for c, (t, k0, length) in enumerate(chunks):
            base_s = (c % kp.STAGES) * stage
            # V's part: vector i at row i // vpr, K k0 + (i % vpr) w of term t
            # (the first bk of K, then the rest where the chunk has one)
            span = bkp if length > bk else bk
            i = np.arange(bm * (span // w))
            r, kk = i // (span // w), (i % (span // w)) * w
            row = r0 + r
            ok = (row < n) & (kk < length)
            for e in range(w):
                val = np.zeros(len(i))
                val[ok] = Vb[t][row[ok], k0 + kk[ok] + e]
                np.add.at(reads[t], (row[ok], k0 + kk[ok] + e), 1)
                smem[base_s + r * bkp + kk + e] = val
            # C's part: vector i at row kbeg[t] + k0 + i // vc, column (i % vc) w
            i = np.arange(span * vc)
            kk, col = i // vc, (i % vc) * w
            ok = (kk < length) & (col < m)
            for e in range(w):
                val = np.zeros(len(i))
                val[ok] = Cb[kbeg[t] + k0 + kk[ok], col[ok] + e]
                smem[base_s + bm * bkp + kk * bn + col + e] = val
            if t > 0 and k0 == 0:  # the previous term's chain ends
                acc += part
                part[:] = 0.0
            sv = base_s + tm * bkp
            sc = base_s + bm * bkp + tn * 4
            for kq in range(0, bkp, 4):
                if kq == bk and length <= bk:
                    break
                x4 = np.stack([smem[(sv + q * tms * bkp + kq)[:, None] + four]
                               for q in range(8)], 1)  # [threads, 8 rows, 4 K]
                for j in range(4):
                    y = np.concatenate([smem[(sc + (kq + j) * bn)[:, None] + four],
                                        smem[(sc + (kq + j) * bn + hn)[:, None] + four]], 1)
                    part += x4[:, :, j, None] * y[:, None, :]
        acc += part
        rows = r0 + tm[:, None] + np.arange(8)[None, :] * tms            # [threads, 8]
        cols = tn[:, None] * 4 + (np.arange(8) & 3) + (np.arange(8) >> 2) * hn
        rr, qq = np.broadcast_arrays(rows[:, :, None], cols[:, None, :])
        keep = (rr < n) & (qq < m)
        # stage padding and never-written shared memory reach no output
        assert np.isfinite(acc[keep]).all()
        s = acc[keep]
        yv = s if Ub is None else Ub[rr[keep], qq[keep]] - s
        if kind != "none":
            yv = yv * live_cols[qq[keep]]
        Y[rr[keep], qq[keep]] = yv
        np.add.at(writes, (rr[keep], qq[keep]), 1)
    return Y, writes, reads


def _int_operands(n, widths, m, layout, seed):
    """Integer entries in [-8, 8]: every product and sum is exact in f64.
    ``layout``: "contiguous"; "slices" (the terms column slices of one
    wider block and C a column slice, 16-byte aligned); "unaligned" (row
    strides and bases of one float)."""
    g = torch.Generator().manual_seed(seed)

    def ints(shape):
        return torch.randint(-8, 9, shape, generator=g).to(F32)

    K = sum(widths)
    if layout == "contiguous":
        return [ints((n, w)) for w in widths], ints((K, m)), ints((n, m))
    extra, off = (8, 4) if layout == "slices" else (3, 1)
    S = ints((n, K + extra))
    blocks, j = [], off
    for w in widths:
        blocks.append(S[:, j:j + w])
        j += w
    C = ints((K, m + extra))[:, off:off + m]
    U = ints((n, m + extra))[:, off:off + m]
    return blocks, C, U


EMULATED = [
    # (n, widths, m, layout, with U, live)
    (300, (164, 164, 164), 164, "contiguous", False, None),
    (250, (164, 164), 164, "slices", True, 150),
    (700, (64, 64, 64), 64, "contiguous", False, None),
    (515, (64, 64), 64, "slices", True, torch.tensor(40)),
    (2100, (16, 16, 16), 16, "contiguous", False, None),
    (1500, (16,), 16, "slices", False, torch.tensor([True, False] * 8)),
    (301, (96, 96), 96, "unaligned", True, 90),
    (203, (129, 129, 129), 129, "contiguous", True, torch.tensor(100)),
    (190, (168,), 168, "slices", False, 0),
    (1100, (4, 4, 4), 4, "contiguous", True, None),
    (333, (7, 13, 5), 13, "unaligned", True, 9),
    (260, (30, 30, 30, 30), 30, "slices", False, 200),
    (280, (2, 6), 6, "contiguous", False, None),
    (170, (120, 36), 120, "slices", True, 100),
]


@pytest.mark.parametrize("n,widths,m,layout,with_u,live", EMULATED,
                         ids=[f"{e[0]}x{e[1]}->{e[2]}-{e[3]}" for e in EMULATED])
def test_emulated_kernel_is_the_projection(n, widths, m, layout, with_u, live):
    """Every row count leaves the last slab short; every output written
    once, every term element read once, the result exact."""
    blocks, C, U = _int_operands(n, list(widths), m, layout, seed=n + m)
    U = U if with_u else None
    Y, writes, reads = emulate(blocks, C, U, live)
    assert (writes == 1).all()
    for r in reads:
        assert (r == 1).all()
    want = kp.project_reference([b.double() for b in blocks], C.double(),
                                None if U is None else U.double(), live)
    np.testing.assert_array_equal(Y, want.numpy())


@pytest.mark.parametrize("cell", ["bdg_well_4M.nev150", "bdg_well_4M.nev56",
                                  "lap3d_160.nd"])
def test_kernel_time_goes_to_gemm_ms_per_iter(cell):
    """The benchmark's layers claim a kernel by a pattern in its name, the
    first metric in BENCHMARK.json's order: the projection kernel's name
    holds ``sgemm``, so its time is the tall contractions'
    (``gemm_ms_per_iter``, beside the Gram kernel's), not the tail's or
    elementwise."""
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    from bench_port import spec, trace

    text = (CSRC / "proj.cu").read_text()
    assert "__global__ void __launch_bounds__(kMaxThreads, 1) " \
           "lobpcg_proj_sgemm_kernel(" in text
    name = ("void (anonymous namespace)::lobpcg_proj_sgemm_kernel<4, 32, 84, 12>"
            "((anonymous namespace)::Args)")
    spec_cell = spec.load_cell(repo, cell)
    partition = [(m["name"], spec_cell.layer(m["name"]).KERNELS)
                 for m in spec_cell.all_per_layer
                 if hasattr(spec_cell.layer(m["name"]), "KERNELS")]
    tr = trace.Trace(kernels={name: [1.0, 1]}, busy_s=1.0, window_s=1.0,
                     idle_gaps=[])
    assert trace.claim(tr, partition) == ({"gemm_ms_per_iter": 1.0}, None)
