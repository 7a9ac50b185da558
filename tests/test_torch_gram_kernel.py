"""The tall Gram kernel (lobpcg_tpu_torch/ops/cuda/gram.py, csrc/gram.cu)
on the CPU, where the wrapper runs its plain version.

- Which product ``tall_gram`` runs for a pair: its predicate ``takes``
  over shape, dtype, strides, batch and n, each case with its route; off
  the card every route is PyTorch's (``ops/gram.py:_tall_hmm`` splitting
  a batched pair over rows), on CPU tensors with the bits it had.
- The plain version is ``torch.matmul(V.mH, U)``, bit for bit.
- The launch plan (tiles, groups, rows a stage, slabs) over the widths
  the kernel takes, and the C entry points against ``SIGNATURES``.
- A host emulation of csrc/gram.cu (its stage copy, the threads' 8 x 8
  register tiles read at the kernel's shared-memory offsets, the groups'
  sum, the partial Grams and the second pass), on integer entries where
  every sum is exact: it must give V^T U exactly, so an offset, a mask
  or a slab bound the kernel gets wrong shows here.

The kernel itself runs on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from lobpcg_tpu_torch.ops import gram
from lobpcg_tpu_torch.ops.cuda import gram as kg

torch.set_num_threads(2)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "lobpcg_tpu_torch" / "csrc"
TALL = kg.MIN_ROWS
F32 = torch.float32

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64}


def test_ctypes_signatures_match_the_source():
    """SIGNATURES equals csrc/gram.cu's C entry points' parameter lists (a
    mismatch shows only on the card, as a crash)."""
    text = (CSRC / "gram.cu").read_text()
    protos = dict(re.findall(r"^int (lobpcg_\w+)\(([^)]*)\)", text, re.M))
    assert set(protos) == set(kg.SIGNATURES)
    for sym, params in protos.items():
        types = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                 for p in params.split(",")]
        assert types == kg.SIGNATURES[sym], sym


def test_constants_match_the_source():
    text = (CSRC / "gram.cu").read_text()
    assert f"kMaxThreads = {kg.MAX_THREADS};" in text
    assert f"kStages = {kg.STAGES};" in text


# --- the route -----------------------------------------------------------------


def _block(n, k, dtype=F32, lead=(), col_slice=False, transposed=False):
    """A block of that layout on the meta device (shape, strides and
    dtype without memory: the route reads nothing else)."""
    def make(shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    if transposed:
        return make(lead + (k, n)).mT
    if col_slice:
        return make(lead + (n, k + 8))[..., 4:4 + k]
    return make(lead + (n, k))


# (case, V, U, the kernel takes it on the card)
ROUTE_CASES = [
    ("flagship [4M-like, 64]", _block(TALL, 64), _block(TALL, 64), True),
    ("4M x 150 [n, 164]", _block(TALL, 164), _block(TALL, 164), True),
    ("Chebyshev chunk [n, 16]", _block(TALL, 16), _block(TALL, 16), True),
    ("odd widths 63 x 65", _block(TALL, 63), _block(TALL, 65), True),
    ("widths 4 and 96", _block(TALL, 4), _block(TALL, 96), True),
    ("width 150", _block(TALL, 150), _block(TALL, 150), True),
    ("widths 129 and 168", _block(TALL, 129), _block(TALL, 168), True),
    ("width 3 (cuBLAS's dot kernels)", _block(TALL, 3), _block(TALL, 3), False),
    ("width 1", _block(TALL, 1), _block(TALL, 1), False),
    ("width 100 (cuBLAS's tiles)", _block(TALL, 100), _block(TALL, 100), False),
    ("width 128", _block(TALL, 128), _block(TALL, 128), False),
    ("width 200", _block(TALL, 200), _block(TALL, 200), False),
    ("widths 64 and 164", _block(TALL, 64), _block(TALL, 164), False),
    ("width 256", _block(TALL, 256), _block(TALL, 256), False),
    ("column slice, row stride k + 8", _block(TALL, 60, col_slice=True),
     _block(TALL, 60), True),
    ("n one short of tall", _block(TALL - 1, 64), _block(TALL - 1, 64), False),
    ("k x k _mat Gram", _block(492, 164), _block(492, 164), False),
    ("width 257", _block(TALL, 257), _block(TALL, 64), False),
    ("f64", _block(TALL, 64, torch.float64), _block(TALL, 64, torch.float64), False),
    ("complex64", _block(TALL, 16, torch.complex64),
     _block(TALL, 16, torch.complex64), False),
    ("mixed f32 / f64", _block(TALL, 16), _block(TALL, 16, torch.float64), False),
    ("column stride n (a transpose)", _block(TALL, 16, transposed=True),
     _block(TALL, 16), False),
    ("batched [2, n, 30]", _block(TALL, 30, lead=(2,)),
     _block(TALL, 30, lead=(2,)), False),
    ("rows differ", _block(TALL, 16), _block(TALL + 8, 16), False),
]


@pytest.mark.parametrize("case,V,U,on_card", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_dispatch_predicate(monkeypatch, case, V, U, on_card):
    """``takes`` is the kernel's route on the card; off the card (meta
    tensors here) every 2-D pair is tall_gram's plain version, one
    torch.matmul, and a batched pair is split over rows where n has more
    than MAX_ROWS rows."""
    assert kg.takes(V, U) is on_card, case
    routes = []
    monkeypatch.setattr(kg, "_launch", lambda *a: routes.append("kernel"))
    monkeypatch.setattr(kg, "tall_gram_reference",
                        lambda *a: routes.append("matmul"))
    split = V.dim() == 3 and V.shape[-2] > kg.MAX_ROWS
    if split:
        assert gram._tall_hmm(V, U).shape == (2, V.shape[-1], U.shape[-1]), case
    else:
        gram._tall_hmm(V, U)
    assert routes == ([] if split else ["matmul"]), case


def test_cpu_tall_grams_keep_their_bits():
    """On the CPU, tall_gram, _tall_hmm and the Grams built on it are the
    torch.matmul they were, at a tall n and at a small one."""
    g = torch.Generator().manual_seed(3)
    for n, k in ((TALL + 5, 24), (300, 7)):
        V = torch.randn((n, k + 3), generator=g)[:, 1:1 + k]
        U = torch.randn((n, k), generator=g)
        assert torch.equal(kg.tall_gram(V, U), torch.matmul(V.mH, U))
        assert torch.equal(gram._tall_hmm(V, U), torch.matmul(V.mH, U))
        assert torch.equal(gram.gram_cross(V, U), torch.matmul(V.mH, U))


def test_plain_version_is_matmul_bit_for_bit():
    g = torch.Generator().manual_seed(4)
    before = kg.tall_gram.launches
    for n, kv, ku in ((1000, 164, 164), (777, 16, 30), (513, 1, 256)):
        V = torch.rand((n, kv), generator=g)
        U = torch.randn((n, ku + 2), generator=g)[:, 2:]
        want = torch.matmul(V.mH, U)
        assert torch.equal(kg.tall_gram_reference(V, U), want)
        assert torch.equal(kg.tall_gram(V, U), want)
    assert kg.tall_gram.launches == before


def test_wrapper_refuses_other_devices():
    """Off the card tall_gram is its plain version (meta in, meta out) and
    launch refuses; operands on two devices raise."""
    V = torch.zeros((8, 4), device="meta")
    G = kg.tall_gram(V, V)
    assert G.device == V.device and G.shape == (4, 4)
    with pytest.raises(ValueError):
        kg.launch(V, V)
    with pytest.raises(ValueError):
        kg.tall_gram(V, torch.zeros((8, 4)))


# --- the plan ------------------------------------------------------------------

WIDTHS = [1, 2, 7, 16, 30, 60, 63, 64, 65, 100, 128, 150, 163, 164, 168, 169,
          176, 200, 255, 256]


@pytest.mark.parametrize("kv", WIDTHS)
def test_plan_fits_a_block_and_covers_g(kv):
    for ku in WIDTHS:
        p = kg.plan(kv, ku)
        assert p.threads <= kg.MAX_THREADS
        assert p.hm % 4 == 0 and p.hn % 4 == 0
        # the tiles cover G, with less than 8 columns of padding a tile
        assert 0 <= p.tiles_m * 2 * p.hm - kv < 8 * p.tiles_m
        assert 0 <= p.tiles_n * 2 * p.hn - ku < 8 * p.tiles_n
        assert p.rpg in (4, 8, 16) and p.groups >= 1
        stage = p.rpg * p.groups * 8 * (p.hm + p.hn)  # bytes of V's and U's rows
        assert stage <= kg.STAGE_BYTES
        # csrc/gram.cu's shared memory: the stages or the groups' tiles
        tiles = (p.groups - 1) * (p.hm // 4) * (p.hn // 4) * 256
        assert max(kg.STAGES * stage, tiles) <= 227 * 1024
        assert p.tiles <= 65535


def test_plan_at_the_solves_widths():
    """k 164 (4M x 150): one tile of 168, 441 threads, no groups, 16 rows
    a stage (the padding 2.4%); k 64 (4M x 56): one tile of 64 a block,
    no padding; k 16: groups; k 256: four tiles of 128 (csrc/gram.cu
    fixes the first two at compile time)."""
    assert kg.plan(164, 164) == kg.Plan(84, 84, 1, 1, 1, 16)
    assert kg.plan(164, 164).threads == 441
    assert kg.plan(64, 64) == kg.Plan(32, 32, 1, 1, 1, 16)
    assert kg.plan(16, 16).threads >= 128
    assert kg.plan(256, 256) == kg.Plan(64, 64, 2, 2, 1, 16)


@pytest.mark.parametrize("n,tiles,slots", [
    (4_000_000, 1, 132), (4_100_000, 1, 264), (1_000_000, 1, 132),
    (1_000_018, 4, 132), (65_536, 1, 132), (4_000_000, 4, 264), (17, 1, 132),
])
def test_slab_plan(n, tiles, slots):
    rows, slabs = kg.slab_plan(n, tiles, slots)
    assert rows <= kg.MAX_ROWS
    assert slabs * rows >= n > (slabs - 1) * rows
    least = -(-n // kg.MAX_ROWS)
    waves = -(-(least * tiles) // slots)
    assert slabs * tiles <= waves * slots  # no wave more than the least needs


def test_slab_plan_fills_waves_at_4m():
    assert kg.slab_plan(4_000_000, 1, 132) == (7576, 528)


@pytest.mark.parametrize("ld,off,k,want", [
    (164, 0, 164, 4), (492, 164, 164, 4), (30, 0, 30, 2), (64, 2, 30, 2),
    (63, 0, 63, 1), (64, 1, 16, 1), (16, 0, 16, 4),
])
def test_vector_width(ld, off, k, want):
    buf = torch.zeros(off + 64 * ld)
    V = buf[off:off + 64 * ld].view(64, ld)[:, :k]
    U = torch.zeros((64, 16))
    assert kg.vector_width(V, U) == want


# --- the kernel, emulated -------------------------------------------------------


def _copy_map(p: kg.Plan, w: int):
    """The (vector, row) pairs of a stage each thread copies
    (csrc/gram.cu: load), as arrays over all copying threads."""
    bm, bn = 2 * p.hm, 2 * p.hn
    bk = p.rpg * p.groups
    vm, vpr = bm // w, bm // w + bn // w
    col_lanes = min(p.threads, vpr)
    row_lanes = p.threads // col_lanes
    cs, rs = [], []
    for t in range(p.threads):
        lane_c, lane_r = t % col_lanes, t // col_lanes
        if lane_r >= row_lanes:
            continue
        for c in range(lane_c, vpr, col_lanes):
            for r in range(lane_r, bk, row_lanes):
                cs.append(c)
                rs.append(r)
    return np.array(cs), np.array(rs), vm


def emulate(V: torch.Tensor, U: torch.Tensor, slots: int) -> np.ndarray:
    """csrc/gram.cu on the host, in float64, block by block: every
    shared-memory read and write at the kernel's offsets (an element
    never written reads NaN), by bulk copies where the copy's width is 4
    floats (lobpcg_gram_sgemm_tma_kernel), else by cp.async."""
    n, kv = V.shape
    ku = U.shape[1]
    p = kg.plan(kv, ku)
    w = kg.vector_width(V, U)
    rows, slabs = kg.slab_plan(n, p.tiles, slots)
    Vb = V.double().numpy()
    Ub = U.double().numpy()
    hm, hn, G, rpg = p.hm, p.hn, p.groups, p.rpg
    P, T = 2, 8
    bm, bn = 2 * hm, 2 * hn
    bk = rpg * G
    stage = bk * (bm + bn)
    t = np.arange(p.threads)
    per_group = (hm // 4) * (hn // 4)
    g = t // per_group
    wi = t - g * per_group
    tm, tn = wi // (hn // 4), wi % (hn // 4)
    cs, rs, vm = _copy_map(p, w)
    partial = np.full((slabs, kv, ku), np.nan)
    four = np.arange(4)
    for s in range(slabs):
        r0 = s * rows
        r1 = min(r0 + rows, n)
        chunks = -(-(r1 - r0) // bk)
        for tile in range(p.tiles):
            tile_m = tile // p.tiles_n
            c0m, c0n = tile_m * bm, (tile - tile_m * p.tiles_n) * bn
            acc = np.zeros((p.threads, T, T))
            smem = np.full(kg.STAGES * stage, np.nan)
            for c in range(chunks):
                base_s = (c % kg.STAGES) * stage
                valid = min(bk, r1 - r0 - c * bk)
                if w == 4:
                    # Bulk copies of the tile's columns of each row in the
                    # slab; everything else in the stage is left as it was
                    # (NaN here: a read of it shows).
                    smem[base_s:base_s + stage] = np.nan
                    vc, uc = min(bm, kv - c0m), min(bn, ku - c0n)
                    for r in range(valid):
                        row = r0 + c * bk + r
                        smem[base_s + r * bm + np.arange(vc)] = Vb[row, c0m:c0m + vc]
                        smem[base_s + bk * bm + r * bn + np.arange(uc)] = \
                            Ub[row, c0n:c0n + uc]
                else:
                    # cp.async of every vector, zero-filled past the ends
                    valid = bk
                    row = r0 + c * bk + rs
                    is_v = cs < vm
                    col = np.where(is_v, cs, cs - vm) * w
                    gcol = np.where(is_v, c0m, c0n) + col
                    ok = (gcol < np.where(is_v, kv, ku)) & (row < r1)
                    dst = base_s + np.where(is_v, col + rs * bm, bk * bm + col + rs * bn)
                    for e in range(w):
                        val = np.zeros(len(cs))
                        sel_v, sel_u = ok & is_v, ok & ~is_v
                        val[sel_v] = Vb[row[sel_v], gcol[sel_v] + e]
                        val[sel_u] = Ub[row[sel_u], gcol[sel_u] + e]
                        smem[dst + e] = val
                sv = base_s + g * bm + tm * 4
                su = base_s + bk * bm + g * bn + tn * 4
                for i in range(rpg):
                    x = np.concatenate([smem[(sv + i * G * bm + j * hm)[:, None] + four]
                                        for j in range(P)], 1)
                    y = np.concatenate([smem[(su + i * G * bn + j * hn)[:, None] + four]
                                        for j in range(P)], 1)
                    part = x[:, :, None] * y[:, None, :]
                    reads = g + i * G < valid  # a short last stage: its rows only
                    acc[reads] += part[reads]
            step = 1  # the groups' tree: g + step into g, g a multiple of 2 step
            while step < G:
                for h in range(0, G - step, 2 * step):
                    acc[g == h] += acc[g == h + step]
                step *= 2
            lead = g == 0
            m = c0m + np.concatenate([j * hm + tm[lead, None] * 4 + four
                                      for j in range(P)], 1)
            q = c0n + np.concatenate([j * hn + tn[lead, None] * 4 + four
                                      for j in range(P)], 1)
            mm, qq = np.broadcast_arrays(m[:, :, None], q[:, None, :])
            keep = (mm < kv) & (qq < ku)
            # padding read as NaN reaches only outputs past kv or ku
            assert np.isfinite(acc[lead][keep]).all()
            partial[s][mm[keep], qq[keep]] = acc[lead][keep]
    # the second pass: any fixed order sums integers exactly
    assert not np.isnan(partial).any()
    return partial.sum(0)


def _operands(n, kv, ku, layout, seed):
    """Integer entries in [-8, 8]: every product and sum is exact in f64."""
    g = torch.Generator().manual_seed(seed)
    def block(k, extra, off):
        X = torch.randint(-8, 9, (n, k + extra), generator=g).to(F32)
        return X[:, off:off + k]
    if layout == "contiguous":
        return block(kv, 0, 0), block(ku, 0, 0)
    if layout == "slices":  # a column slice of a wider block, 16-byte aligned
        return block(kv, 8, 4), block(ku, 12, 8)
    if layout == "unaligned":  # row strides and bases of one float
        return block(kv, 3, 1), block(ku, 1, 1)
    raise ValueError(layout)


@pytest.mark.parametrize("n,kv,ku,layout", [
    (5000, 164, 164, "contiguous"),
    (5000, 164, 164, "slices"),
    (4099, 64, 64, "contiguous"),
    (3001, 16, 16, "contiguous"),
    (3001, 30, 30, "contiguous"),
    (2003, 63, 65, "unaligned"),
    (2000, 1, 1, "contiguous"),
    (1500, 256, 256, "contiguous"),
    (1500, 169, 16, "slices"),
    (2500, 164, 64, "unaligned"),
])
def test_emulated_kernel_is_the_product(n, kv, ku, layout):
    """Three slots a wave, so every case runs several slabs, the last one
    short, with stages that run past a slab's last row."""
    V, U = _operands(n, kv, ku, layout, seed=kv * 1000 + ku)
    got = emulate(V, U, slots=3)
    want = V.double().numpy().T @ U.double().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv,w", [(k, w) for k in (1, 16, 30, 63, 64, 164, 200, 256)
                                  for w in (4, 2, 1) if k % w == 0])
def test_stage_copy_covers_every_element_once(kv, w):
    p = kg.plan(kv, 64)
    cs, rs, _ = _copy_map(p, w)
    vpr = 2 * (p.hm + p.hn) // w
    seen = np.zeros((vpr, p.rpg * p.groups), int)
    np.add.at(seen, (cs, rs), 1)
    assert (seen == 1).all()
