"""The tall Gram G = V^H U of two real f32 blocks [n, kv] and [n, ku]:
the hand-written CUDA kernel ``csrc/gram.cu`` and its plain PyTorch
version.

It replaces no TPU kernel: the JAX package leaves this contraction to
XLA's dot at ``Precision.HIGHEST``; the port gave it to cuBLAS
(``torch.matmul``), whose f32 kernel for these shapes ran at about 45% of
the card's FFMA peak.  The kernel gives each thread an 8 x 8 register
tile of G, stages slabs of rows through shared memory by ``cp.async`` and
sums the slabs' partial Grams in a second pass in a fixed order (no
float atomics: a Gram repeats bit for bit); every product is an f32 FFMA.

``tall_gram`` launches it for CUDA tensors and runs the plain version
``tall_gram_reference`` only for CPU tensors.  ``ops/gram.py:_tall_hmm``
decides which tall Grams come here.  ``plan`` and ``slab_plan`` choose
the launch's shape from the widths alone (csrc/gram.cu says how).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library

MAX_THREADS = 448  # compute threads a block (csrc/gram.cu: kMaxThreads)
STAGES = 4  # shared-memory stages (kStages)
MAX_K = 256  # widths the kernel takes
MAX_ROWS = 8192  # rows of a slab: ops/gram.py's _SPLIT_MAX
GROUP_THREADS = 256  # threads a block of a small tile reaches with groups
STAGE_BYTES = 24 * 1024  # bytes of a stage, where a tile's rows allow

_P, _I = ctypes.c_void_p, ctypes.c_int64
# The C entry points of csrc/gram.cu and their argument types (each
# returns an int cudaError_t).
SIGNATURES = {
    "lobpcg_gram_sgemm_occupancy": [_I] * 5 + [_P],
    "lobpcg_gram_sgemm_f32": [_P, _I, _P, _I, _P, _P] + [_I] * 12 + [_P],
}


@functools.cache
def _lib():
    """The built library with its entry points' ctypes signatures."""
    return load_library("gram", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("gram")


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's shape: output tiles of 2 hm x 2 hn (tiles_m x tiles_n
    of them cover G), each run by hm / 4 x hn / 4 threads of 8 x 8
    outputs; ``groups`` copies of a tile a block, each taking ``rpg`` rows
    of a stage of rpg x groups rows."""

    hm: int
    hn: int
    tiles_m: int
    tiles_n: int
    groups: int
    rpg: int

    @property
    def threads(self) -> int:
        return self.groups * (self.hm // 4) * (self.hn // 4)

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n


def _half(k: int, tiles: int) -> int:
    """Half the width of one of ``tiles`` tiles over k, rounded up to 4."""
    return 4 * -(-k // (8 * tiles))


@functools.lru_cache(maxsize=256)
def plan(kv: int, ku: int) -> Plan:
    """The tiles: one over each width where its hm / 4 x hn / 4 threads
    fit a block (k up to 168 each), else the wider one cut into more
    tiles until they do; then, for a tile of less than a warp, groups of
    it until the block has about GROUP_THREADS threads and a stage of 4
    rows a group fits STAGE_BYTES; then the most rows a group (16, 8 or
    4) that keep a stage within STAGE_BYTES.  Measured on the card at
    [4M, 64]: one 64-thread tile a block, 16 rows a stage, ran 0.86 ms
    against 0.90 for four groups of 8 rows (the solves' widths run the
    plans that won there)."""
    if not (1 <= kv <= MAX_K and 1 <= ku <= MAX_K):
        raise ValueError(f"tall_gram: widths must be in [1, {MAX_K}], got "
                         f"{kv} x {ku}")
    tm, tn = 1, 1
    while True:
        hm, hn = _half(kv, tm), _half(ku, tn)
        if (hm // 4) * (hn // 4) <= MAX_THREADS:
            break
        if hm >= hn:
            tm += 1
        else:
            tn += 1
    per_group = (hm // 4) * (hn // 4)
    row_bytes = 8 * (hm + hn)
    groups = 1 if per_group >= 32 else max(1, min(
        GROUP_THREADS // per_group, STAGE_BYTES // (4 * row_bytes)))
    rpg = next((r for r in (16, 8) if r * groups * row_bytes <= STAGE_BYTES), 4)
    return Plan(hm, hn, tm, tn, groups, rpg)


def slab_plan(n: int, tiles: int, slots: int) -> tuple[int, int]:
    """(rows, slabs): at least ceil(n / MAX_ROWS) slabs, as many more as
    make the blocks (slabs x tiles) fill their last wave of ``slots``
    blocks the card runs at once; rows = ceil(n / slabs)."""
    least = -(-n // MAX_ROWS)
    waves = -(-(least * tiles) // slots)
    slabs = max(least, waves * slots // tiles)
    rows = -(-n // slabs)
    return rows, -(-n // rows)


def vector_width(V: torch.Tensor, U: torch.Tensor) -> int:
    """Floats a copy moves: the widest of 4, 2, 1 that divides both row
    strides, both widths and both bases (in floats)."""
    for w in (4, 2, 1):
        if (all(x % w == 0 for x in (V.stride(0), U.stride(0), V.shape[1],
                                     U.shape[1]))
                and V.data_ptr() % (4 * w) == 0 and U.data_ptr() % (4 * w) == 0):
            return w
    return 1


def takes(V: torch.Tensor, U: torch.Tensor) -> bool:
    """Does the kernel take V^H U, by shape, dtype and layout (the caller
    checks the device)?  Two 2-D real f32 blocks of the same rows, widths
    in [1, MAX_K], column stride 1 and a positive row stride."""
    return (V.dim() == 2 and U.dim() == 2
            and V.dtype == torch.float32 and U.dtype == torch.float32
            and V.shape[0] == U.shape[0] and V.shape[0] >= 1
            and 1 <= V.shape[1] <= MAX_K and 1 <= U.shape[1] <= MAX_K
            and V.stride(1) == 1 and U.stride(1) == 1
            and V.stride(0) >= 1 and U.stride(0) >= 1)


def tall_gram_reference(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Plain version: V^H U as ``torch.matmul``."""
    return torch.matmul(V.mH, U)


@functools.lru_cache(maxsize=64)
def _slots(device_index: int, p: Plan, w: int) -> int:
    """Blocks of plan p the card runs at once: its SMs times the blocks an
    SM holds (the CUDA occupancy calculator on the built kernel)."""
    out = (ctypes.c_int64 * 2)()
    lib = _lib()
    with torch.cuda.device(device_index):
        check(lib, lib.lobpcg_gram_sgemm_occupancy(p.hm, p.hn, p.groups, p.rpg, w,
                                                   ctypes.addressof(out)),
              "tall Gram occupancy")
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * max(1, int(out[1]))


def tall_gram(V: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """G = V^H U [kv, ku] of V [n, kv] and U [n, ku].

    CUDA tensors: launches ``csrc/gram.cu`` (the slabs' partial Grams into
    a scratch buffer, then their sum) on the current stream, without
    synchronising, and counts the call in ``tall_gram.launches``; a pair
    the kernel does not take (``takes``) raises.  CPU tensors: the plain
    version.
    """
    if V.device.type == "cpu" and U.device.type == "cpu":
        return tall_gram_reference(V, U)
    if V.device.type != "cuda" or V.device != U.device:
        raise ValueError(f"tall_gram: V and U on one CUDA device, got "
                         f"{V.device} and {U.device}")
    if not takes(V, U):
        raise ValueError(
            f"tall_gram: the kernel takes two [n, k] real f32 blocks with "
            f"column stride 1 and k <= {MAX_K}, got {tuple(V.shape)} "
            f"{V.dtype} {V.stride()} and {tuple(U.shape)} {U.dtype} "
            f"{U.stride()}")
    n, kv = V.shape
    ku = U.shape[1]
    w = vector_width(V, U)
    p = plan(kv, ku)
    rows, slabs = slab_plan(n, p.tiles, _slots(V.device.index, p, w))
    partial = torch.empty(slabs * kv * ku, dtype=torch.float32, device=V.device)
    G = torch.empty((kv, ku), dtype=torch.float32, device=V.device)
    lib = _lib()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lobpcg_gram_sgemm_f32(
            V.data_ptr(), V.stride(0), U.data_ptr(), U.stride(0),
            partial.data_ptr(), G.data_ptr(), n, kv, ku, rows, slabs, p.hm,
            p.hn, p.tiles_m, p.tiles_n, p.groups, p.rpg, w, stream)
    tall_gram.launches += 1
    check(lib, code, "tall Gram launch")
    return G


tall_gram.launches = 0
