"""The k x k stage of the standard Rayleigh-Ritz's Cholesky branch, from
the Grams GA and GB over S = [X | P | W] to the Ritz coefficients: the
hand-written CUDA kernel ``csrc/rr.cu`` and its plain PyTorch version.

It replaces no TPU kernel: the JAX package leaves the stage to XLA
(``lobpcg_tpu/ops/rayleigh.py``'s Cholesky branch), which fuses its small
ops.  The port ran it as PyTorch's ops (``cholesky_stage_reference``):
about 175 launches of k x k elementwise, ``cat``, ``where`` and ``mm``,
three cuSOLVER ``eigh`` calls, each reading its status back to the host,
and a QR, every one microseconds of work behind several of host.  The
kernel runs the whole stage in one launch, one thread block a problem,
in float64 in shared memory, with its own Jacobi eigensolver and
Householder QR (csrc/rr.cu says how); it reads nothing back.

``cholesky_stage`` takes every such stage (``ops/rayleigh.py`` calls it):
it launches the kernel for Grams on the card that ``takes`` accepts (real
f32/f64, k <= MAX_K, counts as the solver holds them), and runs the plain
version for every other stage (complex, wider, CPU, a count in a 0-d
tensor).  ``launch`` is the kernel alone.  ``cholesky_stage.launches`` /
``.fallbacks`` count the routes on the card.

The plain version is the chain the Cholesky branch ran: the live mask of
the blocks (nx, nx, k - 2 nx) with counts (nx, np_act, nw_act), the dead
diagonals injected (0 in GA, 1 in GB), the block whitening ``block_dinv_r``
(``whiten_block`` of X's block and of the Schur complement of [P W]), H =
DiR^H GA DiR symmetrized with dead-row sentinels, ``eigh``, Cx = DiR Z[:,
:nx] and Cp from ``cp_extract``.  ``whiten_block`` and ``cp_extract`` are
``ops/rayleigh.py``'s too (the first Rayleigh-Ritz, the ortho branch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from lobpcg_tpu_torch.ops.cuda import tail
from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library
from lobpcg_tpu_torch.ops.cuda.chains import (
    blocks_mask,
    clip,
    count,
    inject_diag,
    mm,
)
from lobpcg_tpu_torch.ops.cuda.linalg import eigh, scale_diag

THREADS = 512  # threads a block (csrc/rr.cu: kThreads)
MAX_K = 96  # the widest k (kMaxK): three k x k f64 matrices fit 227 KB
MAX_SWEEPS = 30  # Jacobi sweeps at most (kMaxSweeps)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# The C entry point of csrc/rr.cu and its argument types (it returns an
# int cudaError_t).
SIGNATURES = {
    "lobpcg_rr_jacobi_f64": [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _D, _P, _P,
                             _P, _P, _I, _P],
}

_REAL = (torch.float32, torch.float64)


@functools.cache
def _lib():
    """The built library with its entry point's ctypes signature."""
    return load_library("rr", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("rr")


# --- the plain version -----------------------------------------------------------


def whiten_block(M):
    """Spectral whitening of one Hermitian block: F = D U s^{-1/2} from
    eigh(D M D) = U s U^H satisfies F^H M F = I when M is HPD.
    Returns (F, ok, s_min, s_max) over the full scaled spectrum."""
    D, Ms = scale_diag(M)
    s, U = eigh(Ms)  # ascending
    ok = torch.isfinite(s[..., 0]) & (s[..., 0] > 0) & (s[..., -1] > 0)
    s_safe = torch.where(s > 0, s, 1.0)
    F = (D[..., :, None].to(U.dtype) * U) \
        * torch.rsqrt(s_safe)[..., None, :].to(U.dtype)
    return F, ok, s_safe[..., 0], s_safe[..., -1]


def block_dinv_r(G, nx: int):
    """Whitening transform for the B-Gram over [X | P W]: DiR with
    DiR^H G DiR = I, block-upper-triangular with the block boundary at
    nx (whiten X, B-orthogonalize [P W] against it through the Schur
    complement, whiten that).  Returns (DiR [k,k], ok, rcond)."""
    k = G.shape[-1]
    Fx, ok1, s1_lo, s1_hi = whiten_block(G[..., :nx, :nx])
    E = mm(Fx.mH, G[..., :nx, nx:])
    Sc = G[..., nx:, nx:] - mm(E.mH, E)
    Sc = 0.5 * (Sc + Sc.mH)
    Fs, ok2, s2_lo, s2_hi = whiten_block(Sc)
    top = torch.cat([Fx, -mm(Fx, mm(E, Fs))], dim=-1)
    bot = torch.cat(
        [Fs.new_zeros(Fs.shape[:-2] + (k - nx, nx)), Fs],
        dim=-1,
    )
    DiR = torch.cat([top, bot], dim=-2)
    ok = ok1 & ok2
    rcond = torch.where(
        ok,
        torch.sqrt(torch.minimum(s1_lo, s2_lo) / torch.maximum(s1_hi, s2_hi)),
        0.0,
    )
    return DiR, ok, rcond


def cp_extract(Z, nx: int, DiR: Optional[torch.Tensor], n_live):
    """Duersch Alg. 7: Cp = [D_inv_R] V_perp Q, Q = QR-basis of Z1_perp^T
    (plain transpose).  Only the live unwanted eigenvectors (the first
    n_live - nx columns of Z_perp) take part; the result has
    p_count = clip(n_live - nx, 0, nx) columns.  Kept on QR, for the
    reason the JAX package's docstring gives.  Returns (Cp, p_count)."""
    k = Z.shape[-1]
    Zp = Z[..., nx:]
    zp_live = clip(n_live - nx, 0, k - nx)
    p_count = clip(n_live - nx, 0, nx)
    Zp = tail.compact(Zp, 0, zp_live)
    Z1t = Zp[..., :nx, :].transpose(-2, -1)
    Q, _ = torch.linalg.qr(Z1t)
    Cp = mm(Zp, Q)
    if DiR is not None:
        Cp = mm(DiR, Cp)
    return tail.compact(Cp, 0, p_count), p_count


def cholesky_stage_reference(GA, GB, np_act, nw_act, *, nx: int,
                             tol_skip: float, out_dtype):
    """Plain version: the Cholesky branch's chain from the Grams GA and GB
    of [X | P | W] (as assembled, before the dead diagonals) to (Cx, Cp,
    lam, ok, p_count); Cx and Cp in ``out_dtype``, lam in the Grams'
    dtype, ok (definite and rcond >= tol_skip) on the device, p_count as
    the counts are (an int, or lanes)."""
    k = GA.shape[-1]
    m = nx
    live = blocks_mask((m, m, k - 2 * m), (m, np_act, nw_act), GA.device)
    n_live = m + count(np_act) + count(nw_act)
    GA = inject_diag(GA, live, 0.0)
    GB = inject_diag(GB, live, 1.0)
    DiR, def_ok, rcond = block_dinv_r(GB, nx)
    ok = def_ok & (rcond >= tol_skip)
    DiR = torch.where(
        def_ok[..., None, None], DiR,
        torch.eye(k, dtype=DiR.dtype, device=DiR.device)
    )
    T1 = mm(GA, DiR)
    H = mm(DiR.mH, T1)
    H = 0.5 * (H + H.mH)
    # Dead-coordinate sentinels in pencil form: H + big * K^H K with
    # K the dead rows of DiR; big a Gershgorin bound off the actual H.
    gersh = torch.amax(torch.sum(torch.abs(H), dim=-1), dim=-1)
    big = (2.0 * gersh + 1.0).to(H.dtype)
    dead_rows = (~live).to(DiR.dtype)
    K = DiR * dead_rows[..., :, None]
    H = H + big[..., None, None] * mm(K.mH, K)
    w, Z = eigh(H)
    Cx = mm(DiR, Z[..., :nx])
    lam = w[..., :nx]
    Cp, p_cnt = cp_extract(Z, nx, DiR, n_live)
    return Cx.to(out_dtype), Cp.to(out_dtype), lam, ok, p_cnt


# --- the route -----------------------------------------------------------------


def _count_ok(c, lead) -> bool:
    """A count the kernel reads: a Python int, or an integer tensor of one
    count a problem of the batch ``lead`` (not a 0-d tensor: the plain
    version reads that on the host)."""
    if not isinstance(c, torch.Tensor):
        return isinstance(c, int)
    return (c.dim() >= 1 and tuple(c.shape) == lead
            and not (c.is_floating_point() or c.is_complex() or c.dtype == torch.bool))


def takes(GA, GB, np_act, nw_act, nx: int, out_dtype) -> bool:
    """Does ``cholesky_stage`` launch the kernel for this stage on the
    card?  By shape, dtype and the counts' form alone, the device being
    ``cholesky_stage``'s check: GA and GB of one real dtype (f32 or f64)
    and shape [..., k, k], contiguous, with 1 <= nx, 2 nx <= k <= MAX_K;
    Cx and Cp real f32 or f64; each count an int, or one integer a
    problem of the batch."""
    if GA.dim() < 2 or GA.shape != GB.shape or GA.dtype != GB.dtype:
        return False
    k = GA.shape[-1]
    lead = tuple(GA.shape[:-2])
    return (GA.dtype in _REAL and out_dtype in _REAL and GA.shape[-2] == k
            and 1 <= nx and 2 * nx <= k <= MAX_K
            and GA.is_contiguous() and GB.is_contiguous()
            and _count_ok(np_act, lead) and _count_ok(nw_act, lead))


def cholesky_stage(GA, GB, np_act, nw_act, *, nx: int, tol_skip: float,
                   out_dtype):
    """(Cx, Cp, lam, ok, p_count) of the Cholesky branch, as
    ``cholesky_stage_reference`` forms them.

    Grams on the card that ``takes`` accepts: one launch of the kernel.
    Any other stage: the plain version, counted on the card in
    ``cholesky_stage.fallbacks``.  GA and GB on two devices raise."""
    if GA.device != GB.device:
        raise ValueError("Rayleigh-Ritz stage: GA and GB on one device")
    if GA.device.type == "cuda":
        if takes(GA, GB, np_act, nw_act, nx, out_dtype):
            return _launch(GA, GB, np_act, nw_act, nx, tol_skip, out_dtype)
        cholesky_stage.fallbacks += 1
    return cholesky_stage_reference(GA, GB, np_act, nw_act, nx=nx,
                                    tol_skip=tol_skip, out_dtype=out_dtype)


def launch(GA, GB, np_act, nw_act, *, nx: int, tol_skip: float, out_dtype):
    """The kernel alone: the stage as ``cholesky_stage`` forms it, launched
    on the current stream without synchronising and counted in
    ``cholesky_stage.launches``.  Grams off the card, or a stage the kernel
    does not take (``takes``), raise."""
    if GA.device.type != "cuda" or GB.device != GA.device:
        raise ValueError("Rayleigh-Ritz stage: GA and GB on one CUDA device")
    if not takes(GA, GB, np_act, nw_act, nx, out_dtype):
        raise ValueError(
            f"Rayleigh-Ritz stage: the kernel takes contiguous real f32/f64 "
            f"Grams [..., k, k] with 2 nx <= k <= {MAX_K}, real f32/f64 "
            f"outputs and counts as ints or one a problem; got GA "
            f"{tuple(GA.shape)} {GA.dtype}, GB {tuple(GB.shape)} {GB.dtype}, "
            f"nx {nx}, out {out_dtype}, counts {np_act!r}, {nw_act!r}")
    return _launch(GA, GB, np_act, nw_act, nx, tol_skip, out_dtype)


def _count_args(c, device):
    """(pointer, number) for the C entry point, and the tensor pointed
    into (None for an int)."""
    if not isinstance(c, torch.Tensor):
        return None, int(c), None
    if c.device != device:
        raise ValueError("Rayleigh-Ritz stage: a count on another device")
    c = c.to(torch.int64).contiguous()
    return c.data_ptr(), 0, c


def _launch(GA, GB, np_act, nw_act, nx, tol_skip, out_dtype):
    """One launch of csrc/rr.cu over the problems of GA's batch, counted
    in ``cholesky_stage.launches``; the callers check the stage."""
    k = GA.shape[-1]
    lead = tuple(GA.shape[:-2])
    batch = 1
    for d in lead:
        batch *= d
    dev = GA.device
    Cx = torch.empty(lead + (k, nx), dtype=out_dtype, device=dev)
    Cp = torch.empty(lead + (k, nx), dtype=out_dtype, device=dev)
    lam = torch.empty(lead + (nx,), dtype=GA.dtype, device=dev)
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    np_ptr, np_n, np_t = _count_args(np_act, dev)
    nw_ptr, nw_n, nw_t = _count_args(nw_act, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lobpcg_rr_jacobi_f64(
            GA.data_ptr(), GB.data_ptr(), GA.element_size(), batch, k, nx,
            np_ptr, np_n, nw_ptr, nw_n, float(tol_skip), Cx.data_ptr(),
            Cp.data_ptr(), lam.data_ptr(), ok.data_ptr(),
            Cx.element_size(), stream)
    del np_t, nw_t
    check(lib, code, "Rayleigh-Ritz stage launch")
    cholesky_stage.launches += 1
    n_live = nx + count(np_act) + count(nw_act)
    p_count = clip(n_live - nx, 0, nx)
    return Cx, Cp, lam, ok, p_count


cholesky_stage.launches = 0
cholesky_stage.fallbacks = 0
