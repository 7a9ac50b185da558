"""Projected generalized (nonsymmetric pencil) eigensolve for the
indefinite Rayleigh-Ritz: GA v = lambda GB v on a tiny k x k pair (port
of ``lobpcg_tpu/ops/pencil.py``).

- 'cholesky' (default): the Kressner-Pandur-Shao reduction by spectral
  whitening of the Jacobi-scaled GA, with the definite-combination
  ladder C = c GA + s GB when GA is indefinite or near the definiteness
  boundary.  A genuinely non-definite pencil fails: NaN outputs and
  ok=False, surfaced as ``rr_failed`` by the solver.
- 'qz': ``scipy.linalg.eig`` (QZ) called directly on the host.
- 'auto': cholesky, with QZ when no definite combination exists.

|beta| (resp. |mu|) below `tiny` maps to +-1e30 sentinels.

Batched (``ops/lanes.py``): the pair is [b, k, k], ``ok`` is [b], the
ladder runs for the batch when some problem needs it and is selected per
problem, and the host QZ loops over the problems that need it (the JAX
package's ``pure_callback(..., vmap_method="sequential")``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lobpcg_tpu_torch.ops import lanes, masking
from lobpcg_tpu_torch.ops.gram import mm
from lobpcg_tpu_torch.ops.linalg import eigh
from lobpcg_tpu_torch.utils.profiling import SYNC_COPY, span

BIG = 1e30


def _real_dtype(dt):
    return dt.to_real() if dt.is_complex else dt


def _sentinel_lambda(num, den, tiny, rdt):
    """lambda = num/den, guarded: |den| <= tiny -> +-BIG by sign(Re num)."""
    ok = torch.abs(den) > tiny
    one = torch.ones_like(den)
    lam = torch.where(ok, (num / torch.where(ok, den, one)).real, 0.0)
    sent = torch.where(num.real >= 0, BIG, -BIG)
    return torch.where(ok, lam, sent).to(rdt)


def _kps_reduce(F_safe, GBh, tiny: float):
    """Given F with F F^H = C^{-1} for an HPD C, solve C v = lam_C GB v
    through eigh(F^H GB F).  Returns (lam_C [k] real, V [k,k])."""
    rdt = _real_dtype(GBh.dtype)
    M = mm(F_safe.mH, mm(GBh, F_safe))
    M = 0.5 * (M + M.mH)
    mu, Q = eigh(M)
    V = mm(F_safe, Q.to(GBh.dtype))
    lam_C = _sentinel_lambda(
        torch.ones_like(mu).to(GBh.dtype), mu.to(GBh.dtype), tiny, rdt
    )
    return lam_C, V


# Definite-combination candidates (c, t): C = c*GA + t*rho*GB with
# rho = ||GA||_F / ||GB||_F; (1, 0) first.
_LADDER_C = (1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0,
             1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0)
_LADDER_T = (0.0, 0.0, 0.5, -0.5, 0.5, -0.5, 1.0, -1.0, 1.0, -1.0,
             2.0, -2.0, 2.0, -2.0, 4.0, -4.0, 4.0, -4.0)


def _whiten_scored(M, live=None):
    """Jacobi-scaled spectral whitening with an exact conditioning score,
    batched over M's leading dims.  Returns (F, ok, score): F F^H = M^{-1}
    when M is HPD, ok = the scaled matrix is positive definite over the
    live coordinates, score = s_min / s_max (-1 when not definite).
    Dead coordinates (``live`` False) are shifted above the live spectrum
    before the eigh."""
    rdt = _real_dtype(M.dtype)
    k = M.shape[-1]
    gd = torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)).to(rdt)
    pos = gd > 0
    D = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, gd, 1.0)), 1.0)
    Ms = (D[..., :, None] * M) * D[..., None, :].to(M.dtype)
    s_hi_idx = None
    if live is not None:
        shift = torch.amax(torch.sum(torch.abs(Ms), dim=-1), dim=-1) + 2.0
        dead_diag = masking.diag((~live).to(Ms.dtype))
        Ms = Ms * (1.0 - dead_diag) + shift[..., None, None].to(
            Ms.dtype
        ) * dead_diag
        n_dead = torch.sum(~live, dim=-1)
        s_hi_idx = torch.clamp(k - 1 - n_dead, 0, k - 1)[..., None]
    s, U = eigh(Ms)  # ascending; shifted dead at the top
    s_hi = (
        s[..., -1] if s_hi_idx is None
        else torch.take_along_dim(s, s_hi_idx, dim=-1)[..., 0]
    )
    ok = torch.isfinite(s[..., 0]) & (s[..., 0] > 0) & (s_hi > 0)
    s_safe = torch.where(s > 0, s, 1.0)
    score = torch.where(ok, s[..., 0] / s_hi, -1.0)
    F = (D[..., :, None].to(U.dtype) * U) * torch.rsqrt(s_safe)[
        ..., None, :
    ].to(U.dtype)
    return F, ok, score


def pencil_eig_cholesky(GA, GB, tiny: float, live=None):
    """KPS reduction with a definite-combination ladder.
    Returns (lam [k] real, V [k,k], ok 0-d bool tensor).  When GA is
    HPD and comfortably conditioned (score >= sqrt(eps)), one scaled
    eigh; otherwise every ladder combination is whitened (one batched
    eigh) and the best-conditioned definite one is used, with
    lam = (lam_C - s) / c.  ok=False only when no combination is
    definite; the outputs are then NaN."""
    k = GA.shape[-1]
    dt = GA.dtype
    rdt = _real_dtype(dt)
    GAh = 0.5 * (GA + GA.mH)
    GBh = 0.5 * (GB + GB.mH)

    F0, ok0, sc0 = _whiten_scored(GAh, live)
    floor = float(np.sqrt(torch.finfo(rdt).eps))

    def ladder():
        nGA = torch.sqrt(torch.sum(torch.abs(GAh) ** 2, dim=(-2, -1)))
        nGB = torch.sqrt(torch.sum(torch.abs(GBh) ** 2, dim=(-2, -1)))
        rho = torch.where(
            nGB > 0, nGA / torch.where(nGB > 0, nGB, 1.0), 1.0
        )
        with span(SYNC_COPY):  # copies from the host wait on the stream
            cs = torch.tensor(_LADDER_C, dtype=rdt, device=GA.device)
            ts = torch.tensor(_LADDER_T, dtype=rdt, device=GA.device)
        ss = ts * rho[..., None]
        Cs = (
            cs[:, None, None].to(dt) * GAh[..., None, :, :]
            + ss[..., :, None, None].to(dt) * GBh[..., None, :, :]
        )
        Fs, oks, scs = _whiten_scored(
            Cs, None if live is None else live[..., None, :])
        idx = torch.argmax(scs, dim=-1)  # best-conditioned definite candidate
        F = torch.take_along_dim(Fs, idx[..., None, None, None], dim=-3)
        s = torch.take_along_dim(ss, idx[..., None], dim=-1)[..., 0]
        c = cs[lanes.read(idx)]  # one problem's 0-d index: a host read
        return F[..., 0, :, :], c, s, torch.any(oks, dim=-1)

    F, c, s, ok = lanes.cond(lanes.read(ok0 & (sc0 >= floor)),
                             lambda: (F0, 1.0, 0.0, ok0), ladder)
    eye = torch.eye(k, dtype=dt, device=GA.device)
    F_safe = torch.where(ok[..., None, None], F, eye)
    lam_C, V = _kps_reduce(F_safe, GBh, tiny)
    c, s = lanes.col(c), lanes.col(s)
    lam = torch.where(
        torch.abs(lam_C) >= 0.5 * BIG,
        torch.sign(lam_C) * c * BIG,
        (lam_C - s) * c,  # c in {+1,-1} so 1/c == c
    ).to(rdt)
    lam = torch.where(ok[..., None], lam, float("nan"))
    V = torch.where(ok[..., None, None], V, float("nan"))
    return lam, V, ok


def _qz_host(GA: np.ndarray, GB: np.ndarray):
    """Host QZ via scipy; returns (alpha, beta, VR) with VR cast back to
    the input dtype (real part for real dtypes)."""
    import scipy.linalg as sla

    w, vr = sla.eig(GA, GB, homogeneous_eigvals=True)
    alpha, beta = np.asarray(w)[0], np.asarray(w)[1]
    dt = GA.dtype
    cdt = np.result_type(dt, np.complex64)
    return (
        alpha.astype(cdt),
        beta.astype(cdt),
        vr.real.astype(dt) if np.isrealobj(np.zeros((), dt)) else vr.astype(dt),
    )


def pencil_eig_qz(GA, GB, tiny: float, need=None):
    """GGEV parity path: QZ on the host (scipy), results back on GA's
    device.  A pair [k, k] is a batch of one.  Batched, one QZ per
    problem that ``need`` ([b] bool, None = all) names, in turn (the JAX
    package's ``pure_callback(..., vmap_method="sequential")``); the
    others get NaN and ok False.  A pair that is not finite raises
    (scipy's check), alone or in a batch."""
    rdt = _real_dtype(GA.dtype)
    dev = GA.device
    k = GA.shape[-1]
    with span(SYNC_COPY):
        GA_h = GA.detach().cpu().numpy().reshape(-1, k, k)
    with span(SYNC_COPY):
        GB_h = GB.detach().cpu().numpy().reshape(-1, k, k)
    b = GA_h.shape[0]
    if need is None:
        need = [True] * b
    else:
        with span(SYNC_COPY):
            need = need.reshape(-1).tolist()
    cdt = np.result_type(GA_h.dtype, np.complex64)
    alpha = np.full((b, k), np.nan, dtype=cdt)
    beta = np.full((b, k), np.nan, dtype=cdt)
    VR = np.full((b, k, k), np.nan, dtype=GA_h.dtype)
    for i in range(b):
        if need[i]:
            alpha[i], beta[i], VR[i] = _qz_host(GA_h[i], GB_h[i])
    ok = torch.tensor(need, device=dev)
    lam = _sentinel_lambda(torch.from_numpy(alpha).to(dev),
                           torch.from_numpy(beta).to(dev), tiny, rdt)
    lam = torch.where(ok[..., None], lam, float("nan"))
    VR = torch.from_numpy(VR).to(dev)
    if GA.dim() == 2:
        return lam[0], VR[0], ok[0]
    return lam, VR, ok


def pencil_eig(
    GA, GB, *, method: str, tiny: float, live=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch: returns (lam [k] real, V [k,k] raw eigenvectors, ok 0-d
    bool — False means the solve failed and outputs are NaN)."""
    if method == "cholesky":
        return pencil_eig_cholesky(GA, GB, tiny, live)
    if method == "qz":
        return pencil_eig_qz(GA, GB, tiny)
    if method == "auto":
        lam_c, V_c, ok = pencil_eig_cholesky(GA, GB, tiny, live)
        if lanes.all_(ok):
            return lam_c, V_c, ok
        if GA.dim() == 2:
            return pencil_eig_qz(GA, GB, tiny)
        return lanes.select(ok, (lam_c, V_c, ok),
                            pencil_eig_qz(GA, GB, tiny, need=~ok))
    raise ValueError(f"unknown pencil method {method!r}")
