"""Dense primal-dual interior-point QP solver (Mehrotra), batched (port of
``cmpc_tpu.ops.pdip``).

Solves, per scenario b,  min 1/2 v'H_b v + g_b'v  s.t.  C_b v <= d_b
(plus the optional per-stage blocks C_blk/d_blk) with a fixed iteration
count, so every scenario runs in lockstep.  Every reduction — the cost
scale, mu, the fraction-to-boundary step and the non-finite guard — is
taken per scenario.  Each iteration takes the Newton matrix's blocked
factor once (:func:`batched_chol.spd_factor64`) and applies it to each
right-hand side by block substitution (:func:`batched_chol.spd_solve64`),
on every device and at every n; the CPU tests hold it to the JAX package's
explicit inverse.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.ops.batched_chol import spd_factor64, spd_solve64
from cmpc_tpu_torch.runtime import spans


class PDIPSettings(NamedTuple):
    """The JAX package's settings and defaults, less its two choices of
    Newton step (module docstring)."""
    iters: int = 15
    tau: float = 0.95          # fraction-to-boundary
    reg: float = 1e-8          # Newton-matrix diagonal regularization
    d_clip: float = 1e8        # clip on the complementarity scaling lam/w
    mu_min: float = 1e-9       # barrier floor
    refine: int = 2            # iterative-refinement passes per solve


class PDIPResult(NamedTuple):
    v: torch.Tensor        # (B, n) primal solution
    lam: torch.Tensor      # (B, m) inequality multipliers (>= 0)
    r_prim: torch.Tensor   # (B,) max(C v - d, 0) inf-norm
    r_dual: torch.Tensor   # (B,) ||H v + g + C' lam||_inf
    mu: torch.Tensor       # (B,) final complementarity measure


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


@spans.spanned("pdip.pdip_solve")
def pdip_solve(H, g, C, d, settings: PDIPSettings = PDIPSettings(),
               C_blk=None, d_blk=None) -> PDIPResult:
    """One batch of QP solves.  H (B, n, n), g (B, n), C (B, m_d, n),
    d (B, m_d); C_blk (B, Nb, rb, cb) / d_blk (B, Nb, rb): per-stage blocks
    touching coordinates [32i, 32i+cb) of v (rows ordered dense-first)."""
    B, n = g.shape
    m_d = C.shape[1]
    dt, dev = H.dtype, H.device
    f32 = dt == torch.float32
    eye_n = torch.eye(n, dtype=dt, device=dev)

    if C_blk is not None:
        Nb, rb, cb = C_blk.shape[1:]
        m = m_d + Nb * rb
        bcols = const(("pdip_bcols", Nb, cb), lambda: (
            32 * np.arange(Nb))[:, None] + np.arange(cb)[None], dev)

        def Cmv(v):
            vb = v[:, :32 * Nb].reshape(B, Nb, 32)[:, :, :cb]
            bv = torch.einsum("bnrc,bnc->bnr", C_blk, vb)
            return torch.cat([_mv(C, v), bv.reshape(B, -1)], dim=1)

        def CTmv(w):
            wd, wb = w[:, :m_d], w[:, m_d:].reshape(B, Nb, rb)
            blk = torch.einsum("bnrc,bnr->bnc", C_blk, wb)
            blk = F.pad(blk, (0, 32 - cb)).reshape(B, 32 * Nb)
            return _mtv(C, wd) + F.pad(blk, (0, n - 32 * Nb))

        def newton_matrix(dscale, reg):
            dd, db = dscale[:, :m_d], dscale[:, m_d:].reshape(B, Nb, rb)
            M = H + (C.transpose(-1, -2) * dd[:, None, :]) @ C + reg * eye_n
            Bk = torch.einsum("bnrc,bnr,bnrd->bncd", C_blk, db, C_blk)
            M[:, bcols[:, :, None], bcols[:, None, :]] += Bk
            return M

        d = torch.cat([d, d_blk.reshape(B, -1)], dim=1)
    else:
        m = m_d

        def Cmv(v):
            return _mv(C, v)

        def CTmv(w):
            return _mtv(C, w)

        def newton_matrix(dscale, reg):
            return H + (C.transpose(-1, -2) * dscale[:, None, :]) @ C \
                + reg * eye_n

    # cost scaling to O(1) duals (see the JAX module)
    cs = 1.0 / g.abs().amax(dim=1).clamp_min(1.0)              # (B,)
    H = H * cs[:, None, None]
    g = g * cs[:, None]

    # dtype-aware safeguards: f32 cannot factor a Newton matrix with the
    # 1e12 complementarity spread the f64 endgame reaches
    d_clip = min(settings.d_clip, 1e6) if f32 else settings.d_clip
    reg = max(settings.reg, 1e-7) if f32 else settings.reg
    mu_min = max(settings.mu_min, 1e-7) if f32 else settings.mu_min
    eps_pos = 1e-10 if f32 else 1e-14

    v = torch.zeros_like(g)
    w = d.clamp_min(1.0)                      # slack: C v + w = d
    lam = torch.ones_like(d)

    def alpha_to_boundary(x, dx, tau):
        """Per scenario: max step in [0,1] keeping x + a dx >= (1-tau) x."""
        a = torch.where(dx < 0, -tau * x / dx.clamp_max(-1e-30), 1.0)
        return a.amin(dim=1).clamp_max(1.0)

    for _ in range(settings.iters):
        r_d = _mv(H, v) + g + CTmv(lam)
        r_p = Cmv(v) + w - d
        mu = (w * lam).sum(1) / m

        dscale = torch.clamp(lam / w, 1e-12, d_clip)
        M = newton_matrix(dscale, reg)
        L, Dinv = spd_factor64(M)

        def newton(r_c):
            rhs = -r_d + CTmv((r_c - lam * r_p) / w)
            dv = spd_solve64(L, Dinv, rhs)
            for _ in range(settings.refine):
                dv = dv + spd_solve64(L, Dinv, rhs - _mv(M, dv))
            dw = -r_p - Cmv(dv)
            dlam = (-r_c - lam * dw) / w
            return dv, dw, dlam

        # predictor (affine scaling)
        dv_a, dw_a, dlam_a = newton(w * lam)
        a_p = alpha_to_boundary(w, dw_a, 1.0)
        a_d = alpha_to_boundary(lam, dlam_a, 1.0)
        mu_aff = ((w + a_p[:, None] * dw_a)
                  * (lam + a_d[:, None] * dlam_a)).sum(1) / m
        sigma = torch.clamp((mu_aff / mu.clamp_min(1e-30)) ** 3, 0.0, 1.0)

        # corrector
        mu_t = (sigma * mu).clamp_min(mu_min)
        r_c = w * lam + dw_a * dlam_a - mu_t[:, None]
        dv, dw, dlam = newton(r_c)

        a_p = alpha_to_boundary(w, dw, settings.tau)
        a_d = alpha_to_boundary(lam, dlam, settings.tau)
        # guarded update: a non-finite direction freezes the scenario's
        # (already converged) iterate instead of poisoning it
        ok = (torch.isfinite(dv).all(1) & torch.isfinite(dw).all(1)
              & torch.isfinite(dlam).all(1))
        if spans.enabled():
            spans.add("pdip.guarded", (~ok).sum())
            spans.add("pdip.steps", B)
        a_p = torch.where(ok, a_p, 0.0)
        a_d = torch.where(ok, a_d, 0.0)
        dv = torch.nan_to_num(dv)
        dw = torch.nan_to_num(dw)
        dlam = torch.nan_to_num(dlam)
        v = v + a_p[:, None] * dv
        w = (w + a_p[:, None] * dw).clamp_min(eps_pos)
        lam = (lam + a_d[:, None] * dlam).clamp_min(eps_pos)

    r_prim = (Cmv(v) - d).clamp_min(0.0).amax(dim=1)
    r_dual = (_mv(H, v) + g + CTmv(lam)).abs().amax(dim=1) / cs
    mu = (w * lam).sum(1) / m
    return PDIPResult(v=v, lam=lam / cs[:, None], r_prim=r_prim,
                      r_dual=r_dual, mu=mu)
