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

The Newton matrix H + C' D C + reg I (+ the stage blocks) is formed by
:func:`newton_matrix`: on a CUDA tensor in one pass by the hand-written
kernel ``csrc/newton_matrix.cu``, on a CPU tensor by the plain expression
:func:`newton_matrix_ref`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.ops.batched_chol import (LAUNCHES, _kernel_fn,
                                             spd_factor64, spd_solve64)
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


def newton_matrix_ref(H, C, dscale, reg, C_blk=None):
    """Plain torch version of the Newton matrix kernel:
    H + C' diag(dd) C + reg I, plus for each stage i of C_blk (B, Nb, rb,
    cb) its rows' C_blk' diag(db) C_blk at [32i, 32i + cb), where dscale
    (B, m_d + Nb rb) holds dd and then db."""
    B, n = H.shape[0], H.shape[-1]
    m_d = C.shape[1]
    eye_n = torch.eye(n, dtype=H.dtype, device=H.device)
    if C_blk is None:
        return H + (C.transpose(-1, -2) * dscale[:, None, :]) @ C \
            + reg * eye_n
    Nb, rb, cb = C_blk.shape[1:]
    bcols = const(("pdip_bcols", Nb, cb), lambda: (
        32 * np.arange(Nb))[:, None] + np.arange(cb)[None], H.device)
    dd, db = dscale[:, :m_d], dscale[:, m_d:].reshape(B, Nb, rb)
    M = H + (C.transpose(-1, -2) * dd[:, None, :]) @ C + reg * eye_n
    Bk = torch.einsum("bnrc,bnr,bnrd->bncd", C_blk, db, C_blk)
    M[:, bcols[:, :, None], bcols[:, None, :]] += Bk
    return M


# the kernel's tile of M: block row I of M holds its rows 64 I .. 64 I + 63
_NEWTON_TILE = 64


def _newton_rows(m_d: int, n: int, widths, device):
    """The kernel's rows of each block row I of M, concatenated, and where
    each block row's start: the rows of C that reach column 64 I, in C's
    order (block row I sums rows[level[I]:level[I + 1]]).  Without widths
    every row, in every block row."""
    K = -(-n // _NEWTON_TILE)

    def make():
        w = np.full(m_d, n) if widths is None else np.asarray(widths)
        lists = [np.flatnonzero(w > _NEWTON_TILE * i) for i in range(K)]
        return (np.concatenate(lists),
                np.cumsum([0] + [len(x) for x in lists]))

    key = ("newton_rows", m_d, n, widths)
    rows = const(key + ("rows",), lambda: make()[0], device, torch.int32)
    level = const(key + ("level",), lambda: make()[1], device, torch.int32)
    return rows, level


def _check_newton_matrix(H, C, dscale, C_blk=None, C_width=None):
    """Raise unless the Newton matrix kernel can take H (B, n, n), C
    (B, m_d, n), dscale (B, m_d [+ Nb rb]) and C_blk (B, Nb, rb, cb) or
    None: f32 or f64 alike, one device, contiguous rows, stage blocks that
    fit the kernel (cb <= 32, inside n), widths one per row of C within
    [0, n].  Returns the kernel's arguments up to the row order (pointers
    and strides in elements).  Whether the rows fit the kernel's shared
    memory its launcher tells, which owns the layout."""
    if H.dim() != 3 or H.shape[1] != H.shape[2] or C.dim() != 3 \
            or dscale.dim() != 2:
        raise ValueError(f"newton_matrix takes H (B, n, n), C (B, m_d, n) "
                         f"and dscale (B, m), got {tuple(H.shape)}, "
                         f"{tuple(C.shape)}, {tuple(dscale.shape)}")
    B, n = H.shape[0], H.shape[1]
    m_d = C.shape[1]
    Nb = rb = cb = 0
    if C_blk is not None:
        if C_blk.dim() != 4 or C_blk.shape[0] != B:
            raise ValueError(f"newton_matrix takes C_blk (B, Nb, rb, cb), "
                             f"got {tuple(C_blk.shape)}")
        Nb, rb, cb = C_blk.shape[1:]
        if cb > 32 or 32 * (Nb - 1) + cb > n:
            raise ValueError(f"newton_matrix: stage blocks "
                             f"{tuple(C_blk.shape)} do not fit n = {n}")
    if tuple(C.shape) != (B, m_d, n) \
            or tuple(dscale.shape) != (B, m_d + Nb * rb):
        raise ValueError(f"newton_matrix: C {tuple(C.shape)} and dscale "
                         f"{tuple(dscale.shape)} do not match H "
                         f"{tuple(H.shape)}")
    if C_width is not None and (len(C_width) != m_d or min(C_width) < 0
                                or max(C_width) > n):
        raise ValueError(f"newton_matrix: widths {C_width} do not fit "
                         f"{m_d} rows of width {n}")
    ts = (H, C, dscale) + (() if C_blk is None else (C_blk,))
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"newton_matrix kernel takes f32 or f64, got "
                        f"{H.dtype}")
    if any(t.dtype != H.dtype for t in ts):
        raise TypeError(f"newton_matrix: types "
                        f"{', '.join(str(t.dtype) for t in ts)} do not "
                        f"match")
    if any(t.device != H.device for t in ts):
        raise ValueError(f"newton_matrix: devices "
                         f"{', '.join(str(t.device) for t in ts)} do not "
                         f"match")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"newton_matrix kernel takes contiguous rows, got "
                         f"strides {', '.join(str(t.stride()) for t in ts)}")
    args = (H.data_ptr(), H.stride(0), H.stride(1),
            C.data_ptr(), C.stride(0), C.stride(1),
            dscale.data_ptr(), dscale.stride(0))
    if C_blk is None:
        return args + (None, 0, 0, 0)
    return args + (C_blk.data_ptr(), C_blk.stride(0), C_blk.stride(1),
                   C_blk.stride(2))


@spans.spanned("pdip.newton_matrix")
def newton_matrix(H, C, dscale, reg, C_blk=None, C_width=None):
    """The Newton matrix H + C' diag(dd) C + reg I + the stage blocks'
    C_blk' diag(db) C_blk (:func:`newton_matrix_ref`) of (B, n, n) H.  CPU
    tensors take the plain expression; CUDA tensors launch the kernel on the
    current stream, which rounds each element as the plain expression does
    (its sums row by row in C's order), or raise.  C_width (a tuple, one
    width per row of C, C exactly 0 at and past it) lets the kernel leave
    out the rows that are 0 on a tile, which changes no sum; without it
    every row is summed."""
    if H.device.type == "cpu":
        return newton_matrix_ref(H, C, dscale, reg, C_blk)
    if H.device.type != "cuda":
        raise RuntimeError(f"newton_matrix: no kernel for device "
                           f"{H.device}")
    args = _check_newton_matrix(H, C, dscale, C_blk, C_width)
    B, n = H.shape[0], H.shape[1]
    m_d = C.shape[1]
    Nb, rb, cb = (0, 0, 0) if C_blk is None else C_blk.shape[1:]
    rows, level = _newton_rows(m_d, n, C_width, H.device)
    M = H.new_empty(B, n, n)
    if B == 0:
        return M
    fn = _kernel_fn("newton_matrix", H.dtype)
    with torch.cuda.device(H.device):
        err = fn(*args, rows.data_ptr(), level.data_ptr(), M.data_ptr(),
                 M.stride(0), M.stride(1), float(reg), n, m_d, Nb, rb, cb, B,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"newton_matrix kernel launch failed: CUDA error "
                           f"{err} ({m_d} rows and stage blocks of {rb} "
                           f"rows at n = {n}, {H.dtype})")
    LAUNCHES["newton_matrix"] += 1
    return M


@spans.spanned("pdip.pdip_solve")
def pdip_solve(H, g, C, d, settings: PDIPSettings = PDIPSettings(),
               C_blk=None, d_blk=None, C_width=None) -> PDIPResult:
    """One batch of QP solves.  H (B, n, n), g (B, n), C (B, m_d, n),
    d (B, m_d); C_blk (B, Nb, rb, cb) / d_blk (B, Nb, rb): per-stage blocks
    touching coordinates [32i, 32i+cb) of v (rows ordered dense-first).
    C_width: the nonzero width of each row of C, where C has them by
    structure (:func:`newton_matrix`)."""
    B, n = g.shape
    m_d = C.shape[1]
    f32 = H.dtype == torch.float32

    if C_blk is not None:
        Nb, rb, cb = C_blk.shape[1:]
        m = m_d + Nb * rb

        def Cmv(v):
            vb = v[:, :32 * Nb].reshape(B, Nb, 32)[:, :, :cb]
            bv = torch.einsum("bnrc,bnc->bnr", C_blk, vb)
            return torch.cat([_mv(C, v), bv.reshape(B, -1)], dim=1)

        def CTmv(w):
            wd, wb = w[:, :m_d], w[:, m_d:].reshape(B, Nb, rb)
            blk = torch.einsum("bnrc,bnr->bnc", C_blk, wb)
            blk = F.pad(blk, (0, 32 - cb)).reshape(B, 32 * Nb)
            return _mtv(C, wd) + F.pad(blk, (0, n - 32 * Nb))

        d = torch.cat([d, d_blk.reshape(B, -1)], dim=1)
    else:
        m = m_d

        def Cmv(v):
            return _mv(C, v)

        def CTmv(w):
            return _mtv(C, w)

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
        M = newton_matrix(H, C, dscale, reg, C_blk, C_width)
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
