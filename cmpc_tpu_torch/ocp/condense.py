"""State elimination (condensing) of the centroidal MPC subproblem, batched
(port of ``cmpc_tpu.ocp.condense``).

At base point z = [vec(Xbar), vec(Ubar)] with Xbar = rollout(x0, Ubar), the
subproblem reduces to the input space, dX = E dU, and becomes a dense
inequality QP in v = [dU (32N), s (ns)]: min 1/2 v'Hv + g'v s.t. C v <= d.
The structured form (the solver's) keeps the friction/unilaterality rows
out of C as per-stage blocks C_blk v_stage <= d_blk and never builds the
dense Jacobian; the dense form (the default, as in the JAX package) builds
C whole from ``problem.linearize``.  See the JAX module for the reasoning
behind W_ELASTIC, SOFT_MARGIN and the row hygiene.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.ocp import problem
from cmpc_tpu_torch.runtime import spans

W_ELASTIC = 1e6
SOFT_MARGIN = 1e-2


class CondensedQP(NamedTuple):
    H: torch.Tensor          # (B, nv, nv)
    g: torch.Tensor          # (B, nv)
    C: torch.Tensor          # (B, mc, nv) one-sided rows C v <= d
    d: torch.Tensor          # (B, mc)
    E: torch.Tensor          # (B, 20*(N+1), 32*N)
    row_scale: torch.Tensor  # (B, mc)
    C_blk: torch.Tensor | None = None   # (B, N, 40, 24)
    d_blk: torch.Tensor | None = None   # (B, N, 40)
    C_width: tuple[int, ...] | None = None   # (mc,) dense_row_widths


def n_slack(cfg: WalkConfig) -> int:
    return cfg.N + 1          # N Lyapunov rows + 1 momentum row


@functools.lru_cache(maxsize=8)
def dense_row_widths(N: int, soft: bool) -> tuple[int, ...]:
    """Nonzero widths of the rows of C that :func:`build` gives with
    ``structured=True``: row r is exactly 0 at columns >= width r, since
    dx_0 = 0 makes the state of node i depend on the inputs of nodes < i
    alone.  In C's order: [soft rows (Lyapunov N, momentum 1) | hard rows |
    box | -box | slack rows], the slack rows only where `soft`; the soft
    and slack rows reach their slack column nU + k."""
    nU = 32 * N
    ns = N + 1 if soft else 0
    lyap = [32 * (i + 1) for i in range(N)]         # x_{i+1} and u_i
    mom = [32]                                      # x_1
    height = [32 * i for i in range(N)]             # x_i
    box = [32 * (k + 1) for k in range(N) for _ in range(3)]   # x_{k+1}
    G = lyap + mom + height + box + box
    n_box = 6 * N
    slack = [nU + k + 1 for k in range(ns)]
    return tuple(slack + G[ns:len(G) - n_box] + 2 * G[len(G) - n_box:]
                 + slack)


@functools.lru_cache(maxsize=8)
def _soft_row_index(N: int) -> np.ndarray:
    """(N, 11, 3) z-coordinates each (row, axis) 11-block touches:
    [p_{i+1}, v_{i+1}, theta_i, f_1..f_8 of stage i]."""
    nX = 20 * (N + 1)
    i_ = np.arange(N)
    ax = np.arange(3)
    vtx = 3 * np.arange(8)
    f_cols = (nX + 32 * i_)[:, None, None] + vtx[None, :, None] \
        + ax[None, None, :]
    return np.concatenate([
        (20 * (i_ + 1))[:, None, None] + ax[None, None, :],
        (20 * (i_ + 1) + 3)[:, None, None] + ax[None, None, :],
        (20 * i_ + 9)[:, None, None] + ax[None, None, :],
        f_cols,
    ], axis=1)


def soft_row_q(k1, m, psd: bool = True):
    """(B, 4, 4): the core of the Lyapunov/momentum rows' Hessian, set by
    the gain k1 and the mass m (B,) alone, projected onto the PSD cone by
    its eigendecomposition (psd=True).  On the card ``torch.linalg.eigh``
    makes the host wait for the device (its error check), so a solve
    computes this once and hands it to each :func:`build`, and a closed
    loop once for all its solves."""
    z = torch.zeros_like(k1)
    one = torch.ones_like(k1)
    Q = torch.stack([
        torch.stack([0.0 * k1, k1 ** 2 + 1.0, k1, k1 / m], -1),
        torch.stack([k1 ** 2 + 1.0, 2.0 * k1, one, 1.0 / m], -1),
        torch.stack([k1, one, z, z], -1),
        torch.stack([k1 / m, 1.0 / m, z, z], -1)], -2)        # (B,4,4)
    if not psd:
        return Q
    ew, EV = torch.linalg.eigh(Q)
    return (EV * ew.clamp_min(0.0)[:, None, :]) @ EV.transpose(-1, -2)


def soft_row_parts(lam_soft, params: problem.MPCParams, cfg: WalkConfig,
                   psd: bool = True, Qp=None):
    """(idx (N,11,3) numpy, Q11 (B,N,11,11), lam_mom (B,)): the
    lam-weighted, convexified Hessian of the Lyapunov/momentum rows in
    compact per-(row, axis) form (see the JAX soft_row_hessian docstring;
    this is the JAX package's _soft_row_impl, batched).  Qp: the
    :func:`soft_row_q` of `params`, where the caller has it."""
    N = cfg.N
    m = params.mass
    lam = lam_soft[:, :N]
    lam_mom = lam_soft[:, N]
    B = lam_soft.shape[0]
    if Qp is None:
        Qp = soft_row_q(params.k1, m, psd)

    gam8 = torch.cat([params.gamma_l[:, :N, None].expand(B, N, 4),
                      params.gamma_r[:, :N, None].expand(B, N, 4)],
                     dim=2) / m[:, None, None]                 # (B,N,8)
    T = lam_soft.new_zeros(B, N, 4, 11)
    T[:, :, 0, 0] = 1.0
    T[:, :, 1, 1] = 1.0
    T[:, :, 3, 2] = 1.0
    T[:, :, 2, 3:] = gam8
    Q11 = torch.einsum("bnpi,bpq,bnqj->bnij", T, Qp, T) \
        * lam[:, :, None, None]                                 # (B,N,11,11)
    return _soft_row_index(N), Q11, lam_mom


def soft_row_hessian(lam_soft, params: problem.MPCParams, cfg: WalkConfig,
                     psd: bool = True):
    """(B, n_z, n_z): the lam-weighted Hessian of the Lyapunov/momentum rows
    over z = [vec(X), vec(U)], convexified (psd=True) or exact (psd=False);
    :func:`soft_row_parts` scattered into a dense matrix (see the JAX
    module's docstring for the derivation)."""
    idx, Q11, lam_mom = soft_row_parts(lam_soft, params, cfg, psd)
    B, N = Q11.shape[:2]
    dev = lam_soft.device
    H = lam_soft.new_zeros(B, cfg.n_z, cfg.n_z)
    b = torch.arange(B, device=dev)[:, None, None, None]
    for k in range(3):
        ik = const(("soft_idx_axis", N, k), lambda k=k: idx[:, :, k], dev)
        H.index_put_((b, ik[None, :, :, None], ik[None, :, None, :]), Q11,
                     accumulate=True)
    hw1 = torch.arange(26, 29, device=dev)
    H[:, hw1, hw1] += 2.0 * lam_mom[:, None]
    return H


@functools.lru_cache(maxsize=8)
def _dynamics_index(N: int):
    """(rows, cols_x, cols_u) gathering -A_i (N, 20, 20) and -B_i
    (N, 20, 32) out of the dense Jacobian's dynamics rows."""
    nX = 20 * (N + 1)
    rows = 20 + 20 * np.arange(N)[:, None, None] + np.arange(20)[None, :, None]
    cols_x = (20 * np.arange(N))[:, None, None] + np.arange(20)[None, None]
    cols_u = (nX + 32 * np.arange(N))[:, None, None] \
        + np.arange(32)[None, None]
    return (rows, np.broadcast_to(cols_x, (N, 20, 20)).copy(),
            np.broadcast_to(cols_u, (N, 20, 32)).copy())


@functools.lru_cache(maxsize=8)
def _block_rows(mu: float):
    """(40, 24) stage block [fric_l(16), fric_r(16), fz_l(4), fz_r(4)] on
    the 24 stage force coordinates, before gating (numpy)."""
    Amu = problem._friction_matrix(mu)
    blkA = np.zeros((16, 12))
    v_i = np.repeat(np.arange(4), 4)
    k_i = np.tile(np.arange(4), 4)
    blkA[np.arange(16)[:, None], (3 * v_i)[:, None] + np.arange(3)[None]] = \
        Amu[k_i]
    blkZ = np.zeros((4, 12))
    blkZ[np.arange(4), 3 * np.arange(4) + 2] = -1.0
    z12, z4 = np.zeros((16, 12)), np.zeros((4, 12))
    return np.concatenate([
        np.concatenate([blkA, z12], axis=1),
        np.concatenate([z12, blkA], axis=1),
        np.concatenate([blkZ, z4], axis=1),
        np.concatenate([z4, blkZ], axis=1)], axis=0)


@spans.spanned("condense.build")
def build(z, params: problem.MPCParams, cfg: WalkConfig, prox, w_prox_u,
          lam_soft=None, soft: bool = True,
          structured: bool = False, soft_q=None) -> CondensedQP:
    """Condense the QP at base point z (B, n_z).

    prox: (B,) or float, proximal weight on dU with per-coordinate weights
    w_prox_u (nU,).  lam_soft (B, ns): Lyapunov/momentum multiplier
    estimates whose convexified constraint Hessian enters H.  structured:
    the friction/unilaterality rows as per-stage blocks (C_blk, d_blk) and
    no dense Jacobian; otherwise every row in C and C_blk = d_blk = None.
    soft_q: :func:`soft_row_q` of `params` (structured only), computed
    here where not given.  C_width: where structured, each row's nonzero
    width (:func:`dense_row_widths`), else None."""
    N = cfg.N
    nX = 20 * (N + 1)
    nU = 32 * N
    ns = n_slack(cfg) if soft else 0
    nv = nU + ns
    n_eq = 20 * (N + 1)
    B = z.shape[0]
    dt, dev = z.dtype, z.device

    l_all, u_all = problem.constraint_bounds(cfg)

    if structured:
        parts = problem.linearize_parts(z, params, cfg)
        c = parts.c
        A_blk, B_blk = parts.A_blk, parts.B_blk
    else:
        # linearize() writes the dynamics rows as [+I at x_{i+1}] - A_i -
        # B_i: A_i and B_i come back out of J with a sign flip
        c, J = problem.linearize(z, params, cfg)
        rows, cols_x, cols_u = (const(("dyn_idx", N, k), lambda a=a: a, dev)
                                for k, a in enumerate(_dynamics_index(N)))
        A_blk = -J[:, rows, cols_x]                           # (B,N,20,20)
        B_blk = -J[:, rows, cols_u]                           # (B,N,20,32)

    # sensitivity E: dx_{i+1} = A_i dx_i + B_i du_i, dx_0 = 0
    E_rows = [z.new_zeros(B, 20, nU)]
    for i in range(N):
        Ei = A_blk[:, i] @ E_rows[i]
        Ei[:, :, 32 * i:32 * (i + 1)] += B_blk[:, i]
        E_rows.append(Ei)
    E = torch.cat(E_rows, dim=1)                              # (B, nX, nU)

    Et = E.transpose(-1, -2)
    if structured:
        dX_diag, Puu_c, q = problem.cost_quadratic_parts(params, cfg)
        gz_X = dX_diag * z[:, :nX] + q[:, :nX]
        gz_U = (Puu_c @ z[:, nX:, None])[..., 0] + q[:, nX:]
        Hc = Et @ (dX_diag[:, :, None] * E) + Puu_c
        if lam_soft is not None:
            idx, Q11, lam_mom = soft_row_parts(lam_soft, params, cfg,
                                               Qp=soft_q)
            SE = torch.cat([E, torch.eye(nU, dtype=dt, device=dev)
                            .expand(B, nU, nU)], dim=1)
            R = SE[:, const(("soft_idx", N), lambda: idx.reshape(-1), dev)] \
                .reshape(B, N, 11, 3, nU)
            Y = torch.einsum("bnij,bnjkc->bnikc", Q11, R)
            Hc = Hc + torch.einsum("bnika,bnikc->bac", R, Y)
            E_hw1 = E[:, 26:29]                               # (B, 3, nU)
            Hc = Hc + 2.0 * lam_mom[:, None, None] \
                * (E_hw1.transpose(-1, -2) @ E_hw1)
    else:
        P, q = problem.cost_quadratic(params, cfg)
        gz = (P @ z[..., None])[..., 0] + q
        PH = P if lam_soft is None else P + soft_row_hessian(
            lam_soft, params, cfg)
        Pxx, Pxu = PH[:, :nX, :nX], PH[:, :nX, nX:]
        Puu = PH[:, nX:, nX:]
        Hc = Et @ (Pxx @ E) + Et @ Pxu + Pxu.transpose(-1, -2) @ E + Puu
        gz_X, gz_U = gz[:, :nX], gz[:, nX:]
    prox = torch.as_tensor(prox, dtype=dt, device=dev)
    if prox.dim() == 0:
        prox = prox.expand(B)
    w_prox_u = torch.as_tensor(w_prox_u, dtype=dt, device=dev)
    Hc = Hc + prox[:, None, None] * torch.diag_embed(
        w_prox_u.expand(B, nU))
    gc = (Et @ gz_X[:, :, None])[..., 0] + gz_U

    H = z.new_zeros(B, nv, nv)
    H[:, :nU, :nU] = Hc
    ar = torch.arange(nU, nv, device=dev)
    H[:, ar, ar] += 1.0
    g = torch.cat([gc, z.new_full((B, ns), W_ELASTIC)], dim=1)

    if structured:
        # dense rows [lyap(N), mom(1), height(N), box(6N)]; the friction and
        # unilaterality rows become per-stage (40, 24) blocks
        f0_rel = 2 * N + 1
        b0_rel = f0_rel + 40 * N
        sel = np.concatenate([np.arange(f0_rel), b0_rel + np.arange(6 * N)])
        c_in = c[:, n_eq:][:, const(("dense_sel", N), lambda: sel, dev)]
        lo = const(("dense_lo", cfg), lambda: l_all[n_eq:][sel], dev, dt)
        hi = const(("dense_hi", cfg), lambda: u_all[n_eq:][sel], dev, dt)
        Er = E.reshape(B, N + 1, 20, nU)
        G_ly = torch.einsum("bnk,bnkj->bnj", parts.gx, Er[:, :N]) \
            + torch.einsum("bnk,bnkj->bnj", parts.gxn, Er[:, 1:])
        G_ly = G_ly.reshape(B, N, N, 32)
        G_ly[:, torch.arange(N, device=dev), torch.arange(N, device=dev)] += \
            parts.gu
        G_ly = G_ly.reshape(B, N, nU)
        G_mom = (parts.hw1[:, None, :] @ E[:, 26:29])          # (B, 1, nU)
        G_h = E[:, const(("rows_h", N), lambda: 20 * np.arange(N) + 2, dev)]
        rows_bl = (20 * (np.arange(N) + 1))[:, None] + 13 + np.arange(3)
        G_bl = E[:, const(("rows_bl", N), lambda: rows_bl.reshape(-1), dev)] \
            * params.gamma_l[:, 1:].repeat_interleave(3, dim=1)[:, :, None]
        G_br = E[:, const(("rows_br", N), lambda: (rows_bl + 4).reshape(-1),
                          dev)] \
            * params.gamma_r[:, 1:].repeat_interleave(3, dim=1)[:, :, None]
        G = torch.cat([G_ly, G_mom, G_h, G_bl, G_br], dim=1)

        W1 = const(("block_rows", cfg.mu), lambda: _block_rows(cfg.mu), dev,
                   dt)
        gl_n, gr_n = params.gamma_l[:, :N, None], params.gamma_r[:, :N, None]
        gate = torch.cat([gl_n.expand(B, N, 16), gr_n.expand(B, N, 16),
                          gl_n.expand(B, N, 4), gr_n.expand(B, N, 4)], dim=2)
        W = W1 * gate[..., None]                              # (B,N,40,24)
        cf = c[:, n_eq + f0_rel:n_eq + b0_rel]
        c_blk = torch.cat([
            cf[:, :16 * N].reshape(B, N, 16),
            cf[:, 16 * N:32 * N].reshape(B, N, 16),
            cf[:, 32 * N:36 * N].reshape(B, N, 4),
            cf[:, 36 * N:].reshape(B, N, 4)], dim=2)          # (B,N,40)
        d_blk = -c_blk
        rn_b = W.abs().amax(dim=3)
        vac_b = rn_b < 1e-9
        sc_b = torch.where(vac_b, 1.0, 1.0 / rn_b.clamp_min(1e-2))
        W = W * sc_b[..., None]
        d_blk = torch.where(vac_b, 1.0, d_blk * sc_b)
        fac_b = torch.clamp(10.0 / d_blk.abs().clamp_min(1e-12), max=1.0)
        W = W * fac_b[..., None]
        d_blk = d_blk * fac_b
    else:
        J_in = J[:, n_eq:]
        c_in = c[:, n_eq:]
        lo = const(("ineq_lo", cfg), lambda: l_all[n_eq:], dev, dt)
        hi = const(("ineq_hi", cfg), lambda: u_all[n_eq:], dev, dt)
        W = d_blk = None
        G = J_in[:, :, :nX] @ E + J_in[:, :, nX:]             # (B,m_in,nU)

    # Lyapunov rows get the tightening margin; the momentum row does not
    hi = hi.clone()
    hi[:N] -= SOFT_MARGIN
    n_soft = ns
    n_box = 6 * N
    n_hard = G.shape[1] - n_soft - n_box

    C_rows, d_rows = [], []
    if soft:
        S_soft = -torch.eye(ns, dtype=dt, device=dev).expand(B, ns, ns)
        C_rows.append(torch.cat([G[:, :n_soft], S_soft], dim=2))
        d_rows.append(hi[:n_soft] - c_in[:, :n_soft])
    C_rows.append(torch.cat([G[:, n_soft:n_soft + n_hard],
                             z.new_zeros(B, n_hard, ns)], dim=2))
    d_rows.append(hi[n_soft:n_soft + n_hard]
                  - c_in[:, n_soft:n_soft + n_hard])
    Gb = G[:, n_soft + n_hard:]
    cb = c_in[:, n_soft + n_hard:]
    zb = z.new_zeros(B, n_box, ns)
    C_rows.append(torch.cat([Gb, zb], dim=2))
    d_rows.append(hi[n_soft + n_hard:] - cb)
    C_rows.append(torch.cat([-Gb, zb], dim=2))
    d_rows.append(cb - lo[n_soft + n_hard:])
    C_rows.append(torch.cat([z.new_zeros(B, ns, nU),
                             -torch.eye(ns, dtype=dt, device=dev)
                             .expand(B, ns, ns)], dim=2))
    d_rows.append(z.new_zeros(B, ns))

    C = torch.cat(C_rows, dim=1)
    d = torch.cat(d_rows, dim=1)

    # row hygiene: equilibrate, neutralize vanished rows, cap huge margins
    rn = C.abs().amax(dim=2)
    vac = rn < 1e-9
    scale = torch.where(vac, 1.0, 1.0 / rn.clamp_min(1e-2))
    C = C * scale[..., None]
    d = torch.where(vac, 1.0, d * scale)
    D_CAP = 10.0
    fac = torch.clamp(D_CAP / d.abs().clamp_min(1e-12), max=1.0)
    C = C * fac[..., None]
    d = d * fac
    return CondensedQP(H=H, g=g, C=C, d=d, E=E, row_scale=scale * fac,
                       C_blk=W, d_blk=d_blk,
                       C_width=dense_row_widths(N, soft) if structured
                       else None)
