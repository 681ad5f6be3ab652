"""The centroidal MPC optimal-control problem, batched (port of
``cmpc_tpu.ocp.problem``).

Decision vector z (B, n_z), n_z = 20*(N+1) + 32*N: [vec(X), vec(U)],
X node-major.  Every function here takes batch-first tensors and
per-scenario :class:`MPCParams`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.models import centroidal as cm

W_HW = 1000.0
W_XY = 1.0
W_FOOT = 1000.0
W_SHARE = 10.0
W_SWING = 10.0
W_COM_Z0 = 2000.0


class MPCParams(NamedTuple):
    """Per-solve parameters, each with a leading batch axis."""

    x0: torch.Tensor         # (B, 20)
    com_ref: torch.Tensor    # (B, N, 9)
    pos_ref_l: torch.Tensor  # (B, N, 3)
    pos_ref_r: torch.Tensor  # (B, N, 3)
    yaw_ref_l: torch.Tensor  # (B, N)
    yaw_ref_r: torch.Tensor  # (B, N)
    gamma_l: torch.Tensor    # (B, N+1)
    gamma_r: torch.Tensor    # (B, N+1)
    k1: torch.Tensor         # (B,)
    k2: torch.Tensor         # (B,)
    mass: torch.Tensor       # (B,)


def _wz(cfg: WalkConfig) -> np.ndarray:
    """CoM z tracking weight schedule (:301-305)."""
    i = np.arange(cfg.N)
    wmin = W_COM_Z0 / 2.0
    return (W_COM_Z0 - wmin) * np.exp(-i) + wmin


def _wf_rate(cfg: WalkConfig) -> float:
    return 0.0 if cfg.mpc_rate == 10 else 1.0


def _wz_t(cfg: WalkConfig, like):
    return const(("wz", cfg.N), lambda: _wz(cfg), like.device, like.dtype)


def split_z(z, cfg: WalkConfig):
    nX = cm.N_X * (cfg.N + 1)
    lead = z.shape[:-1]
    X = z[..., :nX].reshape(*lead, cfg.N + 1, cm.N_X)
    U = z[..., nX:].reshape(*lead, cfg.N, cm.N_U)
    return X, U


def join_z(X, U):
    lead = X.shape[:-2]
    return torch.cat([X.reshape(*lead, -1), U.reshape(*lead, -1)], dim=-1)


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

def cost_value(z, p: MPCParams, cfg: WalkConfig):
    """The cost sum (:309-351), one value per scenario: (B,)."""
    X, U = split_z(z, cfg)
    N = cfg.N
    B = z.shape[0]
    gl, gr = p.gamma_l, p.gamma_r
    wz = _wz_t(cfg, z)

    def ssum(a):
        return a.reshape(B, -1).sum(-1)

    c = W_HW * ssum(X[:, :N, cm.H_W] ** 2)
    dcom = X[:, 1:, cm.P_COM] - p.com_ref[:, :, 0:3]
    c = c + W_XY * ssum(dcom[:, :, 0] ** 2) + W_XY * ssum(dcom[:, :, 1] ** 2)
    c = c + ssum(wz * dcom[:, :, 2] ** 2)
    c = c + W_FOOT * ssum(((X[:, 1:, cm.POS_L] - p.pos_ref_l)
                           * gl[:, 1:, None]) ** 2)
    c = c + W_FOOT * ssum(((X[:, 1:, cm.POS_R] - p.pos_ref_r)
                           * gr[:, 1:, None]) ** 2)
    c = c + W_FOOT * ssum(((X[:, 1:, cm.PSI_L] - p.yaw_ref_l)
                           * gl[:, 1:]) ** 2)
    c = c + W_FOOT * ssum(((X[:, 1:, cm.PSI_R] - p.yaw_ref_r)
                           * gr[:, 1:]) ** 2)

    fl = U[:, :, 0:12].reshape(B, N, 4, 3)
    fr = U[:, :, 12:24].reshape(B, N, 4, 3)
    avg_l = fl.sum(2) * (gl[:, :N, None] ** 2) / 4.0
    avg_r = fr.sum(2) * (gr[:, :N, None] ** 2) / 4.0
    c = c + W_SHARE * ssum(((avg_l[:, :, None, :] - fl) ** 2)
                           * gl[:, :N, None, None])
    c = c + W_SHARE * ssum(((avg_r[:, :, None, :] - fr) ** 2)
                           * gr[:, :N, None, None])
    c = c + W_SWING * ssum((fl ** 2) * (1.0 - gl[:, :N, None, None]))
    c = c + W_SWING * ssum((fr ** 2) * (1.0 - gr[:, :N, None, None]))

    wf = _wf_rate(cfg)
    dfl = torch.diff(fl[..., 2], dim=1)
    dfr = torch.diff(fr[..., 2], dim=1)
    c = c + wf * ssum((dfl ** 2) * gl[:, :N - 1, None])
    c = c + wf * ssum((dfr ** 2) * gr[:, :N - 1, None])
    return c


@functools.lru_cache(maxsize=8)
def _force_block_index(N: int):
    """idx[i, foot, v, a] = 32 i + 12 foot + 3 v + a, within U coords."""
    stage_base = 32 * np.arange(N)
    vtx = 3 * np.arange(4)
    axes = np.arange(3)
    idx_l = (stage_base[:, None, None] + vtx[None, :, None]
             + axes[None, None, :])                          # (N,4,3)
    return idx_l, idx_l + 12


def cost_quadratic_parts(p: MPCParams, cfg: WalkConfig):
    """The exact cost Hessian/gradient in block form: (dX_diag (B, nX),
    Puu (B, nU, nU), q (B, n_z)) with P = blockdiag(diag(dX_diag), Puu)."""
    N = cfg.N
    nU = cm.N_U * N
    gl, gr = p.gamma_l, p.gamma_r
    B = gl.shape[0]
    like = p.x0
    wz = _wz_t(cfg, like)

    dX = torch.zeros(B, N + 1, cm.N_X, dtype=like.dtype, device=like.device)
    dX[:, 1:, 0] = 2 * W_XY
    dX[:, 1:, 1] = 2 * W_XY
    dX[:, 1:, 2] = 2 * wz
    dX[:, :N, cm.H_W] = 2 * W_HW
    dX[:, 1:, cm.POS_L] = 2 * W_FOOT * (gl[:, 1:, None] ** 2)
    dX[:, 1:, cm.PSI_L] = 2 * W_FOOT * (gl[:, 1:] ** 2)
    dX[:, 1:, cm.POS_R] = 2 * W_FOOT * (gr[:, 1:, None] ** 2)
    dX[:, 1:, cm.PSI_R] = 2 * W_FOOT * (gr[:, 1:] ** 2)

    eye4 = torch.eye(4, dtype=like.dtype, device=like.device)
    ones4 = torch.ones(4, 4, dtype=like.dtype, device=like.device)

    def fblock(g):  # (B, N) gates -> (B, N, 4, 4)
        g = g[..., None, None]
        M = eye4 - (g ** 2 / 4.0) * ones4
        return 2 * W_SHARE * g * (M.transpose(-1, -2) @ M) \
            + 2 * W_SWING * (1 - g) * eye4

    bl = fblock(gl[:, :N])
    br = fblock(gr[:, :N])

    Puu = torch.zeros(B, nU, nU, dtype=like.dtype, device=like.device)
    idx_l, idx_r = _force_block_index(N)
    dev = like.device
    for foot_idx, blocks in ((idx_l, bl), (idx_r, br)):
        for a in range(3):
            rows = const(("fblk", N, int(foot_idx[0, 0, 0]), a),
                         lambda: foot_idx[:, :, a], dev)            # (N,4)
            Puu[:, rows[:, :, None], rows[:, None, :]] += blocks

    wf = _wf_rate(cfg)
    if wf != 0.0 and N > 1:
        for zcols, g in ((idx_l[:, :, 2], gl), (idx_r[:, :, 2], gr)):
            gi = g[:, :N - 1, None].expand(B, N - 1, 4)
            a_ = const(("zrate0", N, int(zcols[0, 0])),
                       lambda: zcols[:-1], dev)
            b_ = const(("zrate1", N, int(zcols[0, 0])),
                       lambda: zcols[1:], dev)
            Puu[:, a_, a_] += 2 * wf * gi
            Puu[:, b_, b_] += 2 * wf * gi
            Puu[:, a_, b_] += -2 * wf * gi
            Puu[:, b_, a_] += -2 * wf * gi

    qX = torch.zeros_like(dX)
    qX[:, 1:, 0] = -2 * W_XY * p.com_ref[:, :, 0]
    qX[:, 1:, 1] = -2 * W_XY * p.com_ref[:, :, 1]
    qX[:, 1:, 2] = -2 * wz * p.com_ref[:, :, 2]
    qX[:, 1:, cm.POS_L] = -2 * W_FOOT * (gl[:, 1:, None] ** 2) * p.pos_ref_l
    qX[:, 1:, cm.PSI_L] = -2 * W_FOOT * (gl[:, 1:] ** 2) * p.yaw_ref_l
    qX[:, 1:, cm.POS_R] = -2 * W_FOOT * (gr[:, 1:, None] ** 2) * p.pos_ref_r
    qX[:, 1:, cm.PSI_R] = -2 * W_FOOT * (gr[:, 1:] ** 2) * p.yaw_ref_r
    q = torch.cat([qX.reshape(B, -1), qX.new_zeros(B, nU)], dim=1)
    return dX.reshape(B, -1), Puu, q


def cost_quadratic(p: MPCParams, cfg: WalkConfig):
    """Exact dense (P (B, n_z, n_z), q (B, n_z)) with
    cost(z) = 1/2 z^T P z + q^T z + const, assembled from
    :func:`cost_quadratic_parts` (the ADMM path consumes the dense form;
    the condensing path uses the parts directly)."""
    dX_diag, Puu, q = cost_quadratic_parts(p, cfg)
    nX = dX_diag.shape[1]
    P = q.new_zeros(q.shape[0], cfg.n_z, cfg.n_z)
    P.diagonal(dim1=1, dim2=2)[:, :nX] = dX_diag
    P[:, nX:, nX:] = Puu
    return P, q


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------

def _friction_matrix(mu: float):
    """Pyramid rows A f <= 0 (centroidal_mpc_vertices.py:44-48)."""
    return np.array([[1, 0, -mu], [-1, 0, -mu],
                     [0, 1, -mu], [0, -1, -mu]], dtype=np.float64)


def _polygon(cfg: WalkConfig, like):
    return cm.foot_polygon(cfg.foot_length, cfg.foot_width,
                           device=like.device, dtype=like.dtype)


def _lyap_rows(X, U, p: MPCParams, cfg: WalkConfig):
    """Lyapunov decrease rows (:217-220), (B, N)."""
    N = cfg.N
    B = X.shape[0]
    gl, gr = p.gamma_l, p.gamma_r
    k1, k2, m = p.k1[:, None, None], p.k2[:, None, None], p.mass[:, None, None]
    z1 = X[:, 1:, cm.P_COM] - p.com_ref[:, :, 0:3]
    z2 = k1 * z1 + (X[:, 1:, cm.V_COM] - p.com_ref[:, :, 3:6])
    fl = U[:, :, 0:12].reshape(B, N, 4, 3)
    fr = U[:, :, 12:24].reshape(B, N, 4, 3)
    Vl = fl.sum(2) * gl[:, :N, None] / m
    Vr = fr.sum(2) * gr[:, :N, None] / m
    gravity = cm.gravity_vector(cfg.g, X)
    u_n = (-(k1 + k2) * z2 + k1 ** 2 * z1 - gravity
           + p.com_ref[:, :, 6:9] - X[:, :N, cm.THETA] / m)
    return (-k1[..., 0] * torch.sum(z1 * z1, -1)
            - k2[..., 0] * torch.sum(z2 * z2, -1)
            + torch.sum(z1 * z2, -1) + torch.sum(z2 * (Vl + Vr - u_n), -1))


def constraints(z, p: MPCParams, cfg: WalkConfig):
    """Stacked constraint values c(z), (B, m), bounded by
    :func:`constraint_bounds`.  Row order: [init(20), dynamics(20N),
    lyapunov(N), momentum(1), height(N), friction_l(16N), friction_r(16N),
    fz_l(4N), fz_r(4N), box_l(3N), box_r(3N)]."""
    X, U = split_z(z, cfg)
    N = cfg.N
    B = z.shape[0]
    gl, gr = p.gamma_l, p.gamma_r
    polygon = _polygon(cfg, z)

    init = X[:, 0] - p.x0
    step = cm.euler_step(X[:, :-1], p.com_ref, gl[:, :N], gr[:, :N], U,
                         p.k1[:, None], p.k2[:, None], p.mass[:, None],
                         cfg.g, polygon, cfg.delta)
    dyn = (X[:, 1:] - step).reshape(B, -1)

    lyap = _lyap_rows(X, U, p, cfg)
    mom = (torch.sum(X[:, 1, cm.H_W] ** 2, -1)
           - torch.sum(X[:, 0, cm.H_W] ** 2, -1))[:, None]
    height = X[:, :N, 2] - cfg.com_z_max

    fl = U[:, :, 0:12].reshape(B, N, 4, 3)
    fr = U[:, :, 12:24].reshape(B, N, 4, 3)
    A = const(("friction", cfg.mu), lambda: _friction_matrix(cfg.mu),
              z.device, z.dtype)
    fric_l = (torch.einsum("kc,bnvc->bnvk", A, fl)
              * gl[:, :N, None, None]).reshape(B, -1)
    fric_r = (torch.einsum("kc,bnvc->bnvk", A, fr)
              * gr[:, :N, None, None]).reshape(B, -1)
    fz_l = (-fl[..., 2] * gl[:, :N, None]).reshape(B, -1)
    fz_r = (-fr[..., 2] * gr[:, :N, None]).reshape(B, -1)

    box_l = ((X[:, 1:, cm.POS_L] - p.pos_ref_l) * gl[:, 1:, None]) \
        .reshape(B, -1)
    box_r = ((X[:, 1:, cm.POS_R] - p.pos_ref_r) * gr[:, 1:, None]) \
        .reshape(B, -1)

    return torch.cat([init, dyn, lyap, mom, height, fric_l, fric_r,
                      fz_l, fz_r, box_l, box_r], dim=1)


class LinearizeParts(NamedTuple):
    """Per-block constraint linearization (see
    ``cmpc_tpu.ocp.problem.LinearizeParts``), batch-first."""

    c: torch.Tensor       # (B, m)
    A_blk: torch.Tensor   # (B, N, 20, 20) d step / d x_i
    B_blk: torch.Tensor   # (B, N, 20, 32) d step / d u_i
    gx: torch.Tensor      # (B, N, 20) lyap row grad wrt x_i
    gxn: torch.Tensor     # (B, N, 20) lyap row grad wrt x_{i+1}
    gu: torch.Tensor      # (B, N, 32) lyap row grad wrt u_i
    hw0: torch.Tensor     # (B, 3)
    hw1: torch.Tensor     # (B, 3)


def _skew(a):
    """[a]_x with [a]_x b = a x b; a (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(a[..., 0])
    a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2]
    return torch.stack([torch.stack([z, -a3, a2], -1),
                        torch.stack([a3, z, -a1], -1),
                        torch.stack([-a2, a1, z], -1)], -2)


def linearize_parts(z, p: MPCParams, cfg: WalkConfig) -> LinearizeParts:
    """Constraint values plus the per-stage Jacobian blocks of the Euler
    step and the Lyapunov-row gradients, derived by hand (the JAX package
    forms them with jax.vmap(jax.jacfwd) / jax.vmap(jax.grad);
    tests/test_torch_functions.py holds them equal in f64)."""
    X, U = split_z(z, cfg)
    N = cfg.N
    B = z.shape[0]
    dt, dev = z.dtype, z.device
    polygon = _polygon(cfg, z)
    delta = cfg.delta
    c = constraints(z, p, cfg)

    Xs = X[:, :-1]                                       # (B, N, 20)
    gl, gr = p.gamma_l[:, :N, None, None], p.gamma_r[:, :N, None, None]
    # per-scenario scalars shaped for (B, N, 3) vectors and (B, N, r, c)
    # matrix blocks
    k1, k2, m = p.k1[:, None, None], p.k2[:, None, None], p.mass[:, None, None]
    k1m, mm = k1[..., None], m[..., None]
    fl = U[..., 0:12].reshape(B, N, 4, 3)
    fr = U[..., 12:24].reshape(B, N, 4, 3)
    Fl, Fr = fl.sum(-2), fr.sum(-2)
    pc = Xs[..., cm.P_COM]
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def foot_terms(psi, pos):
        """(vertices - p_com, d vertices / d yaw), each (B, N, 4, 3)."""
        verts = cm.foot_vertices(pos, psi, polygon)
        cs, sn = torch.cos(psi)[..., None], torch.sin(psi)[..., None]
        vx, vy = polygon[:, 0], polygon[:, 1]
        dyaw = torch.stack([-sn * vx - cs * vy, cs * vx - sn * vy,
                            torch.zeros_like(cs * vx)], -1)
        return verts - pc[..., None, :], dyaw

    a_l, r_l = foot_terms(Xs[..., cm.PSI_L], Xs[..., cm.POS_L])
    a_r, r_r = foot_terms(Xs[..., cm.PSI_R], Xs[..., cm.POS_R])

    # d f / d x (continuous-time), nonzero blocks only
    Jx = z.new_zeros(B, N, 20, 20)
    Jx[..., 0:3, 3:6] = eye3
    Jx[..., 6:9, 0:3] = gl * _skew(Fl) + gr * _skew(Fr)
    Jx[..., 6:9, cm.PSI_L] = gl[..., 0] * torch.linalg.cross(
        r_l, fl, dim=-1).sum(-2)
    Jx[..., 6:9, cm.POS_L] = -gl * _skew(Fl)
    Jx[..., 6:9, cm.PSI_R] = gr[..., 0] * torch.linalg.cross(
        r_r, fr, dim=-1).sum(-2)
    Jx[..., 6:9, cm.POS_R] = -gr * _skew(Fr)
    Jx[..., 9:12, 0:3] = (k1m / mm) * eye3
    Jx[..., 9:12, 3:6] = (1.0 / mm) * eye3
    A_blk = torch.eye(20, dtype=dt, device=dev) + delta * Jx

    # d f / d u
    Ju = z.new_zeros(B, N, 20, 32)
    Ju[..., 3:6, 0:12] = (gl / mm) * eye3.repeat(1, 4)
    Ju[..., 3:6, 12:24] = (gr / mm) * eye3.repeat(1, 4)
    Ju[..., 6:9, 0:12] = torch.cat(
        [gl * _skew(a_l[..., v, :]) for v in range(4)], dim=-1)
    Ju[..., 6:9, 12:24] = torch.cat(
        [gr * _skew(a_r[..., v, :]) for v in range(4)], dim=-1)
    Ju[..., cm.PSI_L, 30] = 1.0 - gl[..., 0, 0]
    Ju[..., cm.POS_L, 24:27] = (1.0 - gl) * eye3
    Ju[..., cm.PSI_R, 31] = 1.0 - gr[..., 0, 0]
    Ju[..., cm.POS_R, 27:30] = (1.0 - gr) * eye3
    B_blk = delta * Ju

    # Lyapunov row l = -k1|z1|^2 - k2|z2|^2 + z1.z2 + z2.(V - u_n) with
    # z1 = p_{i+1} - ref_p, z2 = k1 z1 + v_{i+1} - ref_v,
    # V = (g_l F_l + g_r F_r)/m, u_n = -(k1+k2) z2 + k1^2 z1 + const
    #     - theta_i/m
    gl1, gr1 = gl[..., 0], gr[..., 0]                    # (B, N, 1)
    ref = p.com_ref
    z1 = X[:, 1:, cm.P_COM] - ref[..., 0:3]
    z2 = k1 * z1 + (X[:, 1:, cm.V_COM] - ref[..., 3:6])
    V = (Fl * gl1 + Fr * gr1) / m
    grav = cm.gravity_vector(cfg.g, z)
    u_n = (-(k1 + k2) * z2 + k1 ** 2 * z1 - grav + ref[..., 6:9]
           - Xs[..., cm.THETA] / m)
    d1 = -2.0 * k1 * z1 + z2 - k1 ** 2 * z2               # d l / d z1
    d2 = -2.0 * k2 * z2 + z1 + (V - u_n) + (k1 + k2) * z2  # d l / d z2
    gxn = z.new_zeros(B, N, 20)
    gxn[..., cm.P_COM] = d1 + k1 * d2
    gxn[..., cm.V_COM] = d2
    gx = z.new_zeros(B, N, 20)
    gx[..., cm.THETA] = z2 / m
    gu = z.new_zeros(B, N, 32)
    gu[..., 0:12] = (z2 * gl1 / m).repeat(1, 1, 4)
    gu[..., 12:24] = (z2 * gr1 / m).repeat(1, 1, 4)

    return LinearizeParts(c=c, A_blk=A_blk, B_blk=B_blk, gx=gx, gxn=gxn,
                          gu=gu, hw0=-2.0 * X[:, 0, cm.H_W],
                          hw1=2.0 * X[:, 1, cm.H_W])


@functools.lru_cache(maxsize=8)
def _jacobian_index(N: int) -> dict:
    """Static (row, column) index arrays of the dense constraint Jacobian's
    blocks, by row family."""
    nX = cm.N_X * (N + 1)
    n_eq = 20 * (N + 1)
    st = np.arange(N)
    idx = {}
    rows_dyn = 20 + 20 * st[:, None] + np.arange(20)[None, :]      # (N,20)
    idx["dyn_x"] = (rows_dyn[:, :, None],
                    (20 * st)[:, None, None] + np.arange(20)[None, None])
    idx["dyn_u"] = (rows_dyn[:, :, None],
                    (nX + 32 * st)[:, None, None] + np.arange(32)[None, None])
    rows_ly = (n_eq + st)[:, None]
    idx["ly_x"] = (rows_ly, (20 * st)[:, None] + np.arange(20)[None])
    idx["ly_xn"] = (rows_ly, (20 * (st + 1))[:, None] + np.arange(20)[None])
    idx["ly_u"] = (rows_ly, (nX + 32 * st)[:, None] + np.arange(32)[None])
    idx["height"] = (n_eq + N + 1 + st, 20 * st + 2)
    f0 = n_eq + 2 * N + 1
    i_, v_ = st[:, None, None, None], np.arange(4)[None, :, None, None]
    k_, c_ = np.arange(4)[None, None, :, None], np.arange(3)[None, None, None]
    rows_fr = np.broadcast_to(f0 + 16 * i_ + 4 * v_ + k_, (N, 4, 4, 3))
    cols_l = np.broadcast_to(nX + 32 * i_ + 3 * v_ + c_, (N, 4, 4, 3))
    idx["fric_l"] = (rows_fr, cols_l)
    idx["fric_r"] = (rows_fr + 16 * N, cols_l + 12)
    z0 = f0 + 32 * N
    rows_fz = z0 + 4 * st[:, None] + np.arange(4)[None]
    cols_fz = nX + 32 * st[:, None] + 3 * np.arange(4)[None] + 2
    idx["fz_l"] = (rows_fz, cols_fz)
    idx["fz_r"] = (rows_fz + 4 * N, cols_fz + 12)
    b0 = z0 + 8 * N
    rows_bx = b0 + 3 * st[:, None] + np.arange(3)[None]
    cols_bl = 20 * (st + 1)[:, None] + 13 + np.arange(3)[None]
    idx["box_l"] = (rows_bx, cols_bl)
    idx["box_r"] = (rows_bx + 3 * N, cols_bl + 4)
    return {k: tuple(np.ascontiguousarray(a, dtype=np.int64) for a in v)
            for k, v in idx.items()}


def linearize(z, p: MPCParams, cfg: WalkConfig):
    """(c(z) (B, m), J(z) (B, m, n_z)): the dense constraint Jacobian
    assembled per block from :func:`linearize_parts` — per-stage Jacobians
    for the dynamics rows, per-stage gradients for the Lyapunov rows, and
    closed-form entries for everything else (the friction/fz/box/height
    rows are linear with gamma-scaled constant coefficients)."""
    N = cfg.N
    B = z.shape[0]
    m = num_constraints(cfg)
    n_eq = 20 * (N + 1)
    gl, gr = p.gamma_l, p.gamma_r
    parts = linearize_parts(z, p, cfg)
    index = _jacobian_index(N)

    def at(name):
        return tuple(const(("jac_idx", N, name, k), lambda: a, z.device)
                     for k, a in enumerate(index[name]))

    J = z.new_zeros(B, m, cfg.n_z)
    # init rows: I on X0; dynamics rows X[i+1] - f(X[i], U[i]):
    # [+I | -A_i | -B_i]
    J[:, :n_eq, :n_eq].diagonal(dim1=1, dim2=2).fill_(1.0)
    r, c = at("dyn_x")
    J[:, r, c] = -parts.A_blk
    r, c = at("dyn_u")
    J[:, r, c] = -parts.B_blk
    # Lyapunov rows: gradient per stage wrt (x_i, x_{i+1}, u_i); x_i and
    # x_{i+1} never share a column
    for name, g in (("ly_x", parts.gx), ("ly_xn", parts.gxn),
                    ("ly_u", parts.gu)):
        r, c = at(name)
        J[:, r, c] = g
    # momentum row: |hw1|^2 - |hw0|^2
    J[:, n_eq + N, 6:9] = parts.hw0
    J[:, n_eq + N, 26:29] = parts.hw1
    # height rows: X[i][2], i = 0..N-1
    r, c = at("height")
    J[:, r, c] = 1.0
    # friction rows: A_mu on stage forces, gamma-gated
    Amu = const(("friction", cfg.mu), lambda: _friction_matrix(cfg.mu),
                z.device, z.dtype)
    for name, g in (("fric_l", gl), ("fric_r", gr)):
        r, c = at(name)
        J[:, r, c] = Amu * g[:, :N, None, None, None]
    # fz rows: -gamma on vertical force comps
    for name, g in (("fz_l", gl), ("fz_r", gr)):
        r, c = at(name)
        J[:, r, c] = -g[:, :N, None].expand(B, N, 4)
    # stance box rows: gamma at X[i+1] foot-position cols
    for name, g in (("box_l", gl), ("box_r", gr)):
        r, c = at(name)
        J[:, r, c] = g[:, 1:, None].expand(B, N, 3)
    return parts.c, J


@functools.lru_cache(maxsize=8)
def constraint_bounds(cfg: WalkConfig):
    """Static numpy (l, u) for l <= c(z) <= u. Equalities: l == u == 0."""
    N = cfg.N
    neg = -np.inf
    n_eq = 20 * (N + 1)
    lo = [np.zeros(n_eq)]
    hi = [np.zeros(n_eq)]
    n_ineq0 = N + 1 + N + 16 * N + 16 * N + 4 * N + 4 * N
    lo.append(np.full(n_ineq0, neg))
    hi.append(np.zeros(n_ineq0))
    box = np.tile(np.asarray(cfg.stance_box), N)
    lo.extend([-box, -box])
    hi.extend([box, box])
    return np.concatenate(lo), np.concatenate(hi)


def num_constraints(cfg: WalkConfig) -> int:
    return constraint_bounds(cfg)[0].shape[0]
