"""IS-MPC: the legacy LIP-model linear MPC with the stability ("periodic
tail") constraint (port of ``cmpc_tpu.ops.ismpc``), batched.

The whole QP is *linear time-invariant*: the constraint matrix, cost
Hessian, and therefore the ADMM KKT inverse are constants built once in
numpy.  Only q, l, u change per solve (initial state + moving ZMP
constraint), so a solve is a fixed count of dense matrix products over the
batch.

Decision vector z = [vec(X) 9*(N+1), vec(U) 3*N], X node-major.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.models.lip import lip_matrices

W_ZMP = 100.0  # zmp tracking weight (original_code/ismpc.py:45-48)


class ISMPCConfig(NamedTuple):
    N: int = 100
    delta: float = 0.01
    eta: float = 3.6913           # sqrt(g/h) for h=0.72
    g: float = 9.81
    foot_size: float = 0.1
    admm_iters: int = 60
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6
    eq_rho_scale: float = 1e3


class ISMPCStatic(NamedTuple):
    """Constants of the QP, float32 numpy arrays (the JAX package stores
    them in float32 whatever the working type)."""

    A: np.ndarray        # (m, n) constraint matrix
    Minv: np.ndarray     # (n, n) inverse ADMM KKT matrix
    P_diag: np.ndarray   # (n,) diagonal cost Hessian
    rho_vec: np.ndarray  # (m,)
    dyn_rhs: np.ndarray  # (9N,) constant drift terms of the dynamics rows


def _zmp_cols(N):
    """z-vector columns of the ZMP components of nodes 1..N, per axis."""
    node = 9 * (np.arange(N) + 1)
    return node + 2, node + 5, node + 8


@functools.lru_cache(maxsize=4)
def build_static(cfg: ISMPCConfig) -> ISMPCStatic:
    N = cfg.N
    nX, nU = 9 * (N + 1), 3 * N
    n = nX + nU
    A_lip, B_lip = lip_matrices(cfg.eta)
    Ad = np.eye(3) + cfg.delta * A_lip
    Bd = cfg.delta * B_lip[:, 0]

    rows = []
    # init (9): x_0
    init = np.zeros((9, n))
    init[:, :9] = np.eye(9)
    rows.append(init)
    # dynamics (9N): x_{i+1} - Ad_blk x_i - Bd_blk u_i == delta*drift
    dyn = np.zeros((9 * N, n))
    for i in range(N):
        r = 9 * i
        dyn[r:r + 9, 9 * (i + 1):9 * (i + 2)] = np.eye(9)
        for ax in range(3):
            dyn[r + 3 * ax:r + 3 * ax + 3,
                9 * i + 3 * ax:9 * i + 3 * ax + 3] = -Ad
            dyn[r + 3 * ax:r + 3 * ax + 3, nX + 3 * i + ax] = -Bd
    rows.append(dyn)
    # zmp rows (3N): value = zmp component, bounds mid -+ foot/2
    cx, cy, cz = _zmp_cols(N)
    zmp = np.zeros((3 * N, n))
    zmp[np.arange(N), cx] = 1.0
    zmp[N + np.arange(N), cy] = 1.0
    zmp[2 * N + np.arange(N), cz] = 1.0
    rows.append(zmp)
    # stability periodic tail (3): per axis
    # (v0 + eta*(p0 - z0)) - (vN + eta*(pN - zN)) == 0
    st = np.zeros((3, n))
    for ax in range(3):
        b0, bN = 3 * ax, 9 * N + 3 * ax
        st[ax, b0 + 0] = cfg.eta
        st[ax, b0 + 1] = 1.0
        st[ax, b0 + 2] = -cfg.eta
        st[ax, bN + 0] = -cfg.eta
        st[ax, bN + 1] = -1.0
        st[ax, bN + 2] = cfg.eta
    rows.append(st)

    A = np.vstack(rows)
    m = A.shape[0]

    P_diag = np.zeros(n)
    P_diag[nX:] = 2.0                   # |U|^2
    P_diag[cx] += 2.0 * W_ZMP
    P_diag[cy] += 2.0 * W_ZMP
    P_diag[cz] += 2.0 * W_ZMP

    rho_vec = np.full(m, cfg.rho)
    is_eq = np.ones(m, dtype=bool)
    is_eq[9 + 9 * N:9 + 9 * N + 3 * N] = False   # zmp boxes are inequalities
    rho_vec[is_eq] *= cfg.eq_rho_scale

    M = np.diag(P_diag + cfg.sigma) + (A.T * rho_vec) @ A
    Minv = np.linalg.inv(M)

    drift = np.zeros(9 * N)
    for i in range(N):
        drift[9 * i + 6:9 * i + 9] = cfg.delta * np.array(
            [0.0, -cfg.g, 0.0])

    f32 = np.float32
    return ISMPCStatic(A=A.astype(f32), Minv=Minv.astype(f32),
                       P_diag=P_diag.astype(f32),
                       rho_vec=rho_vec.astype(f32),
                       dyn_rhs=drift.astype(f32))


class ISMPCState(NamedTuple):
    z: torch.Tensor   # (B, n)
    y: torch.Tensor   # (B, m)


def init_state(cfg: ISMPCConfig, batch: int = 1, *, device=None,
               dtype=torch.float32) -> ISMPCState:
    n = 9 * (cfg.N + 1) + 3 * cfg.N
    m = 9 + 9 * cfg.N + 3 * cfg.N + 3
    return ISMPCState(z=torch.zeros(batch, n, dtype=dtype, device=device),
                      y=torch.zeros(batch, m, dtype=dtype, device=device))


def solve(state: ISMPCState, x0, mc_x, mc_y, mc_z, cfg: ISMPCConfig):
    """One batch of IS-MPC solves. x0 (B, 9); mc_* (B, N) moving ZMP box
    centers.

    Returns (new_state, (com_pos, com_vel, com_acc, zmp_pos, u0)), each
    (B, 3): the node-1 state and the first input
    (original_code/ismpc.py:97-101).
    """
    st = build_static(cfg)
    N = cfg.N
    nX = 9 * (N + 1)
    half = cfg.foot_size / 2.0
    dt, dev = x0.dtype, x0.device
    B = x0.shape[0]

    def c(name):
        return const(("ismpc", name, cfg), lambda: getattr(st, name), dev, dt)

    A, Minv, rho_vec, dyn_rhs = c("A"), c("Minv"), c("rho_vec"), c("dyn_rhs")
    # the ZMP columns of nodes 1..N, x then y then z
    cols = const(("ismpc_cols", N), lambda: np.concatenate(_zmp_cols(N)),
                 dev)

    mid = torch.cat([mc_x, mc_y, mc_z], dim=1)                   # (B, 3N)
    q = x0.new_zeros(B, nX + 3 * N)
    q[:, cols] = -2.0 * W_ZMP * mid

    zero3 = x0.new_zeros(B, 3)
    dyn = dyn_rhs.expand(B, -1)
    l = torch.cat([x0, dyn, mid - half, zero3], dim=1)
    u = torch.cat([x0, dyn, mid + half, zero3], dim=1)

    x, y = state.z, state.y
    zc = torch.clamp(x @ A.T, l, u)
    sigma, alpha = cfg.sigma, cfg.alpha

    for _ in range(cfg.admm_iters):
        rhs = sigma * x - q + (rho_vec * zc - y) @ A
        xt = rhs @ Minv.T
        axt = xt @ A.T
        x = alpha * xt + (1 - alpha) * x
        zt = alpha * axt + (1 - alpha) * zc
        zc = torch.clamp(zt + y / rho_vec, l, u)
        y = y + rho_vec * (zt - zc)

    x1 = x[:, 9:18]
    u0 = x[:, nX:nX + 3]
    com_pos, com_vel, zmp_pos = x1[:, 0::3], x1[:, 1::3], x1[:, 2::3]
    com_acc = cfg.eta ** 2 * (com_pos - zmp_pos)
    com_acc = torch.cat([com_acc[:, :2], com_acc[:, 2:] - cfg.g], dim=1)
    return ISMPCState(z=x, y=y), (com_pos, com_vel, com_acc, zmp_pos, u0)


def moving_constraint_table(plan_pos, timing_ss, timing_ds, timing_start,
                            init_mid_xy, n_ticks: int):
    """ZMP box centers at every absolute tick 0..n_ticks-1 from the
    footstep plan with piecewise-linear blending
    (original_code/ismpc.py:109-122).  The blend weight of step j depends
    on the absolute tick alone, so the whole table is built once; the
    horizon of tick t is its slice [t, t + N) (:func:`moving_constraint`).

    plan_pos: (B, S, 3); timing_*: static (S,) numpy arrays; init_mid_xy a
    pair of floats.  Returns (mc_x, mc_y), each (B, n_ticks).
    """
    S = plan_pos.shape[1]
    tau = np.arange(n_ticks, dtype=np.float64)
    sig = np.zeros((S - 1, n_ticks))
    for j in range(S - 1):
        ds_start = float(timing_start[j] + timing_ss[j])
        fs_end = float(timing_start[j] + timing_ss[j] + timing_ds[j])
        sig[j] = np.clip((tau - ds_start) / (fs_end - ds_start), 0.0, 1.0)
    sig = torch.as_tensor(sig, dtype=plan_pos.dtype, device=plan_pos.device)
    out = []
    for ax in (0, 1):
        cur = plan_pos[:, :S - 1, ax].clone()
        cur[:, 0] = init_mid_xy[ax]
        step = plan_pos[:, 1:, ax] - cur                       # (B, S-1)
        out.append(init_mid_xy[ax] + step @ sig)
    return out[0], out[1]


def moving_constraint(t: int, table, cfg: ISMPCConfig):
    """(mc_x, mc_y, mc_z), each (B, N): the horizon of tick t cut from
    :func:`moving_constraint_table`'s (mc_x, mc_y)."""
    mc_x, mc_y = table
    return (mc_x[:, t:t + cfg.N], mc_y[:, t:t + cfg.N],
            torch.zeros_like(mc_x[:, t:t + cfg.N]))
