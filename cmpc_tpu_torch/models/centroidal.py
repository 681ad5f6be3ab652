"""Adaptive nonlinear centroidal dynamics, batched (port of
``cmpc_tpu.models.centroidal``).

state x (..., 20): [p_com(3), v_com(3), h_w(3), theta_hat(3),
                    psi_L(1), p_L(3), psi_R(1), p_R(3)]
input u (..., 32): [f_1L..f_4L (12), f_1R..f_4R (12), v_L(3), v_R(3),
                    omega_L(1), omega_R(1)]

Leading dims are arbitrary; per-scenario scalars (gates, gains, mass) have
exactly the leading dims of x.  The reference's quirks are kept: theta_hat
enters the force balance multiplied by zero, and the feet freeze while
their contact gate is active.
"""

from __future__ import annotations

import torch

from cmpc_tpu_torch.consts import const

P_COM = slice(0, 3)
V_COM = slice(3, 6)
H_W = slice(6, 9)
THETA = slice(9, 12)
PSI_L = 12
POS_L = slice(13, 16)
PSI_R = 16
POS_R = slice(17, 20)

N_X = 20
N_U = 32


def foot_polygon(foot_length: float = 0.25, foot_width: float = 0.13, *,
                 device=None, dtype=torch.float32):
    """Vertex offsets of the contact polygon in the foot frame, (4, 3)."""
    hl, hw = foot_length / 2.0, foot_width / 2.0
    return const(("polygon", foot_length, foot_width),
                 lambda: [[hl, hw, 0.0], [hl, -hw, 0.0],
                          [-hl, -hw, 0.0], [-hl, hw, 0.0]], device, dtype)


def gravity_vector(g: float, like):
    """[0, 0, -g] on like's device and dtype."""
    return const(("gravity", g), lambda: [0.0, 0.0, -g], like.device,
                 like.dtype)


def foot_vertices(pos, yaw, polygon):
    """World positions of the 4 contact vertices: R_z(yaw) @ v + pos.
    pos (..., 3), yaw (...,) -> (..., 4, 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    vx, vy, vz = polygon[..., 0], polygon[..., 1], polygon[..., 2]
    wx = c[..., None] * vx - s[..., None] * vy
    wy = s[..., None] * vx + c[..., None] * vy
    wz = torch.broadcast_to(vz, wx.shape)
    return torch.stack([wx, wy, wz], dim=-1) + pos[..., None, :]


def centroidal_dynamics(x, com_ref, gamma_l, gamma_r, u, k1, k2, mass, g,
                        polygon):
    """Continuous-time state derivative f(x, u)
    (centroidal_mpc_vertices.py:371-461).  com_ref (..., 9)."""
    p = x[..., P_COM]
    v = x[..., V_COM]
    theta = x[..., THETA]
    psi_l, p_l = x[..., PSI_L], x[..., POS_L]
    psi_r, p_r = x[..., PSI_R], x[..., POS_R]

    lead = u.shape[:-1]
    forces_l = u[..., 0:12].reshape(*lead, 4, 3)
    forces_r = u[..., 12:24].reshape(*lead, 4, 3)
    v_l = u[..., 24:27]
    v_r = u[..., 27:30]
    om_l = u[..., 30]
    om_r = u[..., 31]

    gl, gr = gamma_l[..., None], gamma_r[..., None]
    gravity = gravity_vector(g, x)

    sum_fl = forces_l.sum(-2) * gl
    sum_fr = forces_r.sum(-2) * gr

    z1 = p - com_ref[..., 0:3]
    z2 = k1[..., None] * z1 + (v - com_ref[..., 3:6])

    verts_l = foot_vertices(p_l, psi_l, polygon)          # (..., 4, 3)
    verts_r = foot_vertices(p_r, psi_r, polygon)
    tau_l = gl * torch.linalg.cross(verts_l - p[..., None, :], forces_l,
                                    dim=-1).sum(-2)
    tau_r = gr * torch.linalg.cross(verts_r - p[..., None, :], forces_r,
                                    dim=-1).sum(-2)

    m = mass[..., None]
    dp = v
    # theta_hat * 0: the reference disables the estimate in the force
    # balance (line 453) — reproduced bit-for-bit
    dv = gravity + (sum_fl + sum_fr + theta * 0.0) / m
    dhw = tau_l + tau_r
    dtheta = z2 / m
    dpsi_l = (1.0 - gamma_l) * om_l
    dp_l = (1.0 - gl) * v_l
    dpsi_r = (1.0 - gamma_r) * om_r
    dp_r = (1.0 - gr) * v_r

    return torch.cat([dp, dv, dhw, dtheta, dpsi_l[..., None], dp_l,
                      dpsi_r[..., None], dp_r], dim=-1)


def euler_step(x, com_ref, gamma_l, gamma_r, u, k1, k2, mass, g, polygon,
               delta):
    """Explicit-Euler discretization (centroidal_mpc_vertices.py:187-190)."""
    return x + delta * centroidal_dynamics(x, com_ref, gamma_l, gamma_r, u,
                                           k1, k2, mass, g, polygon)
