"""Whole-body physics plant: articulated forward dynamics + ground contact,
batched (port of ``cmpc_tpu.wholebody.plant``).

The stand-in for a rigid-body physics world (10 ms steps, gravity -9.81,
collision solve against a flat ground).  Contact points are the 4 corners
of each sole polygon (the same 0.25 x 0.13 m footprint the MPC uses).

Two contact models, selected per step:

* ``impulse`` (default) — velocity-level rigid contact, the regime the
  whole-body ID QP *assumes*: per substep, contact impulses solve the
  complementarity problem on the Delassus operator G = J M^-1 J^T with a
  fixed-count projected Gauss-Seidel iteration (normal impulses >= 0 with
  Baumgarte push-out, friction impulses in the Coulomb box).  Branch-free,
  batched, and stiff-stable at 2-10 substeps per 10 ms tick.
* ``penalty`` — smooth spring-damper corners (no complementarity kinks).

This is an evaluation-fidelity plant: it reproduces stance support,
payload loading and push responses well enough to exercise the full
planner -> MPC -> ID -> torques pipeline end to end on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.rbd import algorithms as rbd
from cmpc_tpu_torch.rbd.urdf import RobotModel
from cmpc_tpu_torch.runtime import spans
from cmpc_tpu_torch.utils.rotations import rotvec_to_matrix


class ContactParams(NamedTuple):
    # impulse model
    pgs_iters: int = 15      # projected Gauss-Seidel sweeps per substep
    relax: float = 1.0       # GS relaxation (1 = plain Gauss-Seidel)
    baumgarte: float = 0.2   # penetration push-out gain (per substep)
    slop: float = 1e-4       # penetration tolerance (m)
    cfm: float = 1e-3        # constraint-force mixing (diagonal compliance)
    # penalty model
    kn: float = 4.0e4        # normal stiffness (N/m)
    dn: float = 2.0e3        # normal damping (N s/m)
    kt: float = 2.0e3        # tangential viscous gain (N s/m)
    mu: float = 0.5          # Coulomb friction (both models)


class WBPlantState(NamedTuple):
    q: rbd.RobotQ
    qv: torch.Tensor         # (B, nv)


def foot_corner_offsets(foot_length: float = 0.25, foot_width: float = 0.13,
                        device=None, dtype=torch.float32):
    """(4, 3) sole-frame corner offsets, built once per device and dtype."""
    hl, hw = foot_length / 2.0, foot_width / 2.0
    return const(("foot_corners", foot_length, foot_width),
                 lambda: [[hl, hw, 0.0], [hl, -hw, 0.0],
                          [-hl, -hw, 0.0], [-hl, hw, 0.0]], device, dtype)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _corner_points(model, f, corners):
    """(B, 8, 3) world corner points and their (B, 8, 3, nv) linear
    Jacobians."""
    pts = []
    Js = []
    for site in ("l_sole", "r_sole"):
        R, p = rbd.site_pose(model, f, site)
        idx, _ = model.sites[site]
        world = p[:, None] + torch.einsum("nij,kj->nki", R, corners)
        pts.append(world)
        Js.append(rbd.point_jacobians(model, f, idx, world)[:, :, 3:6])
    return torch.cat(pts, dim=1), torch.cat(Js, dim=1)


def _generalized_rhs(model, f, qv, tau, ext_wrench, g):
    """S tau - h + J_base' w_ext, (B, nv)."""
    bias = rbd.bias_forces(model, f, qv, g)
    rhs = torch.cat([-bias[:, :6], -bias[:, 6:] + tau], dim=1)
    Jb = rbd.point_jacobian(model, f, 0, f.p[:, 0])
    return rhs + _mv(Jb.transpose(1, 2), ext_wrench)


def _impulse_substep(model, q, qv, tau, ext_wrench, corners,
                     cp: ContactParams, g: float, h: float):
    nv = model.nv
    B = qv.shape[0]
    f = rbd.fk(model, q)
    M = rbd.mass_matrix(model, f)
    rhs = _generalized_rhs(model, f, qv, tau, ext_wrench, g)
    pts, Jc = _corner_points(model, f, corners)       # (B,8,3),(B,8,3,nv)
    J = Jc.reshape(B, 24, nv)
    # one factorization of M + 1e-9 I for both right-hand sides
    sol = torch.linalg.solve_ex(rbd._regularized(M, 1e-9),
                                torch.cat([rhs[:, :, None],
                                           J.transpose(1, 2)], dim=2))[0]
    v_free = qv + h * sol[:, :, 0]
    MinvJt = sol[:, :, 1:]
    G = J @ MinvJt                                    # (B,24,24) Delassus

    pen = -pts[:, :, 2]                               # (B,8)
    active = (pen > -cp.slop).to(qv.dtype)
    # J v_free minus the desired outward normal velocity (Baumgarte
    # push-out) on the normal rows
    v0 = _mv(J, v_free).reshape(B, 8, 3)
    push = cp.baumgarte * pen.clamp_min(0.0) / h
    v0 = torch.cat([v0[:, :, :2], (v0[:, :, 2] - push)[:, :, None]],
                   dim=2).reshape(B, 24)
    D = torch.diagonal(G, dim1=1, dim2=2) + cp.cfm

    # Projected Gauss-Seidel: sequential per-row updates.  Jacobi-style
    # parallel sweeps DIVERGE here — the 8 corners ride one near-rigid
    # body, so G's off-diagonals match its diagonal and the parallel
    # update oscillates with period 2.
    lam = qv.new_zeros(B, 24)

    def row_step(r):
        gr = (G[:, r] * lam).sum(dim=1) + v0[:, r]
        if cp.relax != 1.0:
            gr = cp.relax * gr
        return lam[:, r] - gr / D[:, r]

    for _ in range(cp.pgs_iters):
        for k in range(8):
            i = 3 * k
            ln = row_step(i + 2).clamp_min(0.0) * active[:, k]
            lam[:, i + 2] = ln
            cap = cp.mu * ln
            lam[:, i] = torch.clamp(row_step(i), min=-cap, max=cap)
            lam[:, i + 1] = torch.clamp(row_step(i + 1), min=-cap, max=cap)

    qv_new = v_free + _mv(MinvJt, lam)
    # impulses -> average forces over the substep (for ZMP estimation)
    return q, qv_new, pts, lam.reshape(B, 8, 3) / h


@spans.spanned("wholebody.plant_step")
def wb_plant_step(model: RobotModel, state: WBPlantState, tau,
                  ext_force=None, ext_torque=None,
                  dt: float = 0.01, substeps: int = 5,
                  g: float = 9.81,
                  cp: ContactParams = ContactParams(),
                  foot_length: float = 0.25, foot_width: float = 0.13,
                  contact_model: str = "impulse",
                  return_contacts: bool = False):
    """One control tick: hold tau (B, nj) constant, integrate `substeps`
    physics steps.  ext_force/ext_torque (B, 3): world wrench on the base
    (the disturbance-injection hook).

    return_contacts=True additionally returns the final substep's contact
    points and forces ((B, 8, 3) each) — the ZMP-estimation source."""
    if contact_model not in ("impulse", "penalty"):
        raise ValueError(contact_model)
    qv = state.qv
    corners = foot_corner_offsets(foot_length, foot_width, qv.device,
                                  qv.dtype)
    h = dt / substeps
    zero3 = torch.zeros_like(qv[:, :3])
    ext_f = zero3 if ext_force is None else ext_force
    ext_t = zero3 if ext_torque is None else ext_torque
    ext_wrench = torch.cat([ext_t, ext_f], dim=1)

    q = state.q
    pts = f_c = qv.new_zeros(qv.shape[0], 8, 3)
    for _ in range(substeps):
        if contact_model == "impulse":
            _, qv, pts, f_c = _impulse_substep(
                model, q, qv, tau, ext_wrench, corners, cp, g, h)
            q = _integrate_q(q, qv, h)
        else:
            qdd = _penalty_qdd(model, q, qv, tau, ext_wrench, corners,
                               cp, g)
            q, qv = rbd.integrate(q, qv, qdd, h)
    if return_contacts:
        return WBPlantState(q=q, qv=qv), (pts, f_c)
    return WBPlantState(q=q, qv=qv)


def _integrate_q(q: rbd.RobotQ, qv, h: float) -> rbd.RobotQ:
    dR = rotvec_to_matrix(qv[:, 0:3] * h)
    return rbd.RobotQ(base_pos=q.base_pos + h * qv[:, 3:6],
                      base_rot=dR @ q.base_rot,
                      qj=q.qj + h * qv[:, 6:])


def _penalty_qdd(model, q, qv, tau, ext_wrench, corners, cp: ContactParams,
                 g: float):
    f = rbd.fk(model, q)
    wl = _sole_contact_wrench(model, f, qv, "l_sole", corners, cp)
    wr = _sole_contact_wrench(model, f, qv, "r_sole", corners, cp)
    M = rbd.mass_matrix(model, f)
    bias = rbd.bias_forces(model, f, qv, g)
    rhs = torch.cat([-bias[:, :6], -bias[:, 6:] + tau], dim=1)
    Jl = rbd.site_jacobian(model, f, "l_sole")
    Jr = rbd.site_jacobian(model, f, "r_sole")
    rhs = rhs + _mv(Jl.transpose(1, 2), wl) + _mv(Jr.transpose(1, 2), wr)
    Jb = rbd.point_jacobian(model, f, 0, f.p[:, 0])
    rhs = rhs + _mv(Jb.transpose(1, 2), ext_wrench)
    return torch.linalg.solve_ex(rbd._regularized(M, 1e-9), rhs)[0]


def _sole_contact_wrench(model, f, qv, site, corners, cp: ContactParams):
    """Spring-damper ground wrench (B, 6) on one sole about the sole
    origin."""
    R, p = rbd.site_pose(model, f, site)
    omega, v = rbd.site_velocity(model, f, qv, site)
    arm = torch.einsum("nij,kj->nki", R, corners)     # (B,4,3) world corners
    pts = p[:, None] + arm
    vels = v[:, None] + torch.linalg.cross(omega[:, None], pts - p[:, None],
                                           dim=-1)
    pen = -pts[:, :, 2]
    active = pen > 0.0
    fz = torch.where(active,
                     (cp.kn * pen - cp.dn * vels[:, :, 2]).clamp_min(0.0),
                     0.0)
    ft = -cp.kt * vels[:, :, 0:2]
    ft_norm = torch.linalg.vector_norm(ft, dim=2, keepdim=True)
    scale = torch.minimum(torch.ones_like(ft_norm),
                          cp.mu * fz[:, :, None] / ft_norm.clamp_min(1e-9))
    ft = ft * scale * active[:, :, None]
    forces = torch.cat([ft, fz[:, :, None]], dim=2)   # (B,4,3)
    torque = torch.sum(torch.linalg.cross(pts - p[:, None], forces, dim=-1),
                       dim=1)
    return torch.cat([torque, torch.sum(forces, dim=1)], dim=1)
