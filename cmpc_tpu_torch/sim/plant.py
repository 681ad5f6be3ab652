"""Centroidal plant for closed-loop evaluation, batched (port of
``cmpc_tpu.sim.plant``).

The centroidal abstraction of {whole-body ID QP + rigid-body physics}: the
commanded CoM force tracks the MPC's node-1 state with the ID layer's PD
gains; angular momentum integrates the torque of the realized contact
wrench (commanded force at the demanded ZMP, clamped to the support
polygon), scaled by a whole-body compliance, plus a shedding term.  See
the JAX module for the calibration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.models import centroidal as cm

COM_POS_GAIN = 5.0
COM_VEL_GAIN = 10.0
HW_COMPLIANCE = 0.35
HW_SHED_RATE = 1.3


class PlantState(NamedTuple):
    com_pos: torch.Tensor  # (B, 3)
    com_vel: torch.Tensor  # (B, 3)
    hw: torch.Tensor       # (B, 3)


def plant_step(ps: PlantState, com_des_pos, com_des_vel, com_des_acc,
               u0, gamma_l, gamma_r, pose_l, pose_r,
               mpc_mass, plant_mass, ext_force, ext_torque, g, polygon, dt,
               hw_compliance: float = HW_COMPLIANCE,
               hw_shed: float = HW_SHED_RATE) -> PlantState:
    """One Euler step of the plant under the ID-equivalent CoM tracking law.
    pose_l / pose_r (B, 6): [ang(3), pos(3)] actual foot poses; gamma_l /
    gamma_r: contact gates, (B,) tensors or floats shared by the batch."""
    like = ps.com_pos
    B = like.shape[0]
    gravity = cm.gravity_vector(g, like)
    if not isinstance(gamma_l, torch.Tensor):
        gamma_l = torch.full((B,), float(gamma_l), dtype=like.dtype,
                             device=like.device)
    if not isinstance(gamma_r, torch.Tensor):
        gamma_r = torch.full((B,), float(gamma_r), dtype=like.dtype,
                             device=like.device)

    acc_pd = (com_des_acc
              + COM_VEL_GAIN * (com_des_vel - ps.com_vel)
              + COM_POS_GAIN * (com_des_pos - ps.com_pos))
    force_cmd = mpc_mass[:, None] * (acc_pd - gravity)
    acc = gravity + (force_cmd + ext_force) / plant_mass[:, None]

    F = force_cmd + ext_force
    fz = F[:, 2].clamp_min(1e-3)
    zmp_xy = ps.com_pos[:, :2] - ps.com_pos[:, 2:3] * F[:, :2] / fz[:, None]
    zmp_xy = zmp_xy + (hw_shed / hw_compliance) * torch.stack(
        [ps.hw[:, 1], -ps.hw[:, 0]], dim=-1) / fz[:, None]

    verts_l = cm.foot_vertices(pose_l[:, 3:6], pose_l[:, 2], polygon)
    verts_r = cm.foot_vertices(pose_r[:, 3:6], pose_r[:, 2], polygon)
    big = 1e6
    on_l = (gamma_l > 0.5)[:, None]
    on_r = (gamma_r > 0.5)[:, None]
    lo_l = torch.where(on_l, verts_l[:, :, :2].amin(1), big)
    lo_r = torch.where(on_r, verts_r[:, :, :2].amin(1), big)
    hi_l = torch.where(on_l, verts_l[:, :, :2].amax(1), -big)
    hi_r = torch.where(on_r, verts_r[:, :, :2].amax(1), -big)
    lo = torch.minimum(lo_l, lo_r)
    hi = torch.maximum(hi_l, hi_r)
    ok = (on_l | on_r)
    p_cop_xy = torch.clamp(zmp_xy, min=lo, max=hi)
    p_cop = torch.cat([p_cop_xy, torch.zeros_like(p_cop_xy[:, :1])], dim=1)
    tau_grf = torch.where(ok, torch.linalg.cross(p_cop - ps.com_pos, F,
                                                 dim=-1), 0.0)
    tau_yaw = torch.where(ok[:, 0], -hw_shed * ps.hw[:, 2]
                          / max(hw_compliance, 1e-3), 0.0)
    tau_grf = torch.cat([tau_grf[:, :2], (tau_grf[:, 2] + tau_yaw)[:, None]],
                        dim=1)
    tau = hw_compliance * tau_grf + ext_torque

    return PlantState(
        com_pos=ps.com_pos + dt * ps.com_vel,
        com_vel=ps.com_vel + dt * acc,
        hw=ps.hw + dt * tau,
    )
