"""Whole-body state estimation from the articulated model, batched (port
of ``cmpc_tpu.wholebody.state``).

The functional equivalent of Hrp4Controller.retrieve_state
(simulation.py:303-388 of the reference controller), computed from the
rigid-body layer.  Returns a flat NamedTuple of (B, ...) tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.rbd import algorithms as rbd
from cmpc_tpu_torch.rbd.urdf import RobotModel
from cmpc_tpu_torch.utils.rotations import matrix_to_rotvec


class WBState(NamedTuple):
    """Measured whole-body quantities, reference layout ([ang, pos] poses,
    [omega, v] spatial velocities)."""

    pose_l: torch.Tensor     # (B, 6) [rotvec(3), pos(3)] of l_sole
    vel_l: torch.Tensor      # (B, 6) [omega(3), v(3)]
    pose_r: torch.Tensor     # (B, 6)
    vel_r: torch.Tensor      # (B, 6)
    com_pos: torch.Tensor    # (B, 3)
    com_vel: torch.Tensor    # (B, 3)
    torso_rotvec: torch.Tensor  # (B, 3)
    torso_omega: torch.Tensor   # (B, 3)
    base_rotvec: torch.Tensor   # (B, 3)
    base_omega: torch.Tensor    # (B, 3)
    joint_pos: torch.Tensor  # (B, nj)
    joint_vel: torch.Tensor  # (B, nj)
    hw: torch.Tensor         # (B, 3) centroidal angular momentum


def zmp_estimate(contact_points, contact_forces, com_pos, l_foot_pos,
                 total_mass, g: float, h: float, prev_zmp=None):
    """Zero-moment-point estimate from contact forces, (B, 3) — the
    functional mirror of Hrp4Controller.retrieve_state's ZMP block
    (simulation.py:328-348), including its quirks:

    * zmp_z = com_z - Fz / (m g / h) (the LIP normalization);
    * per-contact terms are skipped when the contact's fz <= 0.1 N;
    * if the total fz <= 0.1 N the estimate is zeroed (contact lost; the
      reference notes it should return the previous measurement — pass
      prev_zmp to get that fixed behavior);
    * the result is clipped to +-0.3 m around the reference's "midpoint",
      which is (l_foot + l_foot)/2 == l_foot — the reference's own bug,
      reproduced so traces are comparable (simulation.py:345-348).

    contact_points/contact_forces: (B, C, 3); inactive slots must carry
    zero force.  Masked, fixed C, no host read.
    """
    fz = contact_forces[:, :, 2]                              # (B,C)
    f_tot = contact_forces.sum(1)
    fz_tot = f_tot[:, 2]
    safe_fz = torch.where(fz_tot.abs() > 1e-9, fz_tot,
                          torch.ones_like(fz_tot))

    zmp_z = com_pos[:, 2] - fz_tot / (total_mass * g / h)
    active = fz > 0.1
    num_xy = (contact_points[:, :, :2] * fz[:, :, None]
              + (zmp_z[:, None] - contact_points[:, :, 2])[:, :, None]
              * contact_forces[:, :, :2])
    zmp_xy = torch.where(active[:, :, None], num_xy, 0.0).sum(1) \
        / safe_fz[:, None]
    zmp = torch.cat([zmp_xy, zmp_z[:, None]], dim=1)

    mid = l_foot_pos  # (l_foot + l_foot)/2, simulation.py:345
    zmp = torch.clamp(zmp, min=mid - 0.3, max=mid + 0.3)
    fallback = torch.zeros_like(zmp) if prev_zmp is None else prev_zmp
    return torch.where((fz_tot > 0.1)[:, None], zmp, fallback)


def retrieve_state(model: RobotModel, q: rbd.RobotQ, qv) -> WBState:
    mt = rbd.model_tensors(model, qv)
    f = rbd.fk(model, q)
    Rl, pl = rbd.site_pose(model, f, "l_sole")
    Rr, pr = rbd.site_pose(model, f, "r_sole")
    om_l, v_l = rbd.site_velocity(model, f, qv, "l_sole")
    om_r, v_r = rbd.site_velocity(model, f, qv, "r_sole")
    Rt, _ = rbd.site_pose(model, f, "torso")
    om_t, _ = rbd.site_velocity(model, f, qv, "torso")
    hw, _ = rbd.centroidal_momentum(model, f, qv)
    vel = rbd.velocities(model, f, qv)
    com_vel = torch.einsum("b,nbi->ni", mt.mass, vel.v_com) \
        / model.total_mass
    return WBState(
        pose_l=torch.cat([matrix_to_rotvec(Rl), pl], dim=1),
        vel_l=torch.cat([om_l, v_l], dim=1),
        pose_r=torch.cat([matrix_to_rotvec(Rr), pr], dim=1),
        vel_r=torch.cat([om_r, v_r], dim=1),
        com_pos=rbd.com(model, f),
        com_vel=com_vel,
        torso_rotvec=matrix_to_rotvec(Rt),
        torso_omega=om_t,
        base_rotvec=matrix_to_rotvec(q.base_rot),
        base_omega=qv[:, 0:3],
        joint_pos=q.qj,
        joint_vel=qv[:, 6:],
        hw=hw)
