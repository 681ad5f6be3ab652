"""Whole-body task-space inverse dynamics on the articulated model, batched
(port of ``cmpc_tpu.wholebody.inverse_dynamics``).

The equivalent of InverseDynamics.get_joint_torques
(inverse_dynamics.py:30-136 of the reference controller): six weighted
acceleration tasks (feet, CoM, torso, base angulars, redundant-joint
posture) with PD + feedforward references, the floating-base dynamics
equality, and CoP/friction cones — assembled from the rigid-body layer and
solved by the batched ADMM QP (ops/id_qp.py).  A function of (model
constants, q, qv, desired refs, contact gates), no solver objects.

Known divergence from the reference (documented, deliberate): the
reference's utils.pose_difference indexes its [ang, pos] poses as if they
were [pos, ang], so its foot "position error" is a linear difference of
rotation vectors and its "orientation error" is a rotation-vector
difference of *positions* (which wraps once |p| > pi).  Here the task
error is the correct [rotvec_difference(ang), pos_a - pos_b].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.ops.admm import ADMMSettings
from cmpc_tpu_torch.ops.id_qp import IDDynamics, IDTask, solve_id_qp
from cmpc_tpu_torch.rbd import algorithms as rbd
from cmpc_tpu_torch.rbd.urdf import RobotModel
from cmpc_tpu_torch.runtime import spans
from cmpc_tpu_torch.utils.rotations import rotvec_difference
from cmpc_tpu_torch.wholebody.state import WBState


class WBDesired(NamedTuple):
    """Per-tick task references (the reference's `desired` dict payload,
    simulation.py:207-271), each (B, ...)."""

    pose_l: torch.Tensor    # (B, 6) [ang, pos]
    vel_l: torch.Tensor     # (B, 6)
    acc_l: torch.Tensor     # (B, 6)
    pose_r: torch.Tensor    # (B, 6)
    vel_r: torch.Tensor     # (B, 6)
    acc_r: torch.Tensor     # (B, 6)
    com_pos: torch.Tensor   # (B, 3)
    com_vel: torch.Tensor   # (B, 3)
    com_acc: torch.Tensor   # (B, 3)
    torso_rotvec: torch.Tensor  # (B, 3) torso/base refs: feet average
    torso_omega: torch.Tensor   # (B, 3)
    torso_alpha: torch.Tensor   # (B, 3)
    base_rotvec: torch.Tensor   # (B, 3)
    base_omega: torch.Tensor    # (B, 3)
    base_alpha: torch.Tensor    # (B, 3)
    joint_pos: torch.Tensor     # (B, nj) posture target (initial config)


def redundant_selection(model: RobotModel,
                        names=("NECK_Y", "NECK_P",
                               "R_SHOULDER_P", "R_SHOULDER_R",
                               "R_SHOULDER_Y", "R_ELBOW_P",
                               "L_SHOULDER_P", "L_SHOULDER_R",
                               "L_SHOULDER_Y", "L_ELBOW_P"),
                        device=None, dtype=torch.float32):
    """(nv, nv) diagonal selection of the redundant dofs
    (simulation.py:87-94).  Joints the model fixed away (the payload
    variant locks the elbows/shoulder-yaws to carry the box) are skipped."""
    d = np.zeros(model.nv)
    for n in names:
        if n in model.joint_names:
            d[6 + model.dof_index(n)] = 1.0
    return torch.diag(torch.as_tensor(d, dtype=dtype, device=device))


@spans.spanned("wholebody.joint_torques")
def joint_torques(model: RobotModel, q: rbd.RobotQ, qv,
                  desired: WBDesired, current: WBState,
                  contact_l, contact_r, joint_sel=None,
                  foot_size: float = 0.1, mu: float = 0.5,
                  settings: ADMMSettings = ADMMSettings(iters=60, rho=10.0,
                                                        pdas_rounds=2),
                  weights: dict | None = None, pos_gains: dict | None = None,
                  vel_gains: dict | None = None):
    """Returns (tau (B, nj), ADMMResult). contact_l/r: {0,1} gates, a
    number shared by the batch or a (B,) tensor (the reference's
    contact-string comparison, inverse_dynamics.py:31-32, as data).
    weights/pos_gains/vel_gains override the reference task constants
    (ops/id_qp.py)."""
    f = rbd.fk(model, q)
    vel = rbd.velocities(model, f, qv)
    bias = rbd.bias_accelerations(model, f, vel, qv)
    nv = model.nv
    if joint_sel is None:
        joint_sel = redundant_selection(model, device=qv.device,
                                        dtype=qv.dtype)
    J_site = {s: rbd.site_jacobian(model, f, s)
              for s in ("l_sole", "r_sole", "torso", "body")}

    def foot_task(site, d_pose, d_vel, d_acc, c_pose, c_vel):
        alpha_b, a_b = rbd.site_bias_acc(model, f, vel, bias, site)
        # error ordering [ang, pos] matches the Jacobian rows [ang, lin]
        pos_err = torch.cat([
            rotvec_difference(d_pose[:, 0:3], c_pose[:, 0:3]),
            d_pose[:, 3:6] - c_pose[:, 3:6]], dim=1)
        return IDTask(J=J_site[site],
                      Jdot_qv=torch.cat([alpha_b, a_b], dim=1),
                      ff=d_acc, pos_err=pos_err, vel_err=d_vel - c_vel)

    def angular_task(site, d_rotvec, d_omega, d_alpha, c_rotvec, c_omega):
        alpha_b, _ = rbd.site_bias_acc(model, f, vel, bias, site)
        return IDTask(J=J_site[site][:, 0:3], Jdot_qv=alpha_b, ff=d_alpha,
                      pos_err=rotvec_difference(d_rotvec, c_rotvec),
                      vel_err=d_omega - c_omega)

    zero6 = torch.zeros_like(qv[:, :6])
    zero_nv = torch.zeros_like(qv)
    tasks = {
        "lfoot": foot_task("l_sole", desired.pose_l, desired.vel_l,
                           desired.acc_l, current.pose_l, current.vel_l),
        "rfoot": foot_task("r_sole", desired.pose_r, desired.vel_r,
                           desired.acc_r, current.pose_r, current.vel_r),
        "com": IDTask(
            J=rbd.com_jacobian(model, f),
            Jdot_qv=rbd.com_bias_acc(model, f, vel, bias),
            ff=desired.com_acc,
            pos_err=desired.com_pos - current.com_pos,
            vel_err=desired.com_vel - current.com_vel),
        "torso": angular_task("torso", desired.torso_rotvec,
                              desired.torso_omega, desired.torso_alpha,
                              current.torso_rotvec, current.torso_omega),
        "base": angular_task("body", desired.base_rotvec,
                             desired.base_omega, desired.base_alpha,
                             current.base_rotvec, current.base_omega),
        "joints": IDTask(
            J=joint_sel, Jdot_qv=zero_nv, ff=zero_nv,
            pos_err=torch.cat([zero6, desired.joint_pos - q.qj], dim=1),
            vel_err=torch.cat([zero6, -qv[:, 6:]], dim=1)),
    }

    dyn = IDDynamics(
        M=rbd.mass_matrix(model, f),
        h=rbd.bias_forces(model, f, qv),
        J_lfoot=J_site["l_sole"], J_rfoot=J_site["r_sole"])

    return solve_id_qp(tasks, dyn, qv, contact_l, contact_r, n_dof=nv,
                       foot_size=foot_size, mu=mu, settings=settings,
                       weights=weights, pos_gains=pos_gains,
                       vel_gains=vel_gains)
