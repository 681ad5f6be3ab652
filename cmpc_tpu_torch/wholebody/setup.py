"""HRP-4 initial configuration & placement (port of
``cmpc_tpu.wholebody.setup``).

The reference's startup sequence (simulation.py:63-77): bend knees/hips to
the canonical half-sitting posture, then translate the floating base so the
midpoint of the sole frames is the world origin (feet flat on the ground).
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_tpu_torch.rbd import algorithms as rbd
from cmpc_tpu_torch.rbd.urdf import RobotModel

# degrees, keyed by joint name (simulation.py:63-67)
INITIAL_CONFIGURATION_DEG = {
    "CHEST_P": 0., "CHEST_Y": 0., "NECK_P": 0., "NECK_Y": 0.,
    "R_HIP_Y": 0., "R_HIP_R": -3., "R_HIP_P": -25., "R_KNEE_P": 50.,
    "R_ANKLE_P": -25., "R_ANKLE_R": 3.,
    "L_HIP_Y": 0., "L_HIP_R": 3., "L_HIP_P": -25., "L_KNEE_P": 50.,
    "L_ANKLE_P": -25., "L_ANKLE_R": -3.,
    "R_SHOULDER_P": 4., "R_SHOULDER_R": -8., "R_SHOULDER_Y": 0.,
    "R_ELBOW_P": -25.,
    "L_SHOULDER_P": 4., "L_SHOULDER_R": 8., "L_SHOULDER_Y": 0.,
    "L_ELBOW_P": -25.}


def initial_qj(model: RobotModel) -> np.ndarray:
    qj = np.zeros(model.nj)
    for name, deg in INITIAL_CONFIGURATION_DEG.items():
        # the payload model FIXES the elbow/shoulder-yaw joints at the
        # box-carrying pose — absent joints are folded into the link
        # geometry
        if name in model.joint_names:
            qj[model.dof_index(name)] = np.deg2rad(deg)
    return qj


def initial_q(model: RobotModel, settle: float = 0.0, batch: int = 1,
              device=None, dtype=torch.float32) -> rbd.RobotQ:
    """Half-sitting posture, midsole at the origin, for a batch of `batch`
    robots; `settle` lowers the base by that amount (pre-compression of the
    contact springs)."""
    q = rbd.neutral_q(model, batch, device, dtype)._replace(
        qj=torch.as_tensor(initial_qj(model), dtype=dtype,
                           device=device).repeat(batch, 1))
    f = rbd.fk(model, q)
    _, pl = rbd.site_pose(model, f, "l_sole")
    _, pr = rbd.site_pose(model, f, "r_sole")
    return q._replace(base_pos=-(pl + pr) / 2.0
                      - pl.new_tensor([0.0, 0.0, settle]))
