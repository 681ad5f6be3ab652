"""Rotation utilities, batched (port of ``cmpc_tpu.utils.rotations``).

Only what the controller needs: z-axis (yaw) rotations, rotation matrix
<-> rotation vector, and rotation-vector differences.  Every function
takes any number of leading axes.  The small-angle branches are selects
(``torch.where``): both sides are computed, so each division and the
``acos`` argument are guarded to keep the unselected side finite.
"""

from __future__ import annotations

import torch


def rot_z(yaw):
    """Rotation about z. yaw: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    return torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def hat(v):
    """Skew-symmetric matrix of v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rotvec_to_matrix(rv):
    """Rodrigues formula, (..., 3) -> (..., 3, 3); safe at the identity."""
    theta = torch.linalg.vector_norm(rv, dim=-1, keepdim=True)
    small = theta < 1e-8
    e_x = torch.zeros_like(rv)
    e_x[..., 0] = 1.0
    axis = torch.where(small, e_x,
                       rv / torch.where(small, torch.ones_like(theta), theta))
    K = hat(axis)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device).expand(K.shape)
    R = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    return torch.where(small[..., None], eye + hat(rv), R)


def matrix_to_rotvec(R):
    """(..., 3, 3) -> (..., 3). Stable for small angles; angle < pi assumed
    (true for all torso/feet orientations in the walking task)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
    theta = torch.acos(cos_theta)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_theta = torch.sin(theta)
    small = theta < 1e-6
    scale = torch.where(
        small, torch.full_like(theta, 0.5),
        theta / torch.where(small, torch.ones_like(theta), 2.0 * sin_theta))
    return w * scale[..., None]


def rotvec_difference(rv_a, rv_b):
    """Rotation vector of R_b^{-1} R_a — the orientation error used by the
    whole-body ID task PD laws."""
    Ra = rotvec_to_matrix(rv_a)
    Rb = rotvec_to_matrix(rv_b)
    return matrix_to_rotvec(Rb.transpose(-1, -2) @ Ra)


def pose_difference(pose_a, pose_b):
    """6-dof pose error [pos_diff, rotvec_diff]; poses are [pos(3),
    rotvec(3)]."""
    pos = pose_a[..., :3] - pose_b[..., :3]
    rot = rotvec_difference(pose_a[..., 3:], pose_b[..., 3:])
    return torch.cat([pos, rot], dim=-1)
