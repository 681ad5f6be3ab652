"""Swing-foot trajectory generation, batched (port of
``cmpc_tpu.plan.swing``).

Cubic polynomial in xy + yaw between plan[s-1] and plan[s+1] during single
support, a quartic z bump of height ``step_height``, frozen poses in double
support, initial poses during step 0
(foot_trajectory_generator.py:12-114).  The tick t is a Python int shared
by every scenario, so the phase logic is resolved on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.planner.config import WalkConfig
from portbench.planner.footsteps import FootstepPlan, initial_feet_poses
from portbench.planner.timing import GaitTiming, at


class FeetRef(NamedTuple):
    """Per-foot references [ang(3), pos(3)], (B, 6) each."""

    pose_l: torch.Tensor
    vel_l: torch.Tensor
    acc_l: torch.Tensor
    pose_r: torch.Tensor
    vel_r: torch.Tensor
    acc_r: torch.Tensor


def _plan_pose(plan: FootstepPlan, j: int):
    yaw = plan.yaw[:, j]
    zero = torch.zeros_like(yaw)
    return torch.cat([torch.stack([zero, zero, yaw], dim=-1),
                      plan.pos[:, j]], dim=-1)


def _swing_factors(T: int, t_in: int, step_height: float, delta: float):
    """The polynomial factors of the swing profile, computed in float32
    whatever the working dtype: the JAX package casts T and t to float32
    (swing.py:56-58) even under x64, so its factors carry f32 rounding —
    and its z velocity/acceleration are scaled by 1/delta in f32 too (XLA
    folds the division by a constant into a product with the f32
    reciprocal).  Every constant is an explicit f32 tensor: torch evaluates
    ``scalar / tensor`` as a reciprocal product, which rounds differently
    from the division JAX performs there."""
    def c(x):
        return torch.tensor(float(x), dtype=torch.float32)

    T = c(max(T, 1))
    tf = c(t_in)
    T2 = T * T
    T3 = T2 * T
    T4 = T2 * T2
    tf2 = tf * tf
    tf3 = tf2 * tf
    tf4 = tf2 * tf2
    A = c(-2.0) / T3
    B = c(3.0) / T2
    H = step_height
    A4 = c(16 * H) / T4
    B4 = c(-32 * H) / T3
    C4 = c(16 * H) / T2
    return dict(
        pos=A * tf3 + B * tf2,
        vel=3 * A * tf2 + 2 * B * tf,
        acc=6 * A * tf + 2 * B,
        z_pos=A4 * tf4 + B4 * tf3 + C4 * tf2,
        z_vel=(4 * A4 * tf3 + 3 * B4 * tf2 + 2 * C4 * tf)
        * (c(1.0) / c(delta)),
        z_acc=(12 * A4 * tf2 + 6 * B4 * tf + 2 * C4)
        * (c(1.0) / c(delta ** 2)),
    )


def feet_ref_at(t: int, plan: FootstepPlan, cfg: WalkConfig,
                timing: GaitTiming, foot_y) -> FeetRef:
    """Foot pose/vel/acc references at tick t (a Python int; past the
    tables' end, their last row)."""
    t = int(t)
    s = int(at(timing.step_idx, t))
    t_in = int(at(timing.t_in_step, t))
    in_ds = bool(at(timing.is_ds, t))
    support_is_left = bool(at(timing.foot_is_left, s))
    S = timing.num_steps
    s_prev = min(max(s - 1, 0), S - 1)
    s_next = min(max(s + 1, 0), S - 1)
    zero6 = torch.zeros_like(plan.pos[:, 0, :1]).expand(-1, 6)

    if s == 0:
        # step 0: hold the initial foot poses
        lpose0, rpose0 = initial_feet_poses(foot_y)
        return FeetRef(pose_l=lpose0, vel_l=zero6, acc_l=zero6,
                       pose_r=rpose0, vel_r=zero6, acc_r=zero6)

    support_pose = _plan_pose(plan, s)
    if in_ds:
        # double support: support = plan[s], swing(target) = plan[s+1],
        # all velocities zero
        swing_pose = _plan_pose(plan, s_next)
        swing_vel = swing_acc = zero6
    else:
        start_pose = _plan_pose(plan, s_prev)
        target_pose = _plan_pose(plan, s_next)
        delta = cfg.world_time_step
        # f32 values as Python floats: exact in either working dtype, and
        # no host-to-device copy
        fac = {k: v.item() for k, v in _swing_factors(
            int(at(timing.ss, s)), t_in, cfg.step_height, delta).items()}
        d = target_pose - start_pose
        swing_pose = start_pose + d * fac["pos"]
        swing_vel = d * fac["vel"] / delta
        swing_acc = d * fac["acc"] / delta ** 2
        B = d.shape[0]
        swing_pose = torch.cat([swing_pose[:, :5],
                                d.new_full((B, 1), fac["z_pos"])], dim=1)
        swing_vel = torch.cat([swing_vel[:, :5],
                               d.new_full((B, 1), fac["z_vel"])], dim=1)
        swing_acc = torch.cat([swing_acc[:, :5],
                               d.new_full((B, 1), fac["z_acc"])], dim=1)

    if support_is_left:
        return FeetRef(pose_l=support_pose, vel_l=zero6, acc_l=zero6,
                       pose_r=swing_pose, vel_r=swing_vel, acc_r=swing_acc)
    return FeetRef(pose_l=swing_pose, vel_l=swing_vel, acc_l=swing_acc,
                   pose_r=support_pose, vel_r=zero6, acc_r=zero6)
