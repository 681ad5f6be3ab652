"""Footstep plan positions, batched over scenarios (port of
``cmpc_tpu.plan.footsteps``).

A virtual unicycle is integrated over the per-step velocity commands with
explicit Euler sub-steps, and footsteps are placed at alternating lateral
offsets (footstep_planner_vertices.py:23-66).  ``pos`` is part of the
closed-loop state: footstep adaptation writes into it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.planner.config import WalkConfig
from portbench.planner.timing import GaitTiming


class FootstepPlan(NamedTuple):
    pos: torch.Tensor   # (B, S, 3) footstep positions, z == 0
    yaw: torch.Tensor   # (B, S)    footstep yaw angles


def initial_feet_poses(foot_y):
    """[ang(3), pos(3)] sole poses at t=0, (B, 6) each: feet mirrored about
    the x-z plane (simulation.py:72-77)."""
    z = 0.0 * foot_y
    z3 = torch.zeros(foot_y.shape[0], 3, dtype=foot_y.dtype,
                     device=foot_y.device)
    lpose = torch.cat([z3, torch.stack([z, foot_y, z], dim=-1)], dim=-1)
    rpose = torch.cat([z3, torch.stack([z, -foot_y, z], dim=-1)], dim=-1)
    return lpose, rpose


def plan_footsteps(vref, cfg: WalkConfig, timing: GaitTiming, foot_y,
                   step_y_offset=0.1) -> FootstepPlan:
    """Integrate the unicycle and place S footsteps.  vref (B, S, 3);
    steps 0 and 1 do not move the unicycle; step j > 1 integrates its
    command for its whole (ss + ds) duration, theta before position
    (footstep_planner_vertices.py:38-43)."""
    dt = cfg.world_time_step
    S = cfg.num_steps
    durations = np.asarray(timing.ss + timing.ds)

    lpose, rpose = initial_feet_poses(foot_y)
    upos = (lpose[:, 3:5] + rpose[:, 3:5]) / 2.0
    utheta = (lpose[:, 2] + rpose[:, 2]) / 2.0

    step_y_offset = torch.as_tensor(step_y_offset, dtype=foot_y.dtype,
                                    device=foot_y.device)
    left = torch.as_tensor(timing.foot_is_left, device=foot_y.device)
    disp_sign = torch.where(left[None], step_y_offset.reshape(-1, 1),
                            -step_y_offset.reshape(-1, 1))   # (B or 1, S)

    n_sub = int(durations[2]) if S > 2 else 0
    upos_seq, utheta_seq = [], []
    for j in range(S):
        if j > 1:
            cmd = vref[:, j]
            for _ in range(n_sub):
                utheta = utheta + cmd[:, 2] * dt
                c, s = torch.cos(utheta), torch.sin(utheta)
                upos = upos + torch.stack(
                    [c * cmd[:, 0] - s * cmd[:, 1],
                     s * cmd[:, 0] + c * cmd[:, 1]], dim=-1) * dt
        upos_seq.append(upos)
        utheta_seq.append(utheta)
    upos_seq = torch.stack(upos_seq, dim=1)        # (B, S, 2)
    utheta_seq = torch.stack(utheta_seq, dim=1)    # (B, S)

    displ = torch.stack([-torch.sin(utheta_seq), torch.cos(utheta_seq)],
                        dim=-1) * disp_sign[..., None]
    xy = upos_seq + displ
    pos = torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)
    return FootstepPlan(pos=pos, yaw=utheta_seq)


def contact_pose_refs(plan: FootstepPlan, timing: GaitTiming):
    """Per-tick contact pose references [ang(3), pos(3)] for both feet,
    (B, P, 6) each, gathered from the plan with the static parity tables
    (footstep_planner_vertices.py:106-147)."""
    def gather(idx):
        idx = torch.as_tensor(idx.astype(np.int64), device=plan.pos.device)
        p = plan.pos[:, idx]                   # (B, P, 3)
        yaw = plan.yaw[:, idx]                 # (B, P)
        zero = torch.zeros_like(yaw)
        ang = torch.stack([zero, zero, yaw], dim=-1)
        return torch.cat([ang, p], dim=-1)

    return gather(timing.left_ref_idx), gather(timing.right_ref_idx)
