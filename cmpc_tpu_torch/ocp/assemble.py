"""Per-tick assembly of MPC parameters from precomputed reference arrays,
batched (port of ``cmpc_tpu.ocp.assemble``).

``pack_x0`` packs the measured state with the reference's quirks;
``gather_params`` slices the references over the horizon at
t + (1+i)*mpc_rate and the contact gates at t + i*mpc_rate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.ocp.problem import MPCParams
from cmpc_tpu_torch.plan.com_ref import ComRef
from cmpc_tpu_torch.plan.footsteps import FootstepPlan
from cmpc_tpu_torch.plan.timing import GaitTiming, at, clamp_index


class RefArrays(NamedTuple):
    """Per-scenario precomputed reference arrays (length P ticks)."""

    com: ComRef
    pose_ref_l: torch.Tensor  # (B, P, 6) [ang, pos] from the initial plan
    pose_ref_r: torch.Tensor  # (B, P, 6)


def pack_x0(com_pos, com_vel, hw, theta_hat, pose_l, pose_r,
            t: int, plan: FootstepPlan, refs: RefArrays, timing: GaitTiming,
            cfg: WalkConfig | None = None):
    """Measured-state packing (centroidal_mpc_vertices.py:482-509), (B, 20):

    * hw negated when cfg.hw_meas_negated (the reference's sign quirk);
    * foot yaw from the measured pose's ang-z;
    * stance feet from the static per-tick contact ref before the first-step
      cutoff, from the live plan (parity-indexed at t - ss_duration) after;
    * with cfg.x0_swing_from_traj the swing foot tracks its commanded
      trajectory, otherwise it is pinned like a stance foot.

    Past the end of the tables every read takes their last row, as JAX's
    gathers do.
    """
    t = int(t)
    if at(timing.stance_from_table, t):
        row = clamp_index(t, refs.pose_ref_l.shape[1])
        stance_l = refs.pose_ref_l[:, row, 3:6]
        stance_r = refs.pose_ref_r[:, row, 3:6]
    else:
        stance_l = plan.pos[:, int(at(timing.stance_left_idx, t))]
        stance_r = plan.pos[:, int(at(timing.stance_right_idx, t))]

    if cfg is not None and cfg.x0_swing_from_traj:
        foot_l = stance_l if at(timing.gamma_l, t) > 0.5 else pose_l[:, 3:6]
        foot_r = stance_r if at(timing.gamma_r, t) > 0.5 else pose_r[:, 3:6]
    else:
        foot_l, foot_r = stance_l, stance_r

    if cfg is not None and cfg.hw_meas_negated:
        hw = -hw

    return torch.cat([com_pos, com_vel, hw, theta_hat,
                      pose_l[:, 2:3], foot_l, pose_r[:, 2:3], foot_r], dim=1)


def gather_params(t, x0, refs: RefArrays, timing: GaitTiming,
                  cfg: WalkConfig, k1, k2, mass) -> MPCParams:
    """MPCParams at tick t: a Python int shared by the batch, or a (B,)
    integer tensor of per-scenario ticks."""
    N, rate = cfg.N, cfg.mpc_rate
    dt, dev = x0.dtype, x0.device
    B = x0.shape[0]
    P = refs.com.pos.shape[1]
    if isinstance(t, torch.Tensor):
        t = t.to(device=dev, dtype=torch.int64)[:, None]
        ar = torch.arange(N + 1, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
    else:
        t = int(t)
        ar = np.arange(N + 1)
        rows = slice(None)
    # JAX clamps out-of-range gathers silently where torch would raise:
    # clamp explicitly (only reachable past the end of the padded tables)
    idx = clamp_index(t + (1 + ar[:N]) * rate, P)             # nodes 1..N
    gidx = clamp_index(t + ar * rate, P)
    if not isinstance(t, torch.Tensor) and t + N * rate < P:
        idx = slice(t + rate, t + N * rate + 1, rate)   # a view, no copy
    com_ref = torch.cat([refs.com.pos[rows, idx], refs.com.vel[rows, idx],
                         refs.com.acc[rows, idx]], dim=-1)
    # the gate tables live on the device once (keyed by their contents)
    gl_tbl = const(("gamma", timing.gamma_l.tobytes()),
                   lambda: timing.gamma_l, dev, dt)
    gr_tbl = const(("gamma", timing.gamma_r.tobytes()),
                   lambda: timing.gamma_r, dev, dt)
    if isinstance(t, torch.Tensor):
        gamma_l, gamma_r = gl_tbl[gidx], gr_tbl[gidx]
    else:
        g0, g1 = int(gidx[0]), int(gidx[-1]) + 1
        if rate == 1 and g1 - g0 == N + 1:
            gamma_l = gl_tbl[g0:g1].expand(B, N + 1)
            gamma_r = gr_tbl[g0:g1].expand(B, N + 1)
        else:
            gamma_l = gl_tbl[gidx].expand(B, N + 1)
            gamma_r = gr_tbl[gidx].expand(B, N + 1)
    return MPCParams(
        x0=x0,
        com_ref=com_ref,
        pos_ref_l=refs.pose_ref_l[rows, idx, 3:6],
        pos_ref_r=refs.pose_ref_r[rows, idx, 3:6],
        yaw_ref_l=refs.pose_ref_l[rows, idx, 2],
        yaw_ref_r=refs.pose_ref_r[rows, idx, 2],
        gamma_l=gamma_l,
        gamma_r=gamma_r,
        k1=k1, k2=k2, mass=mass,
    )
