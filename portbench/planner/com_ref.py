"""CoM reference generation — quintic spline as a static linear map,
batched (port of ``cmpc_tpu.plan.com_ref``).

The knot *times* are static, so the min-norm spline coefficients are a
precomputed linear map ``coeffs = W @ knots`` (numpy, built once per
config) followed by static sampling bases; the per-scenario work is two
small matmuls.  The reference's unit quirks are reproduced as in the JAX
module.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from portbench.planner.config import WalkConfig
from portbench.planner.footsteps import FootstepPlan
from portbench.planner.swing import feet_ref_at
from portbench.planner.timing import GaitTiming


class ComRef(NamedTuple):
    pos: torch.Tensor  # (B, P, 3)
    vel: torch.Tensor  # (B, P, 3)
    acc: torch.Tensor  # (B, P, 3)


def _knot_ticks(cfg: WalkConfig):
    """Static knot layout (functions.py:11-55)."""
    scale = cfg.ss_duration + cfg.ds_duration
    first_time_knot = 2 * scale
    first_contact = first_time_knot + cfg.ss_duration + 1
    ticks = [i for i in range(first_time_knot, cfg.num_steps * scale - 1)
             if (i - first_contact) % scale == 0]
    seq_x = [first_time_knot] + ticks
    seq_y = [first_time_knot] + [i + cfg.ds_duration - 1 for i in ticks]
    return ticks, seq_x, seq_y


@functools.lru_cache(maxsize=8)
def _spline_statics(cfg: WalkConfig):
    """The min-norm coefficient map W (6n, n) and per-axis sampling bases
    (numpy); constraint rows follow quintic_spline (functions.py:129-157)."""
    ticks, seq_x, seq_y = _knot_ticks(cfg)
    n = 2 + len(ticks)
    nv = 6 * n
    rows, rhs_sel = [], []

    def add(row, sel_idx=None):
        rows.append(row)
        sel = np.zeros(n)
        if sel_idx is not None:
            sel[sel_idx] = 1.0
        rhs_sel.append(sel)

    for i in range(n - 1):
        r = np.zeros(nv)
        r[6 * i] = 1.0
        add(r, i)
        r = np.zeros(nv)
        r[6 * i:6 * i + 6] = 1.0
        add(r, i + 1)
    r = np.zeros(nv)
    r[1] = 1.0
    add(r)
    r = np.zeros(nv)
    r[6 * (n - 1) + 1] = 1.0
    add(r)
    for i in range(n - 1):
        r = np.zeros(nv)
        r[6 * i + 1:6 * i + 6] = [1, 2, 3, 4, 5]
        r[6 * (i + 1) + 1] = -1.0
        add(r)
    r = np.zeros(nv)
    r[2] = 2.0
    add(r)
    for i in range(n - 1):
        r = np.zeros(nv)
        r[6 * i + 2:6 * i + 6] = [2, 6, 12, 20]
        r[6 * (i + 1) + 2] = -2.0
        add(r)

    C = np.stack(rows)
    Rsel = np.stack(rhs_sel)
    W = np.linalg.pinv(C) @ Rsel

    def bases(seq):
        L = seq[-1]
        seg = np.searchsorted(np.asarray(seq), np.arange(L), side="right")
        prev = np.concatenate([[0], seq])[seg]
        length = (np.asarray(seq)[seg] - prev).astype(np.float64)
        tau = (np.arange(L) - prev) / length
        bpos = np.stack([np.ones(L), tau, tau**2, tau**3, tau**4, tau**5], 1)
        bvel = np.stack([np.zeros(L), np.ones(L), 2 * tau, 3 * tau**2,
                         4 * tau**3, 5 * tau**4], 1)
        bacc = np.stack([np.zeros(L), np.zeros(L), 2 * np.ones(L), 6 * tau,
                         12 * tau**2, 20 * tau**3], 1)
        if cfg.physical_ref_units:
            secs = length * cfg.world_time_step
            bvel = bvel / secs[:, None]
            bacc = bacc / secs[:, None] ** 2
        else:
            bacc = bacc / length[:, None] ** 2
        return seg.astype(np.int64), bpos, bvel, bacc

    return n, W, bases(tuple(seq_x)), bases(tuple(seq_y))


def _sample(coeffs, base, P):
    """coeffs (B, n, 6); base of length L; hold the last sample to P ticks.
    Returns pos, vel, acc of shape (B, P)."""
    seg, bpos, bvel, bacc = base
    c = coeffs[:, torch.as_tensor(seg, device=coeffs.device)]   # (B, L, 6)
    out = []
    for b in (bpos, bvel, bacc):
        v = torch.sum(c * torch.as_tensor(b, dtype=coeffs.dtype,
                                          device=coeffs.device), dim=-1)
        v = torch.cat([v, v[:, -1:].expand(-1, P - v.shape[1])], dim=1)
        out.append(v)
    return out


def build_com_ref(plan: FootstepPlan, cfg: WalkConfig, timing: GaitTiming,
                  foot_y) -> ComRef:
    """CoM reference: knots from the (initial) plan's feet trajectories,
    min-norm quintic coefficients, per-tick samples (functions.py:11-124).
    x knots are mid-feet x; y knots are the upcoming swing-target foot's y
    scaled by knot_y_scale; z is constant h with zero vel/acc."""
    ticks, _, _ = _knot_ticks(cfg)
    n, W, base_x, base_y = _spline_statics(cfg)
    P = cfg.pad_ticks
    B = plan.pos.shape[0]
    dt, dev = plan.pos.dtype, plan.pos.device

    feet = [feet_ref_at(t, plan, cfg, timing, foot_y) for t in [0] + ticks]
    pose_l = torch.stack([f.pose_l for f in feet], dim=1)    # (B, K, 6)
    pose_r = torch.stack([f.pose_r for f in feet], dim=1)
    mid_x = (pose_l[..., 3] + pose_r[..., 3]) / 2.0
    sel_plan_idx = np.array(
        [1] + [min(k + 2, cfg.num_steps - 1) for k in range(len(ticks))])
    sel_is_left = torch.as_tensor(
        np.asarray(timing.foot_is_left)[sel_plan_idx], device=dev)
    sel_y = torch.where(sel_is_left, pose_l[..., 4], pose_r[..., 4])

    knot_x = torch.cat([mid_x[:, :1], mid_x], dim=1)
    knot_y = torch.cat([(pose_l[:, :1, 4] + pose_r[:, :1, 4]) / 2.0,
                        sel_y * cfg.knot_y_scale], dim=1)

    Wt = torch.as_tensor(W, dtype=dt, device=dev)
    co_x = (Wt @ knot_x[..., None])[..., 0].reshape(B, n, 6)
    co_y = (Wt @ knot_y[..., None])[..., 0].reshape(B, n, 6)

    px, vx, ax = _sample(co_x, base_x, P)
    py, vy, ay = _sample(co_y, base_y, P)
    pz = torch.full_like(px, cfg.h)
    zz = torch.zeros_like(px)
    return ComRef(pos=torch.stack([px, py, pz], -1),
                  vel=torch.stack([vx, vy, zz], -1),
                  acc=torch.stack([ax, ay, zz], -1))
