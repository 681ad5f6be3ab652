"""Per-tick assembly of the MPC's parameters from the planner's reference
arrays (a copy of ``cmpc_tpu_torch.ocp.assemble.gather_params``): the
references over the horizon at t + (1+i)*mpc_rate and the contact gates at
t + i*mpc_rate."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.planner.config import WalkConfig
from portbench.planner.consts import const
from portbench.planner.com_ref import ComRef
from portbench.planner.timing import GaitTiming, clamp_index


class RefArrays(NamedTuple):
    """Per-scenario precomputed reference arrays (length P ticks)."""

    com: ComRef
    pose_ref_l: torch.Tensor  # (B, P, 6) [ang, pos] from the initial plan
    pose_ref_r: torch.Tensor  # (B, P, 6)


def gather_params(t, x0, refs: RefArrays, timing: GaitTiming,
                  cfg: WalkConfig, k1, k2, mass) -> dict:
    """The MPC's parameters at tick t (a dict of the solve's fields): a Python int shared by the batch, or a (B,)
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
    return dict(
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
