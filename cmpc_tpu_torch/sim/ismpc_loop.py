"""IS-MPC legacy baseline closed loop: LIP plant + Kalman filter + IS-MPC
(port of ``cmpc_tpu.sim.ismpc_loop``), batched.

The functional equivalent of original_code/simulation.py:133-193 with the
DART robot replaced by the LIP plant itself (the model the controller
assumes): per tick {KF predict on last ZMP command, KF update on noisy
measurement, IS-MPC solve, integrate plant}.  The tick loop is a Python
loop; it runs no hand-written kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.config import (DEFAULT_FOOT_Y, WalkConfig, default_vref,
                                   resolve_device)
from cmpc_tpu_torch.models.lip import lip_dynamics
from cmpc_tpu_torch.ops import ismpc, kalman
from cmpc_tpu_torch.plan import footsteps, timing as timing_mod


class ISMPCTrace(NamedTuple):
    """Per-tick recorded quantities, each (B, T, 3)."""

    com_pos: torch.Tensor
    com_vel: torch.Tensor
    zmp_pos: torch.Tensor   # plant (true) ZMP
    zmp_des: torch.Tensor   # MPC node-1 ZMP
    com_flt: torch.Tensor   # Kalman-filtered CoM


class ISMPCCarry(NamedTuple):
    x: torch.Tensor          # (B, 9) true LIP plant state
    kf: kalman.KalmanState
    solver: ismpc.ISMPCState
    u_prev: torch.Tensor     # (B, 3) last commanded zmp velocity


def run(T_sim: int = 500, cfg: WalkConfig | None = None,
        icfg: ismpc.ISMPCConfig | None = None, noise_std: float = 0.0,
        generator: torch.Generator | None = None, batch: int = 1, *,
        device="cuda", dtype=torch.float32):
    """Closed-loop IS-MPC walk of `batch` identical robots.  Returns
    (carry, ISMPCTrace).  Measurement noise (noise_std > 0) is drawn from
    `generator`, which must then be given and live on `device`."""
    device = resolve_device(device)
    cfg = cfg or WalkConfig()
    icfg = icfg or ismpc.ISMPCConfig(eta=cfg.eta, g=cfg.g,
                                     foot_size=cfg.foot_size,
                                     delta=cfg.world_time_step)
    if noise_std and generator is None:
        raise ValueError("noise_std > 0 needs an explicit torch.Generator")
    timing = timing_mod.build_timing(cfg)
    kw = dict(dtype=dtype, device=device)
    # the velocity commands pass through float32, as in the JAX package
    vref = torch.as_tensor(default_vref(cfg.num_steps).astype(np.float32),
                           device=device).to(dtype)[None].expand(batch, -1, -1)
    plan = footsteps.plan_footsteps(
        vref, cfg, timing, torch.full((batch,), DEFAULT_FOOT_Y, **kw))

    km = kalman.lip_kalman_model(icfg.eta, icfg.delta, **kw)
    x0 = torch.zeros(batch, 9, **kw)
    x0[:, 6] = cfg.h
    carry = ISMPCCarry(
        x=x0,
        kf=kalman.KalmanState(x=x0, P=torch.eye(9, **kw).repeat(batch, 1, 1)),
        solver=ismpc.init_state(icfg, batch, **kw),
        u_prev=torch.zeros(batch, 3, **kw))
    table = ismpc.moving_constraint_table(
        plan.pos, np.asarray(timing.ss, np.float64),
        np.asarray(timing.ds, np.float64),
        np.asarray(timing.start, np.float64), (0.0, 0.0), T_sim + icfg.N)

    def tick(carry: ISMPCCarry, t: int):
        # KF: predict on last command, update on (noisy) measurement
        kf = kalman.predict(km, carry.kf, carry.u_prev)
        meas = carry.x
        if noise_std:
            meas = meas + noise_std * torch.randn(
                batch, 9, generator=generator, **kw)
        kf = kalman.update(km, kf, meas)

        solver, (_, _, _, zmp_pos, u0) = ismpc.solve(
            carry.solver, kf.x, *ismpc.moving_constraint(t, table, icfg),
            icfg)

        # integrate the true LIP plant under the ZMP-velocity command.
        # The z block of the LIP is an *unstable* equilibrium
        # (z'' = eta^2 (z - z_zmp) - g); in the reference the plant is DART,
        # whose ground contact holds the height physically
        # (original_code/simulation.py), so the evaluation plant pins
        # com_z = h / vel_z = 0 and only x/y evolve as a true LIP.
        x_new = carry.x + icfg.delta * lip_dynamics(carry.x, u0, icfg.eta,
                                                    icfg.g)
        x_new[:, 6] = cfg.h
        x_new[:, 7] = 0.0

        trace = ISMPCTrace(
            com_pos=carry.x[:, 0::3], com_vel=carry.x[:, 1::3],
            zmp_pos=carry.x[:, 2::3], zmp_des=zmp_pos,
            com_flt=kf.x[:, 0::3])
        return ISMPCCarry(x=x_new, kf=kf, solver=solver, u_prev=u0), trace

    traces = []
    for t in range(T_sim):
        carry, tr = tick(carry, t)
        traces.append(tr)
    return carry, ISMPCTrace(*(torch.stack(f, dim=1) for f in zip(*traces)))
