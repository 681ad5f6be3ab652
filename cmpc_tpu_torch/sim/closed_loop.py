"""Closed-loop rollout: planner -> MPC -> plant, batched over scenarios
(port of ``cmpc_tpu.sim.closed_loop``).

The tick loop is a Python loop; every scenario of the batch shares the
tick t, so the static gait tables are read on the host and only
per-scenario quantities (state, plan, pushes, payload) live in tensors.
Past the tables' last tick every read takes their last row, as JAX's
clamped gathers do; the push window and the payload onset compare the
tick itself.
Footstep adaptation writes the MPC's terminal swing-foot position into
the carried plan at the statically known event ticks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.config import Scenario, WalkConfig
from cmpc_tpu_torch.models import centroidal as cm
from cmpc_tpu_torch.ocp import assemble, problem
from cmpc_tpu_torch.ops import sqp
from cmpc_tpu_torch.plan import com_ref as com_ref_mod
from cmpc_tpu_torch.plan import footsteps, swing, timing as timing_mod
from cmpc_tpu_torch.plan.timing import at, clamp_index
from cmpc_tpu_torch.sim.plant import PlantState, plant_step


class LoopCarry(NamedTuple):
    plant: PlantState
    plan_pos: torch.Tensor         # (B, S, 3) live footstep positions
    theta_hat: torch.Tensor        # (B, 3) MPC's carried disturbance estimate
    solver: sqp.SolverState


class Trace(NamedTuple):
    """Per-tick recorded quantities, each (B, T, ...)."""

    com_pos: torch.Tensor
    com_vel: torch.Tensor
    com_pos_des: torch.Tensor
    com_acc_des: torch.Tensor
    com_ref: torch.Tensor
    hw: torch.Tensor
    hw_des: torch.Tensor
    theta_hat: torch.Tensor
    pose_l: torch.Tensor
    pose_r: torch.Tensor
    forces: torch.Tensor
    mpc_contact_l: torch.Tensor
    mpc_contact_r: torch.Tensor
    r_prim: torch.Tensor
    lyap_violation: torch.Tensor
    adapted: torch.Tensor
    x0: torch.Tensor


def rollout(scenario: Scenario, cfg: WalkConfig, T_sim: int | None = None,
            return_tick: bool = False, t0: int = 0,
            carry_in: LoopCarry | None = None):
    """Run the batch of scenarios closed loop for T_sim ticks from tick t0
    (optionally resuming from a returned carry).  Returns (carry, Trace).

    return_tick=True returns (carry0, tick) instead, with
    tick(carry, t) -> (carry, Trace of that tick, fields (B, ...)), to step
    the loop manually."""
    timing = timing_mod.build_timing(cfg)
    if T_sim is None:
        T_sim = cfg.num_steps * (cfg.ss_duration + cfg.ds_duration)
    sc = scenario
    like = sc.init_com
    B = like.shape[0]
    dt, dev = like.dtype, like.device

    plan0 = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y,
                                     sc.step_y_offset)
    pose_ref_l, pose_ref_r = footsteps.contact_pose_refs(plan0, timing)
    cref = com_ref_mod.build_com_ref(plan0, cfg, timing, sc.foot_y)
    refs = assemble.RefArrays(com=cref, pose_ref_l=pose_ref_l,
                              pose_ref_r=pose_ref_r)
    polygon = cm.foot_polygon(cfg.foot_length, cfg.foot_width, device=dev,
                              dtype=dt)
    support_is_left_tbl = timing.foot_is_left[timing.step_idx]
    gravity = cm.gravity_vector(cfg.g, like)

    if carry_in is None:
        x0_init = like.new_zeros(B, 20)
        x0_init[:, cm.P_COM] = sc.init_com
        x0_init[:, cm.V_COM] = sc.init_vel
        zero3 = torch.zeros_like(sc.init_com)
        carry = LoopCarry(
            plant=PlantState(com_pos=sc.init_com, com_vel=sc.init_vel,
                             hw=zero3),
            plan_pos=plan0.pos, theta_hat=zero3,
            solver=sqp.init_solver_state(cfg, x0_init, mass=sc.mpc_mass))
    else:
        carry = carry_in

    N, P = cfg.N, cfg.pad_ticks

    def tick(carry: LoopCarry, t: int):
        plan = footsteps.FootstepPlan(pos=carry.plan_pos, yaw=plan0.yaw)
        feet = swing.feet_ref_at(t, plan, cfg, timing, sc.foot_y)
        x0 = assemble.pack_x0(carry.plant.com_pos, carry.plant.com_vel,
                              carry.plant.hw, carry.theta_hat,
                              feet.pose_l, feet.pose_r,
                              t, plan, refs, timing, cfg)
        params = assemble.gather_params(t, x0, refs, timing, cfg,
                                        sc.k1, sc.k2, sc.mpc_mass)

        solver, info = sqp.solve_mpc(carry.solver, params, cfg)
        X, U = problem.split_z(solver.z, cfg)
        x1, u0 = X[:, 1], U[:, 0]

        # CoM acceleration from the force balance
        # (centroidal_mpc_vertices.py:633-636)
        sum_f = (u0[:, 0:12].reshape(B, 4, 3).sum(1) * params.gamma_l[:, :1]
                 + u0[:, 12:24].reshape(B, 4, 3).sum(1)
                 * params.gamma_r[:, :1])
        com_acc_des = sum_f / sc.mpc_mass[:, None] + gravity

        # footstep adaptation at the static event ticks
        do_adapt = bool(at(timing.update_event, t)) and cfg.update_contact
        plan_pos = carry.plan_pos
        if do_adapt:
            new_contact = X[:, N, cm.POS_R] if at(support_is_left_tbl, t) \
                else X[:, N, cm.POS_L]
            plan_pos = plan_pos.clone()
            plan_pos[:, int(at(timing.adapt_target, t))] = new_contact

        # disturbance window (simulation.py:195-198: t > start, t < end)
        pushing = ((t > sc.push_start) & (t < sc.push_end))[:, None]
        ext_f = torch.where(pushing, sc.push_force, 0.0)
        ext_tau = torch.where(pushing, sc.push_torque, 0.0)

        # payload drop: mass step at the onset tick plus a one-tick impact
        # impulse m_p * v_impact
        has_payload = t >= sc.payload_onset
        eff_mass = sc.plant_mass + torch.where(has_payload, sc.payload_mass,
                                               0.0)
        impact = (t == sc.payload_onset) & (sc.payload_mass > 0)
        f_impact = (sc.payload_mass * sc.payload_impact_vel
                    / cfg.world_time_step)
        ext_f = torch.cat([ext_f[:, :2], (ext_f[:, 2] + torch.where(
            impact, -f_impact, 0.0))[:, None]], dim=1)

        plant = plant_step(carry.plant, x1[:, cm.P_COM], x1[:, cm.V_COM],
                           com_acc_des, u0, float(at(timing.gamma_l, t)),
                           float(at(timing.gamma_r, t)),
                           feet.pose_l, feet.pose_r, sc.mpc_mass,
                           eff_mass, ext_f, ext_tau, cfg.g,
                           polygon, cfg.world_time_step,
                           hw_compliance=cfg.plant_hw_compliance,
                           hw_shed=cfg.plant_hw_shed)

        trace = Trace(
            com_pos=carry.plant.com_pos, com_vel=carry.plant.com_vel,
            com_pos_des=x1[:, cm.P_COM], com_acc_des=com_acc_des,
            com_ref=refs.com.pos[:, clamp_index(t, P)],
            hw=carry.plant.hw, hw_des=x1[:, cm.H_W],
            theta_hat=x1[:, cm.THETA],
            pose_l=feet.pose_l, pose_r=feet.pose_r,
            forces=u0[:, 0:24],
            mpc_contact_l=x1[:, cm.POS_L], mpc_contact_r=x1[:, cm.POS_R],
            r_prim=info.r_prim, lyap_violation=info.lyap_violation,
            adapted=torch.full((B,), do_adapt, device=dev), x0=x0,
        )
        return LoopCarry(plant=plant, plan_pos=plan_pos,
                         theta_hat=x1[:, cm.THETA], solver=solver), trace

    if return_tick:
        return carry, tick
    traces = []
    for t in range(int(t0), int(t0) + T_sim):
        carry, tr = tick(carry, t)
        traces.append(tr)
    return carry, Trace(*(torch.stack(f, dim=1) for f in zip(*traces)))
