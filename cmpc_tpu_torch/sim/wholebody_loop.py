"""Full-pipeline closed loop on the articulated robot, batched over
scenarios (port of ``cmpc_tpu.sim.wholebody_loop``):

    planner refs -> centroidal MPC -> swing interpolation -> whole-body ID
    -> joint torques -> whole-body contact plant

The centroidal closed loop (sim/closed_loop.py) is the fast evaluation
path; this one exercises every layer including the robot model and the
whole-body controller.  The tick loop is a Python loop over a batched
tick; every scenario shares the tick t, so the static gait tables are read
on the host, as in the centroidal loop.

Status carried over from the JAX package: the pipeline walks through the
initial double support, the first full step and its landing (err_xy about
0.012 m at the t=270 touchdown, swing apex tracked), then accumulates
tracking error during the second swing: the landing impact leaves a
~0.15 m/s CoM velocity error that the marginally contractive loop does not
reject before the next landing compounds it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.config import Scenario, WalkConfig
from cmpc_tpu_torch.models import centroidal as cm
from cmpc_tpu_torch.ocp import assemble, problem
from cmpc_tpu_torch.ops import sqp
from cmpc_tpu_torch.ops.admm import ADMMSettings
from cmpc_tpu_torch.plan import com_ref as com_ref_mod
from cmpc_tpu_torch.plan import footsteps, swing, timing as timing_mod
from cmpc_tpu_torch.rbd.urdf import RobotModel
from cmpc_tpu_torch.wholebody import inverse_dynamics as wbid
from cmpc_tpu_torch.wholebody import plant as wbplant
from cmpc_tpu_torch.wholebody import setup as wbsetup
from cmpc_tpu_torch.wholebody.state import retrieve_state, zmp_estimate


class WBLoopCarry(NamedTuple):
    plant: wbplant.WBPlantState
    plan_pos: torch.Tensor    # (B, S, 3)
    theta_hat: torch.Tensor   # (B, 3)
    solver: sqp.SolverState
    zmp: torch.Tensor         # (B, 3) last contact-force ZMP estimate
    hw_model: torch.Tensor    # (B, 3) MPC's own node-1 hw prediction
    hw_filt: torch.Tensor     # (B, 3) low-passed measured hw


class WBTrace(NamedTuple):
    """Per-tick recorded quantities, each (B, T, ...)."""

    com_pos: torch.Tensor
    com_vel: torch.Tensor
    com_ref: torch.Tensor
    com_pos_des: torch.Tensor
    hw: torch.Tensor
    hw_des: torch.Tensor
    theta_hat: torch.Tensor
    pose_l: torch.Tensor      # measured sole poses [ang, pos]
    pose_r: torch.Tensor
    tau: torch.Tensor         # (nj,) commanded torques
    zmp: torch.Tensor         # (3,) contact-force ZMP estimate
    r_prim_mpc: torch.Tensor
    r_prim_id: torch.Tensor
    adapted: torch.Tensor
    x0: torch.Tensor          # (20,) the measured state the MPC solved from


def rollout(model: RobotModel, scenario: Scenario, cfg: WalkConfig,
            T_sim: int | None = None,
            # rho_adapt=2: a FIXED rho silently UNDER-CONVERGES the ID
            # ADMM in a contact-state-dependent way (at a single-support
            # state rho=10 stalls at r_dual 0.43 with stance fz 5.9 N of
            # the needed 394 N -> the plant free-falls while every logged
            # residual looks healthy; rho=1 fixes that state but stalls
            # the late-double-support solves instead).  Two
            # residual-balanced rho updates converge every phase.
            id_settings: ADMMSettings = ADMMSettings(iters=90, rho=10.0,
                                                     pdas_rounds=2,
                                                     rho_adapt=2),
            contact: wbplant.ContactParams = wbplant.ContactParams(),
            substeps: int = 10,
            id_weights: dict | None = None,
            id_pos_gains: dict | None = None,
            id_vel_gains: dict | None = None,
            hw_feedback_scale: float = 1.0,
            hw_feedback: str = "measured",
            hw_filter_tau: float = 0.15,
            return_tick: bool = False, t0: int = 0,
            carry_in: WBLoopCarry | None = None):
    """Run the batch of articulated robots closed loop for T_sim control
    ticks from tick t0 (optionally resuming from a returned carry).
    Returns (carry, WBTrace).

    return_tick=True returns (carry0, tick) instead, with
    tick(carry, t) -> (carry, WBTrace of that tick, fields (B, ...)), to
    step the loop manually."""
    if hw_feedback not in ("measured", "model", "filtered"):
        raise KeyError(hw_feedback)
    timing = timing_mod.build_timing(cfg)
    if T_sim is None:
        T_sim = cfg.num_steps * (cfg.ss_duration + cfg.ds_duration)
    sc = scenario
    like = sc.init_com
    B = like.shape[0]
    dt, dev = like.dtype, like.device

    plan0 = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y)
    pose_ref_l, pose_ref_r = footsteps.contact_pose_refs(plan0, timing)
    cref = com_ref_mod.build_com_ref(plan0, cfg, timing, sc.foot_y)
    refs = assemble.RefArrays(com=cref, pose_ref_l=pose_ref_l,
                              pose_ref_r=pose_ref_r)
    support_is_left_tbl = timing.foot_is_left[timing.step_idx]
    gravity = cm.gravity_vector(cfg.g, like)

    joint_pos_des = torch.as_tensor(wbsetup.initial_qj(model), dtype=dt,
                                    device=dev).expand(B, model.nj)
    joint_sel = wbid.redundant_selection(model, device=dev, dtype=dt)
    # arms relative to the base (m), where the payload rests
    arm_offset = like.new_tensor([0.15, 0.0, 0.15])
    down = like.new_tensor([0.0, 0.0, -1.0])

    if carry_in is None:
        q0 = wbsetup.initial_q(model, settle=0.0012, batch=B, device=dev,
                               dtype=dt)
        qv0 = like.new_zeros(B, model.nv)
        st0 = retrieve_state(model, q0, qv0)
        x0_init = like.new_zeros(B, 20)
        x0_init[:, cm.P_COM] = st0.com_pos
        zero3 = torch.zeros_like(like)
        carry = WBLoopCarry(
            plant=wbplant.WBPlantState(q=q0, qv=qv0),
            plan_pos=plan0.pos, theta_hat=zero3,
            solver=sqp.init_solver_state(cfg, x0_init, mass=sc.mpc_mass),
            zmp=zero3, hw_model=zero3, hw_filt=zero3)
    else:
        carry = carry_in

    N = cfg.N
    a_lp = cfg.world_time_step / hw_filter_tau
    # hw_model is stored in PLANT convention (pack_x0 re-negates per the
    # reference's measurement quirk), so "model" feedback mode feeds the
    # MPC exactly what it predicted for this tick
    sgn = -1.0 if cfg.hw_meas_negated else 1.0

    def tick(carry: WBLoopCarry, t: int):
        st = retrieve_state(model, carry.plant.q, carry.plant.qv)
        plan = footsteps.FootstepPlan(pos=carry.plan_pos, yaw=plan0.yaw)
        feet = swing.feet_ref_at(t, plan, cfg, timing, sc.foot_y)

        # --- centroidal MPC on the measured state ---
        hw_filt = carry.hw_filt + a_lp * (st.hw - carry.hw_filt)
        hw_fb = {"measured": st.hw, "model": carry.hw_model,
                 "filtered": hw_filt}[hw_feedback]
        x0 = assemble.pack_x0(st.com_pos, st.com_vel,
                              hw_feedback_scale * hw_fb,
                              carry.theta_hat, st.pose_l, st.pose_r,
                              t, plan, refs, timing, cfg)
        params = assemble.gather_params(t, x0, refs, timing, cfg,
                                        sc.k1, sc.k2, sc.mpc_mass)
        solver, info = sqp.solve_mpc(carry.solver, params, cfg)
        X, U = problem.split_z(solver.z, cfg)
        x1, u0 = X[:, 1], U[:, 0]
        sum_f = (u0[:, 0:12].reshape(B, 4, 3).sum(1) * params.gamma_l[:, :1]
                 + u0[:, 12:24].reshape(B, 4, 3).sum(1)
                 * params.gamma_r[:, :1])
        com_acc_des = sum_f / sc.mpc_mass[:, None] + gravity

        # --- task references (simulation.py:207-271) ---
        ang_avg = (feet.pose_l[:, 0:3] + feet.pose_r[:, 0:3]) / 2.0
        om_avg = (feet.vel_l[:, 0:3] + feet.vel_r[:, 0:3]) / 2.0
        al_avg = (feet.acc_l[:, 0:3] + feet.acc_r[:, 0:3]) / 2.0
        desired = wbid.WBDesired(
            pose_l=feet.pose_l, vel_l=feet.vel_l, acc_l=feet.acc_l,
            pose_r=feet.pose_r, vel_r=feet.vel_r, acc_r=feet.acc_r,
            com_pos=x1[:, cm.P_COM], com_vel=x1[:, cm.V_COM],
            com_acc=com_acc_des,
            torso_rotvec=ang_avg, torso_omega=om_avg, torso_alpha=al_avg,
            base_rotvec=ang_avg, base_omega=om_avg, base_alpha=al_avg,
            joint_pos=joint_pos_des)

        tau, id_res = wbid.joint_torques(
            model, carry.plant.q, carry.plant.qv, desired, st,
            contact_l=float(timing.gamma_l[t]),
            contact_r=float(timing.gamma_r[t]),
            joint_sel=joint_sel, foot_size=cfg.foot_size, mu=cfg.mu,
            settings=id_settings, weights=id_weights,
            pos_gains=id_pos_gains, vel_gains=id_vel_gains)

        # --- footstep adaptation at the static event ticks ---
        do_adapt = bool(timing.update_event[t]) and cfg.update_contact
        plan_pos = carry.plan_pos
        if do_adapt:
            new_contact = X[:, N, cm.POS_R] if support_is_left_tbl[t] \
                else X[:, N, cm.POS_L]
            plan_pos = plan_pos.clone()
            plan_pos[:, int(timing.adapt_target[t])] = new_contact

        # --- disturbance + plant step ---
        pushing = ((t > sc.push_start) & (t < sc.push_end))[:, None]
        ext_f = torch.where(pushing, sc.push_force, 0.0)
        ext_tau = torch.where(pushing, sc.push_torque, 0.0)

        # payload as a wrench transient on the articulated plant (a 2 kg
        # box free-drops onto the arms and rests there).  The resting box
        # is a constant downward force at the arms' body-frame offset
        # ahead of the base (=> a pitch torque); the drop itself is a
        # one-tick impact impulse m * v_impact / dt.  The MPC is NOT told
        # (its mass model stays nominal) — robustness comes from the
        # adaptation law, as in the reference.
        has_pl = (sc.payload_mass > 0.0) & (t >= sc.payload_onset)
        w_pl = sc.payload_mass * cfg.g
        f_imp = torch.where(t == sc.payload_onset,
                            sc.payload_mass * sc.payload_impact_vel
                            / cfg.world_time_step, 0.0)
        f_payload = torch.where(has_pl[:, None],
                                down * (w_pl + f_imp)[:, None], 0.0)
        # arm_offset is a BODY-frame arm position relative to the base,
        # crossed with the world-frame weight and applied as a world
        # torque: a small-tilt approximation, exact only while the base
        # stays near-upright, which holds in the walking envelope
        # (|base pitch/roll| < ~0.1 rad).  wb_plant_step applies ext_tau
        # about the base origin in world axes, matching this convention.
        ext_f = ext_f + f_payload
        ext_tau = ext_tau + torch.linalg.cross(arm_offset.expand(B, 3),
                                               f_payload, dim=-1)
        plant, (c_pts, c_forces) = wbplant.wb_plant_step(
            model, carry.plant, tau, ext_force=ext_f, ext_torque=ext_tau,
            dt=cfg.world_time_step, substeps=substeps, g=cfg.g, cp=contact,
            foot_length=cfg.foot_length, foot_width=cfg.foot_width,
            return_contacts=True)

        # contact-force ZMP estimate (simulation.py:328-348)
        zmp = zmp_estimate(c_pts, c_forces, st.com_pos, st.pose_l[:, 3:6],
                           model.total_mass, cfg.g, cfg.h,
                           prev_zmp=carry.zmp)

        trace = WBTrace(
            com_pos=st.com_pos, com_vel=st.com_vel,
            com_ref=refs.com.pos[:, t], com_pos_des=x1[:, cm.P_COM],
            hw=st.hw, hw_des=x1[:, cm.H_W], theta_hat=x1[:, cm.THETA],
            pose_l=st.pose_l, pose_r=st.pose_r, tau=tau, zmp=zmp,
            r_prim_mpc=info.r_prim, r_prim_id=id_res.r_prim,
            adapted=torch.full((B,), do_adapt, device=dev), x0=x0)

        return WBLoopCarry(plant=plant, plan_pos=plan_pos,
                           theta_hat=x1[:, cm.THETA], solver=solver,
                           zmp=zmp, hw_model=sgn * x1[:, cm.H_W],
                           hw_filt=hw_filt), trace

    if return_tick:
        return carry, tick
    traces = []
    for t in range(int(t0), int(t0) + T_sim):
        carry, tr = tick(carry, t)
        traces.append(tr)
    return carry, WBTrace(*(torch.stack(f, dim=1) for f in zip(*traces)))
