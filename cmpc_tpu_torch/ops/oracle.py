"""High-accuracy oracle solver for the centroidal MPC NLP (port of
``cmpc_tpu.ops.oracle``): scipy SLSQP in float64 on the exact
``ocp.problem`` cost and constraints.

The production path is the batched SQP in ops/sqp.py.  This module is the
third solver of the same NLP, a convergence oracle:

* it checks the problem formulation independently of the SQP solver (if
  the oracle's closed loop walks, the formulation and plant are right);
* it is a per-tick accuracy reference (the SQP solution's cost and
  feasibility against the oracle's).

SLSQP runs on the host.  The cost, its gradient (autograd), the
constraints and their hand-derived Jacobian are evaluated on the device of
the parameters: every evaluation copies z there and its result back to
numpy.  Not batched (one scenario, B = 1); float64 only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.optimize import minimize

from cmpc_tpu_torch.config import Scenario, WalkConfig
from cmpc_tpu_torch.models import centroidal as cm
from cmpc_tpu_torch.ocp import assemble, problem
from cmpc_tpu_torch.ops import sqp
from cmpc_tpu_torch.plan import com_ref as com_ref_mod
from cmpc_tpu_torch.plan import footsteps, swing, timing as timing_mod
from cmpc_tpu_torch.sim.plant import PlantState, plant_step


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=4)
def _fns(cfg: WalkConfig):
    """(cost, grad, con, jac), each a function of one z (n_z,) and one
    B = 1 :class:`MPCParams`, evaluated on their device: a scalar, (n_z,),
    (m,) and (m, n_z)."""

    def cost(z, p):
        return problem.cost_value(z[None], p, cfg)[0]

    def grad(z, p):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(cost(z, p), z)
        return g

    def con(z, p):
        return problem.constraints(z[None], p, cfg)[0]

    def jac(z, p):
        return problem.linearize(z[None], p, cfg)[1][0]

    return cost, grad, con, jac


def tightened_bounds(cfg: WalkConfig, lyap_margin: float = 0.0):
    """numpy (l, u) of :func:`problem.constraint_bounds` with the N
    Lyapunov-decrease rows' upper bounds lowered by `lyap_margin`."""
    l, u = problem.constraint_bounds(cfg)
    if lyap_margin:
        u = np.array(u, copy=True)
        n_eq0 = 20 * (cfg.N + 1)
        u[n_eq0:n_eq0 + cfg.N] -= lyap_margin
    return l, u


def solve_nlp(z0, params: problem.MPCParams, cfg: WalkConfig,
              maxiter: int = 200, lyap_margin: float = 0.0):
    """Solve the MPC NLP to high accuracy with SLSQP. Returns (z, info).

    params: one scenario (B = 1), float64, on the device that evaluates
    the functions.  lyap_margin > 0 tightens the N Lyapunov-decrease rows
    by that amount (u_lyap -= margin), the tightening the production
    solver applies (ocp/condense.SOFT_MARGIN); the returned max_violation
    is measured against the tightened bounds.

    Constraint split: rows [0, n_eq) are equalities (init + dynamics); the
    rest are inequalities l <= c <= u (only the stance-box rows have finite
    lower bounds).
    """
    for name, a in zip(problem.MPCParams._fields, params):
        if a.is_floating_point() and a.dtype != torch.float64:
            raise TypeError(f"the oracle solves in float64: params.{name} is "
                            f"{a.dtype}")
    if params.x0.shape[0] != 1:
        raise ValueError(f"the oracle solves one scenario: params hold "
                         f"{params.x0.shape[0]}")
    cost, grad, con, jac = _fns(cfg)
    l, u = tightened_bounds(cfg, lyap_margin)
    n_eq = 20 * (cfg.N + 1)
    lo, hi = l[n_eq:], u[n_eq:]
    fin_lo = np.isfinite(lo)
    dev = params.x0.device

    def on_dev(z):
        return torch.as_tensor(z, dtype=torch.float64, device=dev)

    def c_eq(z):
        return _np(con(on_dev(z), params)[:n_eq])

    def J_eq(z):
        return _np(jac(on_dev(z), params)[:n_eq])

    def c_ineq(z):
        c = _np(con(on_dev(z), params)[n_eq:])
        return np.concatenate([hi - c, (c - lo)[fin_lo]])

    def J_ineq(z):
        J = _np(jac(on_dev(z), params)[n_eq:])
        return np.concatenate([-J, J[fin_lo]])

    res = minimize(
        lambda z: float(cost(on_dev(z), params)),
        np.asarray(z0, dtype=np.float64),
        jac=lambda z: _np(grad(on_dev(z), params)),
        method="SLSQP",
        constraints=[
            {"type": "eq", "fun": c_eq, "jac": J_eq},
            {"type": "ineq", "fun": c_ineq, "jac": J_ineq},
        ],
        options={"maxiter": maxiter, "ftol": 1e-10},
    )
    c = _np(con(on_dev(res.x), params))
    viol = float(np.maximum(c - u, 0.0).max() + np.maximum(l - c, 0.0).max())
    return res.x, {"success": res.success, "status": res.status,
                   "nit": res.nit, "cost": float(res.fun),
                   "max_violation": viol}


def rollout_oracle(scenario: Scenario, cfg: WalkConfig, T_sim: int,
                   solver=None, verbose_every: int = 0,
                   t0: int = 0, init=None):
    """Eager closed-loop rollout driven by the oracle NLP, for one scenario
    (B = 1) on its device, in float64.

    The tick of the JAX package's oracle rollout, read for read: the
    measured-state packing, footstep adaptation and centroidal plant, with
    `solver(z0, params)` (default: solve_nlp) in place of the batched SQP.
    Returns a dict of stacked per-tick numpy arrays with no batch axis.

    t0/init: start at tick t0 from a handed-off carry, a dict
    {"com_pos", "com_vel", "hw", "plan_pos", "theta_hat", "z"} of one
    scenario's arrays (no batch axis), so that the oracle can enter
    mid-walk.  Past the gait tables' end the tick raises IndexError where
    JAX's does: after the solve of tick pad_ticks, at the support-foot
    read (JAX's gathers clamp; its numpy table reads do not).
    """
    if solver is None:
        solver = lambda z0, p: solve_nlp(z0, p, cfg)  # noqa: E731

    sc = scenario.to(dtype=torch.float64)
    f64, dev = torch.float64, sc.init_com.device

    def t64(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=f64)
        return torch.tensor(np.asarray(x, dtype=np.float64), device=dev)

    timing = timing_mod.build_timing(cfg)
    # the JAX oracle plans with the planner's default step_y_offset
    plan0 = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y)
    prl, prr = footsteps.contact_pose_refs(plan0, timing)
    cref = com_ref_mod.build_com_ref(plan0, cfg, timing, sc.foot_y)
    refs = assemble.RefArrays(com=cref, pose_ref_l=prl, pose_ref_r=prr)
    polygon = cm.foot_polygon(cfg.foot_length, cfg.foot_width, device=dev,
                              dtype=f64)
    gravity = cm.gravity_vector(cfg.g, sc.init_com)

    if init is None:
        plant = PlantState(com_pos=sc.init_com, com_vel=sc.init_vel,
                           hw=torch.zeros(1, 3, dtype=f64, device=dev))
        plan_pos = plan0.pos
        theta_hat = torch.zeros(1, 3, dtype=f64, device=dev)
        x0_init = torch.zeros(1, 20, dtype=f64, device=dev)
        x0_init[:, cm.P_COM] = sc.init_com
        z = sqp.init_solver_state(cfg, x0_init, mass=sc.mpc_mass).z[0]
    else:
        plant = PlantState(com_pos=t64(init["com_pos"])[None],
                           com_vel=t64(init["com_vel"])[None],
                           hw=t64(init["hw"])[None])
        plan_pos = t64(init["plan_pos"])[None]
        theta_hat = t64(init["theta_hat"])[None]
        z = init["z"]

    out = {k: [] for k in ("com_pos", "com_ref", "com_des", "hw", "hw_des",
                           "theta_hat", "max_violation", "cost", "success")}
    for t in range(t0, t0 + T_sim):
        plan = footsteps.FootstepPlan(pos=plan_pos, yaw=plan0.yaw)
        feet = swing.feet_ref_at(t, plan, cfg, timing, sc.foot_y)
        x0 = assemble.pack_x0(plant.com_pos, plant.com_vel, plant.hw,
                              theta_hat, feet.pose_l, feet.pose_r,
                              t, plan, refs, timing, cfg)
        params = assemble.gather_params(t, x0, refs, timing, cfg,
                                        sc.k1, sc.k2, sc.mpc_mass)
        # rebase warm start on the new x0 (cheap; keeps SLSQP fast)
        z = np.array(_np(z), dtype=np.float64)
        z[:20] = _np(x0[0])
        z, info = solver(z, params)
        X, U = problem.split_z(t64(z)[None], cfg)
        x1, u0 = X[:, 1], U[:, 0]
        sum_f = (u0[:, 0:12].reshape(1, 4, 3).sum(1) * params.gamma_l[:, :1]
                 + u0[:, 12:24].reshape(1, 4, 3).sum(1)
                 * params.gamma_r[:, :1])
        com_acc_des = sum_f / sc.mpc_mass[:, None] + gravity

        # numpy reads, unclamped: past pad_ticks this raises, as in JAX
        support_is_left = bool(timing.foot_is_left[timing.step_idx[t]])
        # JAX's tick first takes node 1's swing foot, then overwrites it
        # with the horizon's last node: the last node is what it writes
        new_contact = X[:, cfg.N, cm.POS_R] if support_is_left \
            else X[:, cfg.N, cm.POS_L]
        if bool(timing.update_event[t]) and cfg.update_contact:
            plan_pos = plan_pos.clone()
            plan_pos[:, int(timing.adapt_target[t])] = new_contact

        pushing = (t > int(sc.push_start[0])) and (t < int(sc.push_end[0]))
        ext_f = sc.push_force if pushing else torch.zeros_like(sc.push_force)
        ext_tau = (sc.push_torque if pushing
                   else torch.zeros_like(sc.push_torque))
        out["com_pos"].append(_np(plant.com_pos[0]))
        out["com_ref"].append(_np(refs.com.pos[0, t]))
        out["com_des"].append(_np(x1[0, cm.P_COM]))
        out["hw"].append(_np(plant.hw[0]))
        out["hw_des"].append(_np(x1[0, cm.H_W]))
        out["theta_hat"].append(_np(theta_hat[0]))
        out["max_violation"].append(info.get("max_violation", np.nan))
        out["cost"].append(info.get("cost", np.nan))
        out["success"].append(info.get("success", True))

        plant = plant_step(plant, x1[:, cm.P_COM], x1[:, cm.V_COM],
                           com_acc_des, u0, float(timing.gamma_l[t]),
                           float(timing.gamma_r[t]),
                           feet.pose_l, feet.pose_r, sc.mpc_mass,
                           sc.plant_mass, ext_f, ext_tau, cfg.g,
                           polygon, cfg.world_time_step,
                           hw_compliance=cfg.plant_hw_compliance,
                           hw_shed=cfg.plant_hw_shed)
        theta_hat = x1[:, cm.THETA]
        if verbose_every and t % verbose_every == 0:
            err = np.abs(out["com_pos"][-1][:2] - out["com_ref"][-1][:2])
            print(f"t={t} err={err.max():.4f} viol="
                  f"{out['max_violation'][-1]:.2e} nit={info.get('nit')}",
                  flush=True)
    return {k: np.asarray(v) for k, v in out.items()}
