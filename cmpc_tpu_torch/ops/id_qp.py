"""Whole-body inverse-dynamics QP, batched (port of ``cmpc_tpu.ops.id_qp``).

Per tick, a 72-variable task-space QP over x = [q_ddot(30), tau(30),
f_c(12)]: six weighted acceleration tasks, the floating-base dynamics
equality M q_ddot + h - J_c^T f_c = S tau, and CoP / friction inequality
boxes per foot (inverse_dynamics.py:30-136 of the reference controller).

This module takes the task matrices as inputs (Jacobians, mass matrix,
bias), assembles (H, F, A_eq, A_ineq) as the reference does, and solves
with the shared ADMM solver; every input carries a leading batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.ops.admm import ADMMSettings, admm_solve

TASKS = ("lfoot", "rfoot", "com", "torso", "base", "joints")
# weights and PD gains (inverse_dynamics.py:42-44)
WEIGHTS = dict(lfoot=1.0, rfoot=1.0, com=1.0, torso=1.0, base=1.0,
               joints=1e-1)
POS_GAINS = dict(lfoot=10.0, rfoot=10.0, com=5.0, torso=10.0, base=10.0,
                 joints=10.0)
VEL_GAINS = dict(lfoot=5.0, rfoot=5.0, com=10.0, torso=5.0, base=3.0,
                 joints=5.0)


class IDTask(NamedTuple):
    """One task's data: Jacobian, the velocity-product term Jdot @ qv (the
    bias acceleration — cheaper to compute than the Jdot matrix itself),
    feedforward acceleration, position and velocity errors."""

    J: torch.Tensor        # (B, k, n_dof), or (k, n_dof) shared by the batch
    Jdot_qv: torch.Tensor  # (B, k)
    ff: torch.Tensor       # (B, k)
    pos_err: torch.Tensor  # (B, k)
    vel_err: torch.Tensor  # (B, k)


class IDDynamics(NamedTuple):
    M: torch.Tensor        # (B, n_dof, n_dof) mass matrix
    h: torch.Tensor        # (B, n_dof) Coriolis + gravity bias
    J_lfoot: torch.Tensor  # (B, 6, n_dof) world-frame sole Jacobians
    J_rfoot: torch.Tensor  # (B, 6, n_dof)


def _cop_friction_rows(d: float, mu: float):
    """8 rows per foot over [tau_xyz, f_xyz] (inverse_dynamics.py:121-128):
    CoP box |tau_x|,|tau_y| <= d f_z and friction |f_x|,|f_y| <= mu f_z."""
    return np.array([
        [1, 0, 0, 0, 0, -d], [-1, 0, 0, 0, 0, -d],
        [0, 1, 0, 0, 0, -d], [0, -1, 0, 0, 0, -d],
        [0, 0, 0, 1, 0, -mu], [0, 0, 0, -1, 0, -mu],
        [0, 0, 0, 0, 1, -mu], [0, 0, 0, 0, -1, -mu],
    ], dtype=np.float64)


def _gate(c, like):
    """A contact gate (number or (B,) tensor) shaped (B, 1, 1); a number is
    filled on the device, with no copy from the host."""
    if isinstance(c, torch.Tensor):
        c = c.to(like.dtype)
        return c.expand(like.shape[0])[:, None, None] if c.dim() == 0 \
            else c[:, None, None]
    return like.new_full((like.shape[0], 1, 1), float(c))


def solve_id_qp(tasks: dict, dyn: IDDynamics, qdot, contact_l, contact_r,
                n_dof: int = 30, foot_size: float = 0.1, mu: float = 0.5,
                settings: ADMMSettings = ADMMSettings(iters=100, rho=10.0),
                weights: dict | None = None, pos_gains: dict | None = None,
                vel_gains: dict | None = None):
    """Assemble and solve the ID QP; returns the 24 actuated joint torques
    (B, n_dof - 6) (tau[6:], inverse_dynamics.py:133-136) and the
    ADMMResult.

    tasks: {name: IDTask}; contact_l/contact_r: {0,1} gates, a number
    shared by the batch or a (B,) tensor.
    weights/pos_gains/vel_gains override the reference constants per task.
    """
    weights = {**WEIGHTS, **(weights or {})}
    pos_gains = {**POS_GAINS, **(pos_gains or {})}
    vel_gains = {**VEL_GAINS, **(vel_gains or {})}
    nv = 2 * n_dof + 12
    like = dyn.h
    B = like.shape[0]

    Hq = like.new_zeros(B, n_dof, n_dof)
    Fq = like.new_zeros(B, n_dof)
    for name in TASKS:
        t = tasks[name]
        w, kp, kv = weights[name], pos_gains[name], vel_gains[name]
        Jt = t.J.transpose(-1, -2)
        target = t.ff + kv * t.vel_err + kp * t.pos_err - t.Jdot_qv
        Hq = Hq + w * (Jt @ t.J)
        Fq = Fq + (-w) * (Jt @ target[:, :, None])[:, :, 0]
    H = like.new_zeros(B, nv, nv)
    H[:, :n_dof, :n_dof] = Hq
    # contact-force regularization (inverse_dynamics.py:109)
    H.diagonal(dim1=1, dim2=2)[:, 2 * n_dof:] += 1e-6
    F = torch.cat([Fq, like.new_zeros(B, nv - n_dof)], dim=1)

    # dynamics equality: [M, -S, -J_c^T] x = -h (inverse_dynamics.py:111-116)
    negS = const(("id_qp_negS", n_dof),
                 lambda: -np.diag(np.r_[np.zeros(6), np.ones(n_dof - 6)]),
                 like.device, like.dtype)
    Jc = torch.cat([_gate(contact_l, like) * dyn.J_lfoot,
                    _gate(contact_r, like) * dyn.J_rfoot], dim=1)
    A_eq = torch.cat([dyn.M, negS.expand(B, n_dof, n_dof),
                      -Jc.transpose(1, 2)], dim=2)
    b_eq = -dyn.h

    # inequalities on the contact wrenches only
    A_in = const(("id_qp_rows", n_dof, foot_size, mu), lambda: np.hstack([
        np.zeros((16, 2 * n_dof)),
        np.kron(np.eye(2), _cop_friction_rows(foot_size / 2.0, mu))]),
        like.device, like.dtype)

    A = torch.cat([A_eq, A_in.expand(B, 16, nv)], dim=1)
    l = torch.cat([b_eq, like.new_full((B, 16), -torch.inf)], dim=1)
    u = torch.cat([b_eq, like.new_zeros(B, 16)], dim=1)

    # The reference's QPSolver minimizes 1/2 x'Hx + F'x with H = sum w J'J
    # — admm_solve uses the same 1/2 convention, so H passes through
    # unscaled.  (A 2*H here once halved every achieved task acceleration:
    # the QP solution is -(P)^-1 q up to constraints, and the whole-body
    # loop drifted laterally at exactly half gain.)
    res = admm_solve(H, F, A, l, u, like.new_zeros(B, nv),
                     like.new_zeros(B, A.shape[1]), settings)
    tau = res.x[:, n_dof:2 * n_dof]
    return tau[:, 6:], res
