"""The reference of one tick of the closed-loop sweep, and the numbers that
judge the program's ticks.

A tick of the loop packs the measured state into the MPC's state x0,
builds the MPC's parameters from it, solves, writes the answer's terminal
swing-foot position into the footstep plan at the gait's adaptation ticks,
and steps the centroidal plant from the answer's node-1 state and first
input under the tick's push and payload.  The reference does each part
plainly in float64 from the program's own state before the tick, so that
each is judged by itself:

* the packed state (the reference code's ``centroidal_mpc_vertices.py``,
  482-509): CoM position and velocity, the angular momentum negated where
  ``hw_meas_negated``, the disturbance estimate, each foot's yaw and
  position -- a stance foot from the plan's contact reference before the
  first step's end and from the live plan after it, a swinging foot from
  its commanded trajectory;
* the MPC's parameters from that state (``planner``) and the solve from
  the program's warm state (``reference/solve.py``);
* the plant (a forward Euler step): the CoM force that tracks the
  answer's node-1 position and velocity with gains 5 and 10 about the
  force balance of the first input's contact forces, plus the push (it
  acts at start < t < end) and, at the payload's onset tick, the impulse
  m_p v over one tick; the payload's mass in the plant from its onset on;
  the angular momentum from the torque of that force at the demanded ZMP
  clamped to the box of the feet in contact (with the momentum-shedding
  offset), times the whole-body compliance, with the yaw shed;
* footstep adaptation: at an adaptation tick the plan's next footstep is
  the answer's terminal position of the swinging foot; the plan is
  unchanged at every other tick;
* at the late tick, the merit of the program's answer against the merit of
  the reference's answer from the same start.  Where pushes and payloads
  act, an input known to float32's precision leaves the answer's rows free
  by ~1e-2 (the reference's own answer moves that far when its inputs are
  jiggled by 2**-24), but not their merit (it moves by ~1e-7): the merit
  is what the fixed iterations and the line search keep.

It imports neither JAX nor anything of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import planner
from portbench.planner import assemble, com_ref as crm, footsteps, swing
from portbench.planner import timing as tm
from portbench.reference import solve

F64 = torch.float64
COM_POS_GAIN, COM_VEL_GAIN = 5.0, 10.0
N_X, N_U = 20, 32
POS_L, POS_R = slice(13, 16), slice(17, 20)
CARRIED = ("com_pos", "com_vel", "hw", "theta_hat")


def _t(a):
    return torch.as_tensor(a).to("cpu", F64)


def _gap(a, ref):
    """Per row, the largest |a - ref| / max(|ref|, 1) over its entries."""
    a, ref = a.reshape(a.shape[0], -1), ref.reshape(ref.shape[0], -1)
    return ((a - ref).abs() / ref.abs().clamp_min(1.0)).amax(1)


class LoopReference:
    """The parts of a tick for the configuration `config` (the whole file)
    and the batch's scenarios `scenario` (numpy arrays in the fields of the
    program's ``Scenario``), on the host in float64."""

    def __init__(self, config: dict, scenario: dict):
        walk = self.walk = config["walk_config"]
        self.cfg = planner.walk_config(walk)
        self.timing = tm.build_timing(self.cfg)
        self.sc = {k: _t(v) if np.asarray(v).dtype.kind == "f"
                   else torch.as_tensor(v) for k, v in scenario.items()}
        sc = self.sc
        plan0 = footsteps.plan_footsteps(sc["vref"], self.cfg, self.timing,
                                         sc["foot_y"], sc["step_y_offset"])
        self.yaw = plan0.yaw
        pl, pr = footsteps.contact_pose_refs(plan0, self.timing)
        self.refs = assemble.RefArrays(
            com=crm.build_com_ref(plan0, self.cfg, self.timing,
                                  sc["foot_y"]),
            pose_ref_l=pl, pose_ref_r=pr)
        hl, hw = walk["foot_length"] / 2.0, walk["foot_width"] / 2.0
        self.polygon = torch.tensor([[hl, hw], [hl, -hw], [-hl, -hw],
                                     [-hl, hw]], dtype=F64)

    def feet(self, t, plan_pos):
        """The feet's commanded poses [ang(3), pos(3)] at tick t from the
        live plan."""
        plan = footsteps.FootstepPlan(pos=plan_pos, yaw=self.yaw)
        return swing.feet_ref_at(t, plan, self.cfg, self.timing,
                                 self.sc["foot_y"])

    def pack_x0(self, t, carry):
        """The MPC's state (B, 20) at tick t from the carry before it."""
        tg = self.timing
        feet = self.feet(t, carry["plan_pos"])
        if tm.at(tg.stance_from_table, t):
            row = tm.clamp_index(t, self.refs.pose_ref_l.shape[1])
            stance_l = self.refs.pose_ref_l[:, row, 3:6]
            stance_r = self.refs.pose_ref_r[:, row, 3:6]
        else:
            stance_l = carry["plan_pos"][:, int(tm.at(tg.stance_left_idx,
                                                        t))]
            stance_r = carry["plan_pos"][:, int(tm.at(tg.stance_right_idx,
                                                        t))]
        foot_l, foot_r = stance_l, stance_r
        if self.walk["x0_swing_from_traj"]:
            if tm.at(tg.gamma_l, t) <= 0.5:
                foot_l = feet.pose_l[:, 3:6]
            if tm.at(tg.gamma_r, t) <= 0.5:
                foot_r = feet.pose_r[:, 3:6]
        hw = -carry["hw"] if self.walk["hw_meas_negated"] else carry["hw"]
        return torch.cat([carry["com_pos"], carry["com_vel"], hw,
                          carry["theta_hat"], feet.pose_l[:, 2:3], foot_l,
                          feet.pose_r[:, 2:3], foot_r], dim=1)

    def params(self, t, x0) -> dict:
        """The MPC's parameters at tick t from the state x0."""
        sc = self.sc
        return assemble.gather_params(int(t), x0, self.refs, self.timing,
                                      self.cfg, sc["k1"], sc["k2"],
                                      sc["mpc_mass"])

    def split(self, z):
        N = self.walk["N"]
        B = z.shape[0]
        return (z[:, :N_X * (N + 1)].reshape(B, N + 1, N_X),
                z[:, N_X * (N + 1):].reshape(B, N, N_U))

    def plant(self, t, carry, z):
        """The carried state after tick t (``CARRIED``) from the carry
        before it and the tick's answer z."""
        sc, tg, walk = self.sc, self.timing, self.walk
        X, U = self.split(z)
        x1, u0 = X[:, 1], U[:, 0]
        B = z.shape[0]
        gl, gr = float(tm.at(tg.gamma_l, t)), float(tm.at(tg.gamma_r, t))
        grav = torch.tensor([0.0, 0.0, -walk["g"]], dtype=F64)
        f_sum = (u0[:, 0:12].reshape(B, 4, 3).sum(1) * gl
                 + u0[:, 12:24].reshape(B, 4, 3).sum(1) * gr)
        m_mpc = sc["mpc_mass"][:, None]
        acc_des = f_sum / m_mpc + grav
        pos, vel, hw = carry["com_pos"], carry["com_vel"], carry["hw"]

        pushing = ((t > sc["push_start"]) & (t < sc["push_end"]))[:, None]
        f_ext = torch.where(pushing, sc["push_force"], 0.0)
        tau_ext = torch.where(pushing, sc["push_torque"], 0.0)
        impact = (t == sc["payload_onset"]) & (sc["payload_mass"] > 0)
        f_ext[:, 2] -= torch.where(
            impact, sc["payload_mass"] * sc["payload_impact_vel"]
            / walk["world_time_step"], 0.0)
        mass = sc["plant_mass"] + torch.where(t >= sc["payload_onset"],
                                              sc["payload_mass"], 0.0)

        f_cmd = m_mpc * (acc_des + COM_VEL_GAIN * (x1[:, 3:6] - vel)
                         + COM_POS_GAIN * (x1[:, 0:3] - pos) - grav)
        F = f_cmd + f_ext
        acc = grav + F / mass[:, None]

        compliance, shed = walk["plant_hw_compliance"], walk["plant_hw_shed"]
        fz = F[:, 2].clamp_min(1e-3)[:, None]
        zmp = pos[:, :2] - pos[:, 2:3] * F[:, :2] / fz \
            + shed / compliance * torch.stack([hw[:, 1], -hw[:, 0]], 1) / fz
        feet = self.feet(t, carry["plan_pos"])
        lo = torch.full((B, 2), np.inf, dtype=F64)
        hi = torch.full((B, 2), -np.inf, dtype=F64)
        on = False
        for pose, g in ((feet.pose_l, gl), (feet.pose_r, gr)):
            if g > 0.5:
                c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
                vx, vy = self.polygon[:, 0], self.polygon[:, 1]
                corners = torch.stack([c * vx - s * vy, s * vx + c * vy],
                                      -1) + pose[:, None, 3:5]
                lo = torch.minimum(lo, corners.amin(1))
                hi = torch.maximum(hi, corners.amax(1))
                on = True
        tau = torch.zeros(B, 3, dtype=F64)
        if on:
            cop = torch.cat([torch.minimum(torch.maximum(zmp, lo), hi),
                             torch.zeros(B, 1, dtype=F64)], 1)
            tau = torch.linalg.cross(cop - pos, F, dim=1)
            tau[:, 2] -= shed * hw[:, 2] / max(compliance, 1e-3)
        tau = compliance * tau + tau_ext

        dt = walk["world_time_step"]
        return dict(com_pos=pos + dt * vel, com_vel=vel + dt * acc,
                    hw=hw + dt * tau, theta_hat=x1[:, 9:12])

    def adapted_plan(self, t, plan_pos, z):
        """The footstep plan after tick t: at an adaptation tick the next
        footstep is the answer's terminal position of the swinging foot;
        otherwise the plan before it."""
        tg = self.timing
        if not (tm.at(tg.update_event, t) and self.walk["update_contact"]):
            return plan_pos
        X, _ = self.split(z)
        support_left = tm.at(tg.foot_is_left[tg.step_idx], t)
        plan = plan_pos.clone()
        plan[:, int(tm.at(tg.adapt_target, t))] = \
            X[:, -1, POS_R if support_left else POS_L]
        return plan


def merit_gap(walk: dict, arrays: dict, start, z, device):
    """Per row, (merit(z) - merit(z_ref)) / max(|merit(z_ref)|, 1), z_ref
    the reference's answer from the same start `start` (z, y) on the
    parameters `arrays`: how much worse than the reference's solve the
    answer z leaves the line search's merit."""
    ref = solve.Reference(walk, device)
    out = []
    for lo in range(0, z.shape[0], solve.ROW_BLOCK):
        b = slice(lo, lo + solve.ROW_BLOCK)
        p = ref.params({k: a[b] for k, a in arrays.items()})
        z_ref, _ = ref.solve(start[0][b].to(device, F64),
                             start[1][b].to(device, F64), p)
        m_ref = ref.merit(z_ref, p)
        out.append(((ref.merit(z[b].to(device, F64), p) - m_ref)
                    / m_ref.abs().clamp_min(1.0)).cpu())
    return torch.cat(out)


def _percentiles(rows: dict, sel) -> dict:
    """``z_gap_moved_p10`` and ``z_gap_p50`` (``solve.judge``'s) over the
    rows `sel` of the per-row readings `rows`."""
    gap = np.nan_to_num(rows["gap"][sel], nan=np.inf)
    moved = rows["moved"][sel].astype(bool)
    return (float(np.percentile(gap[moved], 10)) if moved.any() else None,
            float(np.median(gap)) if len(gap) else None)


def judge(config: dict, scenario: dict, ticks, chain, device,
          details: dict | None = None, late: int | None = None):
    """(numbers, failed) of the program's kept ticks and the warm chain.

    `ticks`: (t, carry before, carry after, the program's packed x0) per
    kept tick, each carry a dict of float64 host tensors (``CARRIED``,
    ``plan_pos``, the solver's ``z`` and ``y``); `chain`: the warm chain's
    steps as ``solve.judge`` takes them.  Each kept tick's solve is judged
    from the program's warm state on the parameters built from the
    reference's packed state.  The numbers:

    * ``z_gap_moved_p10``, ``z_gap_p50``: ``solve.judge``'s percentiles
      over the chain's steps and the first kept tick, where every row
      still walks the recorded nominal state: there float32 rounding
      leaves the rows whose decisions match the reference's at ~1e-4 and
      TF32 products do not.  At the later ticks (pushed and loaded rows)
      an answer is free by ~1e-2 at float32's precision (the module's
      docstring): their percentiles are printed, as
      ``z_gap_moved_p10_later`` and ``z_gap_p50_later``;
    * ``merit_gap_p50``: the median over the rows of the kept tick `late`
      of :func:`merit_gap`, where that tick is kept;
    * ``rows_off``: ``solve.judge``'s, over every judged row (and, printed,
      ``z_gap_max``, ``moved_share``, ``rows_huge``);
    * ``x0_gap_max``: the largest gap of the program's packed state from
      the reference's, entry by entry (|a - b| / max(|b|, 1));
    * ``plant_gap_max``: the same of the program's carried state after the
      tick (``CARRIED``) from the reference's plant step;
    * ``adapt_off``: rows whose plan after the tick is not the reference's
      (exactly), at the adaptation tick and every other.

    Printed beside them: the kept ``ticks``, the rows pushed and with a
    payload impact there, and per kept tick ``stalled_share``: the share
    of its rows whose answer keeps the warm start's merit (within 1e-6)
    where the reference's moves.  `failed` counts the rows that are not
    finite in the solve or in the carried state after a tick."""
    ref = LoopReference(config, scenario)
    ticks = sorted(ticks, key=lambda k: k[0])
    steps, x0_gaps, plant_gaps, off, nonfinite = list(chain), [], [], 0, 0
    pushed = impacts = 0
    merit_gaps = None
    sc = ref.sc
    for t, before, after, x0_prog in ticks:
        x0 = ref.pack_x0(t, before)
        x0_gaps.append(_gap(x0_prog, x0))
        p = ref.params(t, x0)
        steps.append((p, (before["z"], before["y"]), [after["z"]]))
        if t == late:
            merit_gaps = merit_gap(config["walk_config"], p,
                             (before["z"], before["y"]), after["z"], device)
        nxt = ref.plant(t, before, after["z"])
        got = torch.cat([after[k] for k in CARRIED], 1)
        want = torch.cat([nxt[k] for k in CARRIED], 1)
        plant_gaps.append(_gap(got, want))
        nonfinite += int((~torch.isfinite(got).all(1)).sum())
        plan = ref.adapted_plan(t, before["plan_pos"], after["z"])
        off += int((after["plan_pos"] != plan).flatten(1).any(1).sum())
        pushed += int(((t > sc["push_start"]) & (t < sc["push_end"])).sum())
        impacts += int(((t == sc["payload_onset"])
                        & (sc["payload_mass"] > 0)).sum())
    rows = {} if details is None else details
    numbers, failed = solve.judge(config["walk_config"], steps, device, rows)
    nominal = rows["step"] <= len(chain)
    numbers["z_gap_moved_p10"], numbers["z_gap_p50"] = _percentiles(
        rows, nominal)
    later = _percentiles(rows, ~nominal)

    def largest(gaps):
        g = torch.cat(gaps) if gaps else torch.zeros(0, dtype=F64)
        return float(torch.nan_to_num(g, nan=np.inf).max()) \
            if len(g) else None

    stalled = rows["moved"].astype(bool) \
        & ~(rows["merit_excess"] < -1e-6)
    numbers.update(z_gap_moved_p10_later=later[0], z_gap_p50_later=later[1],
                   merit_gap_p50=None if merit_gaps is None else float(
                       np.median(np.nan_to_num(merit_gaps.numpy(),
                                               nan=np.inf))),
                   x0_gap_max=largest(x0_gaps),
                   plant_gap_max=largest(plant_gaps), adapt_off=off,
                   ticks=[int(t) for t, *_ in ticks], pushed_rows=pushed,
                   impact_rows=impacts,
                   stalled_share={int(t): float(stalled[
                       rows["step"] == len(chain) + k].mean())
                       for k, (t, *_) in enumerate(ticks)})
    rows.update(x0_gap=torch.cat(x0_gaps).numpy(),
                plant_gap=torch.cat(plant_gaps).numpy())
    if merit_gaps is not None:
        rows["merit_gap"] = merit_gaps.numpy()
    return numbers, failed + nonfinite
