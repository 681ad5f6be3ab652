"""The planner that turns a scenario and recorded states into the MPC's
parameters, for the traffic generator: a copy of the program's
``plan/timing``, ``plan/footsteps``, ``plan/swing``, ``plan/com_ref`` and
``ocp/assemble.gather_params`` (with ``config`` and ``consts``), run on the
host in float64.  The program and the reference both receive its output as
inputs; neither runs this code in a cell."""

from __future__ import annotations

import numpy as np
import torch

PARAM_KEYS = ("x0", "com_ref", "pos_ref_l", "pos_ref_r", "yaw_ref_l",
              "yaw_ref_r", "gamma_l", "gamma_r", "k1", "k2", "mass")


def walk_config(walk: dict):
    """The planner's ``WalkConfig`` of a configuration's ``walk_config``."""
    from portbench.planner.config import WalkConfig
    fields = dict(walk)
    fields["stance_box"] = tuple(fields["stance_box"])
    return WalkConfig(**fields)


def mpc_params(walk: dict, scenario: dict, x0_rec: np.ndarray,
               tick_sets, dtype=np.float32) -> list:
    """The MPC's parameters of the scenario (a batch of one, numpy arrays
    in ``Scenario``'s fields) at the ticks of each array of `tick_sets`
    ((B,) each) from the recorded states `x0_rec` (P, 20): for each, a
    dict of numpy arrays of `dtype` with the batch leading, in the order of
    ``PARAM_KEYS``."""
    from portbench.planner import assemble, footsteps
    from portbench.planner import com_ref as crm
    from portbench.planner import timing as tm
    from portbench.planner.config import Scenario

    cfg = walk_config(walk)
    f64 = torch.float64
    sc = Scenario(**{k: torch.as_tensor(v).to(f64) if v.dtype.kind == "f"
                     else torch.as_tensor(v) for k, v in scenario.items()})
    timing = tm.build_timing(cfg)
    plan = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, cfg, timing, sc.foot_y)
    B = len(tick_sets[0])

    def rep(x):
        return x.expand(B, *x.shape[1:])

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    x0_all = torch.as_tensor(x0_rec, dtype=f64)
    sets = []
    for ticks in tick_sets:
        tk = torch.as_tensor(ticks, dtype=torch.int64)
        out = assemble.gather_params(tk, x0_all[tk], refs, timing, cfg,
                                     rep(sc.k1), rep(sc.k2),
                                     rep(sc.mpc_mass))
        sets.append({k: out[k].numpy().astype(dtype) for k in PARAM_KEYS})
    return sets
