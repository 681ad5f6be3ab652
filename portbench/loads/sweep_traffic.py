"""The generator of the closed-loop sweep's traffic (``kind``
``push_payload``; the mix names the load ``sweep``).

A batch of scenarios of the paper's robustness study, randomized as the
program's ``parallel.mesh.make_batch`` randomizes them, by the
configuration's ``scenarios`` block: lateral and sagittal pushes of
N(0, ``push_sigma_n``) newtons for a drawn number of ticks, payloads of
U(0, ``payload_max_kg``) dropped from ``drop_height_m``, and the payload
gains above ``heavy_kg``.  The mix draws the pushes' starts and the
payloads' onsets in its own window of ticks after the start tick ``t0``.
Every row starts at ``t0`` from the recorded nominal walk
(``assets/walk_x0.npz``): its plant state, its disturbance estimate and
the nominal footstep plan, with the solver's state the end of a
``warm_chain``-solve chain at the ticks before ``t0`` from the cold start,
on the MPC's parameters of each row's gains (``planner``).  Plain numpy in
and out; the program and the reference both receive these inputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import planner, traffic

F32 = np.float32


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(F32)


def draw(mix: dict, seed: int, sc: dict) -> dict:
    """The drawn disturbances of the mix's batch at `seed` under the
    configuration's ``scenarios`` `sc`, float64 and int64 arrays: push
    force (B, 3), push start and end ticks (the push acts at start < t <
    end), payload mass, its onset tick, and the gains k1, k2 (B,)."""
    B = mix["batch"]
    rng = np.random.default_rng([seed % traffic.SEED_SPACE, 15])
    sigma = sc["push_sigma_n"]
    push = rng.normal(size=(B, 3)) * np.array([sigma, sigma, 0.0])
    start = rng.integers(mix["push_start"][0], mix["push_start"][1] + 1,
                         size=B)
    dur = rng.integers(sc["push_ticks"][0], sc["push_ticks"][1] + 1, size=B)
    payload = rng.uniform(0.0, sc["payload_max_kg"], size=B)
    onset = rng.integers(mix["payload_onset"][0],
                         mix["payload_onset"][1] + 1, size=B)
    heavy = payload > sc["heavy_kg"]
    return dict(push_force=push, push_start=start, push_end=start + dur,
                payload_mass=payload, payload_onset=onset,
                k1=np.where(heavy, sc["heavy_k1"], sc["k1"]),
                k2=np.where(heavy, sc["heavy_k2"], sc["k2"]))


def scenario(drawn: dict, walk: dict, sc: dict) -> dict:
    """The batch's scenarios in the fields and the order of the program's
    ``Scenario`` (float32 and int64 arrays, the batch leading): the nominal
    walk's commands times the configuration's velocity scale, its feet at
    the configuration's step width, the configuration's masses and the
    drawn disturbances."""
    B = len(drawn["k1"])
    nominal = traffic.nominal_scenario(walk["num_steps"], walk["h"])
    out = {k: np.repeat(v, B, axis=0) for k, v in nominal.items()}
    out.update(
        vref=_f32(out["vref"].astype(np.float64) * sc["velocity_scale"]),
        step_y_offset=_f32(np.full(B, sc["step_y_offset"])),
        k1=_f32(drawn["k1"]), k2=_f32(drawn["k2"]),
        mpc_mass=_f32(np.full(B, sc["mass_kg"])),
        plant_mass=_f32(np.full(B, sc["mass_kg"])),
        push_force=_f32(drawn["push_force"]),
        push_torque=np.zeros((B, 3), F32),
        push_start=drawn["push_start"].astype(np.int64),
        push_end=drawn["push_end"].astype(np.int64),
        payload_mass=_f32(drawn["payload_mass"]),
        payload_onset=drawn["payload_onset"].astype(np.int64),
        payload_impact_vel=_f32(np.full(
            B, np.sqrt(2.0 * walk["g"] * sc["drop_height_m"]))))
    return out


def start_carry(x0: np.ndarray, walk: dict, plan_pos: np.ndarray) -> dict:
    """The loop's state at a tick whose packed MPC state is `x0` (B, 20):
    the plant's CoM position and velocity and angular momentum (the packed
    state holds the momentum negated where ``hw_meas_negated``), the
    disturbance estimate, and the footstep plan `plan_pos` (B, S, 3)."""
    hw = x0[:, 6:9]
    return dict(com_pos=x0[:, 0:3], com_vel=x0[:, 3:6],
                hw=-hw if walk["hw_meas_negated"] else hw,
                theta_hat=x0[:, 9:12], plan_pos=plan_pos)


def nominal_plan(walk: dict, sc: dict) -> np.ndarray:
    """The footstep positions (B, S, 3) of the scenarios' commands before
    any adaptation (the planner's copy, float64)."""
    from portbench.planner import footsteps
    from portbench.planner import timing as tm
    cfg = planner.walk_config(walk)

    def f64(k):
        return torch.as_tensor(sc[k], dtype=torch.float64)

    plan = footsteps.plan_footsteps(f64("vref"), cfg, tm.build_timing(cfg),
                                    f64("foot_y"), f64("step_y_offset"))
    return plan.pos.numpy()


def generate(mix: dict, seed: int, config: dict) -> dict:
    """The inputs of `mix` at `seed` for the configuration `config` (the
    whole file): ``drawn`` (:func:`draw`), ``scenario``
    (:func:`scenario`), ``params`` (the MPC's parameters of the
    ``warm_chain`` solves at ticks t0 - warm_chain .. t0 - 1, dicts of
    float32 arrays), ``start`` (the chain's cold start (z, y)), ``carry``
    (the loop's state at t0 but the solver's, :func:`start_carry`,
    float32) and ``t0``."""
    if mix["kind"] != "push_payload":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    walk, sc_cfg = config["walk_config"], config["scenarios"]
    B, t0, n = mix["batch"], mix["t0"], mix["warm_chain"]
    rec = np.load(os.path.join(traffic.ROOT, mix["asset"]))["x0"]
    if not (n <= t0 < rec.shape[0]):
        raise ValueError(f"tick {t0} after a chain of {n} does not lie in "
                         f"the {rec.shape[0]} recorded ticks")
    drawn = draw(mix, seed, sc_cfg)
    sc = scenario(drawn, walk, sc_cfg)
    params = planner.mpc_params(walk, sc, rec,
                                [np.full(B, t0 - n + k) for k in range(n)])
    p0 = params[0]
    return dict(drawn=drawn, scenario=sc, params=params, t0=t0,
                start=traffic.cold_state(p0["x0"], p0["mass"], walk),
                carry=start_carry(np.repeat(rec[t0][None], B, axis=0), walk,
                                  nominal_plan(walk, sc).astype(F32)))
