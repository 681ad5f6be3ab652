"""The cases of the closed-loop sweep's tests at B = 8 on the CPU: a batch of
scenarios whose pushes begin and whose payloads land at known ticks, the
program's carry at a tick of the recorded walk, the program's tick from it,
and the loop reference's judgement of that tick
(``portbench/reference/loop.py``)."""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cmpc_tpu_torch.config import Scenario, WalkConfig  # noqa: E402
from cmpc_tpu_torch.ocp.problem import MPCParams  # noqa: E402
from cmpc_tpu_torch.ops import sqp  # noqa: E402
from cmpc_tpu_torch.sim import closed_loop  # noqa: E402
from cmpc_tpu_torch.sim.plant import PlantState  # noqa: E402
from portbench import core, loop_faults, planner, traffic  # noqa: E402
from portbench.loads import sweep_traffic  # noqa: E402
from portbench.reference import loop as ref_loop  # noqa: E402

WORKLOAD = "centroidal-sweep-b2048"
with open(os.path.join(ROOT, "portbench", "configs",
                       "hrp4-robustness-sweep.json")) as _f:
    CONFIG = json.load(_f)
WALK = CONFIG["walk_config"]
CFG = WalkConfig(**dict(WALK, stance_box=tuple(WALK["stance_box"])))
MIX = traffic.load_mix("push-payload-t190-b2048")
LIMITS = core.load_limits(WORKLOAD)
REC = np.load(os.path.join(ROOT, MIX["asset"]))["x0"]
B = 8
LIFT_OFF, ADAPT, PUSH_ONSET, IMPACT = 200, 261, 230, 215
TICKS = (LIFT_OFF, ADAPT, PUSH_ONSET, IMPACT)
CHAIN = 2
KICK = 0.005          # m/s of CoM velocity per newton of a row's push
SMALL = {"batch": B, "warm_chain": 2, "warm_up_steps": 1, "chain_rows": 4,
         "late_tick": MIX["t0"] + 3}


def drawn():
    """Rows 0-2 pushed from PUSH_ONSET on, rows 3-5 pushed all along,
    rows 6-7 never; payloads of rows 0, 3 and 6 land at IMPACT, of rows 1
    and 4 before the start (their mass in the plant), none elsewhere."""
    rng = np.random.default_rng(3)
    push = rng.normal(size=(B, 3)) * np.array([10.0, 10.0, 0.0])
    start = np.array([PUSH_ONSET - 1] * 3 + [150] * 3 + [1000] * 2)
    payload = np.array([2.5, 0.5, 0.0, 1.5, 0.8, 0.0, 2.9, 0.0])
    onset = np.array([IMPACT, 180, 0, IMPACT, 180, 0, IMPACT, 0])
    heavy = payload > 1.0
    return dict(push_force=push, push_start=start, push_end=start + 120,
                payload_mass=payload, payload_onset=onset,
                k1=np.where(heavy, 7.0, 4.0), k2=np.where(heavy, 1.0, 0.1))


SCENARIO = sweep_traffic.scenario(drawn(), WALK, CONFIG["scenarios"])


def hand_counts(t):
    d = drawn()
    pushed = (t > d["push_start"]) & (t < d["push_end"])
    impacts = (t == d["payload_onset"]) & (d["payload_mass"] > 0)
    return int(pushed.sum()), int(impacts.sum())


def start(t, dtype):
    """(scenarios, carry) of the program at tick t: the recorded state at
    t with each row's CoM velocity kicked along its push, the nominal plan
    and a CHAIN-solve warm chain at the ticks before it."""
    sc = Scenario(**{k: torch.as_tensor(v).to(dtype)
                     if v.dtype.kind == "f" else torch.as_tensor(v)
                     for k, v in SCENARIO.items()})
    chain = planner.mpc_params(WALK, SCENARIO, REC,
                               [np.full(B, t - CHAIN + k)
                                for k in range(CHAIN)], dtype=np.float64)
    state = sqp.SolverState(*(torch.as_tensor(a).to(dtype) for a in
                              traffic.cold_state(chain[0]["x0"],
                                                 chain[0]["mass"], WALK)))
    for p in chain:
        state, _ = sqp.solve_mpc(state, MPCParams(**{
            k: torch.as_tensor(v).to(dtype) for k, v in p.items()}), CFG)
    c = {k: torch.as_tensor(v).to(dtype) for k, v in
         sweep_traffic.start_carry(np.repeat(REC[t][None], B, 0), WALK,
                                   sweep_traffic.nominal_plan(
                                       WALK, SCENARIO)).items()}
    # the rows' CoM velocity off the recorded walk's, as after a push
    c["com_vel"] = c["com_vel"] + torch.as_tensor(
        KICK * SCENARIO["push_force"]).to(dtype)
    carry = closed_loop.LoopCarry(
        plant=PlantState(com_pos=c["com_pos"], com_vel=c["com_vel"],
                         hw=c["hw"]),
        plan_pos=c["plan_pos"], theta_hat=c["theta_hat"], solver=state)
    return sc, carry


def run_tick(sc, carry, t, fault=None):
    """(carry after, Trace) of the program's tick t from `carry`, with
    `fault` planted."""
    undo = loop_faults.plant(fault) if fault else None
    try:
        _, tick = closed_loop.rollout(sc, CFG, return_tick=True, t0=t,
                                      carry_in=carry)
        return tick(carry, t)
    finally:
        if undo:
            undo()


def program_tick(t, dtype, fault=None):
    """(carry before, carry after, packed x0) of the program's tick t from
    :func:`start`, with `fault` planted."""
    sc, carry = start(t, dtype)
    after, trace = run_tick(sc, carry, t, fault)
    return carry, after, trace.x0


def fields(carry):
    return {k: v.detach().to(torch.float64) for k, v in dict(
        com_pos=carry.plant.com_pos, com_vel=carry.plant.com_vel,
        hw=carry.plant.hw, plan_pos=carry.plan_pos,
        theta_hat=carry.theta_hat, z=carry.solver.z,
        y=carry.solver.y).items()}


def judged(t, dtype, fault=None):
    """(numbers, failed, carry before, carry after) of the program's tick t
    judged by the reference, t the late tick."""
    before, after, x0 = program_tick(t, dtype, fault)
    numbers, failed = ref_loop.judge(
        CONFIG, SCENARIO, [(t, fields(before), fields(after),
                            x0.to(torch.float64))], [], "cpu", late=t)
    return numbers, failed, before, after
