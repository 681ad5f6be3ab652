"""The closed-loop sweep: every scenario of the batch walks one tick of the
program's closed loop (``sim.closed_loop``: the feet's references, the
packed state and the MPC's parameters, the solve, footstep adaptation, the
disturbances and the plant) a step, back to back.

Set-up hands the program the generated inputs (``sweep_traffic``), runs
the warm chain (the solves at the ticks before the start tick) through the
program's solve, builds the loop's carry at the start tick from the chain's
end, takes the loop's own tick from ``closed_loop.rollout(...,
return_tick=True, t0=, carry_in=)`` and runs the warm-up ticks through it.
The window's steps go on from there, one tick each; nothing is fetched to
the host inside the window.  Each step's output holds the device
references of the carry before and after the tick and of its packed MPC
state; the comparison takes those of the window's first and last ticks,
of the footstep adaptation's tick where the window reaches it and of the
mix's ``late_tick``, every row, and the chain's steps on ``chain_rows``
rows drawn from the seed (``reference/loop.py``).  Where the window ends
before the late tick, the loop runs on to it after the window, untimed,
so that every run judges it."""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic
from portbench.loads import common, sweep_traffic


def tick(loop_tick, carry, t: int):
    """One tick of the closed loop for the whole batch: the program's own
    tick (the traced run's span ``tick``)."""
    return loop_tick(carry, t)


def _carry_fields(carry) -> dict:
    """The loop's carry as plain named tensors."""
    return dict(com_pos=carry.plant.com_pos, com_vel=carry.plant.com_vel,
                hw=carry.plant.hw, plan_pos=carry.plan_pos,
                theta_hat=carry.theta_hat, z=carry.solver.z,
                y=carry.solver.y)


class Load:
    spans = (("portbench.loads.sweep", "tick", "tick"),
             ("cmpc_tpu_torch.ops.sqp", "solve_mpc", "solve"),
             ("cmpc_tpu_torch.ops.sqp", "pdip_solve", "pdip"))

    def __init__(self, config: dict, mix: dict, seed: int, device, clock):
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.clock = torch.device(device), clock
        self.batch = mix["batch"]
        self.adapted = self.late = None

    def prepare(self) -> None:
        from portbench import planner
        from portbench.planner import timing as tm
        sqp = common.module("ops.sqp")
        closed_loop = common.module("sim.closed_loop")
        Scenario = common.module("config").Scenario
        MPCParams = common.module("ocp.problem").MPCParams
        PlantState = common.module("sim.plant").PlantState
        common.set_precision(self.config["tf32"])
        dt = common.DTYPES[self.config["dtype"]]
        cfg = self.cfg = common.walk_config(self.config)
        walk = self.config["walk_config"]
        self.inputs = inp = sweep_traffic.generate(self.mix, self.seed,
                                                   self.config)
        self.events = tm.build_timing(planner.walk_config(walk)).update_event

        def tensor(a):
            a = torch.as_tensor(a).to(self.device)
            return a.to(dt) if a.is_floating_point() else a

        sc = Scenario(**{k: tensor(v) for k, v in inp["scenario"].items()})
        params = [MPCParams(**{k: tensor(v) for k, v in p.items()})
                  for p in inp["params"]]
        state = sqp.SolverState(*(tensor(a) for a in inp["start"]))
        c = {k: tensor(v) for k, v in inp["carry"].items()}
        self.clock.mark("inputs")
        chain = []
        for p in params:
            new, _ = sqp.solve_mpc(state, p, cfg)
            chain.append(((state.z, state.y), new.z))
            state = new
        self.chain = common.to_host(chain)
        carry = closed_loop.LoopCarry(
            plant=PlantState(com_pos=c["com_pos"], com_vel=c["com_vel"],
                             hw=c["hw"]),
            plan_pos=c["plan_pos"], theta_hat=c["theta_hat"], solver=state)
        self.carry, self.loop_tick = closed_loop.rollout(
            sc, cfg, return_tick=True, t0=inp["t0"], carry_in=carry)
        self.t = inp["t0"]
        self.clock.mark("warm_chain")
        for _ in range(self.mix["warm_up_steps"]):
            self.carry, _ = tick(self.loop_tick, self.carry, self.t)
            self.t += 1
        common.sync(self.device)
        self.clock.mark("warm_up")
        common.split_nvcc(self.clock, "warm_chain")

    def step(self):
        t, before = self.t, self.carry
        after, trace = tick(self.loop_tick, before, t)
        self.carry, self.t = after, t + 1
        sample = (t, before, after, trace.x0)
        if self.events[min(t, len(self.events) - 1)]:
            self.adapted = sample
        if t == self.mix["late_tick"]:
            self.late = sample
        return self.batch, sample

    def build_seconds(self) -> dict:
        return common.build_seconds()

    def release(self) -> None:
        while self.t <= self.mix["late_tick"]:
            self.step()
        del self.carry, self.loop_tick
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, samples, details=None):
        """(numbers, failed): the kept ticks and the chain's steps against
        the reference, each from the program's own state."""
        from portbench.reference import loop as ref
        kept = list(samples)
        for extra in (self.adapted, self.late):
            if extra is not None and extra[0] not in {s[0] for s in kept}:
                kept.append(extra)
        ticks = [(t, {k: common.to_host(v) for k, v in
                      _carry_fields(before).items()},
                  {k: common.to_host(v) for k, v in
                   _carry_fields(after).items()}, common.to_host(x0))
                 for t, before, after, x0 in kept]
        rows = np.sort(np.random.default_rng(
            [self.seed % traffic.SEED_SPACE, 1]).choice(
                self.batch, min(self.mix["chain_rows"], self.batch),
                replace=False))
        chain = [({k: a[rows] for k, a in p.items()},
                  (start[0][rows], start[1][rows]), [z[rows]])
                 for p, (start, z) in zip(self.inputs["params"], self.chain)]
        return ref.judge(self.config, self.inputs["scenario"], ticks, chain,
                         self.device, details, self.mix["late_tick"])
