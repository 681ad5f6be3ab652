"""The batched solve: fresh solves of ``ops.sqp.solve_mpc`` from one warm
state, back to back.

Set-up hands the program the generated inputs (the MPC's parameters of
every step, the chain's cold start), runs each tick's warm chain (the
solves at the ticks before it) through the window's own call, and keeps
each chain step's start and answer for the comparison.  Every solve of the
window takes the chain's last state and the parameters of the drawn ticks.
The comparison takes the window's first and last answers, every row, and
the chain's steps on ``chain_rows`` rows drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic
from portbench.loads import common


class Load:
    solver = None           # in place of the program's ops.sqp (the control)
    spans = (("cmpc_tpu_torch.ops.sqp", "solve_mpc", "solve"),
             ("cmpc_tpu_torch.ops.sqp", "pdip_solve", "pdip"))

    def __init__(self, config: dict, mix: dict, seed: int, device, clock):
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.clock = torch.device(device), clock
        self.batch = mix["batch"]

    def prepare(self) -> None:
        sqp = common.module("ops.sqp")
        self.sqp = self.solver or sqp
        MPCParams = common.module("ocp.problem").MPCParams
        common.set_precision(self.config["tf32"])
        dt = common.DTYPES[self.config["dtype"]]
        cfg = self.cfg = common.walk_config(self.config)
        self.inputs = traffic.generate(self.mix, self.seed,
                                       self.config["walk_config"])

        def tensor(a):
            return torch.as_tensor(a).to(self.device, dt)

        params = [MPCParams(**{k: tensor(v) for k, v in p.items()})
                  for p in self.inputs["params"]]
        state = sqp.SolverState(*(tensor(a) for a in self.inputs["start"]))
        self.clock.mark("inputs")
        chain = []
        for p in params[:-1]:
            new, _ = self.sqp.solve_mpc(state, p, cfg)
            chain.append(((state.z, state.y), new.z))
            state = new
        self.state, self.params = state, params[-1]
        self.chain = common.to_host(chain)
        self.clock.mark("warm_chain")
        # as many solves held at once as the window holds, so that the
        # allocator has their blocks before the window
        held = [self.step() for _ in range(self.mix["warm_up_steps"])]
        del held
        common.sync(self.device)
        self.clock.mark("warm_up")
        common.split_nvcc(self.clock, "warm_chain")

    def step(self):
        new, _ = self.sqp.solve_mpc(self.state, self.params, self.cfg)
        return self.batch, new.z

    def build_seconds(self) -> dict:
        return common.build_seconds()

    def release(self) -> None:
        self.warm = common.to_host((self.state.z, self.state.y))
        del self.state, self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, answers, details=None):
        """(numbers, failed): every chain step and the window's answers
        against the reference, each from the program's own start."""
        from portbench.reference import solve as ref
        params = self.inputs["params"]
        rows = np.sort(np.random.default_rng(
            [self.seed % traffic.SEED_SPACE, 1]).choice(
                self.batch, min(self.mix["chain_rows"], self.batch),
                replace=False))
        steps = [({k: a[rows] for k, a in p.items()},
                  (start[0][rows], start[1][rows]), [z[rows]])
                 for p, (start, z) in zip(params, self.chain)]
        steps.append((params[-1], self.warm,
                      [common.to_host(z) for z in answers]))
        return ref.judge(self.config["walk_config"], steps, self.device,
                         details)
