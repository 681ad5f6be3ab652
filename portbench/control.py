"""Readings of a cell's compared numbers over many seeds in one process:
the program as the configuration states it (the lower readings), the
control (the upper readings), or the program with a planted fault.  The
benchmark's own runs never run this.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 \\
        --seconds S [--control] [--fault NAME] [--dump DIR]

The control of a float32 configuration with TF32 off is the nearest lower
precision, TF32: with ``--control`` the reference, in float32 with every
matrix product's operands rounded to TF32 (``reference/tf32.py``), takes
the program's place in the set-up and the window.  (The program's own
switch, ``torch.backends.cuda.matmul.allow_tf32``, leaves most of its
products to kernels without the tensor cores, so it is no control.)
``--fault`` plants one of the faults of ``portbench/faults.py`` in the
program's solve for the set-up and the window.  Each seed runs the cell's
set-up, a window of S seconds, and the comparison with the reference; one
JSON line per seed, and with ``--dump`` each seed's per-row readings in
``DIR/<workload>_<seed>_<what>.npz``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ReferenceInPlace:
    """The reference in float32 with TF32 products, called as the
    program's ``ops.sqp`` is."""

    def __init__(self, walk: dict, device, SolverState):
        import torch

        from portbench.reference.solve import Reference
        self.ref = Reference(walk, device, torch.float32)
        self.SolverState = SolverState

    def solve_mpc(self, state, params, cfg):
        from portbench.reference.nlp import PARAM_KEYS
        from portbench.reference.tf32 import TF32Products
        p = {k: getattr(params, k) for k in PARAM_KEYS}
        with TF32Products():
            z, y = self.ref.solve(state.z, state.y, p)
        return self.SolverState(z=z, y=y), None


def readings(workload: str, seed: int, seconds: float, control=False,
             fault: str | None = None, device="cuda",
             mix_overrides: dict | None = None,
             dump: str | None = None) -> dict:
    """The compared numbers of one seed (with ``correct`` against the
    cell's limits)."""
    import numpy as np
    import torch

    from portbench import core, faults
    from portbench.loads import common

    plan = core.cell_plan(core.load_benchmark(), workload)
    clock = core.SetupClock(time.perf_counter())
    load = core.make_load(plan, seed, device, clock, mix_overrides)
    sqp = common.module("ops.sqp")
    if control:
        load.solver = ReferenceInPlace(load.config["walk_config"], device,
                                       sqp.SolverState)
    undo = faults.plant(fault, load.solver or sqp) if fault else None
    try:
        load.prepare()
        keep = core.Ends()
        run = core.run_window(load, seconds, keep)
    finally:
        if undo:
            undo()
    load.release()
    details = {}
    t_ref = time.perf_counter()
    numbers, failed = load.check(keep.items, details)
    t_ref = time.perf_counter() - t_ref
    what = "control" if control else (fault or "program")
    if dump:
        os.makedirs(dump, exist_ok=True)
        np.savez(os.path.join(dump, f"{workload}_{seed}_{what}.npz"),
                 **details)
    checks = core.judge(numbers, core.load_limits(workload))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "what": what, "steps": len(run["steps"]),
            "setup_s": clock.total(), "reference_s": t_ref,
            "failed": failed, "numbers": numbers,
            "correct": failed == 0 and all(c["ok"]
                                           for c in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.control, args.fault,
                                  dump=args.dump)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
