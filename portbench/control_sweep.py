"""Readings of the closed-loop sweep's compared numbers over many seeds in
one process: the program as the configuration states it (the lower
readings), the control (the upper readings), or the program with a
planted fault of ``loop_faults.py``.  The benchmark's own runs never run
this.

    python3 portbench/control_sweep.py --workload centroidal-sweep-b2048 \\
        --seeds 1,2,3 [--seconds S | --ticks T] [--control] [--fault NAME] \\
        [--dump DIR]

With ``--control`` the reference, in float32 with every matrix product's
operands rounded to TF32 (``reference/tf32.py``), takes the place of the
program's solve in the warm chain and at the window's judged ticks (its
first, the footstep adaptation's, the mix's late tick and its last), and
the window runs ``--ticks`` ticks in place of S seconds.  The program's
solve carries the loop between them, so that the control is judged on the
states the sound runs are judged on (on an H100 the control takes ~4 s a
tick at B = 2048 and the program ~0.35 s: in every tick it would reach
tick 200 in a 30 s window where the program reaches 277).  The rest of
the loop is the program's.  Each seed runs the cell's set-up, the window
and the comparison with the reference: one JSON line per seed, and with
``--dump`` each seed's per-row readings in
``DIR/<workload>_<seed>_<what>.npz``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_solve(walk: dict, device):
    """The reference in float32 with TF32 products, called as the
    program's ``ops.sqp.solve_mpc`` is (what follows the configuration,
    the closed loop's soft-row core, unused), with a zero ``SolveInfo``."""
    from portbench import control
    from portbench.loads import common
    sqp = common.module("ops.sqp")
    ref = control.ReferenceInPlace(walk, device, sqp.SolverState)

    def solve_mpc(state, params, cfg, *unused):
        new, _ = ref.solve_mpc(state, params, cfg)
        zero = new.z.new_zeros(new.z.shape[0])
        return new, sqp.SolveInfo(*[zero] * len(sqp.SolveInfo._fields))
    return solve_mpc


def control_in_place(load, ticks: int, device):
    """Put the control in the place of the program's solve in the warm
    chain and at the judged ticks of a window of `ticks` ticks; returns
    the undo."""
    from portbench.loads import common, sweep
    sqp = common.module("ops.sqp")
    first = load.mix["t0"] + load.mix["warm_up_steps"]
    last = first + ticks - 1
    events = load_events(load)
    judged = {first, last, load.mix["late_tick"]} | {
        t for t in range(first, last + 1) if t < len(events) and events[t]}
    now = {"t": None}                 # the loop's tick; None in the chain
    program, stand_in = sqp.solve_mpc, control_solve(
        load.config["walk_config"], device)
    tick = sweep.tick

    def solve_mpc(state, params, cfg, *rest):
        solve = stand_in if now["t"] is None or now["t"] in judged \
            else program
        return solve(state, params, cfg, *rest)

    def tick_at(loop_tick, carry, t):
        now["t"] = t
        return tick(loop_tick, carry, t)

    sqp.solve_mpc, sweep.tick = solve_mpc, tick_at

    def undo():
        sqp.solve_mpc, sweep.tick = program, tick
    return undo


def load_events(load):
    """The adaptation ticks' table of the load's gait (the planner's)."""
    from portbench import planner
    from portbench.planner import timing as tm
    return tm.build_timing(planner.walk_config(
        load.config["walk_config"])).update_event


def readings(workload: str, seed: int, seconds: float, control=False,
             fault: str | None = None, device="cuda",
             mix_overrides: dict | None = None,
             dump: str | None = None, ticks: int | None = None) -> dict:
    """The compared numbers of one seed (with ``correct`` against the
    cell's limits): a window of `seconds`, or of `ticks` ticks where
    given (with `control`, required)."""
    import numpy as np
    import torch

    from portbench import core, loop_faults

    plan = core.cell_plan(core.load_benchmark(), workload)
    clock = core.SetupClock(time.perf_counter())
    load = core.make_load(plan, seed, device, clock, mix_overrides)
    undo = []
    if control:
        if not ticks:
            raise ValueError("the control runs a window of --ticks ticks")
        undo.append(control_in_place(load, ticks, device))
    if fault:
        undo.append(loop_faults.plant(fault))
    try:
        load.prepare()
        keep = core.Ends()
        if ticks:
            t0 = time.perf_counter()
            steps = []
            for _ in range(ticks):
                units, sample = load.step()
                steps.append((0.0, units))
                keep.add(sample)
            run = {"steps": steps, "window_s": time.perf_counter() - t0}
        else:
            run = core.run_window(load, seconds, keep)
        load.release()                # runs on to the late tick, if need be
    finally:
        for u in reversed(undo):
            u()
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
            "setup_s": clock.total(), "window_s": run["window_s"],
            "reference_s": t_ref, "failed": failed, "numbers": numbers,
            "correct": failed == 0 and all(c["ok"]
                                           for c in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--ticks", type=int, default=None)
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
                                  dump=args.dump, ticks=args.ticks)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
