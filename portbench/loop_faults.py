"""Faults planted in the closed loop's tick, to show that the comparison
with the loop's reference catches them (``control_sweep.py --fault`` and
the repository's tests).  Each replaces a part of the program's loop, and
:func:`plant` returns what takes it out again; plant before the loop's
set-up (``Load.prepare``), which builds the tick.

* ``push_ignored`` — the plant steps without the push (force and torque);
* ``impulse_dropped`` — the plant steps without the payload's impact
  impulse (the payload's mass still joins the plant at its onset);
* ``adapt_skipped`` — footstep adaptation never writes the plan;
* ``plant_frozen`` — the plant is not advanced: its state after the tick
  is the state before it;
* ``hw_sign_dropped`` — the packed state takes the measured angular
  momentum without the sign that ``hw_meas_negated`` gives it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.loads import common

FAULTS = ("push_ignored", "impulse_dropped", "adapt_skipped", "plant_frozen",
          "hw_sign_dropped")


def broken_plant_step(name, plant_step):
    """The program's ``sim.plant.plant_step`` with the fault `name`."""
    def broken(ps, com_des_pos, com_des_vel, com_des_acc, u0, gamma_l,
               gamma_r, pose_l, pose_r, mpc_mass, plant_mass, ext_force,
               ext_torque, *args, **kwargs):
        if name == "plant_frozen":
            return ps
        ext_force = ext_force.clone()
        if name == "push_ignored":
            ext_force[:, :2] = 0.0          # the push has no z component
            ext_torque = ext_torque * 0.0
        else:
            ext_force[:, 2] = 0.0           # the impulse is all of z
        return plant_step(ps, com_des_pos, com_des_vel, com_des_acc, u0,
                          gamma_l, gamma_r, pose_l, pose_r, mpc_mass,
                          plant_mass, ext_force, ext_torque, *args, **kwargs)
    return broken


def plant(name: str):
    """Plant fault `name` in the program's closed loop; returns the undo."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    closed_loop = common.module("sim.closed_loop")
    if name == "hw_sign_dropped":
        assemble = closed_loop.assemble
        pack_x0 = assemble.pack_x0

        def unsigned(com_pos, com_vel, hw, *args, **kwargs):
            return pack_x0(com_pos, com_vel, -hw, *args, **kwargs)
        assemble.pack_x0 = unsigned
        return lambda: setattr(assemble, "pack_x0", pack_x0)
    if name == "adapt_skipped":
        timing = closed_loop.timing_mod
        build = timing.build_timing

        def no_events(cfg):
            tg = build(cfg)
            return dataclasses.replace(
                tg, update_event=np.zeros_like(tg.update_event))
        timing.build_timing = no_events
        return lambda: setattr(timing, "build_timing", build)
    step = closed_loop.plant_step
    closed_loop.plant_step = broken_plant_step(name, step)
    return lambda: setattr(closed_loop, "plant_step", step)
