"""The benchmark's one traffic generator.

A traffic mix is a data file, ``portbench/traffic/<mix>.json``, whose
``kind`` names one of the generators below and whose other keys are its
parameters.  :func:`generate` turns a mix and a seed into plain numpy
inputs; the program and the reference both receive those and nothing else.
A new mix of an existing kind is a new data file and no code.

Kinds (one so far):

* ``recorded_ticks`` — ticks drawn (with repeats or without) from a
  recorded walk
  (``assets/walk_x0.npz``), each with the MPC's parameters of the ticks of
  its warm chain before it (``planner``), and the chain's cold start; the
  robot's scenario is the nominal walk.  A copy of the replay that the
  repository's solve benchmarks ran, with the ticks drawn from the seed.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

DEFAULT_FOOT_Y = 0.10163857612916291
SEED_SPACE = 1 << 64          # numpy seeds are non-negative


def load_mix(name: str) -> dict:
    """The parameters of the mix `name` (``traffic/<name>.json``)."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def default_vref(num_steps: int = 20) -> np.ndarray:
    """One (vx, vy, omega) command per footstep, (num_steps, 3) float64: the
    reference walk's commands (the program's ``config.default_vref``)."""
    cmds = ([(0.15, 0.0, 0.0)] * 11 + [(0.13, 0.0, 0.0)] * 4
            + [(0.10, 0.0, 0.0)] * 2 + [(0.0, 0.0, 0.0)] * 3)
    out = np.array(cmds, dtype=np.float64)
    if num_steps < 20:
        return out[:num_steps]
    return np.vstack([out, np.tile(out[-1], (num_steps - 20, 1))])


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


def nominal_scenario(num_steps: int, h: float, push=(0.0, 3.0, 0.0),
                     push_window=(801, 899), mass: float = 40.05) -> dict:
    """The nominal walk as a batch of one (the program's
    ``config.nominal_scenario``): the fields of the program's ``Scenario``
    in its order, float32 and int64 numpy arrays."""
    def f(x):
        return _f32(x)[None]

    def i(x):
        return np.asarray(x, np.int64)[None]

    return dict(
        k1=f(4.0), k2=f(0.1), mpc_mass=f(mass), plant_mass=f(mass),
        push_force=f(push), push_torque=f(np.zeros(3)),
        push_start=i(push_window[0]), push_end=i(push_window[1]),
        vref=f(default_vref(num_steps)),
        init_com=f([0.0, 0.0, h]), init_vel=f(np.zeros(3)),
        foot_y=f(DEFAULT_FOOT_Y),
        payload_mass=f(0.0), payload_onset=i(0),
        payload_impact_vel=f(0.0), step_y_offset=f(0.1))


def recorded_ticks(seed: int, batch: int, tick_lo: int, tick_hi: int,
                   warm_chain: int, asset: str, repeats: bool) -> dict:
    """`batch` ticks of the recorded walk in [tick_lo, tick_hi], drawn
    with or without repeats, sorted, with the recorded states."""
    rec = np.load(os.path.join(ROOT, asset))
    x0 = rec["x0"]
    if not (warm_chain <= tick_lo <= tick_hi < x0.shape[0]):
        raise ValueError(f"ticks {tick_lo}..{tick_hi} after a chain of "
                         f"{warm_chain} do not lie in the {x0.shape[0]} "
                         f"recorded ticks")
    rng = np.random.default_rng(seed % SEED_SPACE)
    ticks = np.sort(rng.choice(np.arange(tick_lo, tick_hi + 1), size=batch,
                               replace=repeats))
    return dict(ticks=ticks.astype(np.int64), x0=x0)


def cold_state(x0: np.ndarray, mass: np.ndarray, walk: dict,
               dtype=np.float32):
    """The solver's cold start (z, y) at states x0 (B, 20): every node at
    x0, each of the 8 vertices carrying a vertical force m g / 8, and no
    multipliers (the program's ``ops.sqp.init_solver_state``)."""
    N, B = walk["N"], x0.shape[0]
    z = np.zeros((B, 20 * (N + 1) + 32 * N))
    z[:, :20 * (N + 1)] = np.tile(x0.astype(np.float64), (1, N + 1))
    U = np.zeros((B, N, 32))
    U[:, :, 2:24:3] = (mass.astype(np.float64) * walk["g"] / 8.0)[:, None,
                                                                     None]
    z[:, 20 * (N + 1):] = U.reshape(B, -1)
    m = 20 * (N + 1) + (N + 1) + N + 40 * N + 6 * N
    return z.astype(dtype), np.zeros((B, m), dtype)


def generate(mix: dict, seed: int, walk: dict) -> dict:
    """The inputs of `mix` at `seed` for the configuration's walk keys.

    ``recorded_ticks``: the drawn ``ticks`` (B,), the robot's
    ``scenario`` (the nominal walk), the MPC's parameters of
    each step of the warm chain and of the timed solves (``params``, a
    list of warm_chain + 1 dicts of float32 arrays: step k solves tick
    t - warm_chain + k), and the cold start ``start`` = (z, y) of the
    chain."""
    from portbench import planner
    kind, ns, h = mix["kind"], walk["num_steps"], walk["h"]
    if kind == "recorded_ticks":
        out = recorded_ticks(seed, mix["batch"], mix["tick_lo"],
                             mix["tick_hi"], mix["warm_chain"], mix["asset"],
                             mix["repeats"])
        out["scenario"] = scenario = nominal_scenario(ns, h)
        n = mix["warm_chain"]
        out["params"] = planner.mpc_params(
            walk, scenario, out["x0"],
            [out["ticks"] - n + k for k in range(n + 1)])
        p0 = out["params"][0]
        out["start"] = cold_state(p0["x0"], p0["mass"], walk)
        return out
    raise ValueError(f"unknown traffic kind {kind!r}")
