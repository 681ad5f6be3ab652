"""numpy -> port conversion of the carried structures.

Each function takes a dict of numpy arrays — what ``tree._asdict()`` of the
JAX package's NamedTuple gives once its leaves go through ``np.asarray`` —
plus a device and a float dtype.  Float leaves become `dtype`, integer
leaves int64, bool leaves bool.  This is how the tests feed both packages
the same state, and how a state recorded by one is carried into the other.
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_tpu_torch.config import Scenario
from cmpc_tpu_torch.ocp.problem import MPCParams
from cmpc_tpu_torch.ops.sqp import SolverState
from cmpc_tpu_torch.rbd.algorithms import RobotQ
from cmpc_tpu_torch.sim.closed_loop import LoopCarry
from cmpc_tpu_torch.sim.plant import PlantState
from cmpc_tpu_torch.sim.wholebody_loop import WBLoopCarry
from cmpc_tpu_torch.wholebody.inverse_dynamics import WBDesired
from cmpc_tpu_torch.wholebody.plant import WBPlantState


def to_tensor(x, device=None, dtype=torch.float64):
    a = np.array(x)              # a writable copy
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _build(cls, d, device, dtype):
    return cls(**{k: to_tensor(d[k], device, dtype) for k in cls._fields})


def scenario_from_numpy(d: dict, device=None,
                        dtype=torch.float64) -> Scenario:
    """Leaves with a leading batch axis (B, ...)."""
    return _build(Scenario, d, device, dtype)


def params_from_numpy(d: dict, device=None,
                      dtype=torch.float64) -> MPCParams:
    return _build(MPCParams, d, device, dtype)


def solver_state_from_numpy(d: dict, device=None,
                            dtype=torch.float64) -> SolverState:
    return _build(SolverState, d, device, dtype)


def loop_carry_from_numpy(d: dict, device=None,
                          dtype=torch.float64) -> LoopCarry:
    """d['plant'] and d['solver'] are dicts themselves."""
    return LoopCarry(
        plant=_build(PlantState, d["plant"], device, dtype),
        plan_pos=to_tensor(d["plan_pos"], device, dtype),
        theta_hat=to_tensor(d["theta_hat"], device, dtype),
        solver=solver_state_from_numpy(d["solver"], device, dtype))


def robot_q_from_numpy(d: dict, device=None, dtype=torch.float64) -> RobotQ:
    """Leaves (B, 3), (B, 3, 3), (B, nj)."""
    return _build(RobotQ, d, device, dtype)


def wb_plant_state_from_numpy(d: dict, device=None,
                              dtype=torch.float64) -> WBPlantState:
    """d['q'] is a dict itself."""
    return WBPlantState(q=robot_q_from_numpy(d["q"], device, dtype),
                        qv=to_tensor(d["qv"], device, dtype))


def wb_desired_from_numpy(d: dict, device=None,
                          dtype=torch.float64) -> WBDesired:
    return _build(WBDesired, d, device, dtype)


def wb_carry_from_numpy(d: dict, device=None,
                        dtype=torch.float64) -> WBLoopCarry:
    """d['plant'] (with its nested 'q') and d['solver'] are dicts
    themselves."""
    flat = {k: to_tensor(d[k], device, dtype) for k in WBLoopCarry._fields
            if k not in ("plant", "solver")}
    return WBLoopCarry(
        plant=wb_plant_state_from_numpy(d["plant"], device, dtype),
        solver=solver_state_from_numpy(d["solver"], device, dtype), **flat)
