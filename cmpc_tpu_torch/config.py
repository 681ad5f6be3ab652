"""Configuration: the static :class:`WalkConfig` and the batched
:class:`Scenario`.

``WalkConfig`` is a copy of ``cmpc_tpu.config.WalkConfig`` (that module
imports JAX, so it cannot be shared); ``tests/test_torch_config.py`` pins
its field names and defaults to the JAX one.  ``Scenario`` holds tensors
with a leading batch axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_FOOT_Y = 0.10163857612916291


@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """Static problem structure (see ``cmpc_tpu.config.WalkConfig`` for the
    provenance of every default)."""

    g: float = 9.81
    h: float = 0.72
    foot_size: float = 0.1
    step_height: float = 0.02
    world_time_step: float = 0.01
    ss_duration: int = 70
    ds_duration: int = 30
    first_swing: str = "rfoot"
    mu: float = 0.5
    N: int = 10
    mpc_rate: int = 1
    num_steps: int = 20
    update_contact: bool = True
    com_z_max: float = 0.76
    knot_y_scale: float = 0.6
    physical_ref_units: bool = True
    foot_length: float = 0.25
    foot_width: float = 0.13
    stance_box: tuple = (0.01, 0.005, 0.00005)
    mpc_solver: str = "condip"
    pdip_iters: int = 8
    pdip_refine: int = 1
    condip_prox: float = 0.1
    condip_soft: bool = False
    sqp_iters: int = 3
    sqp_prox: float = 20.0
    admm_iters: int = 20
    admm_rho: float = 0.1
    admm_sigma: float = 1e-6
    admm_alpha: float = 1.6
    admm_kkt_form: bool = False
    mpc_blocktri: bool = True
    plant_hw_compliance: float = 0.35
    plant_hw_shed: float = 3.0
    hw_meas_negated: bool = True
    x0_swing_from_traj: bool = True
    sqp_elastic: bool = False

    @property
    def eta(self) -> float:
        return float(np.sqrt(self.g / self.h))

    @property
    def delta(self) -> float:
        return self.world_time_step * self.mpc_rate

    @property
    def total_ticks(self) -> int:
        scale = self.ss_duration + self.ds_duration
        return 2 * scale + (self.num_steps - 1) * scale

    @property
    def pad_ticks(self) -> int:
        return self.total_ticks + (self.N + 2) * self.mpc_rate + 8

    @property
    def n_x(self) -> int:
        return 20

    @property
    def n_u(self) -> int:
        return 32

    @property
    def n_z(self) -> int:
        return self.n_x * (self.N + 1) + self.n_u * self.N


def default_vref(num_steps: int = 20) -> np.ndarray:
    """One (vx, vy, omega) command per footstep (simulation.py:97)."""
    cmds = ([(0.15, 0.0, 0.0)] * 11 + [(0.13, 0.0, 0.0)] * 4
            + [(0.10, 0.0, 0.0)] * 2 + [(0.0, 0.0, 0.0)] * 3)
    out = np.array(cmds, dtype=np.float64)
    if num_steps != 20:
        if num_steps < 20:
            out = out[:num_steps]
        else:
            out = np.vstack([out, np.tile(out[-1], (num_steps - 20, 1))])
    return out


class Gains(NamedTuple):
    """Backstepping gains of the change of coordinates (paper §III;
    centroidal_mpc_vertices.py:27-31), per scenario."""

    k1: torch.Tensor  # () or (B,)
    k2: torch.Tensor


class Scenario(NamedTuple):
    """Per-scenario parameters, each with a leading batch axis (B, ...).
    Tick fields (push_start, push_end, payload_onset) are int64."""

    k1: torch.Tensor               # (B,)
    k2: torch.Tensor               # (B,)
    mpc_mass: torch.Tensor         # (B,)
    plant_mass: torch.Tensor       # (B,)
    push_force: torch.Tensor       # (B, 3)
    push_torque: torch.Tensor      # (B, 3)
    push_start: torch.Tensor       # (B,) int64
    push_end: torch.Tensor         # (B,) int64
    vref: torch.Tensor             # (B, S, 3)
    init_com: torch.Tensor         # (B, 3)
    init_vel: torch.Tensor         # (B, 3)
    foot_y: torch.Tensor           # (B,)
    payload_mass: torch.Tensor     # (B,)
    payload_onset: torch.Tensor    # (B,) int64
    payload_impact_vel: torch.Tensor  # (B,)
    step_y_offset: torch.Tensor    # (B,)

    def to(self, device=None, dtype=None) -> "Scenario":
        """Move every leaf to `device`; float leaves also to `dtype`."""
        return Scenario(*(
            v.to(device=device, dtype=dtype) if v.is_floating_point()
            else v.to(device=device) for v in self))

    def repeat(self, n: int) -> "Scenario":
        """The batch tiled n times along the batch axis."""
        return Scenario(*(v.repeat(n, *([1] * (v.dim() - 1))) for v in self))


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The default is the card, and a
    request for a card that is not there raises: no entry point carries on
    on the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA "
                           f"device is available (pass device='cpu' to run "
                           f"on the CPU)")
    return device


def nominal_scenario(cfg: WalkConfig, mass: float = 40.05,
                     push: tuple = (0.0, 3.0, 0.0),
                     push_window: tuple = (801, 899), *,
                     device="cuda", dtype=torch.float32) -> Scenario:
    """The reference flat-ground walk as a batch of one: 20 steps, lateral
    3 N push for t in (800, 900) (simulation.py:195-198)."""
    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)[None]

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)[None]

    return Scenario(
        k1=f(4.0), k2=f(0.1), mpc_mass=f(mass), plant_mass=f(mass),
        push_force=f(push), push_torque=f(np.zeros(3)),
        push_start=i(push_window[0]), push_end=i(push_window[1]),
        vref=f(default_vref(cfg.num_steps)),
        init_com=f([0.0, 0.0, cfg.h]), init_vel=f(np.zeros(3)),
        foot_y=f(DEFAULT_FOOT_Y),
        payload_mass=f(0.0), payload_onset=i(0),
        payload_impact_vel=f(0.0), step_y_offset=f(0.1),
    )


def payload_scenario(cfg: WalkConfig, mass: float = 40.05,
                     payload_mass: float = 2.0, onset_tick: int = 0,
                     drop_height: float = 0.1, *, device="cuda",
                     dtype=torch.float32) -> Scenario:
    """The payload variant (2 kg box dropped on the arms, gains k1=7,
    k2=1; centroidal_mpc_vertices_payload.py:27-31)."""
    base = nominal_scenario(cfg, mass=mass, push=(0.0, 0.0, 0.0),
                            push_window=(0, 0), device=device, dtype=dtype)

    def f(x):
        return torch.full((1,), float(x), dtype=dtype, device=device)

    return base._replace(
        k1=f(7.0), k2=f(1.0), payload_mass=f(payload_mass),
        payload_onset=torch.full((1,), int(onset_tick), dtype=torch.int64,
                                 device=device),
        payload_impact_vel=f(np.sqrt(2.0 * cfg.g * drop_height)))
