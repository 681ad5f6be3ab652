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
