"""Linear Inverted Pendulum model — the legacy IS-MPC baseline's plant (port
of ``cmpc_tpu.models.lip``), batched.

Mirrors original_code/ismpc.py:17-26: per-axis state [com, com_dot, zmp],
input zmp velocity; the z axis carries a -g drift.
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_tpu_torch.consts import const


def lip_matrices(eta: float):
    """A (3,3), B (3,1) of a single axis (original_code/ismpc.py:18-19)."""
    A = np.array([[0.0, 1.0, 0.0],
                  [eta ** 2, 0.0, -eta ** 2],
                  [0.0, 0.0, 0.0]])
    B = np.array([[0.0], [0.0], [1.0]])
    return A, B


def lip_dynamics(x, u, eta: float, g: float):
    """Full 9-dim stacked dynamics f(x, u) (original_code/ismpc.py:22-26).
    x: (B, 9) = [x-axis(3), y-axis(3), z-axis(3)], u: (B, 3) zmp
    velocities."""
    A = const(("lip_A", eta), lambda: lip_matrices(eta)[0], x.device,
              x.dtype)
    drift = const(("lip_drift", g), lambda: np.array(
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -g, 0.0]), x.device, x.dtype)
    B = x.shape[0]
    f = (x.reshape(B, 3, 3) @ A.T).reshape(B, 9) + drift
    # B = [0, 0, 1]': the command drives each axis' zmp component
    f[:, 2::3] += u
    return f
