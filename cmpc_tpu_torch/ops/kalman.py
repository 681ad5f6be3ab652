"""Linear Kalman filter (port of ``cmpc_tpu.ops.kalman``), batched.

Pure functional predict/update over a (state, covariance) pair with a
leading batch axis; the model matrices are shared by the batch.  Used by
the IS-MPC baseline loop to filter the 9-dim LIP state
(original_code/simulation.py:103-153).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class KalmanModel(NamedTuple):
    A: torch.Tensor   # (n, n) state transition
    B: torch.Tensor   # (n, k) control input
    d: torch.Tensor   # (n,) drift
    H: torch.Tensor   # (p, n) observation
    Q: torch.Tensor   # (n, n) process noise covariance
    R: torch.Tensor   # (p, p) measurement noise covariance


class KalmanState(NamedTuple):
    x: torch.Tensor   # (B, n)
    P: torch.Tensor   # (B, n, n)


def predict(model: KalmanModel, s: KalmanState, u) -> KalmanState:
    """original_code/filter.py:14-17.  u: (B, k)."""
    x = s.x @ model.A.T + u @ model.B.T + model.d
    P = model.A @ s.P @ model.A.T + model.Q
    return KalmanState(x=x, P=P)


def update(model: KalmanModel, s: KalmanState, z) -> KalmanState:
    """original_code/filter.py:19-32.  z: (B, p)."""
    Pt = s.P.transpose(-1, -2)
    S = model.H @ s.P @ model.H.T + model.R
    K = torch.linalg.solve(S.transpose(-1, -2),
                           model.H @ Pt).transpose(-1, -2)   # P H' S^-1
    y = z - s.x @ model.H.T
    x = s.x + (K @ y[..., None])[..., 0]
    eye = torch.eye(s.P.shape[-1], dtype=s.P.dtype, device=s.P.device)
    P = (eye - K @ model.H) @ s.P
    return KalmanState(x=x, P=P)


def lip_kalman_model(eta: float, delta: float, g: float = 9.81,
                     q_pos=1e-4, q_vel=1e-3, q_zmp=1e-4,
                     r_pos=1e-4, r_vel=1e-2, r_zmp=1e-2, *,
                     device=None, dtype=torch.float32) -> KalmanModel:
    """Block-diagonal 9-dim LIP filter model, one (com, com_dot, zmp) block
    per axis, matching the wiring at original_code/simulation.py:103-131
    (including the -g*delta drift on the vertical velocity, :106)."""
    A1 = np.array([[1.0, delta, 0.0],
                   [eta ** 2 * delta, 1.0, -eta ** 2 * delta],
                   [0.0, 0.0, 1.0]])
    B1 = np.array([[0.0], [0.0], [delta]])

    def blk(M):
        return np.kron(np.eye(3), M)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    d = np.zeros(9)
    d[7] = -delta * g
    return KalmanModel(
        A=t(blk(A1)), B=t(blk(B1)), d=t(d), H=t(np.eye(9)),
        Q=t(blk(np.diag([q_pos, q_vel, q_zmp]))),
        R=t(blk(np.diag([r_pos, r_vel, r_zmp]))))
