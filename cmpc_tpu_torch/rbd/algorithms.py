"""Rigid-body kinematics & dynamics algorithms, batched (port of
``cmpc_tpu.rbd.algorithms``).

Everything is a function of (RobotModel constants, q, qv) built from dense
per-body world Jacobians:

    M(q)  = sum_b J_b^T diag(I_b^w, m_b 1) J_b          (mass matrix)
    h(q,qv) = sum_b J_b^T [I a_bias + w x (I w); m a_com_bias]
              - sum_b J_lin,b^T m g                      (Coriolis+gravity)

with J_b the 6 x nv [angular; linear-at-com] Jacobian.  Every tensor
carries a leading batch axis B; the tree recursions are Python loops over
the static tree on (B, 3, 3) / (B, 3) tensors.

Conventions:
  q  = RobotQ(base_pos (B,3), base_rot (B,3,3), qj (B,nj))
  qv = (B, 6+nj) = [omega_base_world(3), v_base_origin_world(3), qdot(nj)]
(angular-first, matching DART's FreeJoint spatial ordering.)

The model's numpy constants are put on the device once per (model, device,
dtype) by :func:`model_tensors`; a host array copied to the card on every
call would synchronize the stream each time.  The JAX module wraps every
function in a matmul-precision scope (``_highp``); it has no counterpart
here because float32 matmuls are full float32 once the entry points switch
TF32 off, and library functions do not touch the global flags.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.rbd.urdf import RobotModel
from cmpc_tpu_torch.utils.rotations import hat, rotvec_to_matrix


class RobotQ(NamedTuple):
    """Configuration. base_rot is a world-from-base rotation matrix (the
    9-number representation keeps FK linear-algebra-only; integrators
    update it through the exp map)."""

    base_pos: torch.Tensor   # (B, 3)
    base_rot: torch.Tensor   # (B, 3, 3)
    qj: torch.Tensor         # (B, nj)


class FK(NamedTuple):
    """World-frame kinematics of every movable body."""

    R: torch.Tensor          # (B, nb, 3, 3) world-from-body rotations
    p: torch.Tensor          # (B, nb, 3) body-frame origins (joint origins)
    axis_w: torch.Tensor     # (B, nb, 3) world joint axes
    com_w: torch.Tensor      # (B, nb, 3) world body-com positions
    I_w: torch.Tensor        # (B, nb, 3, 3) world-axes inertia about body com


class ModelTensors(NamedTuple):
    """The model's constants as tensors of one device and dtype."""

    T_R: torch.Tensor        # (nb, 3, 3) parent frame -> joint frame
    T_p: torch.Tensor        # (nb, 3)
    axis: torch.Tensor       # (nb, 3)
    K: torch.Tensor          # (nj, 3, 3) hat(axis) of the joints
    com: torch.Tensor        # (nb, 3)
    inertia: torch.Tensor    # (nb, 3, 3)
    mass: torch.Tensor       # (nb,)
    anc: torch.Tensor        # (nb, nj) 1 where joint j moves body b
    site_R: dict             # name -> (3, 3) offset rotation
    site_p: dict             # name -> (3,) offset translation


_TENSORS: dict = {}


def model_tensors(model: RobotModel, like: torch.Tensor) -> ModelTensors:
    """The constants of `model` on like's device in like's dtype, built on
    first use (the cache keeps the model alive, so its id stays its own)."""
    key = (id(model), str(like.device), like.dtype)
    hit = _TENSORS.get(key)
    if hit is not None:
        return hit[1]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                               device=like.device)

    axis = np.asarray(model.axis, np.float64)
    K = np.zeros((model.nj, 3, 3))
    x, y, z = axis[1:, 0], axis[1:, 1], axis[1:, 2]
    K[:, 0, 1], K[:, 0, 2] = -z, y
    K[:, 1, 0], K[:, 1, 2] = z, -x
    K[:, 2, 0], K[:, 2, 1] = -y, x
    mt = ModelTensors(
        T_R=t(model.T_tree[:, :3, :3]), T_p=t(model.T_tree[:, :3, 3]),
        axis=t(axis), K=t(K), com=t(model.com), inertia=t(model.inertia),
        mass=t(model.mass), anc=t(model.ancestor[:, 1:]),
        site_R={k: t(T[:3, :3]) for k, (_, T) in model.sites.items()},
        site_p={k: t(T[:3, 3]) for k, (_, T) in model.sites.items()})
    _TENSORS[key] = (model, mt)
    return mt


def neutral_q(model: RobotModel, batch: int = 1, device=None,
              dtype=torch.float32) -> RobotQ:
    return RobotQ(
        base_pos=torch.zeros(batch, 3, dtype=dtype, device=device),
        base_rot=torch.eye(3, dtype=dtype, device=device).repeat(batch, 1, 1),
        qj=torch.zeros(batch, model.nj, dtype=dtype, device=device))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def fk(model: RobotModel, q: RobotQ) -> FK:
    """Forward kinematics over the static tree."""
    mt = model_tensors(model, q.qj)
    # Rodrigues for the fixed unit joint axes, all joints at once
    th = q.qj[:, :, None, None]                              # (B,nj,1,1)
    eye = torch.eye(3, dtype=q.qj.dtype, device=q.qj.device)
    Rax = eye + torch.sin(th) * mt.K + (1.0 - torch.cos(th)) * (mt.K @ mt.K)

    Rs = [q.base_rot]
    ps = [q.base_pos]
    axis_w = [q.base_rot @ mt.axis[0]]
    for i in range(1, model.nb):
        par = int(model.parent[i])
        Rp, pp = Rs[par], ps[par]
        Rj = Rp @ mt.T_R[i]
        Rs.append(Rj @ Rax[:, i - 1])
        ps.append(pp + Rp @ mt.T_p[i])
        axis_w.append(Rj @ mt.axis[i])

    R = torch.stack(Rs, dim=1)
    p = torch.stack(ps, dim=1)
    com_w = p + torch.einsum("nbij,bj->nbi", R, mt.com)
    I_w = torch.einsum("nbij,bjk,nblk->nbil", R, mt.inertia, R)
    return FK(R=R, p=p, axis_w=torch.stack(axis_w, dim=1), com_w=com_w,
              I_w=I_w)


def point_jacobians(model: RobotModel, f: FK, body_idx: int, points_w):
    """(B, K, 6, nv) world Jacobians [angular; linear] of K points rigidly
    attached to body body_idx (static index); points_w (B, K, 3)."""
    mt = model_tensors(model, f.p)
    B, K = points_w.shape[0], points_w.shape[1]
    anc = mt.anc[body_idx]                                    # (nj,)
    eye = torch.eye(3, dtype=f.p.dtype, device=f.p.device).expand(B, K, 3, 3)
    zero = f.p.new_zeros(B, K, 3, 3)
    ax = f.axis_w[:, 1:]                                      # (B,nj,3)
    Jang_j = (ax.transpose(1, 2) * anc)[:, None].expand(B, K, 3, model.nj)
    r = points_w - f.p[:, :1]                                 # (B,K,3)
    arm = points_w[:, :, None, :] - f.p[:, None, 1:, :]       # (B,K,nj,3)
    Jlin_j = _cross(ax[:, None], arm).transpose(2, 3) * anc
    Jang = torch.cat([eye, zero, Jang_j], dim=-1)
    Jlin = torch.cat([-hat(r), eye, Jlin_j], dim=-1)
    return torch.cat([Jang, Jlin], dim=-2)


def point_jacobian(model: RobotModel, f: FK, body_idx: int, point_w):
    """(B, 6, nv) world Jacobian [angular; linear] of a point (B, 3) rigidly
    attached to body body_idx. Matches DART's
    getJacobian(inCoordinatesOf=World) up to the frame offset."""
    return point_jacobians(model, f, body_idx, point_w[:, None])[:, 0]


def _body_com_jacobians(model: RobotModel, f: FK):
    """(B, nb, 6, nv) stacked [angular; linear-at-com] Jacobians of every
    movable body — the common factor of M, h, and the centroidal maps."""
    mt = model_tensors(model, f.p)
    B, nb = f.p.shape[0], model.nb
    eye = torch.eye(3, dtype=f.p.dtype, device=f.p.device).expand(
        B, nb, 3, 3)
    zero = f.p.new_zeros(B, nb, 3, 3)
    ax = f.axis_w[:, 1:]                                      # (B,nj,3)
    # column j moves body b iff joint j is an ancestor of b
    Jang_j = torch.einsum("njc,bj->nbcj", ax, mt.anc)
    arm_base = f.com_w - f.p[:, :1]                           # (B,nb,3)
    arm = f.com_w[:, :, None, :] - f.p[:, None, 1:, :]        # (B,nb,nj,3)
    lin_j = _cross(ax[:, None].expand(arm.shape), arm)        # (B,nb,nj,3)
    Jlin_j = torch.einsum("nbjc,bj->nbcj", lin_j, mt.anc)
    Jang = torch.cat([eye, zero, Jang_j], dim=-1)
    Jlin = torch.cat([-hat(arm_base), eye, Jlin_j], dim=-1)
    return torch.cat([Jang, Jlin], dim=-2)


def mass_matrix(model: RobotModel, f: FK):
    """Joint-space inertia matrix M(q), (B, nv, nv). DART: getMassMatrix()."""
    mt = model_tensors(model, f.p)
    J = _body_com_jacobians(model, f)                         # (B,nb,6,nv)
    IJ_ang = torch.einsum("nbij,nbjv->nbiv", f.I_w, J[:, :, 0:3])
    IJ_lin = mt.mass[:, None, None] * J[:, :, 3:6]
    IJ = torch.cat([IJ_ang, IJ_lin], dim=2)
    M = torch.einsum("nbcv,nbcw->nvw", J, IJ)
    return 0.5 * (M + M.transpose(1, 2))


class Vel(NamedTuple):
    omega: torch.Tensor      # (B, nb, 3) world angular velocities
    v_origin: torch.Tensor   # (B, nb, 3) world velocity of body origins
    v_com: torch.Tensor      # (B, nb, 3)


def velocities(model: RobotModel, f: FK, qv) -> Vel:
    """Propagate body velocities down the static tree."""
    jv = qv[:, 6:, None] * f.axis_w[:, 1:]                    # (B,nj,3)
    om = [qv[:, 0:3]]
    vo = [qv[:, 3:6]]
    for i in range(1, model.nb):
        par = int(model.parent[i])
        r = f.p[:, i] - f.p[:, par]
        om.append(om[par] + jv[:, i - 1])
        vo.append(vo[par] + _cross(om[par], r))
    omega = torch.stack(om, dim=1)
    v_origin = torch.stack(vo, dim=1)
    v_com = v_origin + _cross(omega, f.com_w - f.p)
    return Vel(omega=omega, v_origin=v_origin, v_com=v_com)


class BiasAcc(NamedTuple):
    """Body accelerations with qdd = 0 — i.e. Jdot(q) qv per body."""

    alpha: torch.Tensor      # (B, nb, 3) angular
    a_origin: torch.Tensor   # (B, nb, 3) classical acceleration of origins


def bias_accelerations(model: RobotModel, f: FK, vel: Vel, qv) -> BiasAcc:
    """Propagate qdd=0 (velocity-product) accelerations down the tree."""
    jv = qv[:, 6:, None] * f.axis_w[:, 1:]                    # (B,nj,3)
    zero = torch.zeros_like(qv[:, 0:3])
    al = [zero]
    ao = [zero]
    for i in range(1, model.nb):
        par = int(model.parent[i])
        r = f.p[:, i] - f.p[:, par]
        w = vel.omega[:, par]
        al.append(al[par] + _cross(w, jv[:, i - 1]))
        ao.append(ao[par] + _cross(al[par], r) + _cross(w, _cross(w, r)))
    return BiasAcc(alpha=torch.stack(al, dim=1),
                   a_origin=torch.stack(ao, dim=1))


def _site_point(model: RobotModel, f: FK, site: str):
    idx, _ = model.sites[site]
    mt = model_tensors(model, f.p)
    return idx, f.p[:, idx] + f.R[:, idx] @ mt.site_p[site]


def site_bias_acc(model: RobotModel, f: FK, vel: Vel, bias: BiasAcc,
                  site: str):
    """(alpha (B,3), a (B,3)) of a named site with qdd = 0: the Jdot qv
    terms the ID tasks need (DART getJacobianClassicDeriv @ qv)."""
    idx, p_site = _site_point(model, f, site)
    r = p_site - f.p[:, idx]
    w = vel.omega[:, idx]
    a = (bias.a_origin[:, idx] + _cross(bias.alpha[:, idx], r)
         + _cross(w, _cross(w, r)))
    return bias.alpha[:, idx], a


def _com_accelerations(f: FK, vel: Vel, bias: BiasAcc):
    c_arm = f.com_w - f.p
    return (bias.a_origin + _cross(bias.alpha, c_arm)
            + _cross(vel.omega, _cross(vel.omega, c_arm)))


def com_bias_acc(model: RobotModel, f: FK, vel: Vel, bias: BiasAcc):
    """CoM linear acceleration with qdd = 0 (DART
    getCOMLinearJacobianDeriv @ qv), (B, 3)."""
    mt = model_tensors(model, f.p)
    a_com = _com_accelerations(f, vel, bias)
    return torch.einsum("b,nbi->ni", mt.mass, a_com) / model.total_mass


def bias_forces(model: RobotModel, f: FK, qv, g: float = 9.81):
    """Coriolis + centrifugal + gravity generalized forces h(q, qv),
    (B, nv). DART: getCoriolisAndGravityForces()."""
    mt = model_tensors(model, f.p)
    vel = velocities(model, f, qv)
    bias = bias_accelerations(model, f, vel, qv)
    a_com = _com_accelerations(f, vel, bias)
    g_vec = const(("gravity_vec", float(g)), lambda: [0.0, 0.0, -float(g)],
                  qv.device, qv.dtype)
    tau_b = (torch.einsum("nbij,nbj->nbi", f.I_w, bias.alpha)
             + _cross(vel.omega, torch.einsum("nbij,nbj->nbi", f.I_w,
                                              vel.omega)))
    f_b = mt.mass[:, None] * (a_com - g_vec)
    J = _body_com_jacobians(model, f)
    wrench = torch.cat([tau_b, f_b], dim=2)                   # (B,nb,6)
    return torch.einsum("nbcv,nbc->nv", J, wrench)


def com(model: RobotModel, f: FK):
    """Whole-robot CoM (B, 3). DART: getCOM()."""
    mt = model_tensors(model, f.p)
    return torch.einsum("b,nbi->ni", mt.mass, f.com_w) / model.total_mass


def com_jacobian(model: RobotModel, f: FK):
    """(B, 3, nv) linear CoM Jacobian. DART: getCOMLinearJacobian(World)."""
    mt = model_tensors(model, f.p)
    J = _body_com_jacobians(model, f)
    return torch.einsum("b,nbcv->ncv", mt.mass, J[:, :, 3:6]) \
        / model.total_mass


def centroidal_momentum(model: RobotModel, f: FK, qv):
    """(h_w (B,3), h_lin (B,3)): angular momentum about the robot CoM and
    linear momentum."""
    mt = model_tensors(model, f.p)
    vel = velocities(model, f, qv)
    m = mt.mass[:, None]
    c = com(model, f)
    h_w = torch.einsum("nbij,nbj->ni", f.I_w, vel.omega) + torch.sum(
        m * _cross(f.com_w - c[:, None], vel.v_com), dim=1)
    h_lin = torch.sum(m * vel.v_com, dim=1)
    return h_w, h_lin


def centroidal_inertia(model: RobotModel, f: FK):
    """Composite rigid-body inertia about the robot CoM (B, 3, 3)."""
    mt = model_tensors(model, f.p)
    c = com(model, f)
    d = f.com_w - c[:, None]
    dd = torch.einsum("nbi,nbi->nb", d, d)
    outer = torch.einsum("nbi,nbj->nbij", d, d)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    shift = mt.mass[:, None, None] * (dd[:, :, None, None] * eye - outer)
    return torch.sum(f.I_w + shift, dim=1)


def site_pose(model: RobotModel, f: FK, site: str):
    """World (R (B,3,3), p (B,3)) of a named site (e.g. 'l_sole')."""
    mt = model_tensors(model, f.p)
    idx, p = _site_point(model, f, site)
    return f.R[:, idx] @ mt.site_R[site], p


def site_jacobian(model: RobotModel, f: FK, site: str):
    """(B, 6, nv) world Jacobian of a named site."""
    idx, p = _site_point(model, f, site)
    return point_jacobian(model, f, idx, p)


def site_velocity(model: RobotModel, f: FK, qv, site: str):
    """(omega (B,3), v (B,3)) of a named site."""
    J = site_jacobian(model, f, site)
    sv = (J @ qv[:, :, None])[:, :, 0]
    return sv[:, 0:3], sv[:, 3:6]


def _regularized(M, reg: float):
    return M + reg * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def forward_dynamics(model: RobotModel, q: RobotQ, qv, tau_actuated,
                     contact_wrenches=(), g: float = 9.81,
                     reg: float = 1e-9):
    """qdd = M^{-1} (S tau + sum_c J_c^T w_c - h), (B, nv).
    contact_wrenches: iterable of (site_name, wrench (B,6) [torque; force]
    world)."""
    f = fk(model, q)
    M = mass_matrix(model, f)
    h = bias_forces(model, f, qv, g)
    rhs = torch.cat([-h[:, :6], -h[:, 6:] + tau_actuated], dim=1)
    for site, w in contact_wrenches:
        J = site_jacobian(model, f, site)
        rhs = rhs + (J.transpose(1, 2) @ w[:, :, None])[:, :, 0]
    return torch.linalg.solve_ex(_regularized(M, reg), rhs)[0]


def integrate(q: RobotQ, qv, qacc, dt: float) -> tuple:
    """Semi-implicit Euler with exp-map base-rotation update (the rotation
    matrix stays on SO(3) without re-orthonormalization drift)."""
    qv_new = qv + dt * qacc
    dR = rotvec_to_matrix(qv_new[:, 0:3] * dt)
    return RobotQ(base_pos=q.base_pos + dt * qv_new[:, 3:6],
                  base_rot=dR @ q.base_rot,
                  qj=q.qj + dt * qv_new[:, 6:]), qv_new
