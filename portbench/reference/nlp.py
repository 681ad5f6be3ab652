"""The centroidal MPC's nonlinear program, written out plainly from its
equations (Elobaid et al., arXiv:2409.01144: the vertex-force centroidal
model, the tracking cost, the Lyapunov decrease rows), for the reference.

Nothing here is taken from the program: the functions are written per
stage from the model, with batch dimensions leading (``...``), so that
they run on a batch of any leading shape.
Derivatives are taken outside (``reference/solve.py``): every function
here is analytic in z, so a complex z gives them by the complex step.

Layout (the program's interface, which its warm state is given in):

* state x (20): [p_com(3), v_com(3), h_w(3), theta(3), psi_l, p_l(3),
  psi_r, p_r(3)];
* input u (32): [4 left vertex forces (12), 4 right (12), v_l(3), v_r(3),
  omega_l, omega_r];
* z = [x_0 .. x_N, u_0 .. u_{N-1}] (540 at N = 10).

Parameters ``p`` are a dict of tensors with the batch leading: ``x0``
(20), ``com_ref`` (N, 9: position, velocity, acceleration of the CoM at
nodes 1..N), ``pos_ref_l``/``pos_ref_r`` (N, 3), ``yaw_ref_l``/
``yaw_ref_r`` (N), ``gamma_l``/``gamma_r`` (N+1: contact gates at nodes
0..N), ``k1``, ``k2``, ``mass`` (scalars).
"""

from __future__ import annotations

import math

import torch

# cost weights of the tracking cost
W_HW, W_XY, W_FOOT, W_SHARE, W_SWING, W_COM_Z0 = (
    1000.0, 1.0, 1000.0, 10.0, 10.0, 2000.0)
PARAM_KEYS = ("x0", "com_ref", "pos_ref_l", "pos_ref_r", "yaw_ref_l",
              "yaw_ref_r", "gamma_l", "gamma_r", "k1", "k2", "mass")


class Model:
    """The configuration's constants (from ``walk_config`` of the
    configuration file)."""

    def __init__(self, walk: dict):
        self.N = int(walk["N"])
        self.g = float(walk["g"])
        self.delta = float(walk["world_time_step"]) * int(walk["mpc_rate"])
        self.mu = float(walk["mu"])
        self.com_z_max = float(walk["com_z_max"])
        self.box = tuple(float(b) for b in walk["stance_box"])
        self.rate_weight = 0.0 if int(walk["mpc_rate"]) == 10 else 1.0
        hl, hw = walk["foot_length"] / 2.0, walk["foot_width"] / 2.0
        self.polygon = ((hl, hw), (hl, -hw), (-hl, -hw), (-hl, hw))
        self.n_z = 20 * (self.N + 1) + 32 * self.N

    # -- layout ---------------------------------------------------------

    def split(self, z):
        N = self.N
        X = z[..., :20 * (N + 1)].reshape(*z.shape[:-1], N + 1, 20)
        U = z[..., 20 * (N + 1):].reshape(*z.shape[:-1], N, 32)
        return X, U

    @staticmethod
    def join(X, U):
        return torch.cat([X.flatten(-2), U.flatten(-2)], dim=-1)

    # -- dynamics -------------------------------------------------------

    def _vertices(self, pos, yaw):
        """World positions of a foot's 4 contact vertices, (..., 4, 3)."""
        c, s = torch.cos(yaw), torch.sin(yaw)
        out = []
        for vx, vy in self.polygon:
            out.append(torch.stack([pos[..., 0] + c * vx - s * vy,
                                    pos[..., 1] + s * vx + c * vy,
                                    pos[..., 2]], dim=-1))
        return torch.stack(out, dim=-2)

    @staticmethod
    def _cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           dim=-1)

    def step(self, x, u, ref, gl, gr, k1, m):
        """One explicit-Euler step of the centroidal dynamics.  ref: the
        CoM reference of the step's target node (9); gl, gr: the contact
        gates of the step; k1, m: scalars of the scenario."""
        p, v = x[..., 0:3], x[..., 3:6]
        fl = u[..., 0:12].unflatten(-1, (4, 3))
        fr = u[..., 12:24].unflatten(-1, (4, 3))
        gl_, gr_ = gl[..., None], gr[..., None]
        grav = torch.zeros_like(p)
        grav[..., 2] = -self.g
        dp = v
        dv = grav + (gl_ * fl.sum(-2) + gr_ * fr.sum(-2)) / m[..., None]
        arm_l = self._vertices(x[..., 13:16], x[..., 12]) - p[..., None, :]
        arm_r = self._vertices(x[..., 17:20], x[..., 16]) - p[..., None, :]
        dhw = gl_ * self._cross(arm_l, fl).sum(-2) \
            + gr_ * self._cross(arm_r, fr).sum(-2)
        z2 = k1[..., None] * (p - ref[..., 0:3]) + (v - ref[..., 3:6])
        dtheta = z2 / m[..., None]
        dpsi_l = ((1.0 - gl) * u[..., 30])[..., None]
        dpsi_r = ((1.0 - gr) * u[..., 31])[..., None]
        dpl = (1.0 - gl_) * u[..., 24:27]
        dpr = (1.0 - gr_) * u[..., 27:30]
        f = torch.cat([dp, dv, dhw, dtheta, dpsi_l, dpl, dpsi_r, dpr], -1)
        return x + self.delta * f

    def _stage(self, p, i):
        """The parameters of stage i as step() takes them."""
        return (p["com_ref"][..., i, :], p["gamma_l"][..., i],
                p["gamma_r"][..., i], p["k1"], p["mass"])

    def rollout(self, x0, U, p):
        """The state trajectory (..., N+1, 20) of inputs U from x0."""
        xs = [x0]
        for i in range(self.N):
            xs.append(self.step(xs[-1], U[..., i, :], *self._stage(p, i)))
        return torch.stack(xs, dim=-2)

    def dynamics_residual(self, z, p):
        """[x_0 - x0, x_{i+1} - step(x_i, u_i)]: (..., 20 (N+1))."""
        X, U = self.split(z)
        rows = [X[..., 0, :] - p["x0"]]
        for i in range(self.N):
            rows.append(X[..., i + 1, :]
                        - self.step(X[..., i, :], U[..., i, :],
                                    *self._stage(p, i)))
        return torch.cat(rows, dim=-1)

    # -- cost -----------------------------------------------------------

    def cost(self, z, p):
        """The tracking cost, one value per scenario."""
        X, U = self.split(z)
        N = self.N
        gl, gr = p["gamma_l"], p["gamma_r"]
        c = torch.zeros_like(z[..., 0])
        for i in range(N):
            x1, ref = X[..., i + 1, :], p["com_ref"][..., i, :]
            wz = (W_COM_Z0 / 2.0) * math.exp(-i) + W_COM_Z0 / 2.0
            c = c + W_HW * (X[..., i, 6:9] ** 2).sum(-1)
            c = c + W_XY * ((x1[..., 0:2] - ref[..., 0:2]) ** 2).sum(-1)
            c = c + wz * (x1[..., 2] - ref[..., 2]) ** 2
            for pos, yaw, pref, yref, g in (
                    (x1[..., 13:16], x1[..., 12], p["pos_ref_l"],
                     p["yaw_ref_l"], gl),
                    (x1[..., 17:20], x1[..., 16], p["pos_ref_r"],
                     p["yaw_ref_r"], gr)):
                g1 = g[..., i + 1]
                c = c + W_FOOT * g1 ** 2 * (
                    ((pos - pref[..., i, :]) ** 2).sum(-1)
                    + (yaw - yref[..., i]) ** 2)
            for cols, g in ((slice(0, 12), gl), (slice(12, 24), gr)):
                f = U[..., i, cols].unflatten(-1, (4, 3))
                gi = g[..., i]
                mean = f.sum(-2) * (gi ** 2 / 4.0)[..., None]
                c = c + W_SHARE * gi * ((mean[..., None, :] - f) ** 2) \
                    .sum((-1, -2))
                c = c + W_SWING * (1.0 - gi) * (f ** 2).sum((-1, -2))
                if i < N - 1:
                    fn = U[..., i + 1, cols].unflatten(-1, (4, 3))
                    c = c + self.rate_weight * gi * (
                        (fn[..., 2] - f[..., 2]) ** 2).sum(-1)
        return c

    # -- inequality rows ------------------------------------------------

    def lyapunov(self, X, U, p):
        """The Lyapunov decrease rows (..., N), each <= 0."""
        rows = []
        k1, k2, m = p["k1"][..., None], p["k2"][..., None], \
            p["mass"][..., None]
        for i in range(self.N):
            ref = p["com_ref"][..., i, :]
            x1 = X[..., i + 1, :]
            V = (p["gamma_l"][..., i, None]
                 * U[..., i, 0:12].unflatten(-1, (4, 3)).sum(-2)
                 + p["gamma_r"][..., i, None]
                 * U[..., i, 12:24].unflatten(-1, (4, 3)).sum(-2)) / m
            rows.append(self.lyapunov_row(
                x1[..., 0:3] - ref[..., 0:3], x1[..., 3:6] - ref[..., 3:6],
                V, X[..., i, 9:12], ref[..., 6:9], k1, k2, m))
        return torch.stack(rows, dim=-1)

    def lyapunov_row(self, e_p, e_v, V, theta, acc, k1, k2, m):
        """One row in its own coordinates: the position and velocity
        errors of the next node, the force term V (gated forces over the
        mass), the estimate theta of the stage and the reference
        acceleration (each (..., 3)); k1, k2, m (..., 1)."""
        grav = torch.zeros_like(e_p)
        grav[..., 2] = -self.g
        z1 = e_p
        z2 = k1 * z1 + e_v
        u_n = -(k1 + k2) * z2 + k1 ** 2 * z1 - grav + acc - theta / m
        return (-k1[..., 0] * (z1 * z1).sum(-1)
                - k2[..., 0] * (z2 * z2).sum(-1)
                + (z1 * z2).sum(-1) + (z2 * (V - u_n)).sum(-1))

    def lyapunov_coordinates(self, z, p):
        """The coordinates a Lyapunov row is a quadratic form of, per
        stage and axis: (..., N, 3, 4) of the next node's position and
        velocity, the gated force term V and the stage's estimate theta
        (linear in z)."""
        X, U = self.split(z)
        out = []
        for i in range(self.N):
            V = (p["gamma_l"][..., i, None]
                 * U[..., i, 0:12].unflatten(-1, (4, 3)).sum(-2)
                 + p["gamma_r"][..., i, None]
                 * U[..., i, 12:24].unflatten(-1, (4, 3)).sum(-2)) \
                / p["mass"][..., None]
            out.append(torch.stack([X[..., i + 1, 0:3], X[..., i + 1, 3:6],
                                    V, X[..., i, 9:12]], dim=-1))
        return torch.stack(out, dim=-3).flatten(-3)

    def momentum(self, z):
        """The momentum row: |h_w| at node 1 squared less at node 0."""
        X, _ = self.split(z)
        return (X[..., 1, 6:9] ** 2).sum(-1) - (X[..., 0, 6:9] ** 2).sum(-1)

    def inequalities(self, z, p):
        """(rows, lo, hi) with lo <= rows <= hi, rows (..., m_in): the
        Lyapunov rows (N), the momentum row (1), the CoM height (N),
        friction pyramids of every vertex (32 N), unilateral vertical
        forces (8 N) and the stance-foot boxes (6 N)."""
        X, U = self.split(z)
        N, mu = self.N, self.mu
        gl, gr = p["gamma_l"], p["gamma_r"]
        inf = math.inf
        rows, lo, hi = [], [], []

        def add(r, lo_v, hi_v):
            rows.append(r)
            lo.extend([lo_v] * r.shape[-1])
            hi.extend([hi_v] * r.shape[-1])

        add(self.lyapunov(X, U, p), -inf, 0.0)
        add(self.momentum(z)[..., None], -inf, 0.0)
        add(X[..., :N, 2] - self.com_z_max, -inf, 0.0)
        for cols, g in ((slice(0, 12), gl), (slice(12, 24), gr)):
            f = U[..., cols].unflatten(-1, (4, 3))        # (..., N, 4, 3)
            fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
            pyr = torch.stack([fx - mu * fz, -fx - mu * fz,
                               fy - mu * fz, -fy - mu * fz], dim=-1)
            add((pyr * g[..., :N, None, None]).flatten(-3), -inf, 0.0)
        for cols, g in ((slice(0, 12), gl), (slice(12, 24), gr)):
            fz = U[..., cols].unflatten(-1, (4, 3))[..., 2]
            add((-fz * g[..., :N, None]).flatten(-2), -inf, 0.0)
        for a, (cols, g, ref) in enumerate(
                ((slice(13, 16), gl, p["pos_ref_l"]),
                 (slice(17, 20), gr, p["pos_ref_r"]))):
            r = (X[..., 1:, cols] - ref) * g[..., 1:, None]
            rows.append(r.flatten(-2))
            lo.extend([-b for b in self.box] * N)
            hi.extend(list(self.box) * N)
        out = torch.cat(rows, dim=-1)
        return (out, out.new_tensor(lo), out.new_tensor(hi))

    def violation(self, z, p):
        """Each inequality row's violation of its bounds, (..., m_in)."""
        c, lo, hi = self.inequalities(z, p)
        return (c - hi).clamp_min(0.0) + (lo - c).clamp_min(0.0)


def warm_start_inputs(model: Model, U, p):
    """The inputs a solve starts from, made from the inputs it carries
    (..., N, 32): the vertex forces gated by the new contact schedule and
    topped up evenly over the active vertices to carry the weight m g; and
    where a foot is in the air now and lands within the horizon, its
    velocity inputs set to reach the landing reference at the landing
    node, and zero after it."""
    N, dt = model.N, model.delta
    gl, gr = p["gamma_l"][..., :N], p["gamma_r"][..., :N]
    fl = U[..., 0:12].unflatten(-1, (4, 3)) * gl[..., None, None]
    fr = U[..., 12:24].unflatten(-1, (4, 3)) * gr[..., None, None]
    carried = fl[..., 2].sum(-1) + fr[..., 2].sum(-1)
    active = 4.0 * (gl + gr)
    short = (p["mass"][..., None] * model.g - carried).clamp_min(0.0) \
        / active.clamp_min(1.0)
    fl = fl + torch.stack([torch.zeros_like(fl[..., 0]),
                           torch.zeros_like(fl[..., 0]),
                           (short * gl)[..., None].expand_as(fl[..., 0])],
                          dim=-1)
    fr = fr + torch.stack([torch.zeros_like(fr[..., 0]),
                           torch.zeros_like(fr[..., 0]),
                           (short * gr)[..., None].expand_as(fr[..., 0])],
                          dim=-1)
    vel = []
    for cols, g, pos_now, pref in (
            (slice(24, 27), p["gamma_l"], p["x0"][..., 13:16],
             p["pos_ref_l"]),
            (slice(27, 30), p["gamma_r"], p["x0"][..., 17:20],
             p["pos_ref_r"])):
        stance_later = g[..., 1:] > 0.5                       # (..., N)
        lands = (g[..., 0] < 0.5) & stance_later.any(-1)
        node = torch.where(stance_later, torch.arange(
            N, device=g.device), N).amin(-1).clamp_max(N - 1)  # first
        target = torch.take_along_dim(pref, node[..., None, None], dim=-2)
        steps = (node + 1).to(pos_now.dtype)
        v = (target[..., 0, :] - pos_now) / (dt * steps)[..., None]
        before = torch.arange(N, device=g.device) < (node + 1)[..., None]
        seeded = torch.where(before[..., None], v[..., None, :],
                             torch.zeros_like(U[..., cols]))
        vel.append(torch.where(lands[..., None, None], seeded,
                               U[..., cols]))
    return torch.cat([fl.flatten(-2), fr.flatten(-2), vel[0], vel[1],
                      U[..., 30:32]], dim=-1)
