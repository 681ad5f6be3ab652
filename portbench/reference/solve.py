"""The reference of the batched solve, and the numbers that judge the
program's answers.

The solve is one step of the configuration's SQP from a warm state (z, y):
``sqp_iters`` iterations, each forming the quadratic subproblem of the
NLP (``reference/nlp.py``) at the current rollout, reduced to the inputs
with elastic Lyapunov and momentum rows, solved by ``pdip_iters``
Mehrotra interior-point iterations, and followed by a merit line search
over the steps (1, 0.5, 0.25, 0.1, 0).  The reference does this plainly:
the Jacobians by the complex step, gradients and the Hessians of the
quadratic terms by autograd, the reduction to
the inputs by a triangular solve of the dynamics' Jacobian, every
inequality in one dense matrix, and each Newton system by a Cholesky
factorization.  It shares no code with the program.

What the algorithm fixes, and the reference keeps: the row scaling of the
subproblem (each row over its largest entry, at least 1e-2; a row with
nothing in it made 0 <= 1; right-hand sides capped at 10), the cost
scaling (over the gradient's largest entry, at least 1), the interior
point's start (slacks max(d, 1), multipliers 1) and its safeguards by
precision, the proximal weight (``condip_prox``, times 16 after a rejected
step, a quarter after a step of 0.5 or more), the margin 1e-2 on the
Lyapunov rows, the elastic weight 1e6 and the cap 1e4 on the multipliers
carried in ``y``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.nlp import PARAM_KEYS, Model, warm_start_inputs

F64 = torch.float64
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.0)
W_ELASTIC = 1e6
LYAP_MARGIN = 1e-2
LAM_CAP = 1e4
ROW_FLOOR, ROW_EMPTY, RHS_CAP = 1e-2, 1e-9, 10.0
W_PROX_VEL = 1e-3          # proximal weight of the foot-velocity inputs
CS_STEP = 1e-20            # the complex step
ROW_BLOCK = 1024           # rows the reference solves at once
ROLL_TOL, MERIT_TOL = 1e-4, 1e-3   # what a row's rounding stays under


def safeguards(dtype):
    """(reg, clip, mu_min, floor) of the interior point at `dtype`: the
    Newton matrix's diagonal shift, the clip on lam / w, the least barrier
    and the least slack or multiplier."""
    if dtype == torch.float32:
        return 1e-7, 1e6, 1e-7, 1e-10
    return 1e-8, 1e8, 1e-9, 1e-14


class Reference:
    """The solve of the configuration `walk` (``walk_config`` of the
    configuration file) on `device` in `dtype`."""

    def __init__(self, walk: dict, device, dtype=F64):
        self.m = Model(walk)
        self.walk = walk
        self.device, self.dtype = torch.device(device), dtype
        self.ns = self.m.N + 1            # elastic rows: Lyapunov, momentum

    def params(self, arrays: dict) -> dict:
        return {k: torch.as_tensor(arrays[k]).to(self.device, self.dtype)
                for k in PARAM_KEYS}

    # -- derivatives ----------------------------------------------------

    def per_solve(self, p):
        """What depends on the parameters alone, for every iteration of a
        solve: the cost's Hessian (the cost is quadratic), the Hessian of
        a Lyapunov row in its own coordinates (a quadratic form of four
        per axis: the next node's position and velocity errors, the gated
        force term V and the stage's estimate theta) projected onto the
        positive semidefinite cone, the Jacobian of those coordinates (they
        are linear in z), and the momentum row's Hessian."""
        m = self.m
        B = p["x0"].shape[0]
        z0 = p["x0"].new_zeros(B, m.n_z)
        P = quadratic_hessian(m.cost, z0, p)

        def row(q, pp):
            def axis(s):
                return torch.stack([s, torch.zeros_like(s),
                                    torch.zeros_like(s)], dim=-1)
            k1, k2, mass = (pp[k][..., None] for k in ("k1", "k2", "mass"))
            return m.lyapunov_row(axis(q[..., 0]), axis(q[..., 1]),
                                  axis(q[..., 2]), axis(q[..., 3]),
                                  axis(q[..., 0] * 0.0), k1, k2, mass)
        Q = quadratic_hessian(row, z0.new_zeros(B, 4), p)
        ew, ev = torch.linalg.eigh(Q)
        Qp = (ev * ew.clamp_min(0.0)[:, None, :]) @ ev.transpose(-1, -2)
        T = cs_jacobian(m.lyapunov_coordinates, z0, p) \
            .reshape(B, m.N, 3, 4, m.n_z)
        H_mom = quadratic_hessian(lambda zz, pp: m.momentum(zz), z0, p)
        return P, Qp, T, H_mom

    def elastic_curvature(self, fixed, lam):
        """The multipliers `lam` (B, N+1) times the curvature of the
        Lyapunov rows (convexified, ``per_solve``) and of the momentum
        row, over z (B, n_z, n_z)."""
        _, Qp, T, H_mom = fixed
        N = self.m.N
        H = torch.einsum("bnaiz,bij,bnajy,bn->bzy", T, Qp, T, lam[:, :N])
        return H + lam[:, N, None, None] * H_mom

    # -- the subproblem ---------------------------------------------------

    def subproblem(self, z, p, fixed, lam, prox):
        """The inequality QP over v = dU at the rollout z (v = [dU, s]
        with ``condip_soft``, the Lyapunov and momentum rows elastic):
        min 1/2 v'Hv + g'v s.t. C v <= d, with each row's scale.  The
        first N + 1 rows are the Lyapunov and momentum rows."""
        m = self.m
        N, B = m.N, z.shape[0]
        ns = self.ns if self.walk["condip_soft"] else 0
        nX, nU = 20 * (N + 1), 32 * N
        dt, dev = z.dtype, z.device
        J_dyn = cs_jacobian(m.dynamics_residual, z, p)
        c_in, lo, hi = m.inequalities(z, p)
        J_in = cs_jacobian(lambda zz, pp: m.inequalities(zz, pp)[0], z, p)
        grad_c = gradient(m.cost, z, p)
        # dX = E dU keeps the dynamics' linearization: J_X E + J_U = 0
        E = torch.linalg.solve_triangular(
            J_dyn[:, :, :nX], -J_dyn[:, :, nX:], upper=False)
        S = torch.cat([E, torch.eye(nU, dtype=dt, device=dev)
                       .expand(B, nU, nU)], dim=1)          # dz = S dU
        curv = fixed[0] + self.elastic_curvature(fixed, lam)
        w_prox = torch.ones(N, 32, dtype=dt, device=dev)
        w_prox[:, 24:] = W_PROX_VEL
        H = torch.zeros(B, nU + ns, nU + ns, dtype=dt, device=dev)
        H[:, :nU, :nU] = S.transpose(1, 2) @ curv @ S \
            + torch.diag_embed(prox[:, None] * w_prox.reshape(1, -1))
        H[:, nU:, nU:] = torch.eye(ns, dtype=dt, device=dev)
        gu = (S.transpose(1, 2) @ grad_c[..., None])[..., 0]
        g = torch.cat([gu, gu.new_full((B, ns), W_ELASTIC)], dim=1)

        G = J_in @ S                                         # (B, m_in, nU)
        hi = hi.clone()
        hi[:N] -= LYAP_MARGIN
        lower = torch.isfinite(lo)            # rows with both bounds
        n_lo = int(lower.sum())
        # with elastic rows, the Lyapunov and momentum rows each take a
        # slack s >= 0 of their own
        soft = torch.zeros(G.shape[1], ns, dtype=dt, device=dev)
        soft[torch.arange(ns), torch.arange(ns)] = -1.0
        C = torch.cat([
            torch.cat([G, soft.expand(B, -1, -1)], dim=2),
            torch.cat([-G[:, lower], G.new_zeros(B, n_lo, ns)], dim=2),
            torch.cat([G.new_zeros(B, ns, nU),
                       -torch.eye(ns, dtype=dt, device=dev)
                       .expand(B, ns, ns)], dim=2)], dim=1)
        d = torch.cat([hi - c_in, (c_in - lo)[:, lower],
                       G.new_zeros(B, ns)], dim=1)
        size = C.abs().amax(dim=2)
        empty = size < ROW_EMPTY
        scale = torch.where(empty, 1.0, 1.0 / size.clamp_min(ROW_FLOOR))
        d = torch.where(empty, 1.0, d * scale)
        cap = (RHS_CAP / d.abs().clamp_min(1e-12)).clamp_max(1.0)
        C = C * (scale * cap)[..., None]
        return H, g, C, d * cap, scale * cap

    def interior_point(self, H, g, C, d):
        """(v, lam) after the configuration's Mehrotra iterations, each
        batch row on its own: cost scaled, Newton steps by Cholesky with
        the configuration's refinement passes, a non-finite step taken
        as no step."""
        iters = int(self.walk["pdip_iters"])
        refine = int(self.walk["pdip_refine"])
        reg, clip, mu_min, floor = safeguards(H.dtype)
        B, n = g.shape
        rows = d.shape[1]
        cs = 1.0 / g.abs().amax(dim=1).clamp_min(1.0)
        H, g = H * cs[:, None, None], g * cs[:, None]
        v = torch.zeros_like(g)
        w = d.clamp_min(1.0)
        lam = torch.ones_like(d)
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        Ct = C.transpose(1, 2)

        def mv(A, x):
            return (A @ x[..., None])[..., 0]

        def most_step(x, dx, tau):
            ratio = torch.where(dx < 0, -tau * x / dx.clamp_max(-1e-30),
                                1.0)
            return ratio.amin(dim=1).clamp_max(1.0)

        for _ in range(iters):
            r_d = mv(H, v) + g + mv(Ct, lam)
            r_p = mv(C, v) + w - d
            mu = (w * lam).sum(1) / rows
            M = H + (Ct * (lam / w).clamp(1e-12, clip)[:, None, :]) @ C \
                + reg * eye
            L, info = torch.linalg.cholesky_ex(M)
            L = torch.where((info != 0)[:, None, None], math.nan, L)

            def newton(r_c):
                rhs = -r_d + mv(Ct, (r_c - lam * r_p) / w)
                dv = torch.cholesky_solve(rhs[..., None], L)[..., 0]
                for _ in range(refine):
                    dv = dv + torch.cholesky_solve(
                        (rhs - mv(M, dv))[..., None], L)[..., 0]
                dw = -r_p - mv(C, dv)
                return dv, dw, (-r_c - lam * dw) / w

            dv, dw, dl = newton(w * lam)
            ap, ad = most_step(w, dw, 1.0), most_step(lam, dl, 1.0)
            mu_aff = ((w + ap[:, None] * dw) * (lam + ad[:, None] * dl)) \
                .sum(1) / rows
            sigma = (mu_aff / mu.clamp_min(1e-30)).pow(3).clamp(0.0, 1.0)
            target = (sigma * mu).clamp_min(mu_min)
            dv, dw, dl = newton(w * lam + dw * dl - target[:, None])
            ap, ad = most_step(w, dw, 0.95), most_step(lam, dl, 0.95)
            finite = (torch.isfinite(dv).all(1) & torch.isfinite(dw).all(1)
                      & torch.isfinite(dl).all(1))
            ap, ad = torch.where(finite, ap, 0.0), torch.where(finite, ad,
                                                               0.0)
            v = v + ap[:, None] * torch.nan_to_num(dv)
            w = (w + ap[:, None] * torch.nan_to_num(dw)).clamp_min(floor)
            lam = (lam + ad[:, None] * torch.nan_to_num(dl)).clamp_min(floor)
        return v, lam / cs[:, None]

    # -- the SQP step -----------------------------------------------------

    def merit(self, z, p):
        """The line search's merit: the cost plus 1e6 times the total
        violation of the inequality rows (bounds without the margin)."""
        return self.m.cost(z, p) + W_ELASTIC * self.m.violation(z, p).sum(-1)

    def warm_start(self, z_carried, p):
        """(U, z) the solve starts from: the warm-start inputs and their
        rollout."""
        _, U0 = self.m.split(z_carried)
        U = warm_start_inputs(self.m, U0, p)
        return U, self.m.join(self.m.rollout(p["x0"], U, p), U)

    def solve(self, z_carried, y_carried, p):
        """(z, y) after one solve from the warm state: the answer (B, n_z)
        and the carried multipliers with the Lyapunov and momentum rows'
        new estimates."""
        m = self.m
        N, nU, ns = m.N, 32 * m.N, self.ns
        B = z_carried.shape[0]
        n_eq = 20 * (N + 1)
        lam = y_carried[:, n_eq:n_eq + ns].clamp(0.0, LAM_CAP)
        U, z = self.warm_start(z_carried, p)
        prox = z.new_full((B,), float(self.walk["condip_prox"]))
        alphas = z.new_tensor(ALPHAS)
        rows = torch.arange(B, device=z.device)
        p_rep = {k: v.repeat(len(ALPHAS), *([1] * (v.dim() - 1)))
                 for k, v in p.items()}
        fixed = self.per_solve(p)
        for _ in range(int(self.walk["sqp_iters"])):
            H, g, C, d, row_scale = self.subproblem(z, p, fixed, lam, prox)
            v, mult = self.interior_point(H, g, C, d)
            dU = torch.nan_to_num(v[:, :nU], nan=0.0, posinf=0.0,
                                  neginf=0.0).reshape(B, N, 32)
            lam = torch.nan_to_num(mult[:, :ns] * row_scale[:, :ns]) \
                .clamp(0.0, LAM_CAP)
            cands = (U[None] + alphas[:, None, None, None] * dU[None]) \
                .reshape(len(ALPHAS) * B, N, 32)
            zc = m.join(m.rollout(p_rep["x0"], cands, p_rep), cands)
            merits = self.merit(zc, p_rep).reshape(len(ALPHAS), B)
            best = torch.argmin(torch.nan_to_num(merits, nan=math.inf),
                                dim=0)
            z = zc.reshape(len(ALPHAS), B, -1)[best, rows]
            U = cands.reshape(len(ALPHAS), B, N, 32)[best, rows]
            prox = torch.where(
                best == len(ALPHAS) - 1, prox * 16.0,
                torch.where(best <= 1, (prox / 4.0).clamp_min(
                    float(self.walk["condip_prox"])), prox))
        y = y_carried.clone()
        y[:, n_eq:n_eq + ns] = lam
        return z, y


def cs_jacobian(f, z, p):
    """The Jacobian (B, m, n) of f(z, p) (B, m) at z (B, n) by the complex
    step: all n directions at once, exact to rounding for the analytic
    functions of ``nlp.py``.  Where f gives (B,), a gradient (B, n)."""
    B, n = z.shape
    eye = torch.eye(n, dtype=z.dtype, device=z.device).expand(B, n, n)
    zc = torch.complex(z[:, None, :].expand(B, n, n), CS_STEP * eye)
    pc = {k: v[:, None].expand(B, n, *v.shape[1:]) for k, v in p.items()}
    out = f(zc, pc).imag / CS_STEP
    return out if out.dim() == 2 else out.transpose(1, 2)


def gradient(f, z, p):
    """The gradient (B, n) of f(z, p) (B,) at z, by autograd."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        return torch.autograd.grad(f(zz, p).sum(), zz)[0]


def quadratic_hessian(f, z, p):
    """The Hessian (B, n, n) of a quadratic f(z, p) (B,): the gradients
    (by autograd) at z + e_i less the gradient at z, all at once."""
    B, n = z.shape
    shift = torch.cat([z.new_zeros(1, n), torch.eye(n, dtype=z.dtype,
                                                    device=z.device)])
    pts = (z[:, None, :] + shift[None]).reshape(B * (n + 1), n)
    pp = {k: v.repeat_interleave(n + 1, dim=0) for k, v in p.items()}
    g = gradient(f, pts, pp).reshape(B, n + 1, n)
    return g[:, 1:] - g[:, :1]


def _row_gap(z, ref):
    return (torch.linalg.vector_norm(z - ref, dim=1)
            / torch.linalg.vector_norm(ref, dim=1).clamp_min(1e-30))


def judge(walk: dict, steps, device, details: dict | None = None):
    """(numbers, failed) of the compared steps.  Each step is (params
    arrays, (z, y) the program started from, [answers z]); the reference
    solves each step from the program's own start, in float64.

    * ``z_gap_moved_p10``, ``z_gap_p50``: with a row's gap
      |z - z_ref| / |z_ref|, the 10th percentile over the rows whose
      reference solve moved (its answer differs from its warm start by
      more than 1e-6), and the median over all rows;
    * ``rows_off``: the answers' rows that break what every solve
      guarantees: not finite, states that are not the rollout of the
      row's own inputs from the tick's state (relative gap over
      ``ROLL_TOL``), or a merit above the warm start's (relative excess
      over ``MERIT_TOL``; the step 0 is always a candidate).

    Printed beside them: ``z_gap_max``, ``moved_share`` and ``rows_huge``
    (rows with an entry over 1e3 in size).  `failed` counts the rows that
    are not finite.  `details`, where given, receives every row's
    readings."""
    ref = Reference(walk, device)
    rows = {k: [] for k in ("gap", "moved", "step", "roll", "merit_excess",
                            "zmax")}
    for k, (arrays, (z0, y0), answers) in enumerate(steps):
        for lo in range(0, z0.shape[0], ROW_BLOCK):
            b = slice(lo, lo + ROW_BLOCK)
            p = ref.params({n: a[b] for n, a in arrays.items()})
            zb = z0[b].to(device, F64)
            z_ref, _ = ref.solve(zb, y0[b].to(device, F64), p)
            _, z_ws = ref.warm_start(zb, p)
            moved = _row_gap(z_ref, z_ws) > 1e-6
            m_ws = ref.merit(z_ws, p)
            for z in answers:
                z = z[b].to(device, F64)
                X, U = ref.m.split(z)
                Xr = ref.m.rollout(p["x0"], U, p)
                for name, v in (
                        ("gap", _row_gap(z, z_ref)), ("moved", moved),
                        ("step", torch.full_like(moved, k,
                                                 dtype=torch.int64)),
                        ("roll", (X - Xr).abs().flatten(1).amax(1)
                         / Xr.abs().flatten(1).amax(1).clamp_min(1.0)),
                        ("merit_excess", (ref.merit(z, p) - m_ws)
                         / m_ws.abs().clamp_min(1.0)),
                        ("zmax", z.abs().amax(1))):
                    rows[name].append(v.cpu().numpy())
    r = {k: np.concatenate(v) for k, v in rows.items()}
    gap = np.nan_to_num(r["gap"], nan=np.inf)
    moved = r["moved"].astype(bool)
    finite = np.isfinite(r["zmax"])
    off = ~finite | ~(r["roll"] <= ROLL_TOL) \
        | ~(r["merit_excess"] <= MERIT_TOL)
    numbers = {"z_gap_moved_p10": float(np.percentile(gap[moved], 10))
               if moved.any() else None,
               "z_gap_p50": float(np.median(gap)),
               "rows_off": int(off.sum()),
               "z_gap_max": float(gap.max()),
               "moved_share": float(moved.mean()),
               "rows_huge": int((r["zmax"] > 1e3).sum())}
    if details is not None:
        details.update(r)
    return numbers, int((~finite).sum())
