"""Batched OSQP-style ADMM quadratic-program solver (port of
``cmpc_tpu.ops.admm``).  Solves, per scenario of the batch,

    min 1/2 x^T P x + q^T x    s.t.  l <= A x <= u

with the operator-splitting scheme of OSQP (Stellato et al., 2020):
modified Ruiz equilibration, one factorization of the linear system per
rho, then a fixed count of iterations — every scenario runs in lockstep,
with no data-dependent control flow and no host read.

f32-first numerics:

* kkt_form=True solves the KKT-form system [[P+sI, A^T], [A, -1/rho]] by
  LU like OSQP itself, NOT the normal equations P + sI + A^T rho A, whose
  condition number is the square (1.2e11 against 5e4 on the whole-body
  ID QP, fatal in f32).
* sigma = 1e-4 (not OSQP's 1e-6) caps the KKT condition number.
* One iterative-refinement step per solve backstops LU in f32.

Equality rows (l == u) get a 1e3-boosted rho, matching OSQP's default.

Every input carries a leading batch axis and **every reduction is per
scenario**: the cost scale, the residuals that adapt rho, the active-set
acceptance test and the reported residuals reduce over a scenario's own
axes only, so rho is a (B, m) tensor.  Bounds may be infinite; E * l,
clamp(., l, u) and where(isfinite(l), l, 0) are ordered so that no
inf * 0 appears.  The LU, inverse and Cholesky factorizations are
``torch.linalg`` calls (library calls in the JAX package too), in their
``_ex`` forms: a singular or indefinite system gives non-finite numbers,
which the acceptance test of the active-set rounds and the caller's step
selection reject, where the plain forms would stop the host to raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.ops import blocktri


class ADMMSettings(NamedTuple):
    iters: int = 50
    rho: float = 10.0
    sigma: float = 1e-4
    alpha: float = 1.6
    eq_rho_scale: float = 1e3
    ruiz_iters: int = 10
    refine_steps: int = 1
    # OSQP-style residual-balanced rho adaptation (OSQP §5.2): number of
    # mid-run adaptation events.  Each event splits the iteration budget,
    # rescales the free-row rho by sqrt(r_prim_rel / r_dual_rel) (clipped
    # to [1e-2, 1e3]) and re-factors.  A fixed rho is state-dependently
    # wrong for the whole-body ID QP.  Default 0 (off).
    rho_adapt: int = 0
    # kkt_form=True: LU-factored KKT system — condition-robust (required
    # for the whole-body ID QP in f32).  kkt_form=False: one explicit
    # inverse of the (Ruiz-scaled) normal matrix P + sI + A' rho A, or the
    # block-tridiagonal factor when a stage permutation is given; every
    # iteration is then a matmul or a banded sweep.
    kkt_form: bool = True
    # Primal-dual active-set (PDAS) refinement: each round guesses the
    # active set from (x, y) with the semismooth-Newton rule
    # act_u = {y + c(Ax-u) > 0}, act_l = {y + c(Ax-l) < 0}, then re-solves
    # the KKT system with active rows enforced by a large-weight penalty
    # (active-set sizes differ per scenario, so the penalty keeps every
    # scenario on one dense factorization shape).
    pdas_rounds: int = 3
    pdas_weight: float = 1e5
    pdas_c: float = 1.0
    pdas_eps: float = 1e-6


class ADMMResult(NamedTuple):
    x: torch.Tensor        # (B, n) primal solution
    y: torch.Tensor        # (B, m) dual (for warm starting)
    zc: torch.Tensor       # (B, m) projected constraint values (unscaled)
    r_prim: torch.Tensor   # (B,) ||Ax - z||_inf (unscaled)
    r_dual: torch.Tensor   # (B,) ||Px + q + A'y||_inf (unscaled)


def _mv(A, x):
    """A x per scenario: (B, m, n), (B, n) -> (B, m)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _mtv(A, y):
    """A' y per scenario: (B, m, n), (B, m) -> (B, n)."""
    return (y.unsqueeze(-2) @ A).squeeze(-2)


def _amax(x):
    """max |x| over a scenario's own entries: (B, ...) -> (B,)."""
    return x.abs().flatten(1).amax(dim=1)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _ruiz(P, q, A, l, u, iters: int):
    """Modified Ruiz equilibration (OSQP §5.1): iteratively scale variables
    by D and constraint rows by E so the KKT matrix has ~unit inf-norm
    rows/cols, then scale the cost by c (one c per scenario)."""
    D = torch.ones_like(q)
    E = torch.ones_like(l)
    for _ in range(iters):
        # column norms of [P; A] per variable
        cn = torch.maximum(P.abs().amax(dim=1), A.abs().amax(dim=1))
        # all-zero columns/rows (gated constraints in swing phases) stay
        # unscaled: 1/sqrt(0) would overflow f32 after a few iterations
        d = torch.where(cn < 1e-10, torch.ones_like(cn),
                        1.0 / torch.sqrt(cn.clamp_min(1e-10)))
        d = d.clamp(1e-3, 1e3)
        rn = A.abs().amax(dim=2)
        e = torch.where(rn < 1e-10, torch.ones_like(rn),
                        1.0 / torch.sqrt(rn.clamp_min(1e-10)))
        e = e.clamp(1e-3, 1e3)
        P = P * d[:, :, None] * d[:, None, :]
        q = q * d
        A = A * e[:, :, None] * d[:, None, :]
        D, E = D * d, E * e
    # cost scaling
    cn = P.abs().amax(dim=1).mean(dim=1)
    c = 1.0 / torch.maximum(cn, q.abs().amax(dim=1)).clamp_min(1e-8)
    c = c.clamp(1e-6, 1e6)
    P = P * c[:, None, None]
    q = q * c[:, None]
    return P, q, A, E * l, E * u, D, E, c


def _kkt_solve(K, lu, piv, rhs, refine_steps: int):
    """LU solve with fixed-count iterative refinement (f32 backstop)."""
    def lu_solve(b):
        return torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)).squeeze(-1)

    s = lu_solve(rhs)
    for _ in range(refine_steps):
        s = s + lu_solve(rhs - _mv(K, s))
    return s


def _kkt_matrix(P_reg, A_rows, diag):
    """[[P_reg, A_rows'], [A_rows, diag(diag)]], (B, n+m, n+m)."""
    return torch.cat([
        torch.cat([P_reg, A_rows.transpose(1, 2)], dim=2),
        torch.cat([A_rows, torch.diag_embed(diag)], dim=2)], dim=1)


def admm_solve(P, q, A, l, u, x0, y0, settings: ADMMSettings,
               ocp_perm=None) -> ADMMResult:
    """One QP solve per scenario.  P (B, n, n), q (B, n), A (B, m, n),
    l / u (B, m).

    x0 (B, n): primal warm start; y0 (B, m): dual warm start, both in
    *unscaled* space.  ocp_perm: optional ops.blocktri.StagePerm — when
    given (and kkt_form is off) the linear solves use the
    block-tridiagonal stage structure instead of dense inverses.
    """
    P0, q0, A0 = P, q, A
    P, q, A, l, u, D, E, c = _ruiz(P, q, A, l, u, settings.ruiz_iters)
    n = P.shape[1]
    At = A.transpose(1, 2)

    x = x0 / D
    y = c[:, None] * y0 / E

    is_eq = torch.isfinite(l) & torch.isfinite(u) & ((u - l).abs() < 1e-9)
    sigma = settings.sigma
    alpha = settings.alpha

    zc = torch.clamp(_mv(A, x), min=l, max=u)

    def relax_project(x, zc, y, rho, xt, zt_lin):
        x_new = alpha * xt + (1 - alpha) * x
        zt = alpha * zt_lin + (1 - alpha) * zc
        z_new = torch.clamp(zt + y / rho, min=l, max=u)
        y_new = y + rho * (zt - z_new)
        return x_new, z_new, y_new

    def make_body(rho):
        """Factor the linear system for this rho and return the ADMM
        iteration body (branch-specific factorization)."""
        if settings.kkt_form:
            # KKT-form coefficient matrix (OSQP eq. 15)
            K = _kkt_matrix(P + sigma * _eye(n, P), A, -1.0 / rho)
            lu, piv, _ = torch.linalg.lu_factor_ex(K)

            def body(x, zc, y):
                rhs = torch.cat([sigma * x - q, zc - y / rho], dim=1)
                s = _kkt_solve(K, lu, piv, rhs, settings.refine_steps)
                xt, nu = s[:, :n], s[:, n:]
                return relax_project(x, zc, y, rho, xt, zc + (nu - y) / rho)
        elif ocp_perm is not None:
            # block-tridiagonal OCP fast path: stage-structured factors
            fac = blocktri.factor(*blocktri.build_blocks(P, A, rho, sigma,
                                                         ocp_perm))

            def body(x, zc, y):
                rhs = sigma * x - q + _mtv(A, rho * zc - y)
                xt = blocktri.solve(fac, rhs, ocp_perm)
                return relax_project(x, zc, y, rho, xt, _mv(A, xt))
        else:
            # normal-equations fast path: matmul-only iterations
            Mn = P + sigma * _eye(n, P) + (At * rho[:, None, :]) @ A
            Minv, _ = torch.linalg.inv_ex(Mn)

            def body(x, zc, y):
                rhs = sigma * x - q + _mtv(A, rho * zc - y)
                xt = _mv(Minv, rhs)
                return relax_project(x, zc, y, rho, xt, _mv(A, xt))
        return body

    n_stage = settings.rho_adapt + 1
    # distribute iterations over stages without dropping the remainder; the
    # last stage gets the extras so the final (best-rho) stage runs longest
    iters_per = max(settings.iters // n_stage, 1)
    rem = max(settings.iters - iters_per * n_stage, 0)
    rho_free = q.new_full((q.shape[0], 1), float(settings.rho))
    for stage in range(n_stage):
        n_it = iters_per + (rem if stage == n_stage - 1 else 0)
        rho = torch.where(is_eq, rho_free * settings.eq_rho_scale, rho_free)
        body = make_body(rho)
        for _ in range(n_it):
            x, zc, y = body(x, zc, y)
        if stage + 1 < n_stage:
            # residual-balanced update (OSQP §5.2), measured in the
            # RUIZ-SCALED space the solve itself works in
            ax = _mv(A, x)
            eps = 1e-12
            rp = _amax(ax - zc) / torch.maximum(_amax(ax),
                                                _amax(zc)).clamp_min(eps)
            px = _mv(P, x)
            aty = _mtv(A, y)
            rd = _amax(px + q + aty) / torch.maximum(
                _amax(px), torch.maximum(_amax(aty),
                                         _amax(q))).clamp_min(eps)
            rho_free = (rho_free * torch.sqrt(rp / rd.clamp_min(eps))[:, None]
                        ).clamp(1e-2, 1e3)

    # ---- PDAS refinement rounds ----
    fin_l = torch.isfinite(l)
    fin_u = torch.isfinite(u)
    w_act = settings.pdas_weight
    cpen = settings.pdas_c
    free = ~is_eq
    zero = torch.zeros_like(l)
    l_fin = torch.where(fin_l, l, zero)
    u_fin = torch.where(fin_u, u, zero)

    def _active_set(xp, yp):
        ax = _mv(A, xp)
        act_u = fin_u & free & (yp + cpen * (ax - u) > 0)
        act_l = fin_l & free & (yp + cpen * (ax - l) < 0)
        act = is_eq | act_u | act_l
        tgt = torch.where(is_eq, l_fin, torch.where(act_u, u_fin, l_fin))
        return act, tgt

    if settings.kkt_form:
        def pdas_round(xp, yp):
            act, tgt = _active_set(xp, yp)
            actf = act.to(x.dtype)
            # active rows: near-equality (diag -1/w_act); inactive rows:
            # decoupled (masked A row, diag -1 => nu = 0)
            Kp = _kkt_matrix(P + settings.pdas_eps * _eye(n, P),
                             A * actf[:, :, None],
                             -(actf / w_act + (1.0 - actf)))
            lup, pivp, _ = torch.linalg.lu_factor_ex(Kp)
            rhs = torch.cat([-q, actf * tgt], dim=1)
            s = _kkt_solve(Kp, lup, pivp, rhs, settings.refine_steps)
            return s[:, :n], s[:, n:] * actf
    elif ocp_perm is not None:
        def pdas_round(xp, yp):
            act, tgt = _active_set(xp, yp)
            W = torch.where(act, w_act, 0.0).to(x.dtype)
            facp = blocktri.factor(*blocktri.build_blocks(
                P, A, W, settings.pdas_eps, ocp_perm))
            xp = blocktri.solve(facp, -q + _mtv(A, W * tgt), ocp_perm)
            return xp, W * (_mv(A, xp) - tgt)
    else:
        def pdas_round(xp, yp):
            act, tgt = _active_set(xp, yp)
            W = torch.where(act, w_act, 0.0).to(x.dtype)
            Mp = P + 1e-7 * _eye(n, P) + (At * W[:, None, :]) @ A
            xp, _ = torch.linalg.solve_ex(Mp, -q + _mtv(A, W * tgt))
            return xp, W * (_mv(A, xp) - tgt)

    if settings.pdas_rounds > 0:
        xp, yp = x, y
        for _ in range(settings.pdas_rounds):
            xp, yp = pdas_round(xp, yp)

        # accept only if finite and not much less feasible than the ADMM
        # iterate (the active-set guess can be inconsistent on degenerate
        # problems); the ADMM iterate is the fallback.  One flag per
        # scenario.
        def viol(v):
            av = _mv(A, v)
            return _amax(torch.clamp(av, min=l, max=u) - av)

        ok = torch.isfinite(xp).all(dim=1) \
            & (viol(xp) < viol(x).clamp_min(1e-3))
        x = torch.where(ok[:, None], xp, x)
        y = torch.where(ok[:, None], yp, y)
        zc = torch.clamp(_mv(A, x), min=l, max=u)

    x_out = D * x
    y_out = E * y / c[:, None]
    zc_out = zc / E
    return ADMMResult(
        x=x_out, y=y_out, zc=zc_out,
        r_prim=_amax(_mv(A0, x_out) - zc_out),
        r_dual=_amax(_mv(P0, x_out) + q0 + _mtv(A0, y_out)))
