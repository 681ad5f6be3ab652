"""SQP (real-time-iteration) MPC solve, batched (port of
``cmpc_tpu.ops.sqp``), in its two configurations:

* ``condip`` — each of ``cfg.sqp_iters`` iterations condenses the
  subproblem at the current rollout (ocp/condense.py), solves it with the
  interior-point kernel (ops/pdip.py), and picks the step length per
  scenario by a merit line search over the nonlinear rollout;
* ``admm`` — SQP over the full [X, U] stack: the constraints are
  linearized densely (ocp/problem.linearize) and each convex QP goes to
  the ADMM + active-set solver (ops/admm.py), by default on the
  block-tridiagonal stage structure (ops/blocktri.py).

alpha = 0 is always a candidate step in both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.consts import const
from cmpc_tpu_torch.models import centroidal as cm
from cmpc_tpu_torch.ocp import condense, problem
from cmpc_tpu_torch.ops import blocktri, pdip
from cmpc_tpu_torch.ops.admm import ADMMSettings, admm_solve
from cmpc_tpu_torch.ops.pdip import PDIPSettings
from cmpc_tpu_torch.runtime import graphs, spans

LAM_CAP = 1e4
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.0)
ALPHAS_ADMM = (1.0, 0.5, 0.25, 0.0)
W_ELASTIC_ADMM = 1e4


class SolverState(NamedTuple):
    """Warm-start state carried across control ticks."""

    z: torch.Tensor   # (B, n_z) primal iterate
    y: torch.Tensor   # (B, m) dual iterate


class SolveInfo(NamedTuple):
    r_prim: torch.Tensor          # (B,)
    r_dual: torch.Tensor
    cost: torch.Tensor
    lyap_violation: torch.Tensor  # max positive Lyapunov constraint value


def init_solver_state(cfg: WalkConfig, x0, mass=None) -> SolverState:
    """Cold-start iterate: constant state trajectory at x0 (B, 20) and hover
    forces (mg/8 per contact vertex)."""
    B = x0.shape[0]
    nX = 20 * (cfg.N + 1)
    z = x0.new_zeros(B, cfg.n_z)
    z[:, :nX] = x0.repeat(1, cfg.N + 1)
    mass = x0.new_full((B,), 40.0) if mass is None \
        else torch.as_tensor(mass, dtype=x0.dtype, device=x0.device)
    fz = mass * cfg.g / 8.0
    U = x0.new_zeros(B, cfg.N, 32)
    U[:, :, 2:24:3] = fz[:, None, None]
    z[:, nX:] = U.reshape(B, -1)
    y = x0.new_zeros(B, problem.num_constraints(cfg))
    return SolverState(z=z, y=y)


def _rollout_X(x0, U, params: problem.MPCParams, cfg: WalkConfig):
    """Integrate the dynamics from x0 (B, 20) under U (B, N, 32): a state
    trajectory (B, N+1, 20) with exactly zero dynamics residual."""
    polygon = cm.foot_polygon(cfg.foot_length, cfg.foot_width,
                              device=x0.device, dtype=x0.dtype)
    xs = [x0]
    for i in range(cfg.N):
        xs.append(cm.euler_step(
            xs[-1], params.com_ref[:, i], params.gamma_l[:, i],
            params.gamma_r[:, i], U[:, i], params.k1, params.k2,
            params.mass, cfg.g, polygon, cfg.delta))
    return torch.stack(xs, dim=1)


def prep_warmstart(state: SolverState, params: problem.MPCParams,
                   cfg: WalkConfig):
    """Gait-consistent warm-start inputs U (B, N, 32) from the carried
    iterate: gate the carried vertex forces by the new contact schedule,
    top up vertical support to ~m g, and seed the swing-foot transfer
    velocities (see the JAX module for the failures each repair fixes)."""
    N = cfg.N
    _, U_ws = problem.split_z(state.z, cfg)
    B = U_ws.shape[0]
    U_ws = U_ws.clone()
    gl_u = params.gamma_l[:, :N, None, None]
    gr_u = params.gamma_r[:, :N, None, None]
    fl_ws = U_ws[:, :, 0:12].reshape(B, N, 4, 3) * gl_u
    fr_ws = U_ws[:, :, 12:24].reshape(B, N, 4, 3) * gr_u
    fz_tot = fl_ws[..., 2].sum(-1) + fr_ws[..., 2].sum(-1)         # (B,N)
    n_act = 4.0 * (params.gamma_l[:, :N] + params.gamma_r[:, :N])
    deficit = (params.mass[:, None] * cfg.g - fz_tot).clamp_min(0.0) \
        / n_act.clamp_min(1.0)
    fl_ws[..., 2] += deficit[:, :, None] * gl_u[..., 0]
    fr_ws[..., 2] += deficit[:, :, None] * gr_u[..., 0]
    U_ws[:, :, 0:12] = fl_ws.reshape(B, N, 12)
    U_ws[:, :, 12:24] = fr_ws.reshape(B, N, 12)

    # swing-foot transfer seeding
    idx_n = torch.arange(N, device=U_ws.device)
    rows = torch.arange(B, device=U_ws.device)

    def transfer_vel(gamma, x0_pos, pos_ref):
        stance = gamma[:, 1:] > 0.5
        land = torch.argmax(stance.to(torch.int8), dim=1)   # first stance
        k = land + 1
        has = (gamma[:, 0] < 0.5) & stance.any(dim=1)
        target = pos_ref[rows, land]
        v = (target - x0_pos) / (cfg.delta * k.to(x0_pos.dtype))[:, None]
        mask = (idx_n[None] < k[:, None]) & has[:, None]
        return torch.where(mask[..., None], v[:, None, :], 0.0), has

    v_l, has_l = transfer_vel(params.gamma_l, params.x0[:, cm.POS_L],
                              params.pos_ref_l)
    v_r, has_r = transfer_vel(params.gamma_r, params.x0[:, cm.POS_R],
                              params.pos_ref_r)
    U_ws[:, :, 24:27] = torch.where(has_l[:, None, None], v_l,
                                    U_ws[:, :, 24:27])
    U_ws[:, :, 27:30] = torch.where(has_r[:, None, None], v_r,
                                    U_ws[:, :, 27:30])
    return U_ws


def solve_mpc(state: SolverState, params: problem.MPCParams,
              cfg: WalkConfig, soft_q=None):
    """One batched MPC solve; returns (new SolverState, SolveInfo).

    soft_q: ``condense.soft_row_q(params.k1, params.mass)`` where the
    caller keeps it across solves (condip only; computed here otherwise)."""
    with spans.span("sqp.solve_mpc"):
        if cfg.mpc_solver == "condip":
            return _solve_mpc_condip(state, params, cfg, soft_q)
        if cfg.mpc_solver == "admm":
            return _solve_mpc_admm(state, params, cfg)
        raise ValueError(f"unknown mpc_solver {cfg.mpc_solver!r}")


class _Iterate(NamedTuple):
    """What an SQP iteration of the condip solve hands the next."""

    X: torch.Tensor          # (B, N+1, 20) rollout of U
    U: torch.Tensor          # (B, N, 32)
    lam_soft: torch.Tensor   # (B, ns) Lyapunov/momentum multipliers
    prox: torch.Tensor       # (B,) proximal weight on dU
    r_dual: torch.Tensor     # (B,) the last IPM's dual residual


def _warm_start(state: SolverState, params: problem.MPCParams, soft_q,
                cfg: WalkConfig):
    """The condip solve's first stage: the gait-consistent warm start and
    its rollout.  Returns the first iterate and (state, params, soft_q) as
    this stage read them, which the later stages read in its place."""
    N, B = cfg.N, params.x0.shape[0]
    n_eq, ns = 20 * (N + 1), condense.n_slack(cfg)
    with spans.span("sqp.warm_start"):
        U = prep_warmstart(state, params, cfg)
        lam_soft = state.y[:, n_eq:n_eq + ns].clamp(0.0, LAM_CAP)
        X = _rollout_X(params.x0, U, params, cfg)
    it = _Iterate(X=X, U=U, lam_soft=lam_soft,
                  prox=params.x0.new_full((B,), cfg.condip_prox),
                  r_dual=params.x0.new_zeros(B))
    return it, (state, params, soft_q)


def _condense(it: _Iterate, params: problem.MPCParams, soft_q,
              cfg: WalkConfig) -> condense.CondensedQP:
    """The QP of an SQP iteration, condensed at the iterate."""
    dt, dev = it.X.dtype, it.X.device
    # proximal weights over dU: foot-velocity / yaw-rate inputs exempt
    w_prox_u = torch.ones(cfg.N, 32, dtype=dt, device=dev)
    w_prox_u[:, 24:] = 1e-3
    return condense.build(problem.join_z(it.X, it.U), params, cfg, it.prox,
                          w_prox_u.reshape(-1), lam_soft=it.lam_soft,
                          soft=cfg.condip_soft, structured=True,
                          soft_q=soft_q)


def _line_search(it: _Iterate, qp: condense.CondensedQP, res,
                 params: problem.MPCParams, cfg: WalkConfig) -> _Iterate:
    """The step length per scenario from the QP's answer `res`, by the
    merit of the nonlinear rollout; the next iterate."""
    N = cfg.N
    nU, n_eq, ns = 32 * N, 20 * (N + 1), condense.n_slack(cfg)
    B = params.x0.shape[0]
    l_c, u_c = _bounds(cfg, params.x0.device, params.x0.dtype)
    dU = torch.nan_to_num(res.v[:, :nU], nan=0.0, posinf=0.0,
                          neginf=0.0).reshape(B, N, 32)
    lam_new = torch.nan_to_num(res.lam[:, :ns] * qp.row_scale[:, :ns])
    lam_soft = lam_new.clamp(0.0, LAM_CAP)

    with spans.span("sqp.line_search"):
        # all step lengths at once, as a batch of nA * B candidates
        # (alpha-major)
        nA = len(ALPHAS)
        params_rep = problem.MPCParams(*(
            f.repeat(nA, *([1] * (f.dim() - 1))) for f in params))
        U_cands = torch.stack([it.U + a * dU for a in ALPHAS])  # (nA,B,N,32)
        U_flat = U_cands.reshape(nA * B, N, 32)
        X_flat = _rollout_X(params_rep.x0, U_flat, params_rep, cfg)
        zc = problem.join_z(X_flat, U_flat)
        c = problem.constraints(zc, params_rep, cfg)[:, n_eq:]
        viol = ((c - u_c[n_eq:]).clamp_min(0.0)
                + (l_c[n_eq:] - c).clamp_min(0.0)).sum(1)
        merits = (problem.cost_value(zc, params_rep, cfg)
                  + condense.W_ELASTIC * viol).reshape(nA, B)
        best = torch.argmin(torch.nan_to_num(merits, nan=float("inf")),
                            dim=0)                                # (B,)
        rows = torch.arange(B, device=dU.device)
        U = U_cands[best, rows]
        X = X_flat.reshape(nA, B, N + 1, 20)[best, rows]
        rejected = best == nA - 1
        small = best <= 1           # alpha >= 0.5 accepted
        prox = torch.where(rejected, it.prox * 16.0,
                           torch.where(small,
                                       (it.prox / 4.0).clamp_min(
                                           cfg.condip_prox), it.prox))
        if spans.enabled():
            spans.add("line_search.rejected", rejected.sum())
            spans.add("line_search.rows", B)
    return _Iterate(X=X, U=U, lam_soft=lam_soft, prox=prox,
                    r_dual=res.r_dual)


def _finish(it: _Iterate, state: SolverState, params: problem.MPCParams,
            cfg: WalkConfig):
    """The solve's answer and its residuals from the last iterate."""
    N = cfg.N
    n_eq, ns = 20 * (N + 1), condense.n_slack(cfg)
    l_c, u_c = _bounds(cfg, params.x0.device, params.x0.dtype)
    z = problem.join_z(it.X, it.U)
    c_final = problem.constraints(z, params, cfg)
    viol_all = (c_final - u_c).clamp_min(0.0) \
        + (l_c - c_final).clamp_min(0.0)
    lyap = c_final[:, n_eq:n_eq + N]
    info = SolveInfo(
        r_prim=viol_all.amax(dim=1), r_dual=it.r_dual,
        cost=problem.cost_value(z, params, cfg),
        lyap_violation=lyap.clamp_min(0.0).amax(dim=1),
    )
    y = state.y.clone()
    y[:, n_eq:n_eq + ns] = it.lam_soft
    return SolverState(z=z, y=y), info


# the interior point as the solve calls it: each solve looks it up here, so
# that a wrapper set in its place sees every call
pdip_solve = graphs.Graphed(pdip.pdip_solve)
_GRAPHED = (graphs.Graphed(_warm_start), graphs.Graphed(_condense),
            graphs.Graphed(_line_search), graphs.Graphed(_finish, fresh=True))


def _solve_mpc_condip(state: SolverState, params: problem.MPCParams,
                      cfg: WalkConfig, soft_q=None):
    """The condip solve.  On the card each stage (the warm start, then per
    SQP iteration condensing, the interior point and the line search, then
    the answer's residuals) replays a CUDA graph of its own
    (``runtime/graphs``): the same kernels on the same numbers, started by
    one host call a stage.  The answer is fresh tensors."""
    warm, cond, search, finish = _GRAPHED
    return _condip(state, params, cfg, soft_q, warm, cond, pdip_solve,
                   search, finish)


def _solve_mpc_condip_eager(state: SolverState, params: problem.MPCParams,
                            cfg: WalkConfig, soft_q=None):
    """The condip solve with every stage dispatched op by op on any
    device: what the card's graphs are held to."""
    return _condip(state, params, cfg, soft_q, _warm_start, _condense,
                   pdip.pdip_solve, _line_search, _finish)


def _condip(state, params, cfg, soft_q, warm, cond, qp_solve, search,
            finish):
    if soft_q is None:
        # once a solve, not once an SQP iteration, and outside any graph:
        # its eigh makes the host wait for the device
        soft_q = condense.soft_row_q(params.k1, params.mass)
    settings = PDIPSettings(iters=cfg.pdip_iters, refine=cfg.pdip_refine)
    it, (state, params, soft_q) = warm(state, params, soft_q, cfg)
    for _ in range(cfg.sqp_iters):
        qp = cond(it, params, soft_q, cfg)
        res = qp_solve(qp.H, qp.g, qp.C, qp.d, settings, C_blk=qp.C_blk,
                       d_blk=qp.d_blk, C_width=qp.C_width)
        it = search(it, qp, res, params, cfg)
    return finish(it, state, params, cfg)


def _bounds(cfg: WalkConfig, dev, dt):
    l_c = const(("bounds_l", cfg), lambda: problem.constraint_bounds(cfg)[0],
                dev, dt)
    u_c = const(("bounds_u", cfg), lambda: problem.constraint_bounds(cfg)[1],
                dev, dt)
    return l_c, u_c


def _solve_mpc_admm(state: SolverState, params: problem.MPCParams,
                    cfg: WalkConfig):
    """SQP over the full [X, U] stack with the ADMM + PDAS inner QP."""
    N = cfg.N
    B = params.x0.shape[0]
    dt, dev = params.x0.dtype, params.x0.device
    l_c, u_c = _bounds(cfg, dev, dt)
    P, q = problem.cost_quadratic(params, cfg)
    settings = ADMMSettings(iters=cfg.admm_iters, rho=cfg.admm_rho,
                            sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
                            kkt_form=cfg.admm_kkt_form)

    U_ws = prep_warmstart(state, params, cfg)
    X_ws = _rollout_X(params.x0, U_ws, params, cfg)
    z = problem.join_z(X_ws, U_ws)
    y = state.y

    nA = len(ALPHAS_ADMM)
    alphas = z.new_tensor(ALPHAS_ADMM)[:, None, None]
    params_rep = problem.MPCParams(*(
        f.repeat(nA, *([1] * (f.dim() - 1))) for f in params))

    def merit(zz):
        """L1 exact-penalty merit on the *nonlinear* constraints of the
        nA * B candidates (alpha-major).  Full-step SQP oscillates on this
        problem (bilinear momentum dynamics + indefinite Lyapunov rows); a
        3-point backtracking pick is enough to globalize it."""
        c = problem.constraints(zz, params_rep, cfg)
        viol = ((c - u_c).clamp_min(0.0) + (l_c - c).clamp_min(0.0)).sum(1)
        return problem.cost_value(zz, params_rep, cfg) + 1e4 * viol

    # Elastic (slack-relaxed) subproblem structure: the linearized
    # Lyapunov rows can be INFEASIBLE jointly with the proximal trust
    # region even when the nonlinear problem is feasible; elastic mode
    # (Gill et al.) relaxes them as lyap_i - s_i <= 0 with s_i >= 0 and an
    # exact linear penalty on s, solved in the same QP.
    n_eq = 20 * (N + 1)
    n_z = cfg.n_z
    m0 = problem.num_constraints(cfg)
    # stage-structured linear solves (elastic mode changes the variable
    # layout, so it stays on the dense path)
    ocp_perm = None
    if cfg.mpc_blocktri and not cfg.sqp_elastic and not cfg.admm_kkt_form:
        ocp_perm = blocktri.stage_perm(N)

    # proximal weights: foot-velocity / yaw-rate inputs are exempt (weight
    # 1e-3) — the landing transfer needs tens of m/s on those inputs in
    # one node, and a uniform prox term would veto that step
    w_prox = torch.ones(N, 32, dtype=dt, device=dev)
    w_prox[:, 24:] = 1e-3
    w_prox = torch.cat([torch.ones(n_eq, dtype=dt, device=dev),
                        w_prox.reshape(-1)])
    lam = cfg.sqp_prox
    if cfg.sqp_elastic:
        S_rows = z.new_zeros(m0, N)
        S_rows[n_eq:n_eq + N].diagonal().fill_(-1.0)
        S_pos = torch.cat([z.new_zeros(N, n_z),
                           torch.eye(N, dtype=dt, device=dev)], dim=1)
        P_e = z.new_zeros(B, n_z + N, n_z + N)
        P_e[:, :n_z, :n_z] = P + lam * torch.eye(n_z, dtype=dt, device=dev)
        P_e.diagonal(dim1=1, dim2=2)[:, n_z:] = 2.0
        zeros_N = z.new_zeros(B, N)
    else:
        P_prox = P + lam * torch.diag(w_prox)

    rows = torch.arange(B, device=dev)
    r_prim = r_dual = z.new_zeros(B)
    for _ in range(cfg.sqp_iters):
        c, J = problem.linearize(z, params, cfg)
        b = (J @ z[:, :, None])[:, :, 0] - c
        # proximal (Levenberg-style) damping around the current iterate:
        # bounds the step so the bilinear momentum rows stay within their
        # linearization's validity region
        if cfg.sqp_elastic:
            q_e = torch.cat([q - lam * z,
                             z.new_full((B, N), W_ELASTIC_ADMM)], dim=1)
            A_e = torch.cat([
                torch.cat([J, S_rows.expand(B, m0, N)], dim=2),
                S_pos.expand(B, N, n_z + N)], dim=1)
            lyap_viol = c[:, n_eq:n_eq + N].clamp_min(0.0)
            res = admm_solve(
                P_e, q_e, A_e,
                torch.cat([l_c + b, zeros_N], dim=1),
                torch.cat([u_c + b, z.new_full((B, N), torch.inf)], dim=1),
                torch.cat([z, lyap_viol], dim=1),
                torch.cat([y, zeros_N], dim=1), settings)
        else:
            res = admm_solve(P_prox, q - lam * w_prox * z, J, l_c + b,
                             u_c + b, z, y, settings, ocp_perm=ocp_perm)
        dz = torch.nan_to_num(res.x[:, :n_z] - z, nan=0.0, posinf=0.0,
                              neginf=0.0)
        # alpha = 0 is always a candidate: a QP step that worsens the merit
        # is rejected outright, so a bad solve can never inject garbage
        # into the warm-start loop
        cands = z + alphas * dz                              # (nA, B, n_z)
        merits = merit(cands.reshape(nA * B, n_z)).reshape(nA, B)
        best = torch.argmin(torch.nan_to_num(merits, nan=float("inf")),
                            dim=0)                           # (B,)
        z = cands[best, rows]
        # keep the old dual when the step was rejected; clamp to keep the
        # PDAS penalty duals from compounding across ticks
        accepted = best < nA - 1
        y_new = torch.nan_to_num(res.y[:, :m0]).clamp(-1e5, 1e5)
        y = torch.where(accepted[:, None], y_new, y)
        r_prim, r_dual = res.r_prim, res.r_dual

    c_final = problem.constraints(z, params, cfg)
    lyap = c_final[:, n_eq:n_eq + N]
    info = SolveInfo(
        r_prim=r_prim, r_dual=r_dual,
        cost=problem.cost_value(z, params, cfg),
        lyap_violation=lyap.clamp_min(0.0).amax(dim=1),
    )
    return SolverState(z=z, y=y), info
