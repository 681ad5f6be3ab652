"""The port's batched ADMM QP solver against the JAX package's, in f64 on
the CPU: the same numpy QPs go through ``cmpc_tpu.ops.admm.admm_solve``
under vmap and through the port's batch-first solver, for the three
linear-system branches x rho_adapt 0/2 x pdas_rounds 0/2; the port alone
against scipy; and row independence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.optimize
import torch

from cmpc_tpu.ops import admm as jadmm, blocktri as jbt
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.ocp import problem as tprob
from cmpc_tpu_torch.ops import admm as tadmm, blocktri as tbt, sqp as tsqp
from cmpc_tpu_torch.rbd import urdf as turdf

from tests.test_torch_wholebody import perturbed_standing, t_desired

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def random_qp(seed, n=12, m=18):
    """The QP family of tests/test_ocp_solver.py::test_admm_matches_scipy:
    one-sided rows (l = -inf), two-sided rows and three equality rows."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P = L @ L.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l = np.where(rng.uniform(size=m) < 0.3, rng.normal(size=m) - 2.0,
                 -np.inf)
    u = rng.normal(size=m) + 2.0
    l[:3] = u[:3] = rng.normal(size=3) * 0.1
    return P, q, A, l, u


def random_batch(seeds=(0, 1, 2, 3)):
    return tuple(np.stack(x) for x in zip(*(random_qp(s) for s in seeds)))


def run_both(qp, settings_kw, ocp_perm=(None, None), x0=None, y0=None):
    P, q, A, l, u = qp
    B, m, n = A.shape
    x0 = np.zeros((B, n)) if x0 is None else x0
    y0 = np.zeros((B, m)) if y0 is None else y0
    js = jadmm.ADMMSettings(**settings_kw)
    jres = jax.jit(jax.vmap(lambda *a: jadmm.admm_solve(
        *a, js, ocp_perm=ocp_perm[0])))(
        *(jnp.asarray(a) for a in (P, q, A, l, u, x0, y0)))
    tres = tadmm.admm_solve(*(torch.tensor(a) for a in
                              (P, q, A, l, u, x0, y0)),
                            tadmm.ADMMSettings(**settings_kw),
                            ocp_perm=ocp_perm[1])
    return jres, tres


def assert_results_close(jres, tres, atol, amax=1.0):
    """x, zc, r_prim at `atol`; the duals at `atol` of their largest
    magnitude (PDAS duals carry the 1e5 penalty weight), and r_dual, the
    norm of P x + q + A' y, at `atol` of the largest |A' y| term."""
    ymax = max(1.0, np.abs(np.asarray(jres.y)).max())
    for name in jres._fields:
        want = np.asarray(getattr(jres, name))
        scale = {"y": ymax, "r_dual": ymax * amax}.get(name, 1.0)
        np.testing.assert_allclose(getattr(tres, name).numpy(), want,
                                   rtol=0, atol=atol * scale, err_msg=name)


def test_settings_defaults_match():
    assert tadmm.ADMMSettings._fields == jadmm.ADMMSettings._fields
    assert tuple(tadmm.ADMMSettings()) == tuple(jadmm.ADMMSettings())
    assert tadmm.ADMMResult._fields == jadmm.ADMMResult._fields


def test_ruiz_matches():
    P, q, A, l, u = random_batch()
    want = jax.vmap(lambda *a: jadmm._ruiz(*a, 10))(
        *(jnp.asarray(a) for a in (P, q, A, l, u)))
    got = tadmm._ruiz(*(torch.tensor(a) for a in (P, q, A, l, u)), 10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=0)


@pytest.mark.parametrize("pdas_rounds", [0, 2])
@pytest.mark.parametrize("rho_adapt", [0, 2])
@pytest.mark.parametrize("kkt_form", [True, False])
def test_random_qps_dense_branches(kkt_form, rho_adapt, pdas_rounds):
    """KKT-form LU and normal-equation branches on random QPs with infinite
    bounds and equality rows, warm-started from a nonzero (x0, y0):
    1e-9 absolute."""
    qp = random_batch()
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=qp[1].shape) * 0.1
    y0 = rng.normal(size=qp[3].shape) * 0.1
    jres, tres = run_both(qp, dict(iters=60, rho=1.0, kkt_form=kkt_form,
                                   rho_adapt=rho_adapt,
                                   pdas_rounds=pdas_rounds), x0=x0, y0=y0)
    assert np.isfinite(tres.x.numpy()).all()
    assert_results_close(jres, tres, 1e-9)


def mpc_qp(N=4, B=3):
    """The first SQP subproblem of the ADMM configuration on perturbed
    standing problems, horizon N (stage-structured: the block-tridiagonal
    branch needs the OCP's own sparsity)."""
    cfg = WalkConfig(N=N, mpc_solver="admm")
    p = standing_params(cfg, B, seed=5, noise=0.01)
    st = tsqp.init_solver_state(cfg, p.x0, mass=p.mass)
    U = tsqp.prep_warmstart(st, p, cfg)
    z = tprob.join_z(tsqp._rollout_X(p.x0, U, p, cfg), U)
    P, q = tprob.cost_quadratic(p, cfg)
    c, J = tprob.linearize(z, p, cfg)
    l_c, u_c = (torch.tensor(a) for a in tprob.constraint_bounds(cfg))
    b = (J @ z[:, :, None])[:, :, 0] - c
    w = torch.ones(cfg.n_z, dtype=torch.float64)
    qp = (P + cfg.sqp_prox * torch.diag(w), q - cfg.sqp_prox * w * z, J,
          l_c + b, u_c + b)
    return cfg, tuple(a.numpy() for a in qp), z.numpy()


def standing_params(cfg, B, seed=0, noise=0.0):
    """The standing double-support problem of
    tests/test_ocp_solver.py::test_mpc_solve_standing as a batch, built
    with numpy; `noise` perturbs x0 per scenario."""
    from cmpc_tpu_torch.models import centroidal as cm
    rng = np.random.default_rng(seed)
    N = cfg.N
    x0 = np.zeros((B, 20))
    x0[:, cm.P_COM] = [0.0, 0.0, cfg.h]
    x0[:, cm.POS_L] = [0.0, 0.1, 0.0]
    x0[:, cm.POS_R] = [0.0, -0.1, 0.0]
    x0 += noise * rng.normal(size=x0.shape)
    com_ref = np.zeros((B, N, 9))
    com_ref[:, :, 2] = cfg.h
    t = torch.tensor
    return tprob.MPCParams(
        x0=t(x0), com_ref=t(com_ref),
        pos_ref_l=t(np.tile([0.0, 0.1, 0.0], (B, N, 1))),
        pos_ref_r=t(np.tile([0.0, -0.1, 0.0], (B, N, 1))),
        yaw_ref_l=t(np.zeros((B, N))), yaw_ref_r=t(np.zeros((B, N))),
        gamma_l=t(np.ones((B, N + 1))), gamma_r=t(np.ones((B, N + 1))),
        k1=t(np.full(B, 4.0)), k2=t(np.full(B, 0.1)),
        mass=t(np.full(B, 40.05)))


@pytest.fixture(scope="module")
def mpc_problem():
    return mpc_qp()


@pytest.mark.parametrize("pdas_rounds", [0, 2])
@pytest.mark.parametrize("rho_adapt", [0, 2])
def test_mpc_qp_blocktri_branch(mpc_problem, rho_adapt, pdas_rounds):
    """The block-tridiagonal branch on the MPC's own QP (N = 4): 1e-9
    absolute on x (states ~1, forces ~50 N)."""
    cfg, qp, z = mpc_problem
    perms = (jbt.stage_perm(cfg.N), tbt.stage_perm(cfg.N))
    jres, tres = run_both(qp, dict(iters=20, rho=0.1, sigma=1e-6,
                                   kkt_form=False, rho_adapt=rho_adapt,
                                   pdas_rounds=pdas_rounds),
                          ocp_perm=perms, x0=z)
    assert np.isfinite(tres.x.numpy()).all()
    assert_results_close(jres, tres, 1e-9)


def test_mpc_qp_branches_agree(mpc_problem):
    """The port's block-tridiagonal and normal-equation branches solve the
    same linear systems: same iterates to 1e-6."""
    cfg, qp, z = mpc_problem
    T = [torch.tensor(a) for a in qp]
    B, m, _ = qp[2].shape
    kw = dict(iters=20, rho=0.1, sigma=1e-6, kkt_form=False, pdas_rounds=0)
    a = tadmm.admm_solve(*T, torch.tensor(z), torch.zeros(B, m).double(),
                         tadmm.ADMMSettings(**kw),
                         ocp_perm=tbt.stage_perm(cfg.N))
    b = tadmm.admm_solve(*T, torch.tensor(z), torch.zeros(B, m).double(),
                         tadmm.ADMMSettings(**kw))
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def id_qp_matrices():
    """The ID QP's own matrices (72 variables, 46 rows, 16 of them with
    l = -inf) at the three contact gates, recorded from the port's
    assembly at perturbed standing states."""
    from cmpc_tpu_torch.ops import id_qp
    from cmpc_tpu_torch.wholebody import inverse_dynamics as twbid
    from cmpc_tpu_torch.wholebody.state import retrieve_state

    tm = turdf.load_hrp4()
    ps = perturbed_standing(tm, seed=3, batch=3)
    st = retrieve_state(tm, ps.q, ps.qv)
    seen = []
    real = id_qp.admm_solve

    def record(*a, **k):
        seen.append([x.numpy() for x in a[:5]])
        return real(*a, **k)

    id_qp.admm_solve = record
    try:
        twbid.joint_torques(tm, ps.q, ps.qv, t_desired(st), st,
                            contact_l=torch.tensor([1.0, 1.0, 0.0]).double(),
                            contact_r=torch.tensor([1.0, 0.0, 1.0]).double())
    finally:
        id_qp.admm_solve = real
    return tuple(seen[0])


@pytest.mark.parametrize("rho_adapt,pdas_rounds", [(0, 0), (2, 0), (0, 2),
                                                   (2, 2)])
def test_id_qp_matrices_kkt_branch(id_qp_matrices, rho_adapt, pdas_rounds):
    """The whole-body loop's settings (iters 90, rho 10, KKT form) on the
    ID QP's matrices at gates (1,1), (1,0), (0,1): x (accelerations,
    torques up to ~1e2, forces up to ~4e2) at 1e-7 absolute."""
    assert id_qp_matrices[2].shape == (3, 46, 72)
    assert np.isinf(id_qp_matrices[3]).sum() == 3 * 16
    jres, tres = run_both(id_qp_matrices, dict(
        iters=90, rho=10.0, rho_adapt=rho_adapt, pdas_rounds=pdas_rounds))
    assert np.isfinite(tres.x.numpy()).all()
    assert_results_close(jres, tres, 1e-7)


def _scipy_qp(P, q, A, l, u):
    cons = []
    for a, li, ui in zip(A, l, u):
        if np.isfinite(li) and abs(ui - li) < 1e-12:
            cons.append({"type": "eq", "fun": lambda x, a=a, li=li: a @ x - li,
                         "jac": lambda x, a=a: a})
            continue
        cons.append({"type": "ineq", "fun": lambda x, a=a, ui=ui: ui - a @ x,
                     "jac": lambda x, a=a: -a})
        if np.isfinite(li):
            cons.append({"type": "ineq",
                         "fun": lambda x, a=a, li=li: a @ x - li,
                         "jac": lambda x, a=a: a})
    res = scipy.optimize.minimize(
        lambda x: 0.5 * x @ P @ x + q @ x, np.zeros(P.shape[0]),
        jac=lambda x: P @ x + q, constraints=cons, method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-12})
    return res.x


@pytest.mark.parametrize("kkt_form", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_matches_scipy(seed, kkt_form):
    """The port alone, in f32 as the card runs it, against SLSQP (the
    bound of tests/test_ocp_solver.py::test_admm_matches_scipy: 2e-2)."""
    qp = random_qp(seed)
    x_ref = _scipy_qp(*qp)
    T = [torch.tensor(a, dtype=torch.float32)[None] for a in qp]
    res = tadmm.admm_solve(*T, torch.zeros(1, 12), torch.zeros(1, 18),
                           tadmm.ADMMSettings(iters=400, rho=10.0,
                                              kkt_form=kkt_form))
    assert res.x.dtype == torch.float32
    np.testing.assert_allclose(res.x[0].numpy(), x_ref, atol=2e-2)


@pytest.mark.parametrize("kkt_form", [True, False])
def test_rows_are_independent(kkt_form):
    """Every reduction is per scenario: a permuted batch gives bitwise the
    same rows, and a scenario solved alone gives the row it has in the
    batch to 1e-12 (a batch of one takes other BLAS paths, so not
    bitwise)."""
    qp = [torch.tensor(a) for a in random_batch()]
    s = tadmm.ADMMSettings(iters=40, rho=1.0, rho_adapt=2, pdas_rounds=2,
                           kkt_form=kkt_form)
    zx, zy = torch.zeros(4, 12).double(), torch.zeros(4, 18).double()
    full = tadmm.admm_solve(*qp, zx, zy, s)
    perm = torch.tensor([3, 1, 0, 2])
    shuf = tadmm.admm_solve(*(a[perm] for a in qp), zx, zy, s)
    one = tadmm.admm_solve(*(a[2:3] for a in qp), zx[:1], zy[:1], s)
    for name in full._fields:
        assert torch.equal(getattr(shuf, name), getattr(full, name)[perm]), \
            name
        np.testing.assert_allclose(getattr(one, name).numpy(),
                                   getattr(full, name)[2:3].numpy(), rtol=0,
                                   atol=1e-12, err_msg=name)
    assert full.r_prim.shape == (4,) and full.r_dual.shape == (4,)


def test_rejected_active_set_falls_back():
    """An active-set refinement that turns non-finite (an infinite penalty
    weight in the normal-equation branch) is rejected: the ADMM iterate
    comes back, finite; a usable refinement is accepted and differs."""
    qp = [torch.tensor(a) for a in random_batch((0, 1))]
    zx, zy = torch.zeros(2, 12).double(), torch.zeros(2, 18).double()
    kw = dict(iters=40, rho=1.0, kkt_form=False)
    plain = tadmm.admm_solve(*qp, zx, zy,
                             tadmm.ADMMSettings(pdas_rounds=0, **kw))
    good = tadmm.admm_solve(*qp, zx, zy,
                            tadmm.ADMMSettings(pdas_rounds=2, **kw))
    assert not torch.equal(good.x, plain.x)
    bad = tadmm.admm_solve(*qp, zx, zy, tadmm.ADMMSettings(
        pdas_rounds=2, pdas_weight=float("inf"), **kw))
    assert torch.isfinite(bad.x).all()
    assert torch.equal(bad.x, plain.x)
