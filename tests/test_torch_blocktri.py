"""The port's stage-structured linear algebra and the ADMM configuration of
the MPC solve against the JAX package's, in f64 on the CPU: the dense
``cost_quadratic`` / ``linearize`` forms, ``build_blocks`` / ``factor`` /
``solve``, the counterparts of tests/test_blocktri.py on the port alone,
and ``solve_mpc(mpc_solver="admm")`` on the standing double-support
problem."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg
from cmpc_tpu.ocp import problem as jprob
from cmpc_tpu.ops import blocktri as jbt, sqp as jsqp
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.models import centroidal as cm
from cmpc_tpu_torch.ocp import problem as tprob
from cmpc_tpu_torch.ops import blocktri as tbt, sqp as tsqp

torch.set_num_threads(1)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def params_np(N, B, seed, standing):
    """The MPC parameters of tests/test_ocp_solver.py::make_params as a
    batch of numpy arrays: standing double support (x0 exact in row 0,
    perturbed by 1e-3 in the others), or a perturbed state under random
    contact gates."""
    rng = np.random.default_rng(seed)
    h = WalkConfig().h
    x0 = np.zeros((B, 20))
    x0[:, cm.P_COM] = [0.0, 0.0, h]
    x0[:, cm.POS_L] = [0.0, 0.1, 0.0]
    x0[:, cm.POS_R] = [0.0, -0.1, 0.0]
    if standing:
        x0[1:, :6] += 1e-3 * rng.normal(size=(B - 1, 6))
        gl = gr = np.ones((B, N + 1))
    else:
        x0 += 0.01 * rng.normal(size=x0.shape)
        gl = (rng.uniform(size=(B, N + 1)) > 0.3).astype(np.float64)
        gr = np.where(gl > 0, (rng.uniform(size=(B, N + 1)) > 0.5), 1.0)
    com_ref = np.zeros((B, N, 9))
    com_ref[:, :, 2] = h
    return dict(
        x0=x0, com_ref=com_ref,
        pos_ref_l=np.tile([0.0, 0.1, 0.0], (B, N, 1)),
        pos_ref_r=np.tile([0.0, -0.1, 0.0], (B, N, 1)),
        yaw_ref_l=np.zeros((B, N)), yaw_ref_r=np.zeros((B, N)),
        gamma_l=gl, gamma_r=gr.astype(np.float64), k1=np.full(B, 4.0),
        k2=np.full(B, 0.1), mass=np.full(B, 40.05))


def both_params(d):
    return (jprob.MPCParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.params_from_numpy(d))


def test_stage_perm_matches():
    for N in (3, 10):
        a, b = jbt.stage_perm(N), tbt.stage_perm(N)
        np.testing.assert_array_equal(a.perm, b.perm)
        assert tuple(a)[1:] == tuple(b)[1:]
    assert tbt.StagePerm._fields == jbt.StagePerm._fields
    assert tbt.BlockFactor._fields == jbt.BlockFactor._fields


@pytest.mark.parametrize("standing", [True, False])
def test_dense_forms_match(standing):
    """cost_quadratic and linearize (dense P, q, c, J at N = 10) at a
    random z: 1e-10 absolute (entries up to ~1e3 in P)."""
    cfg, jcfg = WalkConfig(), JCfg()
    d = params_np(cfg.N, 3, seed=7, standing=standing)
    jp, tp = both_params(d)
    z = 0.05 * np.random.default_rng(11).normal(size=(3, cfg.n_z))
    z[:, :20] += d["x0"]
    jP, jq = jax.vmap(lambda p: jprob.cost_quadratic(p, jcfg))(jp)
    jc, jJ = jax.vmap(lambda zz, p: jprob.linearize(zz, p, jcfg))(
        jnp.asarray(z), jp)
    tP, tq = tprob.cost_quadratic(tp, cfg)
    tc, tJ = tprob.linearize(torch.tensor(z), tp, cfg)
    for got, want in ((tP, jP), (tq, jq), (tc, jc), (tJ, jJ)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)
    # cost(z) == 1/2 z'Pz + q'z + cost(0), on the port alone
    zt = torch.tensor(z)
    lhs = tprob.cost_value(zt, tp, cfg)
    rhs = 0.5 * torch.einsum("bi,bij,bj->b", zt, tP, zt) \
        + (tq * zt).sum(1) + tprob.cost_value(torch.zeros_like(zt), tp, cfg)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-10)


def _system(seed, B=2):
    """(P, q, J, rho, sigma, M) of the port at N = 10 for a batch."""
    cfg = WalkConfig()
    d = params_np(cfg.N, B, seed=seed, standing=(seed == 0))
    _, tp = both_params(d)
    z = torch.tensor(0.1 * np.random.default_rng(seed + 3).normal(
        size=(B, cfg.n_z)))
    P, q = tprob.cost_quadratic(tp, cfg)
    _, J = tprob.linearize(z, tp, cfg)
    m = J.shape[1]
    rho = torch.where(torch.arange(m) < 20 * (cfg.N + 1), 1e3, 10.0).to(
        F64).expand(B, m)
    sigma = 1e-4
    M = P + sigma * torch.eye(cfg.n_z, dtype=F64) \
        + (J.transpose(1, 2) * rho[:, None, :]) @ J
    return cfg, P, q, J, rho, sigma, M


@pytest.mark.parametrize("seed", [0, 1])
def test_structure_and_solve(seed):
    """The OCP matrices are exactly block-tridiagonal in stage-major order
    and the block Cholesky solve equals the dense solve (rtol 1e-8); the
    blocks, the factor and the solution equal the JAX package's on the
    same matrices at 1e-9 of their largest entry."""
    cfg, P, q, J, rho, sigma, M = _system(seed)
    sp = tbt.stage_perm(cfg.N)
    B = P.shape[0]

    Mp = M.numpy()[:, sp.perm][:, :, sp.perm]
    w = sp.width
    for i in range(sp.n_stages):
        for j in range(sp.n_stages):
            if abs(i - j) > 1:
                blk = Mp[:, i * w:min((i + 1) * w, sp.n),
                         j * w:min((j + 1) * w, sp.n)]
                assert np.abs(blk).max() == 0.0, (i, j)

    D, O = tbt.build_blocks(P, J, rho, sigma, sp)
    fac = tbt.factor(D, O)
    b = torch.tensor(np.random.default_rng(seed + 9).normal(
        size=(B, cfg.n_z)))
    x_bt = tbt.solve(fac, b, sp)
    x_ref = torch.linalg.solve(M, b[:, :, None])[:, :, 0]
    np.testing.assert_allclose(x_bt.numpy(), x_ref.numpy(), rtol=1e-8,
                               atol=1e-10)

    jsp = jbt.stage_perm(cfg.N)

    def jax_side(P, J, rho, b):
        D, O = jbt.build_blocks(P, J, rho, sigma, jsp)
        f = jbt.factor(D, O)
        return D, O, f.C, f.B, jbt.solve(f, b, jsp)

    want = jax.jit(jax.vmap(jax_side))(*(jnp.asarray(a.numpy())
                                         for a in (P, J, rho, b)))
    for name, g, w_ in zip(("D", "O", "C", "B", "x"),
                           (D, O, fac.C, fac.B, x_bt), want):
        w_ = np.asarray(w_)
        assert g.shape == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(w_).max()),
                                   err_msg=name)


def test_batch():
    """A batch of differing problems through build / factor / solve (the
    counterpart of test_vmap_batch), and row independence: a permuted
    batch gives bitwise the same rows."""
    cfg = WalkConfig()
    sp = tbt.stage_perm(cfg.N)
    B = 3
    _, tp = both_params(params_np(cfg.N, B, seed=0, standing=False))
    P, q = tprob.cost_quadratic(tp, cfg)
    _, J = tprob.linearize(torch.zeros(B, cfg.n_z, dtype=F64), tp, cfg)
    rho = torch.full((B, J.shape[1]), 10.0, dtype=F64)

    def run(P, J, rho, q):
        return tbt.solve(tbt.factor(*tbt.build_blocks(P, J, rho, 1e-4, sp)),
                         q, sp)

    out = run(P, J, rho, q)
    assert out.shape == (B, cfg.n_z)
    assert torch.isfinite(out).all()
    perm = torch.tensor([2, 0, 1])
    assert torch.equal(run(P[perm], J[perm], rho[perm], q[perm]), out[perm])
    assert not torch.equal(out[0], out[1])


def test_factor_of_indefinite_matrix_gives_nan_in_its_row_only():
    """A scenario whose matrix is not positive definite gets NaN factors,
    as the JAX package's Cholesky does; nothing is raised and the other
    scenarios' solves are bitwise what they are without it."""
    cfg, P, q, J, rho, sigma, M = _system(1, B=3)
    sp = tbt.stage_perm(cfg.N)
    D, O = tbt.build_blocks(P, J, rho, sigma, sp)
    good = tbt.solve(tbt.factor(D, O), q, sp)
    D_bad = D.clone()
    D_bad[1, 4] = -D_bad[1, 4]
    x = tbt.solve(tbt.factor(D_bad, O), q, sp)
    assert torch.isnan(x[1]).any()
    assert torch.equal(x[0], good[0]) and torch.equal(x[2], good[2])


def test_blocktri_f32_residual():
    """The block solve in f32 (as the card runs it) at the production
    conditioning, sigma = 1e-6 plus the SQP prox term: relative residual
    under 1e-4, the bound of tests/test_blocktri.py."""
    cfg = WalkConfig()
    sp = tbt.stage_perm(cfg.N)
    d = params_np(cfg.N, 2, seed=2, standing=False)
    tp = convert.params_from_numpy(d, dtype=torch.float32)
    z = torch.zeros(2, cfg.n_z)
    z[:, :20] = tp.x0
    P, q = tprob.cost_quadratic(tp, cfg)
    _, J = tprob.linearize(z, tp, cfg)
    m = J.shape[1]
    rho = torch.where(torch.arange(m) < 20 * (cfg.N + 1), 1e3, 10.0).expand(
        2, m)
    sigma = 1e-6 + cfg.sqp_prox
    M = P + sigma * torch.eye(cfg.n_z) \
        + (J.transpose(1, 2) * rho[:, None, :]) @ J
    fac = tbt.factor(*tbt.build_blocks(P, J, rho, sigma, sp))
    b = torch.tensor(np.random.default_rng(5).normal(size=(2, cfg.n_z)),
                     dtype=torch.float32)
    x = tbt.solve(fac, b, sp)
    assert x.dtype == torch.float32
    res = (M @ x[:, :, None])[:, :, 0] - b
    rel = torch.linalg.vector_norm(res, dim=1) \
        / torch.linalg.vector_norm(b, dim=1)
    assert float(rel.max()) < 1e-4, rel


# ------------------------------------------- solve_mpc(mpc_solver="admm")

ADMM_KW = dict(sqp_iters=3, admm_iters=20, admm_rho=0.1, mpc_solver="admm")


def _check_standing(cfg, state, info, B):
    """The bounds of tests/test_ocp_solver.py::test_mpc_solve_standing,
    per scenario."""
    X, U = tprob.split_z(state.z, cfg)
    X, U = X.numpy(), U.numpy()
    assert (info.r_prim.numpy() < 1e-2).all(), info.r_prim
    fz = U[:, 0, 0:24].reshape(B, 8, 3)[:, :, 2].sum(1)
    assert (np.abs(fz - 40.05 * 9.81) / (40.05 * 9.81) < 0.05).all(), fz
    assert (np.abs(X[:, :, 0:2]) < 0.02).all()
    assert (np.abs(X[:, :, 2] - cfg.h) < 0.02).all()
    f = U[:, :, 0:24].reshape(-1, 3)
    assert (np.abs(f[:, 0]) <= 0.5 * f[:, 2] + 1.0).all()
    assert (f[:, 2] >= -1.0).all()
    assert (info.lyap_violation.numpy() < 1e-2).all(), info.lyap_violation


@pytest.mark.parametrize("elastic", [False, True])
def test_solve_mpc_admm_standing(elastic):
    """The whole ADMM-configured solve (3 SQP iterations of 20 ADMM
    iterations and 3 active-set rounds; block-tridiagonal branch, or the
    dense normal equations under sqp_elastic) on 3 standing problems,
    N = 10, against the JAX package: z at 1e-7 absolute (forces ~50 N), so
    every scenario took the same step lengths; the duals (up to ~1e4, from
    the 1e5 active-set penalty) at 1e-6 of their largest; and the standing
    test's own bounds on every scenario."""
    cfg = WalkConfig(sqp_elastic=elastic, **ADMM_KW)
    jcfg = JCfg(sqp_elastic=elastic, **ADMM_KW)
    B = 3
    jp, tp = both_params(params_np(cfg.N, B, seed=0, standing=True))
    jst = jax.vmap(lambda p: jsqp.init_solver_state(jcfg, p.x0,
                                                    mass=p.mass))(jp)
    jst, jinfo = jax.jit(jax.vmap(lambda s, p: jsqp.solve_mpc(s, p, jcfg)))(
        jst, jp)
    tst = tsqp.init_solver_state(cfg, tp.x0, mass=tp.mass)
    tst, tinfo = tsqp.solve_mpc(tst, tp, cfg)
    np.testing.assert_allclose(tst.z.numpy(), np.asarray(jst.z), rtol=0,
                               atol=1e-7)
    ymax = max(1.0, np.abs(np.asarray(jst.y)).max())
    np.testing.assert_allclose(tst.y.numpy(), np.asarray(jst.y), rtol=0,
                               atol=1e-6 * ymax)
    for name in ("r_prim", "lyap_violation"):
        np.testing.assert_allclose(getattr(tinfo, name).numpy(),
                                   np.asarray(getattr(jinfo, name)), rtol=0,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(tinfo.cost.numpy(), np.asarray(jinfo.cost),
                               rtol=1e-8)
    assert tinfo.r_prim.shape == (B,)
    if not elastic:
        _check_standing(cfg, tst, tinfo, B)


@pytest.mark.parametrize("branch", ["blocktri", "normal", "kkt"])
def test_solve_mpc_admm_branches_run(branch):
    """solve_mpc(mpc_solver="admm") on each of admm_solve's three linear-
    system branches (N = 4, 2 standing problems, port alone): finite and
    inside the standing test's bounds.  (The branches need not agree
    closely: their active-set rounds regularize differently, 1e-6 on the
    banded and KKT forms and 1e-7 on the dense normal equations.)"""
    kw = dict(blocktri={}, normal=dict(mpc_blocktri=False),
              kkt=dict(admm_kkt_form=True))[branch]
    cfg = WalkConfig(N=4, **ADMM_KW, **kw)
    tp = convert.params_from_numpy(params_np(4, 2, seed=0, standing=True))
    st, info = tsqp.solve_mpc(
        tsqp.init_solver_state(cfg, tp.x0, mass=tp.mass), tp, cfg)
    assert torch.isfinite(st.z).all() and torch.isfinite(st.y).all()
    _check_standing(cfg, st, info, 2)
