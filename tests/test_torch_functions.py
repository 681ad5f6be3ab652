"""Function-level parity of the PyTorch port with the JAX package, in f64:
the centroidal model, the OCP (cost, constraints, linearization), the
structured condensing and the interior-point solver, each fed the same
numpy inputs made from a seed.  Plus the landing-tick KKT check of
tests/test_pdip.py on the port's solver, in f64 and f32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg
from cmpc_tpu.models import centroidal as jcm
from cmpc_tpu.ocp import condense as jcond, problem as jprob
from cmpc_tpu.ops import pdip as jpdip
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.models import centroidal as tcm
from cmpc_tpu_torch.ocp import condense as tcond, problem as tprob
from cmpc_tpu_torch.ops import pdip as tpdip, sqp as tsqp

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(), JCfg()
B = 3
TOL = 1e-10


@pytest.fixture(autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def random_params(rng, N=CFG.N):
    gl = (rng.uniform(size=(B, N + 1)) > 0.4).astype(np.float64)
    gr = np.where(gl > 0, (rng.uniform(size=(B, N + 1)) > 0.5), 1.0)
    x0 = rng.normal(size=(B, 20)) * 0.05
    x0[:, 2] += CFG.h
    com_ref = rng.normal(size=(B, N, 9)) * 0.05
    com_ref[:, :, 2] += CFG.h
    return dict(
        x0=x0, com_ref=com_ref,
        pos_ref_l=rng.normal(size=(B, N, 3)) * 0.1,
        pos_ref_r=rng.normal(size=(B, N, 3)) * 0.1,
        yaw_ref_l=rng.normal(size=(B, N)) * 0.1,
        yaw_ref_r=rng.normal(size=(B, N)) * 0.1,
        gamma_l=gl, gamma_r=gr.astype(np.float64),
        k1=rng.uniform(3.0, 5.0, B), k2=rng.uniform(0.05, 1.0, B),
        mass=rng.uniform(38.0, 42.0, B))


def random_z(rng, p):
    """A plausible base point: states near x0, hover-ish forces."""
    X = p["x0"][:, None, :] + 0.02 * rng.normal(size=(B, CFG.N + 1, 20))
    U = rng.normal(size=(B, CFG.N, 32))
    U[:, :, 2:24:3] += 50.0
    return np.concatenate([X.reshape(B, -1), U.reshape(B, -1)], axis=1)


def jparams(p):
    return jprob.MPCParams(**{k: jnp.asarray(v) for k, v in p.items()})


def vm(fn):
    return jax.jit(jax.vmap(fn))


def close(t, j, tol=TOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_euler_step(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 20))
    r = rng.normal(size=(B, 9))
    u = rng.normal(size=(B, 32)) * 30
    gl = np.array([1.0, 0.0, 1.0])
    gr = np.array([1.0, 1.0, 0.0])
    k1, k2, m = rng.uniform(3, 5, B), rng.uniform(0, 1, B), rng.uniform(
        38, 42, B)
    poly_j = jcm.foot_polygon(CFG.foot_length, CFG.foot_width)
    j = vm(lambda *a: jcm.euler_step(*a, CFG.g, poly_j, CFG.delta))(
        *map(jnp.asarray, (x, r, gl, gr, u, k1, k2, m)))
    poly_t = tcm.foot_polygon(CFG.foot_length, CFG.foot_width,
                              dtype=torch.float64)
    t = tcm.euler_step(*map(torch.tensor, (x, r, gl, gr, u, k1, k2, m)),
                       CFG.g, poly_t, CFG.delta)
    close(t, j)
    # the reference's quirks: theta_hat does not enter the force balance,
    # and a foot in contact does not move
    dx = tcm.centroidal_dynamics(*map(torch.tensor, (x, r, gl, gr, u, k1,
                                                     k2, m)), CFG.g, poly_t)
    x2 = x.copy()
    x2[:, 9:12] += 1.0
    dx2 = tcm.centroidal_dynamics(*map(torch.tensor, (x2, r, gl, gr, u, k1,
                                                      k2, m)), CFG.g, poly_t)
    assert torch.equal(dx[:, 3:6], dx2[:, 3:6])
    assert torch.all(dx[0, 12:20] == 0) and torch.all(dx[1, 16:20] == 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_constraints_and_cost(seed):
    rng = np.random.default_rng(seed)
    p = random_params(rng)
    z = random_z(rng, p)
    tp = convert.params_from_numpy(p)
    jc = vm(lambda zz, pp: jprob.constraints(zz, pp, JCFG))(
        jnp.asarray(z), jparams(p))
    close(tprob.constraints(torch.tensor(z), tp, CFG), jc)
    jv = vm(lambda zz, pp: jprob.cost_value(zz, pp, JCFG))(
        jnp.asarray(z), jparams(p))
    close(tprob.cost_value(torch.tensor(z), tp, CFG), jv, tol=0.0,
          rtol=1e-12)
    lj, uj = jprob.constraint_bounds(JCFG)
    lt, ut = tprob.constraint_bounds(CFG)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ut, uj)
    assert tprob.num_constraints(CFG) == jprob.num_constraints(JCFG)


def test_cost_quadratic_parts():
    rng = np.random.default_rng(2)
    p = random_params(rng)
    j = vm(lambda pp: jprob.cost_quadratic_parts(pp, JCFG))(jparams(p))
    t = tprob.cost_quadratic_parts(convert.params_from_numpy(p), CFG)
    for a, b in zip(t, j):
        close(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_linearize_parts(seed):
    rng = np.random.default_rng(seed)
    p = random_params(rng)
    z = random_z(rng, p)
    j = vm(lambda zz, pp: jprob.linearize_parts(zz, pp, JCFG))(
        jnp.asarray(z), jparams(p))
    t = tprob.linearize_parts(torch.tensor(z), convert.params_from_numpy(p),
                              CFG)
    assert t._fields == j._fields
    for name in j._fields:
        close(getattr(t, name), getattr(j, name))


def _qp_inputs(seed):
    rng = np.random.default_rng(seed)
    p = random_params(rng)
    z = random_z(rng, p)
    nU = 32 * CFG.N
    w = np.ones((CFG.N, 32))
    w[:, 24:] = 1e-3
    lam = rng.uniform(0.0, 50.0, size=(B, CFG.N + 1))
    prox = rng.uniform(0.1, 2.0, size=B)
    return p, z, w.reshape(nU), lam, prox


@pytest.mark.parametrize("soft", [False, True])
def test_condense_build_structured(soft):
    p, z, w, lam, prox = _qp_inputs(3)
    j = vm(lambda zz, pp, pr, ll: jcond.build(
        zz, pp, JCFG, pr, jnp.asarray(w), lam_soft=ll, soft=soft,
        structured=True))(jnp.asarray(z), jparams(p), jnp.asarray(prox),
                          jnp.asarray(lam))
    t = tcond.build(torch.tensor(z), convert.params_from_numpy(p), CFG,
                    torch.tensor(prox), torch.tensor(w),
                    lam_soft=torch.tensor(lam), soft=soft, structured=True)
    nv = 32 * CFG.N + (CFG.N + 1 if soft else 0)
    assert tuple(t.H.shape) == (B, nv, nv)
    for name in ("H", "g", "C", "d", "C_blk", "d_blk", "E", "row_scale"):
        a, b = getattr(t, name), getattr(j, name)
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        close(a, b, tol=TOL * scale)


@pytest.mark.parametrize("soft", [False, True])
def test_condense_build_dense(soft):
    """The dense form, build's default as in the JAX package: every row in
    C, no per-stage blocks; against JAX at TOL (scaled by the magnitude)."""
    p, z, w, lam, prox = _qp_inputs(4)
    j = vm(lambda zz, pp, pr, ll: jcond.build(
        zz, pp, JCFG, pr, jnp.asarray(w), lam_soft=ll, soft=soft))(
        jnp.asarray(z), jparams(p), jnp.asarray(prox), jnp.asarray(lam))
    t = tcond.build(torch.tensor(z), convert.params_from_numpy(p), CFG,
                    torch.tensor(prox), torch.tensor(w),
                    lam_soft=torch.tensor(lam), soft=soft)
    assert t.C_blk is None and t.d_blk is None and j.C_blk is None
    assert tuple(t.C.shape) == (B, tprob.num_constraints(CFG) - 20 * (
        CFG.N + 1) + 6 * CFG.N + (CFG.N + 1 if soft else 0),
        32 * CFG.N + (CFG.N + 1 if soft else 0))
    for name in ("H", "g", "C", "d", "E", "row_scale"):
        a, b = getattr(t, name), getattr(j, name)
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        close(a, b, tol=TOL * scale)


def test_condense_dense_form_not_ported():
    """The name is from when the dense form raised NotImplementedError.  It
    is ported: build's defaults (structured=False, no multipliers) give the
    dense form, equal to JAX's with the same defaults."""
    p, z, w, lam, prox = _qp_inputs(4)
    t = tcond.build(torch.tensor(z), convert.params_from_numpy(p), CFG, 0.1,
                    torch.tensor(w))
    j = vm(lambda zz, pp: jcond.build(zz, pp, JCFG, 0.1, jnp.asarray(w)))(
        jnp.asarray(z), jparams(p))
    assert t.C_blk is None
    for name in ("H", "g", "C", "d"):
        a, b = getattr(t, name), getattr(j, name)
        close(a, b, tol=TOL * max(1.0, float(np.abs(np.asarray(b)).max())))


@pytest.mark.parametrize("psd", [True, False])
def test_soft_row_hessian(psd):
    """The dense soft-row Hessian (convexified or exact) against JAX's, and
    the convexified one positive semidefinite."""
    p, _, _, lam, _ = _qp_inputs(5)
    j = vm(lambda ll, pp: jcond.soft_row_hessian(ll, pp, JCFG, psd=psd))(
        jnp.asarray(lam), jparams(p))
    t = tcond.soft_row_hessian(torch.tensor(lam),
                               convert.params_from_numpy(p), CFG, psd=psd)
    assert tuple(t.shape) == (B, CFG.n_z, CFG.n_z)
    close(t, j, tol=TOL * max(1.0, float(np.abs(np.asarray(j)).max())))
    ew = torch.linalg.eigvalsh(t)
    if psd:
        assert float(ew.min()) > -1e-9
    else:
        assert float(ew.min()) < -1e-3     # the exact Hessian is indefinite


def test_condense_structured_matches_dense():
    """tests/test_condense.py::test_structured_build_matches_dense on the
    port, f64: the structured pieces, reassembled in the dense row order,
    equal the dense build (random base points, with multipliers), and the
    interior-point solves of both forms of the landing-tick QP agree."""
    p, z, w, lam, prox = _qp_inputs(6)
    N, nU = CFG.N, 32 * CFG.N
    args = (torch.tensor(z), convert.params_from_numpy(p), CFG,
            torch.tensor(prox), torch.tensor(w))
    qpd = tcond.build(*args, lam_soft=torch.tensor(lam), soft=False)
    qps = tcond.build(*args, lam_soft=torch.tensor(lam), soft=False,
                      structured=True)

    def reassembled(qps):
        rows, dvals = [], []
        for r0, nr in ((0, 16), (16, 16), (32, 4), (36, 4)):
            blk = qps.C.new_zeros(qps.C.shape[0], N, nr, nU)
            for i in range(N):
                blk[:, i, :, 32 * i:32 * i + 24] = \
                    qps.C_blk[:, i, r0:r0 + nr]
            rows.append(blk.reshape(blk.shape[0], N * nr, nU))
            dvals.append(qps.d_blk[:, :, r0:r0 + nr].reshape(blk.shape[0],
                                                             -1))
        return (torch.cat([qps.C[:, :2 * N + 1], *rows,
                           qps.C[:, 2 * N + 1:]], 1),
                torch.cat([qps.d[:, :2 * N + 1], *dvals,
                           qps.d[:, 2 * N + 1:]], 1))

    C_re, d_re = reassembled(qps)
    np.testing.assert_allclose(C_re.numpy(), qpd.C.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(d_re.numpy(), qpd.d.numpy(), rtol=0,
                               atol=1e-10)
    scale = float(qpd.H.abs().max())
    np.testing.assert_allclose(qps.H.numpy(), qpd.H.numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(qps.g.numpy(), qpd.g.numpy(), rtol=0,
                               atol=1e-12 * float(qpd.g.abs().max()))

    lp = _landing_params()
    state = tsqp.init_solver_state(CFG, lp.x0, mass=lp.mass)
    U = tsqp.prep_warmstart(state, lp, CFG)
    zl = tprob.join_z(tsqp._rollout_X(lp.x0, U, lp, CFG), U)
    w1 = torch.ones(nU, dtype=torch.float64)
    qpd = tcond.build(zl, lp, CFG, 0.1, w1, soft=False)
    qps = tcond.build(zl, lp, CFG, 0.1, w1, soft=False, structured=True)
    C_re, _ = reassembled(qps)
    np.testing.assert_allclose(C_re.numpy(), qpd.C.numpy(), rtol=0,
                               atol=1e-10)
    st = tpdip.PDIPSettings(iters=25)
    rd = tpdip.pdip_solve(qpd.H, qpd.g, qpd.C, qpd.d, st)
    rs = tpdip.pdip_solve(qps.H, qps.g, qps.C, qps.d, st, C_blk=qps.C_blk,
                          d_blk=qps.d_blk)
    vmax = float(rd.v.abs().max())
    np.testing.assert_allclose(rs.v.numpy(), rd.v.numpy(), rtol=0,
                               atol=1e-6 * vmax)
    assert abs(float(rd.r_prim[0]) - float(rs.r_prim[0])) < 1e-8


def test_pdip_settings_fields_and_defaults():
    """The port's PDIPSettings: JAX's fields less its two choices of Newton
    step (explicit_inv, inv_method), in JAX's order, with JAX's
    defaults."""
    step = ("explicit_inv", "inv_method")
    assert tpdip.PDIPSettings._fields == tuple(
        f for f in jpdip.PDIPSettings._fields if f not in step)
    assert tpdip.PDIPSettings._field_defaults == {
        k: v for k, v in jpdip.PDIPSettings._field_defaults.items()
        if k not in step}


def _qp320(seed):
    """A strictly convex QP at the MPC's size, n = 320 (the blocked
    factor's 5 tiles), m = 400 rows, f64."""
    rng = np.random.default_rng(seed)
    n, m = 320, 400
    A = rng.normal(size=(B, n, n)) / np.sqrt(n)
    H = A @ np.swapaxes(A, 1, 2) + np.eye(n)
    g = rng.normal(size=(B, n)) * 10.0
    C = rng.normal(size=(B, m, n)) / np.sqrt(n)
    d = rng.uniform(0.1, 1.0, size=(B, m))
    return H, g, C, d


@pytest.mark.parametrize("kw", [dict(), dict(explicit_inv=False),
                                dict(inv_method="xla")],
                         ids=["blocked_inverse", "substitution",
                              "library_inverse"])
def test_pdip_solve_other_newton_paths(kw):
    """The port's one Newton step (the blocked factor applied by block
    substitution) against each of JAX's three, at n = 320 and the solver's
    8 iterations (mu ~6e-7), at 1e-8.  (Past ~10 iterations this QP's f64
    endgame turns rounding differences of 1e-16 into 1e-5 on lam, in either
    package and on every path.)"""
    qp = _qp320(8)
    j = vm(lambda *a: jpdip.pdip_solve(*a, jpdip.PDIPSettings(iters=8,
                                                              **kw)))(
        *map(jnp.asarray, qp))
    t = tpdip.pdip_solve(*map(torch.tensor, qp), tpdip.PDIPSettings(iters=8))
    for name in j._fields:
        close(getattr(t, name), getattr(j, name), tol=1e-8)
    assert float(t.r_prim.max()) < 1e-8 and float(t.mu.max()) < 1e-6


def test_pdip_newton_step_factors_once_and_substitutes(monkeypatch):
    """Each interior-point iteration factors the Newton matrix once
    (spd_factor64) and applies the factor by substitution (spd_solve64) to
    every right-hand side: (1 + refine) solves each for the predictor and
    the corrector.  No inverse is formed, on the CPU as on the card."""
    factor, solve = tpdip.spd_factor64, tpdip.spd_solve64
    factored, solved = [], []

    def counted_factor(M):
        factored.append(tuple(M.shape))
        return factor(M)

    def counted_solve(L, Dinv, b):
        solved.append(tuple(b.shape))
        return solve(L, Dinv, b)

    monkeypatch.setattr(tpdip, "spd_factor64", counted_factor)
    monkeypatch.setattr(tpdip, "spd_solve64", counted_solve)
    iters, refine = 3, 2
    t = tpdip.pdip_solve(*map(torch.tensor, _qp320(10)),
                         tpdip.PDIPSettings(iters=iters, refine=refine))
    assert factored == [(B, 320, 320)] * iters
    assert solved == [(B, 320)] * (iters * 2 * (1 + refine))
    assert torch.isfinite(t.v).all()


def test_pdip_non_pd_row_is_frozen():
    """A scenario whose Newton matrix is not positive definite gets a
    non-finite direction from the blocked factor, and the guarded update
    freezes it at its start (v = 0); the others solve."""
    H, g, C, d = _qp320(9)
    H[1] = -np.eye(320)
    t = tpdip.pdip_solve(*map(torch.tensor, (H, g, C, d)),
                         tpdip.PDIPSettings(iters=4))
    assert torch.equal(t.v[1], torch.zeros(320, dtype=torch.float64))
    assert torch.isfinite(t.v[[0, 2]]).all()
    assert float(t.r_prim[[0, 2]].max()) < 1e-3


def test_pdip_solve_small_qp():
    """A QP below one tile (n = 24), dense rows only: the blocked factor
    pads M with an identity tail to n = 64 and the right-hand sides with
    zeros; against JAX (its library-Cholesky branch there) at 1e-8."""
    rng = np.random.default_rng(6)
    n, m = 24, 40
    A = rng.normal(size=(B, n, n))
    H = A @ np.swapaxes(A, 1, 2) + np.eye(n)
    g = rng.normal(size=(B, n)) * 10.0
    C = rng.normal(size=(B, m, n))
    d = rng.uniform(0.1, 1.0, size=(B, m))
    qp = (H, g, C, d)
    s = jpdip.PDIPSettings(iters=15)
    j = vm(lambda *a: jpdip.pdip_solve(*a, s))(*map(jnp.asarray, qp))
    t = tpdip.pdip_solve(*map(torch.tensor, qp), tpdip.PDIPSettings(iters=15))
    for name in j._fields:
        close(getattr(t, name), getattr(j, name), tol=1e-8)


def _landing_params():
    """tests/test_pdip.py::_walking_params: left support, the right foot
    lands at node 6, walking-speed CoM velocity."""
    N, h = CFG.N, CFG.h
    x0 = np.zeros(20)
    x0[0:3] = [0.0, 0.0, h]
    x0[3:6] = [0.15, 0.02, 0.0]
    x0[13:16] = [0.0, 0.1, 0.0]
    x0[17:20] = [0.1, -0.1, 0.0]
    com_ref = np.zeros((N, 9))
    com_ref[:, 2] = h
    com_ref[:, 0] = 0.01 * np.arange(1, N + 1)
    com_ref[:, 3] = 0.15
    p = dict(x0=x0, com_ref=com_ref,
             pos_ref_l=np.tile([0.0, 0.1, 0.0], (N, 1)),
             pos_ref_r=np.tile([0.25, -0.1, 0.0], (N, 1)),
             yaw_ref_l=np.zeros(N), yaw_ref_r=np.zeros(N),
             gamma_l=np.ones(N + 1),
             gamma_r=np.concatenate([np.zeros(6), np.ones(N + 1 - 6)]),
             k1=np.asarray(4.0), k2=np.asarray(0.1), mass=np.asarray(40.05))
    return convert.params_from_numpy({k: np.asarray(v)[None]
                                      for k, v in p.items()})


def _full_rows(qp):
    """[C; per-stage blocks placed at their columns] as one dense matrix."""
    C = qp.C[0].numpy()
    Cb = qp.C_blk[0].numpy()
    Nb, rb, cb = Cb.shape
    blk = np.zeros((Nb * rb, C.shape[1]))
    for i in range(Nb):
        blk[i * rb:(i + 1) * rb, 32 * i:32 * i + cb] = Cb[i]
    return (np.concatenate([C, blk]),
            np.concatenate([qp.d[0].numpy(), qp.d_blk[0].numpy().ravel()]))


def test_pdip_on_landing_tick_kkt():
    """tests/test_pdip.py::test_pdip_on_condensed_mpc_qp on the port: the
    IPM must satisfy the KKT conditions of the landing-tick QP; f64:
    r_stat < 1e-8; f32: r_stat < 0.15 (the JAX package's own bound)."""
    p = _landing_params()
    state = tsqp.init_solver_state(CFG, p.x0, mass=p.mass)
    U = tsqp.prep_warmstart(state, p, CFG)
    X = tsqp._rollout_X(p.x0, U, p, CFG)
    z = tprob.join_z(X, U)
    nU = 32 * CFG.N
    qp = tcond.build(z, p, CFG, 0.1, torch.ones(nU, dtype=torch.float64),
                     lam_soft=None, soft=False, structured=True)
    Cf, df = _full_rows(qp)
    H, g = qp.H[0].numpy(), qp.g[0].numpy()
    scale = max(1.0, np.abs(g).max())

    def kkt(res):
        v = res.v[0].double().numpy()
        lam = res.lam[0].double().numpy()
        assert float(np.maximum(Cf @ v - df, 0.0).max()) < 1e-3
        assert lam.min() >= 0.0
        r_stat = np.abs(H @ v + g + Cf.T @ lam).max() / scale
        comp = np.abs(lam * np.maximum(df - Cf @ v, 0.0)).max() / scale
        return r_stat, comp

    s = tpdip.PDIPSettings(iters=25)
    r_stat, comp = kkt(tpdip.pdip_solve(qp.H, qp.g, qp.C, qp.d, s,
                                        C_blk=qp.C_blk, d_blk=qp.d_blk))
    assert r_stat < 1e-8, r_stat
    assert comp < 1e-6, comp

    f32 = [a.float() for a in (qp.H, qp.g, qp.C, qp.d, qp.C_blk, qp.d_blk)]
    r_stat, comp = kkt(tpdip.pdip_solve(*f32[:4], s, C_blk=f32[4],
                                        d_blk=f32[5]))
    assert r_stat < 0.15, r_stat
    assert comp < 1.0, comp


def test_solve_mpc_admm_not_ported():
    """The name is from when mpc_solver="admm" raised NotImplementedError.
    It is ported now: the landing problem solves (finite, a step accepted,
    the stance foot carrying the weight at node 0), and only an unknown
    solver name raises."""
    import dataclasses
    p = _landing_params()
    state = tsqp.init_solver_state(CFG, p.x0, mass=p.mass)
    new, info = tsqp.solve_mpc(state, p,
                               dataclasses.replace(CFG, mpc_solver="admm"))
    assert torch.isfinite(new.z).all() and torch.isfinite(info.r_prim).all()
    assert not torch.equal(new.z, state.z)
    _, U = tprob.split_z(new.z, CFG)
    fz_l = U[0, 0, 0:12].reshape(4, 3)[:, 2].sum()
    assert 0.5 * 40.05 * 9.81 < float(fz_l) < 1.5 * 40.05 * 9.81
    with pytest.raises(ValueError, match="unknown mpc_solver"):
        tsqp.solve_mpc(state, p, dataclasses.replace(CFG, mpc_solver="x"))
