"""The port's batched MPC solve against the JAX package's, in f64, on
recorded production-walk states (assets/walk_x0.npz) with MPCParams built
by the JAX planner: the warm-start helpers, one interior-point QP of the
production path, and whole solves."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg, nominal_scenario
from cmpc_tpu.ocp import assemble as jasm, condense as jcond
from cmpc_tpu.ops import pdip as jpdip, sqp as jsqp
from cmpc_tpu.plan import com_ref as jcr, footsteps as jfs, timing as jtm
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.ocp import condense as tcond, problem as tprob
from cmpc_tpu_torch.ops import pdip as tpdip, sqp as tsqp

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(), JCfg()
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")
# mid-stance, the first single-support tick after a landing, late double
# support and a swing tick with the landing inside the horizon
TICKS = (250, 262, 300, 420)


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def f64_tree(tree):
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.float64) if jnp.issubdtype(
            a.dtype, jnp.floating) else a
    return jax.tree.map(cast, tree)


def walk_params(ticks=TICKS):
    """JAX-built f64 MPCParams at recorded ticks, stacked on a batch axis
    (call under x64)."""
    timing = jtm.build_timing(JCFG)
    sc = f64_tree(nominal_scenario(JCFG))
    plan = jfs.plan_footsteps(sc.vref, JCFG, timing, sc.foot_y)
    pl, pr = jfs.contact_pose_refs(plan, timing)
    cref = jcr.build_com_ref(plan, JCFG, timing, sc.foot_y)
    refs = jasm.RefArrays(com=cref, pose_ref_l=pl, pose_ref_r=pr)
    x0 = np.load(ASSET)["x0"].astype(np.float64)
    ps = [jasm.gather_params(t, jnp.asarray(x0[t]), refs, timing, JCFG,
                             sc.k1, sc.k2, sc.mpc_mass) for t in ticks]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *ps), sc


def as_numpy(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def test_warmstart_helpers(x64):
    P, sc = walk_params()
    st = jax.vmap(lambda p: jsqp.init_solver_state(JCFG, p.x0,
                                                   mass=sc.mpc_mass))(P)
    tP = convert.params_from_numpy(as_numpy(P))
    tst = tsqp.init_solver_state(CFG, tP.x0, mass=tP.mass)
    for k in ("z", "y"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(),
                                      np.asarray(getattr(st, k)))
    # a carried iterate that is not a cold start
    rng = np.random.default_rng(0)
    z = np.asarray(st.z) + rng.normal(size=st.z.shape) * 0.5
    st = st._replace(z=jnp.asarray(z))
    tst = tst._replace(z=torch.tensor(z))
    Uj = jax.vmap(lambda s, p: jsqp.prep_warmstart(s, p, JCFG))(st, P)
    Ut = tsqp.prep_warmstart(tst, tP, CFG)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0,
                               atol=1e-10)
    Xj = jax.vmap(lambda p, u: jsqp._rollout_X(p.x0, u, p, JCFG))(P, Uj)
    Xt = tsqp._rollout_X(tP.x0, Ut, tP, CFG)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=1e-10)


def test_pdip_solve_production_qp(x64):
    """pdip_solve (C_blk form; the blocked factor applied by substitution)
    on the first SQP subproblem of production solves, against JAX's
    explicit blocked inverse: v, lam and residuals at 1e-8."""
    P, sc = walk_params()
    st = jax.vmap(lambda p: jsqp.init_solver_state(JCFG, p.x0,
                                                   mass=sc.mpc_mass))(P)
    nU = 32 * JCFG.N
    w = np.ones((JCFG.N, 32))
    w[:, 24:] = 1e-3
    w = jnp.asarray(w.reshape(nU))

    def qp_of(s, p):
        U = jsqp.prep_warmstart(s, p, JCFG)
        X = jsqp._rollout_X(p.x0, U, p, JCFG)
        z = jnp.concatenate([X.reshape(-1), U.reshape(-1)])
        return jcond.build(z, p, JCFG, 0.1, w,
                           lam_soft=jnp.zeros(JCFG.N + 1), soft=False,
                           structured=True)

    qp = jax.jit(jax.vmap(qp_of))(st, P)
    s = jpdip.PDIPSettings(iters=JCFG.pdip_iters, refine=JCFG.pdip_refine)
    jr = jax.jit(jax.vmap(lambda H, g, C, d, Cb, db: jpdip.pdip_solve(
        H, g, C, d, s, C_blk=Cb, d_blk=db)))(
        qp.H, qp.g, qp.C, qp.d, qp.C_blk, qp.d_blk)
    T = [torch.tensor(np.asarray(a)) for a in
         (qp.H, qp.g, qp.C, qp.d, qp.C_blk, qp.d_blk)]
    tr = tpdip.pdip_solve(*T[:4], tpdip.PDIPSettings(
        iters=CFG.pdip_iters, refine=CFG.pdip_refine), C_blk=T[4],
        d_blk=T[5])
    # primal quantities at 1e-8 absolute; the duals (up to ~1e3 here) at
    # 1e-8 of their largest magnitude
    for name in jr._fields:
        b = np.asarray(getattr(jr, name))
        scale = max(1.0, np.abs(b).max()) if name in ("lam", "r_dual") \
            else 1.0
        np.testing.assert_allclose(getattr(tr, name).numpy(), b, rtol=0,
                                   atol=1e-8 * scale, err_msg=name)

    # the port's own condensing of the same base point agrees too
    tP = convert.params_from_numpy(as_numpy(P))
    tst = tsqp.init_solver_state(CFG, tP.x0, mass=tP.mass)
    U = tsqp.prep_warmstart(tst, tP, CFG)
    X = tsqp._rollout_X(tP.x0, U, tP, CFG)
    tqp = tcond.build(tprob.join_z(X, U), tP, CFG, 0.1, torch.tensor(
        np.asarray(w)), lam_soft=torch.zeros(len(TICKS), CFG.N + 1,
                                             dtype=torch.float64),
        soft=False, structured=True)
    for name in ("H", "g", "C", "d", "C_blk", "d_blk"):
        b = np.asarray(getattr(qp, name))
        np.testing.assert_allclose(getattr(tqp, name).numpy(), b, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def test_solve_mpc_on_recorded_ticks(x64):
    """Whole solves (3 SQP iterations x 8 IPM iterations) at 4 recorded
    ticks: z, r_prim and lyap_violation at 1e-8 absolute; the carried
    duals y (capped at 1e4) and r_dual at 1e-8 of their largest
    magnitude."""
    P, sc = walk_params()
    st = jax.vmap(lambda p: jsqp.init_solver_state(JCFG, p.x0,
                                                   mass=sc.mpc_mass))(P)
    jst, jinfo = jax.jit(jax.vmap(lambda s, p: jsqp.solve_mpc(s, p, JCFG)))(
        st, P)
    tP = convert.params_from_numpy(as_numpy(P))
    tst = convert.solver_state_from_numpy(as_numpy(st))
    nst, ninfo = tsqp.solve_mpc(tst, tP, CFG)
    got = {**nst._asdict(), **ninfo._asdict()}
    want = {**jst._asdict(), **jinfo._asdict()}
    for name in ("z", "y", "r_prim", "lyap_violation", "r_dual"):
        b = np.asarray(want[name])
        scale = max(1.0, np.abs(b).max()) if name in ("y", "r_dual") \
            else 1.0
        np.testing.assert_allclose(got[name].numpy(), b, rtol=0,
                                   atol=1e-8 * scale, err_msg=name)
    np.testing.assert_allclose(got["cost"].numpy(), np.asarray(
        want["cost"]), rtol=1e-10, atol=0, err_msg="cost")
