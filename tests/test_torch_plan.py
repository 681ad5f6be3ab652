"""Planner, per-tick assembly and plant of the PyTorch port against the JAX
package, in f64 at 1e-10: footstep plan, contact references, swing-foot
references (including the f32 polynomial factors the JAX package computes
even under x64), the CoM spline, pack_x0 / gather_params and plant_step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg, nominal_scenario
from cmpc_tpu.models import centroidal as jcm
from cmpc_tpu.ocp import assemble as jasm
from cmpc_tpu.plan import com_ref as jcr, footsteps as jfs, swing as jsw
from cmpc_tpu.plan import timing as jtm
from cmpc_tpu.sim import plant as jplant
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.models import centroidal as tcm
from cmpc_tpu_torch.ocp import assemble as tasm
from cmpc_tpu_torch.plan import com_ref as tcr, footsteps as tfs
from cmpc_tpu_torch.plan import swing as tsw, timing as ttm
from cmpc_tpu_torch.sim import plant as tplant

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(), JCfg()
TOL = 1e-10


@pytest.fixture(autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def batch_scenarios():
    """Nominal, and a turning variant with other foot offsets."""
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.float64) if jnp.issubdtype(
            a.dtype, jnp.floating) else a
    sc = jax.tree.map(cast, nominal_scenario(JCFG))
    b = jax.tree.map(lambda x: jnp.stack([x, x]), sc)
    vref = np.asarray(b.vref).copy()
    vref[1, 5:12, 2] = 0.1
    vref[1, :, 1] = 0.02
    return b._replace(vref=jnp.asarray(vref),
                      foot_y=jnp.asarray([b.foot_y[0], 0.095]),
                      step_y_offset=jnp.asarray([0.1, 0.12]))


def planned(b):
    """JAX plan, refs and CoM reference for a scenario batch."""
    timing = jtm.build_timing(JCFG)

    def one(s):
        plan = jfs.plan_footsteps(s.vref, JCFG, timing, s.foot_y,
                                  s.step_y_offset)
        pl, pr = jfs.contact_pose_refs(plan, timing)
        cref = jcr.build_com_ref(plan, JCFG, timing, s.foot_y)
        return plan, jasm.RefArrays(com=cref, pose_ref_l=pl, pose_ref_r=pr)

    return timing, jax.jit(jax.vmap(one))(b)


def port_planned(b):
    timing = ttm.build_timing(CFG)
    tsc = convert.scenario_from_numpy(
        {k: np.asarray(v) for k, v in b._asdict().items()})
    plan = tfs.plan_footsteps(tsc.vref, CFG, timing, tsc.foot_y,
                              tsc.step_y_offset)
    pl, pr = tfs.contact_pose_refs(plan, timing)
    cref = tcr.build_com_ref(plan, CFG, timing, tsc.foot_y)
    return timing, tsc, plan, tasm.RefArrays(com=cref, pose_ref_l=pl,
                                             pose_ref_r=pr)


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)


def test_plan_refs_and_com_spline():
    b = batch_scenarios()
    _, (jplan, jrefs) = planned(b)
    _, _, plan, refs = port_planned(b)
    close(plan.pos, jplan.pos)
    close(plan.yaw, jplan.yaw)
    close(refs.pose_ref_l, jrefs.pose_ref_l)
    close(refs.pose_ref_r, jrefs.pose_ref_r)
    for name in ("pos", "vel", "acc"):
        close(getattr(refs.com, name), getattr(jrefs.com, name))
    lp, rp = tfs.initial_feet_poses(torch.tensor([0.1, 0.09],
                                                 dtype=torch.float64))
    jl, jr = jfs.initial_feet_poses(jnp.asarray(0.09))
    close(lp[1], jl)
    close(rp[1], jr)


def test_feet_ref_every_tick():
    """feet_ref_at over every tick of the padded tables, on the (adapted-
    looking) perturbed plan, including the f32 swing-polynomial factors."""
    b = batch_scenarios()
    timing, (jplan, _) = planned(b)
    rng = np.random.default_rng(0)
    pos = np.asarray(jplan.pos) + rng.normal(size=jplan.pos.shape) * 0.01
    jplan = jplan._replace(pos=jnp.asarray(pos))
    ticks = np.arange(JCFG.pad_ticks)
    jf = jax.jit(jax.vmap(lambda p, fy: jax.vmap(
        lambda t: jsw.feet_ref_at(t, p, JCFG, timing, fy))(ticks)))(
        jplan, b.foot_y)
    tplan = tfs.FootstepPlan(pos=torch.tensor(pos),
                             yaw=torch.tensor(np.asarray(jplan.yaw)))
    ttiming = ttm.build_timing(CFG)
    fy = torch.tensor(np.asarray(b.foot_y))
    got = [tsw.feet_ref_at(int(t), tplan, CFG, ttiming, fy) for t in ticks]
    for name in jf._fields:
        t = torch.stack([getattr(g, name) for g in got], dim=1)
        close(t, getattr(jf, name))


def test_pack_x0_and_gather_params():
    b = batch_scenarios()
    timing, (jplan, jrefs) = planned(b)
    ttiming, tsc, plan, refs = port_planned(b)
    rng = np.random.default_rng(1)
    ticks = sorted(set(range(0, 700, 7)) | {199, 200, 201, 262, 269, 270,
                                             JCFG.pad_ticks - 1})

    @jax.jit
    def jax_tick(t, cp, cv, hw, th, pl, pr, plan, refs):
        def one(cp, cv, hw, th, pl, pr, plan, refs, k1, k2, m):
            x0 = jasm.pack_x0(cp, cv, hw, th, pl, pr, t, plan, refs, timing,
                              JCFG)
            return jasm.gather_params(t, x0, refs, timing, JCFG, k1, k2, m)
        return jax.vmap(one)(cp, cv, hw, th, pl, pr, plan, refs, b.k1, b.k2,
                             b.mpc_mass)

    for t in ticks:
        st = [rng.normal(size=(2, 3)) for _ in range(4)]
        pl, pr = rng.normal(size=(2, 6)), rng.normal(size=(2, 6))
        jp = jax_tick(t, *st, pl, pr, jplan, jrefs)
        x0 = tasm.pack_x0(*map(torch.tensor, st), torch.tensor(pl),
                          torch.tensor(pr), t, plan, refs, ttiming, CFG)
        tp = tasm.gather_params(t, x0, refs, ttiming, CFG, tsc.k1, tsc.k2,
                                tsc.mpc_mass)
        for name in jp._fields:
            close(getattr(tp, name), getattr(jp, name))

    # per-scenario ticks (the bench's replay of recorded states)
    tk = np.array([150, 263])
    x0 = rng.normal(size=(2, 20))
    jp = jax.vmap(lambda t, x, r, k1, k2, m: jasm.gather_params(
        t, x, r, timing, JCFG, k1, k2, m))(jnp.asarray(tk), jnp.asarray(x0),
                                           jrefs, b.k1, b.k2, b.mpc_mass)
    tp = tasm.gather_params(torch.tensor(tk), torch.tensor(x0), refs,
                            ttiming, CFG, tsc.k1, tsc.k2, tsc.mpc_mass)
    for name in jp._fields:
        close(getattr(tp, name), getattr(jp, name))


@pytest.mark.parametrize("gates", [(1.0, 1.0), (1.0, 0.0), (0.0, 1.0)])
def test_plant_step(gates):
    rng = np.random.default_rng(2)
    Bn = 3
    cp = rng.normal(size=(Bn, 3)) * 0.05 + [0.0, 0.0, 0.72]
    args = dict(
        com_des_pos=cp + rng.normal(size=(Bn, 3)) * 0.01,
        com_des_vel=rng.normal(size=(Bn, 3)) * 0.1,
        com_des_acc=rng.normal(size=(Bn, 3)),
        u0=rng.normal(size=(Bn, 32)),
        pose_l=np.concatenate([rng.normal(size=(Bn, 3)) * 0.1,
                               rng.normal(size=(Bn, 3)) * 0.1], 1),
        pose_r=np.concatenate([rng.normal(size=(Bn, 3)) * 0.1,
                               rng.normal(size=(Bn, 3)) * 0.1], 1),
        mpc_mass=np.full(Bn, 40.05), plant_mass=rng.uniform(40, 43, Bn),
        ext_force=rng.normal(size=(Bn, 3)) * 3,
        ext_torque=rng.normal(size=(Bn, 3)) * 0.1)
    ps = dict(com_pos=cp, com_vel=rng.normal(size=(Bn, 3)) * 0.1,
              hw=rng.normal(size=(Bn, 3)))
    gl, gr = gates
    kw = dict(hw_compliance=CFG.plant_hw_compliance,
              hw_shed=CFG.plant_hw_shed)
    poly_j = jcm.foot_polygon(CFG.foot_length, CFG.foot_width)
    j = jax.vmap(lambda s, a: jplant.plant_step(
        jplant.PlantState(**s), a["com_des_pos"], a["com_des_vel"],
        a["com_des_acc"], a["u0"], gl, gr, a["pose_l"], a["pose_r"],
        a["mpc_mass"], a["plant_mass"], a["ext_force"], a["ext_torque"],
        CFG.g, poly_j, CFG.world_time_step, **kw))(
        {k: jnp.asarray(v) for k, v in ps.items()},
        {k: jnp.asarray(v) for k, v in args.items()})
    ta = {k: torch.tensor(v) for k, v in args.items()}
    poly_t = tcm.foot_polygon(CFG.foot_length, CFG.foot_width,
                              dtype=torch.float64)
    t = tplant.plant_step(
        tplant.PlantState(**{k: torch.tensor(v) for k, v in ps.items()}),
        ta["com_des_pos"], ta["com_des_vel"], ta["com_des_acc"], ta["u0"],
        gl, gr, ta["pose_l"], ta["pose_r"], ta["mpc_mass"],
        ta["plant_mass"], ta["ext_force"], ta["ext_torque"], CFG.g, poly_t,
        CFG.world_time_step, **kw)
    for name in j._fields:
        close(getattr(t, name), getattr(j, name))
