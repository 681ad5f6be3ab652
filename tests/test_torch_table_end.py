"""The port past the end of the gait tables, against the JAX package, in f64.

The tables are ``cfg.pad_ticks`` (P) ticks long.  A loop may run past them
(a walk longer than P ticks, a sweep whose last chunk overruns): JAX's
gathers then clamp the index to the last row, and the port's loops, which
read the tables on the host, read them through ``plan/timing.at`` and
``clamp_index`` to the same effect.

* Every table the tick reads, read by the port's helper at ticks
  P - 2 ... P + 3, equals JAX's own gather of the same table at the same
  tick, exactly.
* feet_ref_at, pack_x0 and gather_params at those ticks match JAX's at
  1e-10.
* The centroidal loop, stepped tick by tick from a shared carried state
  (the JAX loop's initial carry, handed over through
  cmpc_tpu_torch.convert) over ticks P - 2 ... P + 1, matches JAX's at 1e-6
  in the plant state, the live plan and the solver residual.
* The whole-body loop (JAX's has no t0 or carry_in) steps across the end
  from its own initial carry: finite, and its com_ref past the end is the
  tables' last row.
* The 75-tick walk on a gait whose tables are 70 ticks long runs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import (WalkConfig as JCfg, nominal_scenario as jnom,
                             payload_scenario as jpay)
from cmpc_tpu.ocp import assemble as jasm
from cmpc_tpu.plan import swing as jsw
from cmpc_tpu.sim import closed_loop as jcl
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ocp import assemble as tasm
from cmpc_tpu_torch.plan import com_ref as tcr, footsteps as tfs
from cmpc_tpu_torch.plan import swing as tsw, timing as ttm
from cmpc_tpu_torch.rbd.urdf import load_hrp4
from cmpc_tpu_torch.sim import closed_loop as tcl, wholebody_loop

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(), JCfg()
P = CFG.pad_ticks
TICKS = range(P - 2, P + 4)
TOL_FN = 1e-10            # a function of the tick, as tests/test_torch_plan
TOL_LOOP = 1e-6           # a loop tick, as tests/test_torch_closed_loop

# every per-tick table of plan/timing that a loop tick reads
TICK_TABLES = ("step_idx", "t_in_step", "is_ds", "gamma_l", "gamma_r",
               "stance_from_table", "stance_left_idx", "stance_right_idx",
               "update_event", "adapt_target", "support_is_left")
# the per-step tables, read at the step index
STEP_TABLES = ("foot_is_left", "ss")
# the per-scenario reference tables, (B, P, k)
REF_TABLES = ("com.pos", "com.vel", "com.acc", "pose_ref_l", "pose_ref_r")


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _tick_table(timing, name):
    if name == "support_is_left":       # as both loops build it
        return timing.foot_is_left[timing.step_idx]
    return getattr(timing, name)


@pytest.mark.parametrize("name", TICK_TABLES)
def test_clamped_tick_table_read_equals_jax_gather(name):
    table = _tick_table(ttm.build_timing(CFG), name)
    assert len(table) == P
    for t in TICKS:
        got = ttm.at(table, t)
        want = np.asarray(jnp.asarray(table)[t])
        assert got == want, (name, t, got, want)


@pytest.mark.parametrize("name", STEP_TABLES)
def test_clamped_step_table_read_equals_jax_gather(name):
    table = getattr(ttm.build_timing(CFG), name)
    S = len(table)
    for s in range(S - 2, S + 4):
        assert ttm.at(table, s) == np.asarray(jnp.asarray(table)[s]), (name,
                                                                        s)


def _port_refs(b):
    timing = ttm.build_timing(CFG)
    plan = tfs.plan_footsteps(b.vref, CFG, timing, b.foot_y,
                              b.step_y_offset)
    pl, pr = tfs.contact_pose_refs(plan, timing)
    cref = tcr.build_com_ref(plan, CFG, timing, b.foot_y)
    return timing, plan, tasm.RefArrays(com=cref, pose_ref_l=pl,
                                        pose_ref_r=pr)


@pytest.mark.parametrize("name", REF_TABLES)
def test_clamped_ref_table_read_equals_jax_gather(x64, name):
    sc = nominal_scenario(CFG, device="cpu", dtype=torch.float64)
    _, _, refs = _port_refs(sc)
    table = refs
    for part in name.split("."):
        table = getattr(table, part)
    assert table.shape[1] == P
    jtable = jnp.asarray(table.numpy())
    for t in TICKS:
        np.testing.assert_array_equal(
            table[:, ttm.clamp_index(t, P)].numpy(),
            np.asarray(jtable[:, t]), err_msg=f"{name} at tick {t}")


def _jax_batch():
    """The nominal walk (its push over ticks 801-899) and the payload walk
    (box from tick 0), floats cast to f64."""
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.float64) if jnp.issubdtype(
            a.dtype, jnp.floating) else a
    return jax.tree.map(lambda *x: jnp.stack([cast(v) for v in x]),
                        jnom(JCFG), jpay(JCFG))


def _port_batch(b):
    return convert.scenario_from_numpy(
        {k: np.asarray(v) for k, v in b._asdict().items()})


@pytest.mark.parametrize("t", TICKS)
def test_tick_functions_past_the_end_match_jax(x64, t):
    """feet_ref_at, pack_x0 and gather_params at tick t, on a perturbed
    (adapted-looking) plan and random measured states."""
    from cmpc_tpu.plan import com_ref as jcr, footsteps as jfs
    from cmpc_tpu.plan import timing as jtm

    b = _jax_batch()
    jtiming = jtm.build_timing(JCFG)

    def plan_one(s):
        plan = jfs.plan_footsteps(s.vref, JCFG, jtiming, s.foot_y,
                                  s.step_y_offset)
        pl, pr = jfs.contact_pose_refs(plan, jtiming)
        cref = jcr.build_com_ref(plan, JCFG, jtiming, s.foot_y)
        return plan, jasm.RefArrays(com=cref, pose_ref_l=pl, pose_ref_r=pr)

    jplan, jrefs = jax.vmap(plan_one)(b)
    rng = np.random.default_rng(t)
    pos = np.asarray(jplan.pos) + rng.normal(size=jplan.pos.shape) * 0.01
    jplan = jplan._replace(pos=jnp.asarray(pos))
    st = [rng.normal(size=(2, 3)) for _ in range(4)]

    def jax_tick(p, r, fy, cp, cv, hw, th, k1, k2, m):
        feet = jsw.feet_ref_at(t, p, JCFG, jtiming, fy)
        x0 = jasm.pack_x0(cp, cv, hw, th, feet.pose_l, feet.pose_r, t, p, r,
                          jtiming, JCFG)
        return feet, jasm.gather_params(t, x0, r, jtiming, JCFG, k1, k2, m)

    jfeet, jparams = jax.vmap(jax_tick)(jplan, jrefs, b.foot_y, *st, b.k1,
                                        b.k2, b.mpc_mass)

    tsc = _port_batch(b)
    timing, plan, refs = _port_refs(tsc)
    plan = tfs.FootstepPlan(pos=torch.tensor(pos), yaw=plan.yaw)
    feet = tsw.feet_ref_at(t, plan, CFG, timing, tsc.foot_y)
    x0 = tasm.pack_x0(*map(torch.tensor, st), feet.pose_l, feet.pose_r, t,
                      plan, refs, timing, CFG)
    params = tasm.gather_params(t, x0, refs, timing, CFG, tsc.k1, tsc.k2,
                                tsc.mpc_mass)
    for got, want in ((feet, jfeet), (params, jparams)):
        for name in want._fields:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                rtol=0, atol=TOL_FN, err_msg=f"{name} at tick {t}")


def _numpy_carry(c):
    return {"plant": {k: np.asarray(v) for k, v in c.plant._asdict().items()},
            "plan_pos": np.asarray(c.plan_pos),
            "theta_hat": np.asarray(c.theta_hat),
            "solver": {k: np.asarray(v)
                       for k, v in c.solver._asdict().items()}}


def test_closed_loop_past_the_end_matches_jax(x64):
    """From the JAX loop's initial carry, both packages step one tick at a
    time over ticks P - 2 ... P + 1, each tick from the same carried state
    (the JAX one's)."""
    b = _jax_batch()
    carry = jax.vmap(lambda s: jcl.rollout(s, JCFG, return_tick=True)[0])(b)
    step = jax.jit(jax.vmap(
        lambda s, c, t0: jcl.rollout(s, JCFG, T_sim=1, t0=t0, carry_in=c),
        in_axes=(0, 0, None)))
    _, tick = tcl.rollout(_port_batch(b), CFG, return_tick=True)
    for t in range(P - 2, P + 2):
        tcarry, ttr = tick(convert.loop_carry_from_numpy(_numpy_carry(carry)),
                           t)
        carry, jtr = step(b, carry, t)
        got = {"r_prim": ttr.r_prim, "plan_pos": tcarry.plan_pos,
               "com_ref": ttr.com_ref, **tcarry.plant._asdict()}
        want = {"r_prim": jtr.r_prim[:, 0], "plan_pos": carry.plan_pos,
                "com_ref": jtr.com_ref[:, 0], **carry.plant._asdict()}
        for name, a in got.items():
            err = np.abs(a.numpy() - np.asarray(want[name])).max()
            assert err <= TOL_LOOP, f"{name} differs by {err:.3e} at tick {t}"
        assert np.isfinite(ttr.com_pos.numpy()).all()
        np.testing.assert_array_equal(ttr.adapted.numpy(),
                                      np.asarray(jtr.adapted[:, 0]))


def test_wholebody_loop_runs_past_the_end():
    """The whole-body loop from its initial carry over ticks P - 2 ... P + 1,
    f64: every trace field finite, com_ref past the end the last row."""
    model = load_hrp4(payload=False)
    sc = nominal_scenario(CFG, device="cpu", dtype=torch.float64)
    carry, _ = wholebody_loop.rollout(model, sc, CFG, return_tick=True)
    _, tr = wholebody_loop.rollout(model, sc, CFG, T_sim=4, t0=P - 2,
                                   carry_in=carry)
    for name in tr._fields:
        assert torch.isfinite(getattr(tr, name).double()).all(), name
    _, _, refs = _port_refs(sc)
    last = refs.com.pos[:, P - 1]
    assert torch.equal(tr.com_ref[:, 1], last)       # tick P - 1, in range
    assert torch.equal(tr.com_ref[:, 2], last)
    assert torch.equal(tr.com_ref[:, 3], last)


def test_short_gait_walk_runs_past_its_tables():
    """A 75-tick walk on a gait of 4 steps of 7 + 3 ticks, whose tables are
    70 ticks long (JAX's jitted rollout runs it; the port raised at tick 70
    before the clamped reads)."""
    cfg = WalkConfig(num_steps=4, ss_duration=7, ds_duration=3)
    assert cfg.pad_ticks == 70
    sc = nominal_scenario(cfg, device="cpu")
    _, tr = tcl.rollout(sc, cfg, T_sim=75)
    assert tr.com_pos.shape == (1, 75, 3)
    assert torch.isfinite(tr.com_pos).all()
