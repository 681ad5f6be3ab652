"""The port's whole-body layer against the JAX package's, in f64 on the
CPU: initial configuration, state estimation, ZMP estimate, the ID QP's
joint torques at the three contact gates, both contact models of the
plant, the whole-body tick stepped from the JAX rollout's carried state,
and the counterparts of tests/test_wholebody.py on the port alone."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg, nominal_scenario
from cmpc_tpu.ops.admm import ADMMSettings as JSettings
from cmpc_tpu.rbd import algorithms as jrbd, urdf as jurdf
from cmpc_tpu.sim import wholebody_loop as jwbl
from cmpc_tpu.wholebody import (inverse_dynamics as jwbid, plant as jplant,
                                setup as jsetup, state as jstate)
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.ops.admm import ADMMSettings
from cmpc_tpu_torch.rbd import algorithms as trbd, urdf as turdf
from cmpc_tpu_torch.runtime import trace as ttrace
from cmpc_tpu_torch.sim import wholebody_loop as twbl
from cmpc_tpu_torch.wholebody import (inverse_dynamics as twbid,
                                      plant as tplant, setup as tsetup,
                                      state as tstate)

torch.set_num_threads(1)

F64 = torch.float64
ID_KW = dict(iters=90, rho=10.0, pdas_rounds=2, rho_adapt=2)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def models():
    return jurdf.load_hrp4(), turdf.load_hrp4()


def tree_np(tree):
    """A (nested) NamedTuple of arrays or tensors as nested dicts of
    numpy."""
    if hasattr(tree, "_asdict"):
        return {k: tree_np(v) for k, v in tree._asdict().items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def to_jax(cls, d):
    """Nested dicts of numpy -> the JAX package's NamedTuple `cls`."""
    nested = {"q": jrbd.RobotQ, "plant": jplant.WBPlantState}
    return cls(**{k: (to_jax(nested[k], v) if k in nested and
                      isinstance(v, dict) else jnp.asarray(v))
                  for k, v in d.items()})


def perturbed_standing(tm, seed=0, batch=3, noise=1.0):
    """The half-sitting posture settled 1.2 mm, with seeded noise on the
    joints, the base and the velocities (port types, f64)."""
    rng = np.random.default_rng(seed)
    q = tsetup.initial_q(tm, settle=0.0012, batch=batch, dtype=F64)
    q = q._replace(
        qj=q.qj + noise * 0.02 * torch.tensor(rng.normal(
            size=(batch, tm.nj))),
        base_pos=q.base_pos + noise * 1e-3 * torch.tensor(rng.normal(
            size=(batch, 3))))
    qv = noise * 0.05 * torch.tensor(rng.normal(size=(batch, tm.nv)))
    return tplant.WBPlantState(q=q, qv=qv)


def t_desired(st, offset=0.0):
    """Hold the measured state (zero vel/acc targets); `offset` shifts the
    CoM and foot targets so that every task has an error."""
    z3, z6 = torch.zeros_like(st.com_pos), torch.zeros_like(st.pose_l)
    return twbid.WBDesired(
        pose_l=st.pose_l + offset, vel_l=z6, acc_l=z6,
        pose_r=st.pose_r - offset, vel_r=z6, acc_r=z6,
        com_pos=st.com_pos + offset, com_vel=z3, com_acc=z3 + offset,
        torso_rotvec=st.torso_rotvec, torso_omega=z3, torso_alpha=z3,
        base_rotvec=st.base_rotvec, base_omega=z3, base_alpha=z3,
        joint_pos=st.joint_pos)


def close(t, j, atol=1e-10, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol,
                               **kw)


# ------------------------------------------------------------ setup, state

@pytest.mark.parametrize("payload", [False, True])
def test_initial_configuration(payload):
    jm, tm = jurdf.load_hrp4(payload), turdf.load_hrp4(payload)
    np.testing.assert_array_equal(tsetup.initial_qj(tm),
                                  jsetup.initial_qj(jm))
    jq = jsetup.initial_q(jm, settle=0.0012)
    tq = tsetup.initial_q(tm, settle=0.0012, batch=2, dtype=F64)
    for name in jq._fields:
        for row in getattr(tq, name):
            close(row, getattr(jq, name), atol=1e-13, err_msg=name)


def test_retrieve_state(models):
    jm, tm = models
    ps = perturbed_standing(tm, seed=1, batch=4, noise=5.0)
    want = jax.vmap(lambda p: jstate.retrieve_state(jm, p.q, p.qv))(
        to_jax(jplant.WBPlantState, tree_np(ps)))
    got = tstate.retrieve_state(tm, ps.q, ps.qv)
    assert got._fields == want._fields
    for name in want._fields:
        close(getattr(got, name), getattr(want, name), err_msg=name)


def _zmp_cases():
    m, g, h = 40.05, 9.81, 0.72
    pts = [[dx, fy + dy, 0.0] for fy in (0.1, -0.1)
           for dx, dy in ((0.125, 0.065), (0.125, -0.065),
                          (-0.125, -0.065), (-0.125, 0.065))]
    ds = (np.array(pts), np.tile([0.0, 0.0, m * g / 8.0], (8, 1)), None)
    lost = (np.zeros((8, 3)), np.zeros((8, 3)), np.array([0.03, -0.01, 0.0]))
    p_ss = np.zeros((8, 3))
    p_ss[0, 1], p_ss[1, 1] = 0.1, -0.1
    f_ss = np.zeros((8, 3))
    f_ss[0, 2], f_ss[1, 2] = 300.0, 100.0
    return {"double_support": ds, "contact_loss": lost,
            "single_support_weighted": (p_ss, f_ss, None)}


@pytest.mark.parametrize("case", ["double_support", "contact_loss",
                                  "single_support_weighted"])
def test_zmp_estimate(case):
    """The three cases of tests/test_scenarios.py, as one batch row each
    beside a row with tangential forces: equal to the JAX function at
    1e-12, and the case's own expectation."""
    pts, forces, prev = _zmp_cases()[case]
    rng = np.random.default_rng(0)
    pts_b = np.stack([pts, pts + rng.normal(size=pts.shape) * 0.01])
    f_b = np.stack([forces, forces + np.abs(rng.normal(size=forces.shape))])
    com = np.array([[0.0, 0.0, 0.72], [0.01, -0.02, 0.7]])
    lfoot = np.array([[0.0, 0.1, 0.0], [0.02, 0.1, 0.0]])
    prev_b = None if prev is None else np.stack([prev, prev * 2])
    want = jax.vmap(lambda p, f, c, lf, pv: jstate.zmp_estimate(
        p, f, c, lf, 40.05, 9.81, 0.72, prev_zmp=pv),
        in_axes=(0, 0, 0, 0, None if prev is None else 0))(
        jnp.asarray(pts_b), jnp.asarray(f_b), jnp.asarray(com),
        jnp.asarray(lfoot), None if prev is None else jnp.asarray(prev_b))
    got = tstate.zmp_estimate(
        torch.tensor(pts_b), torch.tensor(f_b), torch.tensor(com),
        torch.tensor(lfoot), 40.05, 9.81, 0.72,
        prev_zmp=None if prev is None else torch.tensor(prev_b))
    close(got, want, atol=1e-12)
    zmp = got[0].numpy()
    if case == "double_support":
        assert np.abs(zmp).max() < 1e-5
    elif case == "contact_loss":
        assert np.allclose(zmp, prev)
    else:
        assert 0.02 < zmp[1] < 0.08


# ------------------------------------------------------------- ID torques

def test_joint_torques_at_contact_gates(models):
    """Gates (1,1), (1,0), (0,1) as the rows of one batch, from perturbed
    states with task errors, at the whole-body loop's ID settings: torques
    (up to ~1e2 N m) at 1e-7 absolute, the QP solution at 1e-7."""
    jm, tm = models
    ps = perturbed_standing(tm, seed=2, batch=3)
    st = tstate.retrieve_state(tm, ps.q, ps.qv)
    des = t_desired(st, offset=0.003)
    gl = np.array([1.0, 1.0, 0.0])
    gr = np.array([1.0, 0.0, 1.0])
    jst = to_jax(jstate.WBState, tree_np(st))
    jdes = to_jax(jwbid.WBDesired, tree_np(des))
    jps = to_jax(jplant.WBPlantState, tree_np(ps))
    jtau, jres = jax.jit(jax.vmap(
        lambda p, d, s, a, b: jwbid.joint_torques(
            jm, p.q, p.qv, d, s, contact_l=a, contact_r=b,
            settings=JSettings(**ID_KW))))(
        jps, jdes, jst, jnp.asarray(gl), jnp.asarray(gr))
    ttau, tres = twbid.joint_torques(
        tm, ps.q, ps.qv, convert.wb_desired_from_numpy(tree_np(des)), st,
        contact_l=torch.tensor(gl), contact_r=torch.tensor(gr),
        settings=ADMMSettings(**ID_KW))
    assert ttau.shape == (3, tm.nj)
    close(ttau, jtau, atol=1e-7)
    close(tres.x, jres.x, atol=1e-7)
    close(tres.r_prim, jres.r_prim, atol=1e-9)
    # a gate shared by the batch may be a plain number
    tau_f, _ = twbid.joint_torques(tm, ps.q, ps.qv, des, st, contact_l=1.0,
                                   contact_r=1.0,
                                   settings=ADMMSettings(**ID_KW))
    assert torch.equal(tau_f[0], ttau[0])
    # swing-foot forces are gated out of the dynamics row
    assert float(np.abs(np.asarray(jres.x)[0, 60:]).max()) > 1.0


def test_redundant_selection(models):
    jm, tm = models
    np.testing.assert_array_equal(
        twbid.redundant_selection(tm, dtype=F64).numpy(),
        np.asarray(jwbid.redundant_selection(jm)))
    tp = turdf.load_hrp4(payload=True)
    assert twbid.redundant_selection(tp).diagonal().sum() < 10


# ------------------------------------------------------------------ plant

@pytest.mark.parametrize("contact_model", ["impulse", "penalty"])
def test_wb_plant_step(models, contact_model):
    """One control tick of 3 substeps under a torque, a push and a base
    torque, from states in contact (the settled posture) and in the air:
    q and qv at 1e-9 (the 30x30 solves amplify last-bit differences),
    contact points and forces at 1e-7."""
    jm, tm = models
    ps = perturbed_standing(tm, seed=4, batch=3)
    lift = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -0.002],
                         [0.0, 0.0, 0.05]], dtype=F64)
    ps = ps._replace(q=ps.q._replace(base_pos=ps.q.base_pos + lift))
    rng = np.random.default_rng(4)
    tau = rng.normal(size=(3, tm.nj)) * 3.0
    ext_f = rng.normal(size=(3, 3)) * 5.0
    ext_t = rng.normal(size=(3, 3))
    want, (jpts, jfc) = jax.jit(jax.vmap(
        lambda p, t, f, m: jplant.wb_plant_step(
            jm, p, t, ext_force=f, ext_torque=m, substeps=3,
            contact_model=contact_model, return_contacts=True)))(
        to_jax(jplant.WBPlantState, tree_np(ps)), jnp.asarray(tau),
        jnp.asarray(ext_f), jnp.asarray(ext_t))
    got, (tpts, tfc) = tplant.wb_plant_step(
        tm, ps, torch.tensor(tau), ext_force=torch.tensor(ext_f),
        ext_torque=torch.tensor(ext_t), substeps=3,
        contact_model=contact_model, return_contacts=True)
    close(got.qv, want.qv, atol=1e-9)
    for name in want.q._fields:
        close(getattr(got.q, name), getattr(want.q, name), atol=1e-9,
              err_msg=name)
    close(tpts, jpts, atol=1e-7)
    close(tfc, jfc, atol=1e-7)
    if contact_model == "impulse":
        assert float(tfc[0, :, 2].sum()) > 1.0       # touching: pushed up
        assert float(tfc[2].abs().max()) == 0.0      # in the air: no force
    # without return_contacts only the state comes back
    only = tplant.wb_plant_step(tm, ps, torch.tensor(tau), substeps=1,
                                contact_model=contact_model)
    assert isinstance(only, tplant.WBPlantState)


def test_plant_rejects_unknown_contact_model(models):
    _, tm = models
    ps = perturbed_standing(tm, batch=1)
    with pytest.raises(ValueError):
        tplant.wb_plant_step(tm, ps, torch.zeros(1, tm.nj, dtype=F64),
                             contact_model="lcp")


def test_contact_params_and_corners_match():
    assert tuple(tplant.ContactParams()) == tuple(jplant.ContactParams())
    close(tplant.foot_corner_offsets(dtype=F64),
          jplant.foot_corner_offsets(), atol=0)


# ----------------------------- tests/test_wholebody.py, on the port alone

def standing_state(tm, batch=1):
    return perturbed_standing(tm, batch=batch, noise=0.0)


def test_id_standing_torques_sane(models):
    _, tm = models
    ps = standing_state(tm)
    st = tstate.retrieve_state(tm, ps.q, ps.qv)
    tau, res = twbid.joint_torques(tm, ps.q, ps.qv, t_desired(st), st,
                                   contact_l=1.0, contact_r=1.0)
    assert tau.shape == (1, tm.nj)
    assert torch.isfinite(tau).all()
    assert float(tau.abs().max()) < 150.0
    assert float(res.r_prim) < 1e-2


def test_standing_balance_closed_loop(models):
    """ID + plant keep the robot standing for 50 control ticks: CoM height
    within 2 cm, no drift blow-up, base upright."""
    _, tm = models
    ps = standing_state(tm)
    st0 = tstate.retrieve_state(tm, ps.q, ps.qv)
    desired = t_desired(st0)
    for _ in range(50):
        st = tstate.retrieve_state(tm, ps.q, ps.qv)
        tau, _ = twbid.joint_torques(tm, ps.q, ps.qv, desired, st,
                                     contact_l=1.0, contact_r=1.0)
        ps = tplant.wb_plant_step(tm, ps, tau)
    st = tstate.retrieve_state(tm, ps.q, ps.qv)
    d = (st.com_pos - st0.com_pos)[0].numpy()
    assert torch.isfinite(ps.qv).all()
    assert abs(d[2]) < 0.02
    assert np.linalg.norm(d[:2]) < 0.03
    assert float(torch.linalg.vector_norm(st.base_rotvec)) < 0.15


def test_plant_drop_settles(models):
    """Drop from 5 mm with zero torque: the feet make contact and the
    robot does not fall through."""
    _, tm = models
    q = tsetup.initial_q(tm, dtype=F64)
    q = q._replace(base_pos=q.base_pos + torch.tensor([0.0, 0.0, 0.005]))
    ps = tplant.WBPlantState(q=q, qv=torch.zeros(1, tm.nv, dtype=F64))
    for _ in range(30):
        ps = tplant.wb_plant_step(tm, ps, torch.zeros(1, tm.nj, dtype=F64))
    _, pl = trbd.site_pose(tm, trbd.fk(tm, ps.q), "l_sole")
    assert torch.isfinite(ps.qv).all()
    assert -0.02 < float(pl[0, 2]) < 0.02


def test_id_batches(models):
    """The ID solve over a batch of differing robots; the permuted batch
    gives bitwise the same rows (f64 on the CPU)."""
    _, tm = models
    ps = standing_state(tm, batch=3)
    ps = ps._replace(q=ps.q._replace(
        qj=ps.q.qj + 0.001 * torch.arange(3, dtype=F64)[:, None]))
    st0 = tstate.retrieve_state(tm, trbd.RobotQ(*(x[:1] for x in ps.q)),
                                ps.qv[:1])
    desired = twbid.WBDesired(*(x.expand(3, -1) for x in t_desired(st0)))
    st = tstate.retrieve_state(tm, ps.q, ps.qv)
    taus, _ = twbid.joint_torques(tm, ps.q, ps.qv, desired, st,
                                  contact_l=1.0, contact_r=1.0)
    assert taus.shape == (3, tm.nj) and torch.isfinite(taus).all()
    perm = torch.tensor([2, 0, 1])

    def shuffled(tree):
        return type(tree)(*(x[perm] for x in tree))

    taus_p, _ = twbid.joint_torques(tm, shuffled(ps.q), ps.qv[perm],
                                    shuffled(desired), shuffled(st),
                                    contact_l=1.0, contact_r=1.0)
    assert torch.equal(taus_p, taus[perm])
    assert not torch.equal(taus[0], taus[1])


# --------------------------------------------------- the slice as a whole

def _wb_scenarios():
    """Two scenarios: a push over ticks 2-3, and a 2 kg payload dropped at
    tick 3 under the payload gains."""
    jcfg = JCfg()
    a = nominal_scenario(jcfg, push=(4.0, 9.0, 0.0), push_window=(1, 4))
    a = a._replace(push_torque=jnp.asarray([0.5, -0.3, 0.2]))
    b = nominal_scenario(jcfg, push=(0.0, 0.0, 0.0), push_window=(0, 0))
    b = b._replace(k1=jnp.asarray(7.0), k2=jnp.asarray(1.0),
                   payload_mass=jnp.asarray(2.0),
                   payload_onset=jnp.asarray(3),
                   payload_impact_vel=jnp.asarray(1.4))

    def f64(x):
        x = jnp.asarray(x)
        return x.astype(jnp.float64) if jnp.issubdtype(
            x.dtype, jnp.floating) else x

    return jax.tree.map(lambda x, y: jnp.stack([f64(x), f64(y)]), a, b)


@pytest.fixture(scope="module")
def jax_wb_chunks(models):
    """The JAX rollout to 2, 4 and 6 ticks: (carry, trace) each."""
    jm, _ = models
    sc = _wb_scenarios()
    out = {}
    for T in (2, 4, 6):
        out[T] = jax.jit(jax.vmap(lambda s: jwbl.rollout(
            jm, s, JCfg(), T_sim=T)))(sc)
    return sc, out


@pytest.mark.parametrize("t0", [0, 2, 4])
def test_wholebody_ticks_from_jax_carry(models, jax_wb_chunks, t0):
    """Two whole-body ticks (MPC -> ID QP -> 10 impulse substeps) from the
    JAX rollout's carried state at tick t0, against the JAX rollout's next
    two ticks.  The window holds a push with a torque (ticks 2-3) and a
    payload onset with its impact (tick 3).  Trace and carried state at
    1e-6 absolute (torques and ZMP at 1e-5: the ID QP's duals of ~1e2
    feed them); the solver's duals at 1e-6 of their largest."""
    _, tm = models
    sc, chunks = jax_wb_chunks
    tsc = convert.scenario_from_numpy(tree_np(sc))
    cfg = WalkConfig()
    carry_in = None
    if t0:
        d = tree_np(chunks[t0][0])
        d["plant"] = tree_np(chunks[t0][0].plant)
        carry_in = convert.wb_carry_from_numpy(d)
    carry, tr = twbl.rollout(tm, tsc, cfg, T_sim=2, t0=t0,
                             carry_in=carry_in)
    jcarry, jtr = chunks[t0 + 2]
    for name in jtr._fields:
        want = np.asarray(getattr(jtr, name))[:, t0:t0 + 2]
        got = getattr(tr, name).numpy()
        if name == "adapted":
            np.testing.assert_array_equal(got, want)
            continue
        atol = 1e-5 if name in ("tau", "zmp") else 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
    got, want = tree_np(carry), tree_np(jcarry)
    for name in ("plan_pos", "theta_hat", "zmp", "hw_model", "hw_filt"):
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=1e-5 if name == "zmp" else 1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(got["plant"]["qv"], want["plant"]["qv"],
                               rtol=0, atol=1e-6)
    for name in ("base_pos", "base_rot", "qj"):
        np.testing.assert_allclose(got["plant"]["q"][name],
                                   want["plant"]["q"][name], rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got["solver"]["z"], want["solver"]["z"],
                               rtol=0, atol=1e-6)
    ymax = max(1.0, np.abs(want["solver"]["y"]).max())
    np.testing.assert_allclose(got["solver"]["y"], want["solver"]["y"],
                               rtol=0, atol=1e-6 * ymax)
    if t0 == 2:
        # the push and the payload really acted inside this window
        assert np.abs(got["plant"]["qv"][0] - got["plant"]["qv"][1]).max() \
            > 1e-3


def test_rollout_knobs_and_manual_stepping(models):
    """return_tick steps the loop by hand and equals the rollout bitwise;
    the hw_feedback modes and the ID overrides run; an unknown mode
    raises."""
    _, tm = models
    cfg = WalkConfig()
    tsc = convert.scenario_from_numpy(tree_np(_wb_scenarios()))
    carry, tr = twbl.rollout(tm, tsc, cfg, T_sim=2)
    c, tick = twbl.rollout(tm, tsc, cfg, return_tick=True)
    for t in range(2):
        c, row = tick(c, t)
    assert torch.equal(c.plant.qv, carry.plant.qv)
    assert torch.equal(row.tau, tr.tau[:, 1])
    assert tr.com_pos.shape == (2, 2, 3) and tr.tau.shape == (2, 2, tm.nj)
    for mode in ("model", "filtered"):
        _, tr_m = twbl.rollout(tm, tsc, cfg, T_sim=2, hw_feedback=mode,
                               hw_feedback_scale=0.5, substeps=2,
                               id_weights={"com": 2.0},
                               id_pos_gains={"com": 6.0},
                               id_vel_gains={"com": 9.0})
        assert torch.isfinite(tr_m.tau).all()
        assert not torch.equal(tr_m.tau, tr.tau)
    with pytest.raises(KeyError):
        twbl.rollout(tm, tsc, cfg, T_sim=1, hw_feedback="none")


# ----------------------------------------------------- trace and the CLI

def test_summarize_on_wb_trace_and_missing_residual(models, tmp_path):
    """summarize falls back to r_prim_mpc (the whole-body trace's name),
    as the JAX package's does, and says so when neither is there."""
    from cmpc_tpu.runtime import trace as jtrace
    _, tm = models
    tsc = convert.scenario_from_numpy(tree_np(_wb_scenarios()))
    _, tr = twbl.rollout(tm, tsc, WalkConfig(), T_sim=3)
    row0 = {k: v[0] for k, v in tr._asdict().items()}
    got = ttrace.summarize(row0)
    want = jtrace.summarize({k: v.numpy() for k, v in row0.items()})
    assert got == want
    assert got.ticks == 3 and not got.fell
    assert got.r_prim_p50 == float(np.percentile(row0["r_prim_mpc"].numpy(),
                                                 50))
    ttrace.save(str(tmp_path / "wb.npz"), tr, meta={"cmd": "walk-wb"})
    with np.load(tmp_path / "wb.npz") as z:
        assert set(z.files) == set(twbl.WBTrace._fields)
        assert z["tau"].shape == (2, 3, tm.nj)
    del row0["r_prim_mpc"]
    with pytest.raises(KeyError, match="neither 'r_prim' nor 'r_prim_mpc'"):
        ttrace.summarize(row0)
    with pytest.raises(KeyError, match="neither 'r_prim' nor 'r_prim_mpc'"):
        jtrace.summarize({k: v.numpy() for k, v in row0.items()})


def test_envelope_tool_reads_a_saved_trace(tmp_path):
    """tools/wholebody_envelope_torch.py on a synthetic 300-tick trace in
    the port's (B, T, ...) layout: the figures are those of the arrays."""
    import os
    import subprocess
    import sys
    T = 300
    t = np.arange(T, dtype=np.float64)
    com = np.stack([0.001 * t, 0.002 * np.sin(t / 50), 0.72 - 1e-5 * t], 1)
    ref = np.stack([0.001 * t, np.zeros(T), np.full(T, 0.72)], 1)
    pose_r = np.zeros((T, 6))
    pose_r[200:270, 5] = 0.02 * np.sin(np.pi * (t[200:270] - 200) / 70)
    tr = dict(com_pos=com, com_ref=ref, pose_r=pose_r,
              pose_l=np.zeros((T, 6)), r_prim_id=np.full(T, 3e-5))
    np.savez(tmp_path / "trace.npz", **{k: v[None] for k, v in tr.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tools",
                                      "wholebody_envelope_torch.py"),
         "--trace", str(tmp_path / "trace.npz")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    fig = json.loads(out.stdout.strip().splitlines()[-1])
    assert fig["ticks"] == T
    assert fig["err_xy_to_tick_270"] == pytest.approx(
        np.abs(com[:271, 1]).max(), abs=1e-12)
    assert fig["com_z_dev_max"] == pytest.approx(299e-5, abs=1e-12)
    assert fig["right_sole_apex_200_269"] == pytest.approx(
        pose_r[:, 5].max(), abs=1e-12)
    assert fig["progress_from_150"] == pytest.approx(0.149, abs=1e-12)
    assert set(fig["bounds"]) <= set(fig)


def test_cli_walk_wb_cpu(tmp_path, capsys):
    from cmpc_tpu_torch import __main__ as cli
    cli.main(["walk-wb", "--device", "cpu", "--ticks", "3", "--out",
              str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ticks"] == 3 and out["device"] == "cpu"
    assert out["com_max_err_xy"] < 0.01 and not out["fell"]
    assert (tmp_path / "trace.npz").exists()
    meta = json.loads((tmp_path / "trace.npz.json").read_text())
    assert meta["cmd"] == "walk-wb"


def test_cli_walk_wb_without_card_raises(monkeypatch):
    from cmpc_tpu_torch import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["walk-wb", "--ticks", "1"])
