"""The port's IS-MPC baseline (models/lip, ops/kalman, ops/ismpc,
sim/ismpc_loop) against the JAX package in f64, and the three behaviour
tests of tests/test_ismpc.py repeated on the port.

The port is batch-first: the JAX functions take one robot, the port's a
leading batch axis.  The closed loop is compared at ``noise_std=0`` only:
with noise the two packages draw from different random streams
(``jax.random`` against a ``torch.Generator``) and cannot agree tick by
tick."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg
from cmpc_tpu.models import lip as jlip
from cmpc_tpu.ops import ismpc as jismpc, kalman as jkalman
from cmpc_tpu.sim import ismpc_loop as jloop
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.models import lip as tlip
from cmpc_tpu_torch.ops import ismpc as tismpc, kalman as tkalman
from cmpc_tpu_torch.sim import ismpc_loop as tloop

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(), JCfg()
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _icfg(mod, **kw):
    return mod.ISMPCConfig(eta=CFG.eta, g=CFG.g, foot_size=CFG.foot_size,
                           delta=CFG.world_time_step, **kw)


def test_lip_matrices_and_dynamics_match_jax(x64):
    for a, b in zip(tlip.lip_matrices(CFG.eta), jlip.lip_matrices(JCFG.eta)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    x, u = rng.normal(size=(5, 9)), rng.normal(size=(5, 3))
    got = tlip.lip_dynamics(torch.tensor(x), torch.tensor(u), CFG.eta, CFG.g)
    want = jax.vmap(lambda a, b: jlip.lip_dynamics(a, b, JCFG.eta, JCFG.g))(
        jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_kalman_predict_update_match_jax(x64):
    """Three predict/update rounds from a random SPD covariance, batch of
    4 against the JAX functions under vmap: the prediction (products only)
    at 1e-12, the update at 1e-10 (it solves with the innovation
    covariance, condition ~1e3 here, through two LAPACK front ends)."""
    rng = np.random.default_rng(1)
    jm = jkalman.lip_kalman_model(JCFG.eta, JCFG.world_time_step)
    tm = tkalman.lip_kalman_model(CFG.eta, CFG.world_time_step, **F64)
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    x = rng.normal(size=(4, 9))
    A = rng.normal(size=(4, 9, 9))
    P = A @ np.swapaxes(A, 1, 2) + np.eye(9)
    js = jkalman.KalmanState(x=jnp.asarray(x), P=jnp.asarray(P))
    ts = tkalman.KalmanState(x=torch.tensor(x), P=torch.tensor(P))
    for _ in range(3):
        u, z = rng.normal(size=(4, 3)), rng.normal(size=(4, 9))
        js = jax.vmap(lambda s, u_: jkalman.predict(jm, s, u_))(
            js, jnp.asarray(u))
        ts = tkalman.predict(tm, ts, torch.tensor(u))
        np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P), rtol=0,
                                   atol=1e-12)
        js = jax.vmap(lambda s, z_: jkalman.update(jm, s, z_))(
            js, jnp.asarray(z))
        ts = tkalman.update(tm, ts, torch.tensor(z))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P), rtol=0,
                                   atol=1e-10)


def test_ismpc_static_matches_jax():
    js = jismpc.build_static(_icfg(jismpc))
    ts = tismpc.build_static(_icfg(tismpc))
    for name in js._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)
        assert b.dtype == np.float32 and a.dtype == np.float32, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_ismpc_solve_matches_jax(x64):
    """Two chained solves (cold start, then warm) of a batch of 3 with
    moving ZMP boxes, against the JAX solve under vmap: 1e-9 on the
    iterate and the node-1 outputs (60 ADMM iterations of f64 products
    with a 1209 x 1212 constraint matrix taken in another order)."""
    jc, tc = _icfg(jismpc), _icfg(tismpc)
    rng = np.random.default_rng(2)
    B, N = 3, jc.N
    x0 = rng.normal(size=(B, 9)) * 0.01
    x0[:, 6] += CFG.h
    mc = [np.cumsum(rng.uniform(0, 2e-3, size=(B, N)), axis=1)
          for _ in range(2)] + [np.zeros((B, N))]
    jst = jax.vmap(lambda _: jismpc.init_state(jc))(jnp.arange(B))
    tst = tismpc.init_state(tc, B, **F64)
    jsolve = jax.jit(jax.vmap(
        lambda s, x, a, b, c: jismpc.solve(s, x, a, b, c, jc)))
    for k in range(2):
        jst, jout = jsolve(jst, jnp.asarray(x0), *map(jnp.asarray, mc))
        tst, tout = tismpc.solve(tst, torch.tensor(x0),
                                 *map(torch.tensor, mc), tc)
        np.testing.assert_allclose(tst.z.numpy(), np.asarray(jst.z), rtol=0,
                                   atol=1e-9, err_msg=f"z, solve {k}")
        np.testing.assert_allclose(tst.y.numpy(), np.asarray(jst.y), rtol=0,
                                   atol=1e-6, err_msg=f"y, solve {k}")
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-9)
        x0 = x0 + 1e-3


def test_moving_constraint_matches_jax(x64):
    """The table built once over absolute ticks, cut at tick t, against
    the JAX package's per-tick blend: 1e-12."""
    from cmpc_tpu.config import DEFAULT_FOOT_Y, default_vref
    from cmpc_tpu.plan import footsteps as jfs, timing as jtm
    jc, tc = _icfg(jismpc), _icfg(tismpc)
    timing = jtm.build_timing(JCFG)
    plan = jfs.plan_footsteps(jnp.asarray(default_vref(JCFG.num_steps)),
                              JCFG, timing, jnp.asarray(DEFAULT_FOOT_Y))
    ss, ds, start = (np.asarray(getattr(timing, k), np.float64)
                     for k in ("ss", "ds", "start"))
    table = tismpc.moving_constraint_table(
        torch.tensor(np.asarray(plan.pos))[None], ss, ds, start, (0.0, 0.0),
        700 + tc.N)
    for t in (0, 150, 290, 455, 700):
        want = jismpc.moving_constraint(t, plan.pos, ss, ds, start,
                                        jnp.zeros(2), jc)
        got = tismpc.moving_constraint(t, table, tc)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12, err_msg=f"tick {t}")


def test_ismpc_loop_matches_jax(x64):
    """60 ticks of the closed loop at noise_std=0 (the two packages' noise
    streams differ by nature), f64: every trace field and the final plant
    and filter state at 1e-8."""
    jcarry, jtr = jax.jit(lambda: jloop.run(T_sim=60, cfg=JCFG))()
    tcarry, ttr = tloop.run(T_sim=60, cfg=CFG, **F64)
    for name in jtr._fields:
        a = getattr(ttr, name)
        assert tuple(a.shape) == (1, 60, 3), name
        np.testing.assert_allclose(a[0].numpy(),
                                   np.asarray(getattr(jtr, name)), rtol=0,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_allclose(tcarry.x[0].numpy(), np.asarray(jcarry.x),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tcarry.kf.P[0].numpy(),
                               np.asarray(jcarry.kf.P), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tcarry.u_prev[0].numpy(),
                               np.asarray(jcarry.u_prev), rtol=0, atol=1e-6)


def test_ismpc_loop_noise_needs_a_generator_and_is_reproducible():
    with pytest.raises(ValueError, match="Generator"):
        tloop.run(T_sim=1, noise_std=1e-3, device="cpu")
    runs = []
    for _ in range(2):
        g = torch.Generator(device="cpu").manual_seed(5)
        runs.append(tloop.run(T_sim=3, noise_std=1e-3, generator=g, batch=2,
                              device="cpu")[1])
    assert torch.equal(runs[0].com_flt, runs[1].com_flt)
    # the two robots of the batch draw different noise
    assert not torch.equal(runs[0].com_flt[0], runs[0].com_flt[1])
    quiet = tloop.run(T_sim=3, batch=2, device="cpu")[1]
    assert not torch.equal(quiet.com_flt, runs[0].com_flt)


def test_ismpc_loop_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.run(T_sim=1)


def test_kalman_converges_on_lip():
    """Filtering a noiseless LIP trajectory must converge to the truth
    (tests/test_ismpc.py::test_kalman_converges_on_lip on the port)."""
    km = tkalman.lip_kalman_model(CFG.eta, CFG.world_time_step, device="cpu")
    x_true = torch.tensor([[0.01, 0.0, 0.0, 0.02, 0.0, 0.0, CFG.h, 0.0,
                            0.0]])
    x_est = torch.zeros(1, 9)
    x_est[0, 6] = CFG.h - 0.05
    s = tkalman.KalmanState(x=x_est, P=torch.eye(9)[None])
    u = torch.zeros(1, 3)
    for _ in range(100):
        x_true = x_true + CFG.world_time_step * tlip.lip_dynamics(
            x_true, u, CFG.eta, CFG.g)
        s = tkalman.predict(km, s, u)
        s = tkalman.update(km, s, x_true)
    np.testing.assert_allclose(s.x.numpy(), x_true.numpy(), atol=2e-3)


def test_ismpc_solver_keeps_zmp_in_box():
    """A single solve from rest: horizon ZMP must respect the moving box
    and the node-1 state must be finite/sane
    (tests/test_ismpc.py::test_ismpc_solver_keeps_zmp_in_box on the
    port)."""
    icfg = _icfg(tismpc, admm_iters=100)
    x0 = torch.zeros(1, 9)
    x0[0, 6] = CFG.h
    mc = (torch.zeros(1, icfg.N),) * 3
    st, (com_pos, _, _, _, u0) = tismpc.solve(
        tismpc.init_state(icfg, device="cpu"), x0, *mc, icfg)
    half = CFG.foot_size / 2.0
    nX = 9 * (icfg.N + 1)
    X = st.z[0].numpy()[:nX].reshape(icfg.N + 1, 9)
    assert np.all(np.abs(X[1:, 2]) <= half + 1e-2)   # zmp x in box
    assert np.all(np.abs(X[1:, 5]) <= half + 1e-2)   # zmp y in box
    assert np.isfinite(u0.numpy()).all()
    assert abs(float(com_pos[0, 2]) - CFG.h) < 0.05


def test_ismpc_closed_loop_walks():
    """500 ticks of the LIP closed loop: bounded ZMP-CoM offset, forward
    progress, no instability
    (tests/test_ismpc.py::test_ismpc_closed_loop_walks on the port, f32)."""
    _, tr = tloop.run(T_sim=500, cfg=WalkConfig(sqp_iters=1), device="cpu")
    com = tr.com_pos[0].numpy()
    zmp = tr.zmp_pos[0].numpy()
    assert com.shape == (500, 3) and np.isfinite(com).all()
    assert com[-1, 0] > 0.05                          # walks forward
    assert np.abs(com[:, 1]).max() < 0.15             # support corridor
    assert np.abs(com[:, :2] - zmp[:, :2]).max() < 0.2
    assert np.abs(com[:, 2] - CFG.h).max() < 0.02     # height holds
