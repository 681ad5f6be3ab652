"""The port's f64 NLP oracle (cmpc_tpu_torch.ops.oracle: scipy SLSQP on
the exact ocp.problem cost and constraints) against the JAX package's
(cmpc_tpu.ops.oracle), on the CPU.

Inputs are built once with the JAX planner from the recorded production
walk (assets/walk_x0.npz), in f64, and fed to both packages: the port's
parameters through convert.params_from_numpy.

Both packages hand SLSQP the same functions to ~1e-16 relative (the
gradients are equal bit for bit), so SLSQP takes the same path until the
last bits part it.  Where the NLP's optimum is flat (the long initial
double support, whose cost is ~1e-4 of the starting cost) the two runs
stop at different points of that flat set: the z of the two packages
part by up to 2e-2 at tick 150, with costs 3.4e-6 apart (relative).  There only the
costs are compared; at tick 300 (single support, a unique optimum) z is
compared too.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from cmpc_tpu.config import WalkConfig as JCfg, nominal_scenario
from cmpc_tpu.models import centroidal as jcm
from cmpc_tpu.ocp import assemble as jasm, problem as jprob
from cmpc_tpu.ops import oracle as jor, sqp as jsqp
from cmpc_tpu.plan import com_ref as jcr, footsteps as jfs, timing as jtm
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.ops import oracle as tor

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")
# _fns: every value within this of JAX's, relative to the largest |value|
FNS_RTOL = 1e-10
LYAP_MARGIN = 1e-4       # SLSQP solves the tightened NLP at ticks 150, 300
MAX_VIOLATION = 1e-8     # solve_nlp: each package's result, both margins


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def one_blas_thread():
    """SLSQP's least-squares steps call LAPACK.  One BLAS thread per
    worker: more spin against the suite's other workers (a 4 s solve took
    minutes), and the thread count changes the steps' rounding, so the
    measured tolerances below are for one thread."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _cfgs(**kw):
    return (dataclasses.replace(JCfg(), **kw),
            dataclasses.replace(WalkConfig(), **kw))


def _f64_scenario(jcfg):
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.float64) if jnp.issubdtype(
            a.dtype, jnp.floating) else a
    return jax.tree.map(cast, nominal_scenario(jcfg, push=(0.0, 0.0, 0.0),
                                               push_window=(0, 0)))


@functools.lru_cache(maxsize=None)
def _problem(N, tick):
    """(params as a dict of numpy arrays, z0): the MPC parameters at a
    recorded tick, and the production warm start the JAX oracle test
    starts SLSQP from (prep_warmstart -> _rollout_X -> join_z from a cold
    state at x0).  Call under x64."""
    jcfg, _ = _cfgs(N=N)
    timing = jtm.build_timing(jcfg)
    sc = _f64_scenario(jcfg)
    plan = jfs.plan_footsteps(sc.vref, jcfg, timing, sc.foot_y)
    pl, pr = jfs.contact_pose_refs(plan, timing)
    cref = jcr.build_com_ref(plan, jcfg, timing, sc.foot_y)
    refs = jasm.RefArrays(com=cref, pose_ref_l=pl, pose_ref_r=pr)
    x0 = np.load(ASSET)["x0"].astype(np.float64)
    p = jasm.gather_params(tick, jnp.asarray(x0[tick]), refs, timing, jcfg,
                           sc.k1, sc.k2, sc.mpc_mass)
    st = jsqp.init_solver_state(jcfg, p.x0, mass=p.mass)
    U = jsqp.prep_warmstart(st, p, jcfg)
    X = jsqp._rollout_X(p.x0, U, p, jcfg)
    return ({k: np.asarray(v) for k, v in p._asdict().items()},
            np.asarray(jprob.join_z(X, U)))


def _both_params(pd):
    """The same parameters for each package: JAX's unbatched, the port's
    a batch of one."""
    return (jprob.MPCParams(**{k: jnp.asarray(v) for k, v in pd.items()}),
            convert.params_from_numpy({k: v[None] for k, v in pd.items()}))


@pytest.mark.parametrize("perturbed", [False, True])
def test_fns_match_jax(x64, perturbed):
    """Cost, gradient (autograd against jax.grad), constraints and the
    hand-derived Jacobian at WalkConfig()'s N = 10, at tick 150's
    production warm start and at one seeded perturbation of it."""
    jcfg, tcfg = _cfgs()
    pd, z = _problem(jcfg.N, 150)
    if perturbed:
        z = z + np.random.default_rng(0).normal(size=z.shape) * 0.05
    jp, tp = _both_params(pd)
    for name, jf, tf in zip(("cost", "grad", "con", "jac"),
                            jor._fns(jcfg), tor._fns(tcfg)):
        want = np.asarray(jf(jnp.asarray(z), jp))
        got = tf(torch.tensor(z), tp).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(
            got, want, rtol=FNS_RTOL,
            atol=FNS_RTOL * np.abs(want).max(), err_msg=name)


# (tick, lyap_margin, cost rtol, cost atol, z atol or None).  Measured on
# the CPU with one BLAS thread: at tick 300 the costs agree to 3.7e-14
# (margin 0) and 1.4e-13 (margin 1e-4) relative and z to 2.5e-7 and
# 7.0e-7; at tick 150 the costs are 4.6402e-5 against 4.6410e-5 (margin
# 0) and 4.003465 against 4.003451 (margin 1e-4: SLSQP stops after 98 and
# 112 iterations, 3.4e-6 apart), with z 5.3e-3 and 2.1e-2 apart on the
# flat optimum (module docstring)
SOLVES = [
    (300, 0.0, 1e-9, 0.0, 1e-5),
    (300, LYAP_MARGIN, 1e-9, 0.0, 1e-5),
    (150, 0.0, 0.0, 1e-7, None),
    (150, LYAP_MARGIN, 1e-5, 0.0, None),
]


@pytest.mark.parametrize("tick,margin,cost_rtol,cost_atol,z_atol", SOLVES)
def test_solve_nlp_matches_jax(x64, tick, margin, cost_rtol, cost_atol,
                               z_atol):
    """solve_nlp at N = 4 (228 variables) from the same z0, with the
    Lyapunov rows as they are and tightened: the tightened bounds equal
    JAX's exactly, both solves succeed within MAX_VIOLATION, and the
    results agree within the case's tolerances."""
    jcfg, tcfg = _cfgs(N=4)
    pd, z0 = _problem(4, tick)
    jp, tp = _both_params(pd)

    # the JAX oracle's tightening (cmpc_tpu/ops/oracle.py, solve_nlp)
    l, u = jprob.constraint_bounds(jcfg)
    u = np.array(u, copy=True)
    n_eq = 20 * (jcfg.N + 1)
    u[n_eq:n_eq + jcfg.N] -= margin
    tl, tu = tor.tightened_bounds(tcfg, margin)
    np.testing.assert_array_equal(tl, np.asarray(l))
    np.testing.assert_array_equal(tu, u)

    zj, ij = jor.solve_nlp(z0, jp, jcfg, lyap_margin=margin)
    zt, it = tor.solve_nlp(z0, tp, tcfg, lyap_margin=margin)
    assert z0.shape == zt.shape == (228,)
    assert set(it) == set(ij)
    for k in ij:
        assert type(it[k]) is type(ij[k]), k
    assert ij["success"] and it["success"], (ij, it)
    assert ij["max_violation"] < MAX_VIOLATION, ij
    assert it["max_violation"] < MAX_VIOLATION, it
    assert abs(it["cost"] - ij["cost"]) <= (cost_rtol * abs(ij["cost"])
                                            + cost_atol), (ij, it)
    if z_atol is not None:
        np.testing.assert_allclose(zt, zj, rtol=0, atol=z_atol)


def _handoff(jcfg, tick):
    """A mid-walk carry in the oracle's init form: the recorded measured
    state at `tick` (hw un-negated as pack_x0 reads it), the initial plan
    and a cold warm start at that state."""
    x0 = np.load(ASSET)["x0"].astype(np.float64)[tick]
    sc = _f64_scenario(jcfg)
    timing = jtm.build_timing(jcfg)
    plan = jfs.plan_footsteps(sc.vref, jcfg, timing, sc.foot_y)
    hw = x0[jcm.H_W] * (-1.0 if jcfg.hw_meas_negated else 1.0)
    z = jsqp.init_solver_state(jcfg, jnp.asarray(x0), mass=sc.mpc_mass).z
    return {"com_pos": x0[jcm.P_COM], "com_vel": x0[jcm.V_COM], "hw": hw,
            "plan_pos": np.asarray(plan.pos),
            "theta_hat": x0[jcm.THETA], "z": np.asarray(z)}


# per output key, (rtol, atol) against JAX's.  Measured on the CPU with
# one BLAS thread, largest |port - JAX| over the cold start (ticks 0-2,
# the flat standing optimum) and the hand-off (ticks 300-301): com_pos
# 5.5e-14, com_ref 2.8e-17, com_des 5.0e-12, hw 5.0e-9 (on 0.99),
# hw_des 1.3e-8 (on 0.27), theta_hat 1.4e-15, max_violation 6.0e-12,
# cost 3.2e-9 on 2.8e-4 (cold) and 2.2e-5 on 1743.6 (hand-off)
ROLLOUT_TOL = {"com_pos": (0, 1e-12), "com_ref": (0, 1e-12),
               "com_des": (0, 1e-10), "hw": (0, 1e-7), "hw_des": (0, 1e-6),
               "theta_hat": (0, 1e-12), "max_violation": (0, 1e-9),
               "cost": (1e-7, 1e-7)}


@pytest.mark.parametrize("t0", [0, 300])
def test_rollout_oracle_matches_jax(x64, t0):
    """rollout_oracle at N = 4 on the 4-step gait, port against JAX, every
    output key: 3 ticks from the cold start, and 2 from a mid-walk
    hand-off (init) at the first single-support tick of step 2."""
    jcfg, tcfg = _cfgs(N=4, num_steps=4)
    sc = _f64_scenario(jcfg)
    tsc = convert.scenario_from_numpy(
        {k: np.asarray(v)[None] for k, v in sc._asdict().items()})
    init = None if t0 == 0 else _handoff(jcfg, t0)
    T = 3 if t0 == 0 else 2
    oj = jor.rollout_oracle(sc, jcfg, T, t0=t0, init=init)
    ot = tor.rollout_oracle(tsc, tcfg, T, t0=t0, init=init)
    assert set(ot) == set(oj) == set(ROLLOUT_TOL) | {"success"}
    for k in oj:
        assert ot[k].shape == oj[k].shape and ot[k].dtype == oj[k].dtype, k
    np.testing.assert_array_equal(ot["success"], oj["success"])
    assert oj["success"].all()
    for k, (rtol, atol) in ROLLOUT_TOL.items():
        np.testing.assert_allclose(ot[k], oj[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_rollout_past_the_tables_end_as_jax(x64):
    """Past pad_ticks the JAX oracle's gathers clamp but its numpy table
    reads do not: both packages solve tick pad_ticks and then raise
    IndexError at the support-foot read.  A solver that returns its warm
    start keeps this cheap; the ticks before are held to JAX's."""
    jcfg, tcfg = _cfgs(N=4, num_steps=4)
    P = jcfg.pad_ticks
    sc = _f64_scenario(jcfg)
    tsc = convert.scenario_from_numpy(
        {k: np.asarray(v)[None] for k, v in sc._asdict().items()})
    init = _handoff(jcfg, 300)
    calls = {"jax": 0, "port": 0}

    def solver(name):
        def solve(z0, p):
            calls[name] += 1
            return z0, {}
        return solve

    oj = jor.rollout_oracle(sc, jcfg, 2, solver=solver("jax"), t0=P - 2,
                            init=init)
    ot = tor.rollout_oracle(tsc, tcfg, 2, solver=solver("port"), t0=P - 2,
                            init=init)
    np.testing.assert_array_equal(ot["success"], oj["success"])
    for k in ROLLOUT_TOL:
        np.testing.assert_allclose(ot[k], oj[k], rtol=0, atol=1e-12,
                                   equal_nan=True, err_msg=k)
    calls.update(jax=0, port=0)
    with pytest.raises(IndexError):
        jor.rollout_oracle(sc, jcfg, 3, solver=solver("jax"), t0=P - 2,
                           init=init)
    with pytest.raises(IndexError):
        tor.rollout_oracle(tsc, tcfg, 3, solver=solver("port"), t0=P - 2,
                           init=init)
    assert calls == {"jax": 3, "port": 3}


@pytest.mark.parametrize("bad", ["float32", "batch of two"])
def test_solve_nlp_refuses_what_it_cannot_solve(x64, bad):
    """The oracle solves one scenario in float64 (JAX's asserts x64)."""
    _, tcfg = _cfgs(N=4)
    pd, z0 = _problem(4, 150)
    if bad == "float32":
        tp, err = convert.params_from_numpy(
            {k: v[None] for k, v in pd.items()}, dtype=torch.float32), \
            TypeError
    else:
        tp, err = convert.params_from_numpy(
            {k: np.stack([v, v]) for k, v in pd.items()}), ValueError
    with pytest.raises(err):
        tor.solve_nlp(z0, tp, tcfg)
