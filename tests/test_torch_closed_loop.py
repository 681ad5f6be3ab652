"""The port's closed loop (planner -> MPC -> plant) against
jax.vmap(cmpc_tpu.sim.closed_loop.rollout), in f64: two scenarios — the
nominal walk and a 3 N lateral push over ticks 100-200 — for 275 ticks,
covering the long double support, take-off at 200, the footstep
adaptation at 261 and the first landing at ~270.

Why tick by tick: the closed loop amplifies a perturbation at the last bit
into millimetres within ~130 ticks (measured on the port itself: two runs
whose initial CoM differs by 1e-15 m drift 1.8e-7 apart by tick 112,
1.5e-5 by 120 and 9.6e-4 by 128), and the line search flips between step
lengths on knife edges that a 1e-10 difference decides (measured: two
25-tick stretches started from the same state part by 2.6e-5 m/s at tick
220).  The JAX package sees the same across its own programs
(test_closed_loop.py::test_vmap_batches_scenarios).  So at every one of
the 275 ticks both packages step from the same carried state — the JAX
rollout's, handed to the port through cmpc_tpu_torch.convert — and the
port's next plant state (com_pos, com_vel, hw), live footstep plan and
solver residual are held to 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import WalkConfig as JCfg, nominal_scenario
from cmpc_tpu.sim import closed_loop as jcl
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.sim import closed_loop as tcl

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG, JCFG = WalkConfig(), JCfg()
T_SIM = 275
TOL = 1e-6
# ticks where the port's line search picks another step length than the
# JAX package's from the SAME carried state (a knife edge decided by
# last-bit rounding): none over these 275 ticks
KNIFE_EDGE_TICKS = ()


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _batch():
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.float64) if jnp.issubdtype(
            a.dtype, jnp.floating) else a
    sc = jax.tree.map(cast, nominal_scenario(JCFG, push=(0.0, 0.0, 0.0),
                                             push_window=(0, 0)))
    b = jax.tree.map(lambda x: jnp.stack([x, x]), sc)
    return b._replace(
        push_force=jnp.asarray([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0]]),
        push_start=jnp.asarray([0, 100]), push_end=jnp.asarray([0, 200]))


def _numpy_carry(c):
    return {"plant": {k: np.asarray(v) for k, v in c.plant._asdict().items()},
            "plan_pos": np.asarray(c.plan_pos),
            "theta_hat": np.asarray(c.theta_hat),
            "solver": {k: np.asarray(v)
                       for k, v in c.solver._asdict().items()}}


def test_closed_loop_slice_matches_jax(x64):
    b = _batch()
    tsc = convert.scenario_from_numpy(
        {k: np.asarray(v) for k, v in b._asdict().items()})
    carry = jax.vmap(lambda s: jcl.rollout(s, JCFG, return_tick=True)[0])(b)
    step = jax.jit(jax.vmap(
        lambda s, c, t0: jcl.rollout(s, JCFG, T_sim=1, t0=t0, carry_in=c),
        in_axes=(0, 0, None)))
    _, tick = tcl.rollout(tsc, CFG, return_tick=True)
    adapted = []
    for t in range(T_SIM):
        tcarry, ttr = tick(convert.loop_carry_from_numpy(_numpy_carry(carry)),
                           t)
        carry, jtr = step(b, carry, t)
        got = {"r_prim": ttr.r_prim, "plan_pos": tcarry.plan_pos,
               **tcarry.plant._asdict()}
        want = {"r_prim": jtr.r_prim[:, 0], "plan_pos": carry.plan_pos,
                **carry.plant._asdict()}
        for name, a in got.items():
            if t in KNIFE_EDGE_TICKS:
                continue
            err = np.abs(a.numpy() - np.asarray(want[name])).max()
            assert err <= TOL, f"{name} differs by {err:.3e} at tick {t}"
        np.testing.assert_array_equal(ttr.adapted.numpy(),
                                      np.asarray(jtr.adapted[:, 0]))
        adapted.append(bool(ttr.adapted[0]))
    assert np.nonzero(adapted)[0].tolist() == [261]


def test_rollout_resumes_from_a_carry(x64):
    """Two 5-tick calls chained through the returned carry give exactly
    the 10-tick run."""
    tsc = convert.scenario_from_numpy(
        {k: np.asarray(v) for k, v in _batch()._asdict().items()})
    _, full = tcl.rollout(tsc, CFG, T_sim=10, t0=195)
    carry, first = tcl.rollout(tsc, CFG, T_sim=5, t0=195)
    _, second = tcl.rollout(tsc, CFG, T_sim=5, t0=200, carry_in=carry)
    for name in full._fields:
        a = getattr(full, name)
        assert torch.equal(a[:, :5], getattr(first, name)), name
        assert torch.equal(a[:, 5:], getattr(second, name)), name
