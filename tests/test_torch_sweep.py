"""The port's scenario sweep (cmpc_tpu_torch.parallel.mesh and
tools/run_sweep_torch.py) against cmpc_tpu.parallel.mesh, and the
independence of the scenarios of one batch.

The sweeps run on the small gait of ``__graft_entry__.dryrun_multichip``
(4 steps of 7 + 3 ticks) with a heterogeneous batch from ``make_batch``
whose push windows and payload onsets are moved inside the run, so that
every per-scenario branch of the tick is taken."""

import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.config import Scenario as JScenario, WalkConfig as JCfg
from cmpc_tpu.parallel import mesh as jmesh
from cmpc_tpu.sim import closed_loop as jcl
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.config import WalkConfig
from cmpc_tpu_torch.parallel import mesh as tmesh
from cmpc_tpu_torch.sim import closed_loop as tcl

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

SMALL = dict(sqp_iters=2, num_steps=4, ss_duration=7, ds_duration=3)
CFG, JCFG = WalkConfig(**SMALL), JCfg(**SMALL)
# Free-running parity length.  The closed loop amplifies last-bit
# differences between the two packages, and this small gait under pushes
# and payload impacts does so by ~10x per tick (measured: CoM velocities of
# the two packages 1e-14 apart at tick 2 are 1e-9 apart at tick 10, 1e-7 at
# tick 13 and 1e-3 at tick 16).  12 ticks hold every push window and
# payload onset below and stay under the tolerance; the take-offs, the
# footstep adaptations and the landings are held tick by tick from a
# shared carried state (test_heterogeneous_ticks_match_jax).
T_PARITY = 12
T_LANES = 24           # port against port: exact, so no such limit
TOL = 1e-6

_spec = importlib.util.spec_from_file_location(
    "run_sweep_torch", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "run_sweep_torch.py"))
run_sweep_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run_sweep_torch)


@pytest.fixture()
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _inside(d: dict) -> dict:
    """The make_batch scenario dict with pushes and payloads moved inside
    the first 12 ticks: windows (0,4) (2,6) (5,9) (7,11); onsets 0, 3, 7
    and one that never lands."""
    n = len(d["k1"])
    d = dict(d)
    d["push_start"] = np.array([0, 2, 5, 7] * n)[:n].astype(np.int64)
    d["push_end"] = d["push_start"] + 4
    d["payload_onset"] = np.array([0, 3, 7, 1000] * n)[:n].astype(np.int64)
    return d


def _numpy_batch(n=4, seed=0):
    """make_batch of the JAX package as float64/int64 numpy arrays."""
    b = jmesh.make_batch(JCFG, n, seed=seed)
    return _inside({k: np.asarray(v, np.float64)
                    if np.issubdtype(np.asarray(v).dtype, np.floating)
                    else np.asarray(v, np.int64)
                    for k, v in b._asdict().items()})


def _tbatch(d):
    return convert.scenario_from_numpy(d, device="cpu", dtype=torch.float64)


def _jbatch(d):
    return JScenario(**{k: jnp.asarray(v) for k, v in d.items()})


def _np_stats(per):
    return {k: v.numpy() for k, v in per._asdict().items()}


@functools.lru_cache(maxsize=None)
def _lanes_base():
    """The un-permuted, un-disturbed run both lane tests compare with."""
    d = _numpy_batch()
    return d, _np_stats(tmesh.sweep_per_scenario(_tbatch(d), CFG, T_LANES))


@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_matches_jax(seed):
    """Every field equal for the same seed: integers exactly, floats
    exactly after the JAX package's float32 cast."""
    j = jmesh.make_batch(JCfg(), 8, seed=seed)
    t = tmesh.make_batch(WalkConfig(), 8, seed=seed, device="cpu")
    assert t._fields == j._fields
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert tuple(b.shape) == a.shape, name
        assert b.is_floating_point() == np.issubdtype(a.dtype, np.floating)
        if b.is_floating_point():
            assert b.dtype == torch.float32, name
            a = a.astype(np.float32)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    t64 = tmesh.make_batch(WalkConfig(), 8, seed=seed, device="cpu",
                           dtype=torch.float64)
    np.testing.assert_array_equal(t64.vref.numpy(),
                                  t.vref.numpy().astype(np.float64))


def test_make_batch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_batch(WalkConfig(), 2)


def test_sweep_per_scenario_matches_jax(x64):
    """12 ticks, n = 4, f64: every per-scenario statistic at 1e-6."""
    d = _numpy_batch()
    assert (d["payload_mass"] > 0).all() and len(set(d["k1"])) == 2
    want = jmesh.sweep_per_scenario(
        _jbatch(d), JCFG, T_PARITY, mesh=jmesh.make_mesh(jax.devices()[:1]))
    got = tmesh.sweep_per_scenario(_tbatch(d), CFG, T_PARITY)
    for name in got._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=0, atol=TOL, err_msg=name)
    # the pushes and payloads did move the scenarios apart
    assert np.ptp(got.max_err.numpy()) > 1e-5


def _numpy_carry(c):
    return {"plant": {k: np.asarray(v) for k, v in c.plant._asdict().items()},
            "plan_pos": np.asarray(c.plan_pos),
            "theta_hat": np.asarray(c.theta_hat),
            "solver": {k: np.asarray(v)
                       for k, v in c.solver._asdict().items()}}


def test_heterogeneous_ticks_match_jax(x64):
    """42 ticks of the same heterogeneous batch, both packages stepping
    from the same carried state (the JAX rollout's) at every tick: the long
    double support, the take-offs at ticks 20, 30 and 40 with the footstep
    adaptation at each, and two landings, with velocity commands and
    lateral step offsets that differ per scenario.  What the sweep
    statistics read (r_prim, lyap_violation, com_ref) and the next plant
    state and live plan are held to 1e-6 (absolute, or relative where the
    residual of this coarse gait exceeds 1)."""
    d = _numpy_batch()
    jb, tb = _jbatch(d), _tbatch(d)
    carry = jax.vmap(lambda s: jcl.rollout(s, JCFG, return_tick=True)[0])(jb)
    step = jax.jit(jax.vmap(
        lambda s, c, t0: jcl.rollout(s, JCFG, T_sim=1, t0=t0, carry_in=c),
        in_axes=(0, 0, None)))
    _, tick = tcl.rollout(tb, CFG, return_tick=True)
    adapted = []
    for t in range(42):
        tcarry, ttr = tick(convert.loop_carry_from_numpy(
            _numpy_carry(carry), device="cpu"), t)
        carry, jtr = step(jb, carry, t)
        got = {"r_prim": ttr.r_prim, "lyap": ttr.lyap_violation,
               "com_ref": ttr.com_ref, "plan_pos": tcarry.plan_pos,
               **tcarry.plant._asdict()}
        want = {"r_prim": jtr.r_prim[:, 0], "lyap": jtr.lyap_violation[:, 0],
                "com_ref": jtr.com_ref[:, 0], "plan_pos": carry.plan_pos,
                **carry.plant._asdict()}
        for name, a in got.items():
            b = np.asarray(want[name])
            err = (np.abs(a.numpy() - b) / np.maximum(np.abs(b), 1.0)).max()
            assert err <= TOL, f"{name} differs by {err:.3e} at tick {t}"
        np.testing.assert_array_equal(ttr.adapted.numpy(),
                                      np.asarray(jtr.adapted[:, 0]))
        adapted.append(bool(ttr.adapted[0]))
    assert np.nonzero(adapted)[0].tolist() == [20, 30, 40]
    # the adaptation wrote different landing positions per scenario
    assert np.ptp(tcarry.plan_pos[:, 2, 0].numpy()) > 1e-3


def test_sweep_equals_reduction_of_per_scenario():
    sc = _tbatch(_numpy_batch())
    per = _np_stats(tmesh.sweep_per_scenario(sc, CFG, 6))
    s = tmesh.sweep(sc, CFG, 6)
    assert float(s.n) == 4.0
    for got, want in ((s.com_rmse_xy, per["rmse"].mean()),
                      (s.max_tilt, per["max_err"].max()),
                      (s.fall_rate, (per["max_err"] > 0.3).mean()),
                      (s.mean_lyap_violation, per["lyap"].mean()),
                      (s.mean_r_prim, per["r_prim"].mean())):
        np.testing.assert_allclose(float(got), want, rtol=1e-12, atol=1e-300)


def test_lane_independence_under_permutation():
    """Permute the batch, run, un-permute: every per-scenario output is
    unchanged bit for bit."""
    d, base = _lanes_base()
    perm = np.array([2, 0, 3, 1])
    per_p = _np_stats(tmesh.sweep_per_scenario(
        _tbatch({k: v[perm] for k, v in d.items()}), CFG, T_LANES))
    inv = np.argsort(perm)
    for name, a in base.items():
        np.testing.assert_array_equal(per_p[name][inv], a, err_msg=name)


def test_lane_independence_next_to_a_falling_scenario():
    """Replace scenario 1 by one that falls (a 600 N push from tick 1 on):
    every other scenario's outputs are unchanged bit for bit."""
    d, base = _lanes_base()
    f = {k: v.copy() for k, v in d.items()}
    f["push_force"][1] = [600.0, 600.0, 0.0]
    f["push_start"][1], f["push_end"][1] = 0, 1000
    fallen = _np_stats(tmesh.sweep_per_scenario(_tbatch(f), CFG, T_LANES))
    assert fallen["max_err"][1] > 0.3 > base["max_err"].max()
    keep = [0, 2, 3]
    for name, a in base.items():
        assert np.isfinite(fallen[name]).all(), name
        np.testing.assert_array_equal(fallen[name][keep], a[keep],
                                      err_msg=name)


def test_chunked_runner_equals_one_run():
    """Two chunks of 6 ticks against one rollout of 12: the maxima are
    equal bit for bit; the sums are taken in another order (6 + 6 terms
    against 12), so they are held at 1e-12 relative.  The device-side
    accumulation equals the host-side one."""
    sc = _tbatch(_numpy_batch())
    host, dev, ticks = tmesh.sweep_chunked(sc, CFG, 12, 6)
    assert ticks == 12 and host.shape == (4, 4)
    one = _np_stats(tmesh.sweep_per_scenario(sc, CFG, 12))
    two = tmesh.per_scenario_from_sums(host, ticks)
    np.testing.assert_array_equal(two.max_err, one["max_err"])
    for name in ("rmse", "lyap", "r_prim"):
        np.testing.assert_allclose(getattr(two, name), one[name],
                                   rtol=1e-12, atol=1e-300, err_msg=name)
    np.testing.assert_allclose(dev.numpy(), host, rtol=1e-12, atol=1e-300)
    # a length that is no multiple of the chunk runs whole chunks
    assert tmesh.sweep_chunked(sc, CFG, 3, 2)[2] == 4


def test_run_sweep_torch_payload_and_all_fallen_guard():
    """The runner's JSON has the JAX runner's keys; the survivors' figures
    are None (null) when every scenario fell instead of raising."""
    out = run_sweep_torch.run(2, 4, 2, device="cpu", dtype=torch.float64,
                              cfg=CFG)
    assert set(out) == {"n_scenarios", "ticks", "solves", "wall_s",
                        "solves_per_s", "device", "chunk", "stats", "note"}
    assert out["ticks"] == 4 and out["solves"] == 8
    assert set(out["stats"]) == {
        "fall_rate", "rmse_xy_survivors", "max_err_survivors",
        "r_prim_mean_survivors", "lyap_mean_survivors", "err_p50", "err_p95"}
    assert out["stats"]["fall_rate"] == 0.0
    acc = np.array([[4.0, 0.5, 1.0, 1.0], [9.0, 0.9, 2.0, 2.0]])
    st = run_sweep_torch.survivor_stats(acc, 10)
    assert st["fall_rate"] == 1.0 and st["err_p50"] == pytest.approx(0.7)
    assert st["rmse_xy_survivors"] is None
    assert st["max_err_survivors"] is None
    half = run_sweep_torch.survivor_stats(
        np.array([[4.0, 0.5, 1.0, 1.0], [0.1, 0.1, 2.0, 4.0]]), 10)
    assert half["fall_rate"] == 0.5
    assert half["rmse_xy_survivors"] == pytest.approx(0.1)
    assert half["r_prim_mean_survivors"] == pytest.approx(0.4)


def test_run_sweep_torch_cli_writes_to_out(tmp_path, capsys, monkeypatch):
    """The command line: positional n, T, chunk as the JAX runner's, the
    JSON written to --out and printed; without --device and without a card
    it raises."""
    import json
    out = tmp_path / "deep" / "sweep.json"
    run_sweep_torch.main(["2", "2", "1", "--device", "cpu", "--out",
                          str(out)])
    payload = json.loads(out.read_text())
    assert payload == json.loads(capsys.readouterr().out.strip()
                                 .splitlines()[-1])
    assert payload["n_scenarios"] == 2 and payload["ticks"] == 2
    assert payload["chunk"] == 1 and payload["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep_torch.main(["2", "2", "1", "--out", str(out)])
