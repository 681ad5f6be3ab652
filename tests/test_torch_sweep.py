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


def test_chunked_runner_overruns_the_tables():
    """A sweep whose last chunk runs past the end of the gait tables (70
    ticks here: two chunks of 36 run to tick 71) runs on, as the JAX
    runner's chunked dispatches do, and gives finite rows."""
    assert CFG.pad_ticks == 70
    sc = _tbatch(_numpy_batch(n=2))
    host, dev, ticks = tmesh.sweep_chunked(sc, CFG, 71, 36)
    assert ticks == 72 and host.shape == (2, 4)
    assert np.isfinite(host).all() and torch.isfinite(dev).all()


def test_run_sweep_torch_payload_and_all_fallen_guard(monkeypatch):
    """The runner's JSON has the JAX runner's keys, its dtype, and one row
    per scenario in global order equal to per_scenario_from_sums of the
    chunked runner's statistics; each row's fall_chunk is the first chunk
    whose maximum error passed 0.3 (null for none).  The survivors'
    figures are None (null) when every scenario fell instead of raising."""
    out = run_sweep_torch.run(2, 4, 2, device="cpu", dtype=torch.float64,
                              cfg=CFG)
    assert set(out) == {"n_scenarios", "seed", "ticks", "solves", "wall_s",
                        "solves_per_s", "device", "dtype", "chunk", "stats",
                        "rows", "note"}
    assert out["ticks"] == 4 and out["solves"] == 8
    assert out["seed"] == run_sweep_torch.SEED
    assert out["dtype"] == "float64"
    assert set(out["stats"]) == {
        "fall_rate", "rmse_xy_survivors", "max_err_survivors",
        "r_prim_mean_survivors", "lyap_mean_survivors", "err_p50", "err_p95"}
    assert out["stats"]["fall_rate"] == 0.0
    host, _, _ = tmesh.sweep_chunked(
        tmesh.make_batch(CFG, 2, seed=run_sweep_torch.SEED, device="cpu",
                         dtype=torch.float64), CFG, 4, 2)
    per = tmesh.per_scenario_from_sums(host, 4)
    assert [r["fall_chunk"] for r in out["rows"]] == [None, None]
    for name in ("rmse", "max_err", "lyap", "r_prim"):
        assert [r[name] for r in out["rows"]] == getattr(per, name).tolist()

    # a batch with a falling scenario (1: a 600 N push from tick 0 on)
    f = _numpy_batch()
    f["push_force"][1] = [600.0, 600.0, 0.0]
    f["push_start"][1], f["push_end"][1] = 0, 1000
    monkeypatch.setattr(tmesh, "make_batch", lambda *a, **k: _tbatch(f))
    fell = run_sweep_torch.run(4, T_LANES, 6, device="cpu",
                               dtype=torch.float64, cfg=CFG)
    _, tr = tcl.rollout(_tbatch(f), CFG, T_LANES)
    err = torch.linalg.vector_norm(tr.com_pos[..., :2] - tr.com_ref[..., :2],
                                   dim=-1).numpy()
    first = [int(np.argmax(e > 0.3)) // 6 if (e > 0.3).any() else None
             for e in err]
    assert first[1] is not None and first.count(None) == 3
    assert [r["fall_chunk"] for r in fell["rows"]] == first
    assert fell["stats"]["fall_rate"] == 0.25
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
    assert payload["dtype"] == "float32" and len(payload["rows"]) == 2
    # --dtype reaches make_batch
    asked = []
    make_batch = tmesh.make_batch
    monkeypatch.setattr(tmesh, "make_batch", lambda *a, **k: (
        asked.append(k["dtype"]), make_batch(*a, **k))[1])
    run_sweep_torch.main(["2", "2", "1", "--device", "cpu", "--dtype",
                          "float64", "--out", str(out)])
    assert asked == [torch.float64]
    assert json.loads(out.read_text())["dtype"] == "float64"
    # --scenarios runs those alone: each row is the whole batch's up to
    # rounding (the batch's width changes the order of some sums);
    # --plain-tile swaps the tile step (here for the same plain version
    # the CPU runs anyway) for the rest of the process
    from cmpc_tpu_torch.ops import batched_chol as bc
    kernel_step = bc.chol_inv_tile_into
    monkeypatch.setattr(bc, "chol_inv_tile_into", kernel_step)
    whole = json.loads(out.read_text())["rows"][1]
    run_sweep_torch.main(["2", "2", "1", "--device", "cpu", "--dtype",
                          "float64", "--scenarios", "1", "--plain-tile",
                          "--out", str(out)])
    sub = json.loads(out.read_text())
    assert sub["scenarios"] == [1] and sub["plain_tile"] is True
    assert len(sub["rows"]) == 1 and sub["rows"][0]["fall_chunk"] is None
    for name in ("rmse", "max_err", "lyap", "r_prim"):
        assert sub["rows"][0][name] == pytest.approx(whole[name], rel=TOL)
    assert bc.chol_inv_tile_into is not kernel_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep_torch.main(["2", "2", "1", "--out", str(out)])


def test_sweep_rows_jax_reruns_the_fallen_scenarios(x64, tmp_path, capsys):
    """tools/sweep_rows_jax.py on two port runs of the production batch (4
    scenarios, 2 chunks of 1 tick, f64): it reruns the scenarios that fell
    in either run (here marked by hand: 1 in the first at chunk 0, 3 in the
    second at chunk 1) for the chunks up to the latest fall, and its
    maximum errors match the port's f64 run at 1e-6 relative."""
    import json
    spec = importlib.util.spec_from_file_location(
        "sweep_rows_jax", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "sweep_rows_jax.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = run_sweep_torch.run(4, 2, 1, device="cpu", dtype=torch.float64)
    a, b = json.loads(json.dumps(out)), json.loads(json.dumps(out))
    a["rows"][1].update(max_err=0.5, fall_chunk=0)
    b["rows"][3].update(max_err=0.4, fall_chunk=1)
    paths = [tmp_path / "a.json", tmp_path / "b.json"]
    for p, run in zip(paths, (a, b)):
        p.write_text(json.dumps(run))
    (tmp_path / "c.json").write_text(json.dumps(dict(b, seed=b["seed"] + 1)))
    with pytest.raises(ValueError, match="same whole batch"):
        tool.main([str(paths[0]), str(tmp_path / "c.json")])
    assert tool.choose(a["rows"], b["rows"], 32) == [1, 3]
    assert tool.choose(a["rows"], b["rows"], 1) == [1]
    tool.main([str(paths[0]), str(paths[1]), "--dtype", "float64"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["ticks"] == 2 and [r["index"] for r in got["rows"]] == [1, 3]
    assert got["rows"][0]["port_a"]["fall_chunk"] == 0
    assert got["rows"][1]["port_b"]["fall_chunk"] == 1
    for r in got["rows"]:
        assert r["jax"]["fall_chunk"] is None
        want = out["rows"][r["index"]]["max_err"]
        assert want > 0.0
        assert abs(r["jax"]["max_err"] - want) <= TOL * want, r


def test_step_parity_tools_hold_a_sweep_scenario(x64, tmp_path, capsys,
                                                 monkeypatch):
    """tools/step_parity_jax.py records the nominal walk and scenario 34 of
    the production sweep's batch for 3 ticks in f64; tools/step_parity_torch.py
    steps the port from each recorded carry and lands within the tolerance
    of JAX's next one, with the kernel's step and with the plain one (the
    same on the CPU).  The recorded trace is the envelope tool's input.
    tools/tile_accuracy_torch.py holds each tile step against f64."""
    import json

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    record, step = load("step_parity_jax"), load("step_parity_torch")
    record.main(["nominal,34", "--dtype", "float64", "--ticks", "3",
                 "--every", "2", "--out", str(tmp_path)])
    with np.load(tmp_path / "carries.npz") as z:
        assert z["ticks"].tolist() == [0, 2]
        assert z["before/plant/com_pos"].shape == (2, 2, 3)
        assert [str(r) for r in z["rows"]] == ["nominal", "34"]
    with np.load(tmp_path / "34.npz") as tr:
        assert tr["com_pos"].shape == (3, 3)
    from cmpc_tpu_torch.ops import batched_chol as bc
    monkeypatch.setattr(bc, "chol_inv_tile_into", bc.chol_inv_tile_into)
    for plain in (False, True):
        step.main([str(tmp_path / "carries.npz"), "--device", "cpu"]
                  + ["--plain-tile"] * plain)
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got["ticks_stepped"] == 2 and got["launches"] == 0
        assert got["plain_tile"] is plain
        assert [r["row"] for r in got["rows"]] == ["nominal", "34"]
        for r in got["rows"]:
            assert r["first_over_tol"] is None
            assert set(r["max_diff"]) == {"r_prim", "plan_pos", "com_pos",
                                          "com_vel", "hw"}
            assert max(r["max_diff"].values()) <= TOL
    # the tile-accuracy tool on the same carries: on the CPU the "kernel"
    # is the plain version, and both agree with f64 on these tiles
    load("tile_accuracy_torch").main([str(tmp_path / "carries.npz"),
                                      "--device", "cpu"])
    acc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert acc["tiles"] == 2 * 120 * 2 and acc["f64_not_pd"] == 0
    assert acc["L_kernel"] == acc["L_ref"] and acc["X_kernel"] == acc["X_ref"]
    assert acc["X_ref"]["p100"] <= 1e-12
