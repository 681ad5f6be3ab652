"""The closed-loop sweep cell of the benchmark (``centroidal-sweep-b2048``) on
the CPU at B = 8: the generator, the carry it builds, the program's tick
against the loop's plain float64 reference (``portbench/reference/loop.py``)
at lift-off, at the footstep adaptation, at a push's onset and at a payload's
impact, the planted faults, and one run of the cell through the harness."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _sweep_cases import (ADAPT, B, CFG, CONFIG, IMPACT, LIFT_OFF,  # noqa: E402
                          LIMITS, MIX, PUSH_ONSET, REC, ROOT, SCENARIO, SMALL,
                          TICKS, WORKLOAD, fields, hand_counts, judged,
                          program_tick)
from cmpc_tpu_torch.config import Scenario  # noqa: E402
from cmpc_tpu_torch.ocp import assemble  # noqa: E402
from cmpc_tpu_torch.sim import closed_loop  # noqa: E402
from portbench import core  # noqa: E402
from portbench.loads import sweep_traffic  # noqa: E402
from portbench.reference import loop as ref_loop  # noqa: E402

# the suite runs several worker processes per host: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("t", TICKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tick_against_the_reference(t, dtype):
    """From the same carry, the program's tick packs the state, solves,
    adapts and steps the plant as the reference does: in float64 to
    rounding, in float32 the loop's parts to the cell's limits and every
    answer within what a solve guarantees."""
    numbers, failed, before, after = judged(t, dtype)
    assert failed == 0
    assert numbers["rows_off"] == 0 and numbers["adapt_off"] == 0
    assert (numbers["pushed_rows"], numbers["impact_rows"]) == hand_counts(t)
    if dtype == torch.float64:
        assert numbers["z_gap_p50"] < 1e-9, numbers
        assert numbers["z_gap_max"] < 1e-6, numbers
        assert abs(numbers["merit_gap_p50"]) < 1e-9, numbers
        assert numbers["x0_gap_max"] < 1e-12, numbers
        assert numbers["plant_gap_max"] < 1e-12, numbers
    else:
        assert numbers["x0_gap_max"] <= LIMITS["x0_gap_max"] / 10, numbers
        assert numbers["plant_gap_max"] <= LIMITS["plant_gap_max"] / 10, \
            numbers
    # the plan changes at most at the adaptation's target, step 2
    changed = (after.plan_pos != before.plan_pos).any(2).any(0)
    assert not changed[3:].any() and not changed[:2].any()
    assert t == ADAPT or not changed.any()


@pytest.mark.parametrize("fault,t,number", [
    ("push_ignored", PUSH_ONSET, "plant_gap_max"),
    ("impulse_dropped", IMPACT, "plant_gap_max"),
    ("adapt_skipped", ADAPT, "adapt_off"),
    ("plant_frozen", LIFT_OFF, "plant_gap_max"),
    ("hw_sign_dropped", ADAPT, "x0_gap_max")])
def test_a_planted_fault_is_not_correct(fault, t, number):
    numbers, _, _, _ = judged(t, torch.float32, fault)
    checks = core.judge(numbers, LIMITS)
    assert not checks[number]["ok"], numbers


def test_an_answer_left_at_its_warm_start_is_not_correct():
    """A solve that leaves every row at its warm start (finite, a rollout of
    its inputs, the warm start's merit) passes ``rows_off``; the merit of
    its answer against the reference's does not pass."""
    from portbench.reference import solve
    t = PUSH_ONSET
    before, after, x0 = program_tick(t, torch.float32)
    before, after = fields(before), fields(after)
    ref = ref_loop.LoopReference(CONFIG, SCENARIO)
    p = solve.Reference(CONFIG["walk_config"], "cpu").params(
        ref.params(t, ref.pack_x0(t, before)))
    _, after["z"] = solve.Reference(CONFIG["walk_config"], "cpu") \
        .warm_start(before["z"], p)
    numbers, failed = ref_loop.judge(
        CONFIG, SCENARIO, [(t, before, after, x0.to(torch.float64))], [],
        "cpu", late=t)
    checks = core.judge(numbers, LIMITS)
    assert failed == 0 and checks["rows_off"]["ok"], numbers
    assert not checks["merit_gap_p50"]["ok"], numbers


def test_the_generator_draws_from_the_seed():
    mix = dict(MIX, **SMALL)
    a = sweep_traffic.generate(mix, 2**31 + 5, CONFIG)
    b = sweep_traffic.generate(mix, 2**31 + 5, CONFIG)
    c = sweep_traffic.generate(mix, 2**31 + 6, CONFIG)
    for k, v in a["scenario"].items():
        np.testing.assert_array_equal(v, b["scenario"][k], err_msg=k)
    for pa, pb in zip(a["params"], b["params"]):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert not np.array_equal(a["scenario"]["push_force"],
                              c["scenario"]["push_force"])
    big = sweep_traffic.draw(MIX, 11, CONFIG["scenarios"])
    assert len(big["k1"]) == 2048
    lo, hi = MIX["push_start"]
    assert lo <= big["push_start"].min() and big["push_start"].max() <= hi
    dur = big["push_end"] - big["push_start"]
    assert 50 <= dur.min() and dur.max() <= 149
    lo, hi = MIX["payload_onset"]
    assert lo <= big["payload_onset"].min() <= big["payload_onset"].max() \
        <= hi
    assert big["payload_mass"].min() >= 0 and big["payload_mass"].max() < 3
    heavy = big["payload_mass"] > 1.0
    assert (big["k1"] == np.where(heavy, 7.0, 4.0)).all()
    assert (big["k2"] == np.where(heavy, 1.0, 0.1)).all()
    assert (big["push_force"][:, 2] == 0).all()
    assert 8.0 < big["push_force"][:, :2].std() < 12.0
    sc = a["scenario"]
    assert list(sc) == list(Scenario._fields)
    assert sc["payload_impact_vel"][0] == np.float32(np.sqrt(2 * 9.81 * 0.1))
    assert len(a["params"]) == SMALL["warm_chain"] and a["t0"] == MIX["t0"]


def test_the_start_carry_packs_back_to_the_recorded_state():
    """The carry built from x0[190] packs, by the program and by the
    reference, to x0[190]."""
    t0 = MIX["t0"]
    got = sweep_traffic.generate(dict(MIX, **SMALL), 5, CONFIG)
    c = {k: torch.as_tensor(v) for k, v in got["carry"].items()}
    x0 = np.repeat(REC[t0][None], B, 0)
    sc = Scenario(**{k: torch.as_tensor(v) for k, v in
                     got["scenario"].items()})
    _, tick = closed_loop.rollout(sc, CFG, return_tick=True, t0=t0,
                                  carry_in=None)
    from cmpc_tpu_torch.plan import com_ref as crm, footsteps, swing
    from cmpc_tpu_torch.plan import timing as tm
    timing = tm.build_timing(CFG)
    plan0 = footsteps.plan_footsteps(sc.vref, CFG, timing, sc.foot_y,
                                     sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan0, timing)
    refs = assemble.RefArrays(
        com=crm.build_com_ref(plan0, CFG, timing, sc.foot_y),
        pose_ref_l=pl, pose_ref_r=pr)
    plan = footsteps.FootstepPlan(pos=c["plan_pos"], yaw=plan0.yaw)
    feet = swing.feet_ref_at(t0, plan, CFG, timing, sc.foot_y)
    packed = assemble.pack_x0(c["com_pos"], c["com_vel"], c["hw"],
                              c["theta_hat"], feet.pose_l, feet.pose_r, t0,
                              plan, refs, timing, CFG)
    np.testing.assert_array_equal(packed.numpy(), x0)
    ref = ref_loop.LoopReference(CONFIG, got["scenario"])
    packed = ref.pack_x0(t0, {k: v.to(torch.float64) for k, v in c.items()})
    np.testing.assert_allclose(packed.numpy(), x0, rtol=0, atol=1e-7)


def test_the_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.loop;"
            "import portbench.loads.sweep_traffic;"
            "import portbench.loop_faults;"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            " & {'cmpc_tpu_torch', 'cmpc_tpu', 'jax', 'jaxlib'});"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_of_the_cell(trace):
    """The cell through the harness at B = 8, in a process of its own
    without JAX (no card: the result's numbers are judged, not asserted
    correct): the window's and the traced run's metrics, the kept ticks
    judged."""
    code = ("import json, sys, time; sys.path.insert(0, '.');"
            "import torch; torch.set_num_threads(1);"
            "from portbench import core;"
            f"r = core.run_cell({WORKLOAD!r}, 2**31 + 99, 0.2, {trace},"
            " time.perf_counter(), device='cpu', require_chip=False,"
            f" mix_overrides={SMALL!r});"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    plan = core.cell_plan(core.load_benchmark(), WORKLOAD)
    want = {m["name"] for m in plan["per_layer" if trace else "end_to_end"]}
    got = set(result["metrics"])
    assert got <= want
    if trace:
        assert {"loop.share", "idle_share.solve", "pdip.share",
                "solve_mfu"} <= got
        assert 0 < result["metrics"]["loop.share"]["value"] < 100
        assert result["attempted"] == B * MIX["trace_profiled_steps"]
    else:
        assert got == want
    assert set(result["checks"]) == set(LIMITS)
    assert result["failed"] == 0 and result["diagnostics"]["error"] is None
    n = result["diagnostics"]["numbers"]
    assert n["ticks"][0] == MIX["t0"] + SMALL["warm_up_steps"]
    assert SMALL["late_tick"] in n["ticks"]
    for k in ("x0_gap_max", "plant_gap_max", "adapt_off", "rows_off"):
        assert result["checks"][k]["value"] <= LIMITS[k], k


def test_the_control_stands_in_for_the_loops_solve():
    """The control (``control_sweep.py``) in the solve's place at every
    judged tick of a one-tick window, called as the loop calls the
    program's solve, and the kept ticks judged."""
    from portbench import control_sweep
    r = control_sweep.readings(WORKLOAD, 2**31 + 5, 0.0, control=True,
                               device="cpu", mix_overrides=SMALL, ticks=1)
    assert (r["what"], r["steps"], r["failed"]) == ("control", 1, 0)
    n = r["numbers"]
    assert n["ticks"] == [MIX["t0"] + SMALL["warm_up_steps"],
                          SMALL["late_tick"]]
    assert np.isfinite(n["z_gap_p50"]) and n["x0_gap_max"] <= LIMITS[
        "x0_gap_max"]
