"""The port's program spans and counters (``runtime/spans.py``) on the CPU:
off they leave no record, on they nest as the solve does, and either way
the solve's answers are the same bits."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ocp import assemble
from cmpc_tpu_torch.ops import sqp
from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm
from cmpc_tpu_torch.rbd.urdf import load_hrp4
from cmpc_tpu_torch.runtime import spans
from cmpc_tpu_torch.wholebody import inverse_dynamics as wbid, plant, setup
from cmpc_tpu_torch.wholebody import state as wbstate

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

CFG = WalkConfig()
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")
# recorded ticks across stance, landing and swing; a few warm solves first
TICKS = np.array([150, 250, 262, 300, 420, 520])
WARM = 3
SOLVE_SPANS = ("sqp.warm_start", "condense.build", "pdip.pdip_solve",
               "sqp.line_search")
IPM_SPANS = ("pdip.newton_matrix",)     # inside pdip.pdip_solve
KERNEL_COUNTERS = {"batched_chol.LAUNCHES", "cuda_build.BUILD_SECONDS",
                   "graphs.captures", "graphs.replays"}


@pytest.fixture(autouse=True)
def tracing_off():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


@pytest.fixture(scope="module")
def problem():
    """(state, params): the solver's state WARM ticks into a warm chain
    ending at TICKS, and the MPC parameters at TICKS (f32, the port's
    planner, no JAX)."""
    f32 = torch.float32
    timing = tm.build_timing(CFG)
    sc = nominal_scenario(CFG, device="cpu", dtype=f32)
    x0 = torch.tensor(np.load(ASSET)["x0"], dtype=f32)
    plan = footsteps.plan_footsteps(sc.vref, CFG, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, CFG, timing, sc.foot_y)
    B = len(TICKS)

    def rep(x):
        return x.expand(B, *x.shape[1:])

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    k1, k2, mass = rep(sc.k1), rep(sc.k2), rep(sc.mpc_mass)
    ticks = torch.tensor(TICKS)

    def params_at(t):
        return assemble.gather_params(t, x0[t], refs, timing, CFG, k1, k2,
                                      mass)

    state = sqp.init_solver_state(CFG, x0[ticks - WARM], mass=mass)
    for k in range(WARM):
        state, _ = sqp.solve_mpc(state, params_at(ticks - WARM + k), CFG)
    return state, params_at(ticks)


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def annotations(prof):
    """(name, start, end) of the profile's user annotations (the kineto
    records: the profiler's event tree takes ~30 s to build for a solve)."""
    return sorted((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation())


def parent(ann, a):
    """The name of the innermost annotation in `ann` that holds `a`."""
    held = [b for b in ann if b is not a and b[1] <= a[1] and a[2] <= b[2]]
    return max(held, key=lambda b: b[1])[0] if held else None


def test_off_leaves_no_annotation(problem):
    state, params = problem
    _, prof = profiled(lambda: sqp.solve_mpc(state, params, CFG))
    assert annotations(prof) == []
    assert not spans.enabled()


def test_on_nests_the_solve_spans(problem):
    state, params = problem
    with spans.recording():
        assert spans.enabled()
        _, prof = profiled(lambda: sqp.solve_mpc(state, params, CFG))
    assert not spans.enabled()
    ann = annotations(prof)
    names = [a[0] for a in ann]
    assert names.count("sqp.solve_mpc") == 1
    want = {"sqp.warm_start": 1, "condense.build": CFG.sqp_iters,
            "pdip.pdip_solve": CFG.sqp_iters,
            "pdip.newton_matrix": CFG.sqp_iters * CFG.pdip_iters,
            "sqp.line_search": CFG.sqp_iters}
    assert {n: names.count(n) for n in want} == want
    assert set(names) == {"sqp.solve_mpc", *SOLVE_SPANS, *IPM_SPANS}
    for a in ann:
        assert parent(ann, a) == (None if a[0] == "sqp.solve_mpc"
                                  else "pdip.pdip_solve"
                                  if a[0] in IPM_SPANS
                                  else "sqp.solve_mpc")


def test_outputs_are_the_same_bits_on_and_off(problem):
    state, params = problem
    off_state, off_info = sqp.solve_mpc(state, params, CFG)
    with spans.recording():
        on_state, on_info = sqp.solve_mpc(state, params, CFG)
    for a, b in zip((*off_state, *off_info), (*on_state, *on_info)):
        assert torch.equal(a, b)


def test_counters(problem):
    state, params = problem
    B = params.x0.shape[0]
    sqp.solve_mpc(state, params, CFG)
    assert set(spans.counters()) == KERNEL_COUNTERS
    with spans.recording():
        sqp.solve_mpc(state, params, CFG)
    c = spans.counters()
    assert c["line_search.rows"] == B * CFG.sqp_iters
    assert c["pdip.steps"] == B * CFG.sqp_iters * CFG.pdip_iters
    assert 0 <= c["line_search.rejected"] <= c["line_search.rows"]
    assert 0 <= c["pdip.guarded"] <= c["pdip.steps"]
    assert all(isinstance(c[k], int) for k in (
        "line_search.rows", "line_search.rejected", "pdip.steps",
        "pdip.guarded"))
    with spans.recording():
        sqp.solve_mpc(state, params, CFG)
    assert spans.counters()["line_search.rows"] == 2 * B * CFG.sqp_iters
    spans.reset()
    assert set(spans.counters()) == KERNEL_COUNTERS


def test_counters_add_ints_and_device_tensors():
    spans.add("a", 2)
    spans.add("a", torch.tensor(3))
    spans.add("b", torch.tensor(4))
    spans.add("b", torch.tensor(5))
    c = spans.counters()
    assert c["a"] == 5 and c["b"] == 9
    spans.reset()
    assert set(spans.counters()) == KERNEL_COUNTERS


def test_counters_list_the_kernel_counters():
    from cmpc_tpu_torch.ops import batched_chol, cuda_build
    c = spans.counters()
    assert c["batched_chol.LAUNCHES"] == batched_chol.LAUNCHES
    assert c["cuda_build.BUILD_SECONDS"] == cuda_build.BUILD_SECONDS
    spans.reset()
    assert set(spans.counters()) == KERNEL_COUNTERS


def test_recording_restores_the_switch():
    spans.enable(True)
    with spans.recording():
        pass
    assert spans.enabled()
    spans.enable(False)
    with pytest.raises(RuntimeError):
        with spans.recording():
            raise RuntimeError
    assert not spans.enabled()
    assert spans.span("x") is spans.span("y")


def test_wholebody_spans():
    """The ID QP and the plant step each in their span; the same bits on
    and off."""
    model = load_hrp4()
    q = setup.initial_q(model)
    qv = torch.zeros(1, model.nv)
    st = wbstate.retrieve_state(model, q, qv)
    z3, z6 = torch.zeros_like(st.com_pos), torch.zeros_like(st.pose_l)
    desired = wbid.WBDesired(
        pose_l=st.pose_l, vel_l=z6, acc_l=z6, pose_r=st.pose_r, vel_r=z6,
        acc_r=z6, com_pos=st.com_pos, com_vel=z3, com_acc=z3,
        torso_rotvec=st.torso_rotvec, torso_omega=z3, torso_alpha=z3,
        base_rotvec=st.base_rotvec, base_omega=z3, base_alpha=z3,
        joint_pos=st.joint_pos)

    def tick():
        tau, _ = wbid.joint_torques(model, q, qv, desired, st,
                                    contact_l=1.0, contact_r=1.0)
        ps = plant.wb_plant_step(model, plant.WBPlantState(q=q, qv=qv), tau)
        return tau, ps

    tau_off, ps_off = tick()
    with spans.recording():
        (tau_on, ps_on), prof = profiled(tick)
    names = [a[0] for a in annotations(prof)]
    assert names == ["wholebody.joint_torques", "wholebody.plant_step"]
    assert torch.equal(tau_off, tau_on)
    assert torch.equal(ps_off.qv, ps_on.qv)
    assert all(torch.equal(a, b) for a, b in zip(ps_off.q, ps_on.q))
