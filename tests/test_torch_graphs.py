"""The CUDA graph helper's host side (``runtime/graphs.py``) on the CPU:
what its key separates, how it takes calls apart and puts outputs back
together, where it stays out of the way (the CPU, the spans on, the ADMM
solve), and its counters.  The card's side, capture and replay, is
``tests/test_torch_cuda_graphs.py``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
from cmpc_tpu_torch.ocp import assemble, condense
from cmpc_tpu_torch.ops import pdip, sqp
from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm
from cmpc_tpu_torch.runtime import graphs, spans

torch.set_num_threads(1)

CFG = WalkConfig()
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "walk_x0.npz")


def _problem(B, dtype=torch.float32, t=300):
    """(state, params, soft_q) of B rows at tick t of the recorded walk,
    from a cold start."""
    timing = tm.build_timing(CFG)
    sc = nominal_scenario(CFG, device="cpu", dtype=dtype)
    plan = footsteps.plan_footsteps(sc.vref, CFG, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, CFG, timing, sc.foot_y)

    def rep(x):
        return x.expand(B, *x.shape[1:]).contiguous()

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    x0 = torch.tensor(np.load(ASSET)["x0"][t], dtype=dtype).expand(
        B, 20).contiguous()
    mass = rep(sc.mpc_mass)
    params = assemble.gather_params(t, x0, refs, timing, CFG, rep(sc.k1),
                                    rep(sc.k2), mass)
    state = sqp.init_solver_state(CFG, x0, mass=mass)
    return state, params, condense.soft_row_q(params.k1, params.mass)


def test_key_separates_batch_dtype_device_and_config():
    state, params, q = _problem(2)
    base = graphs.key(state, params, q, CFG)
    assert graphs.key(state, params, q, CFG) == base
    # other values, same shapes: the same graph
    other = sqp.SolverState(state.z + 1.0, state.y - 1.0)
    assert graphs.key(other, params, q, CFG) == base
    s3, p3, q3 = _problem(3)
    assert graphs.key(s3, p3, q3, CFG) != base
    s64, p64, q64 = _problem(2, torch.float64)
    assert graphs.key(s64, p64, q64, CFG) != base
    meta = [t.to("meta") for t in (state.z, state.y)]
    assert graphs.key(sqp.SolverState(*meta), params, q, CFG) != base
    assert graphs.key(state, params, q,
                      dataclasses.replace(CFG, sqp_iters=2)) != base
    # settings passed by keyword, and the float32 matmul precision
    s = pdip.PDIPSettings()
    k = graphs.key(state.z, s, C_blk=None)
    assert k != graphs.key(state.z, s._replace(iters=9), C_blk=None)
    assert k != graphs.key(state.z, s, C_blk=state.z)
    was = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(
            "high" if was == "highest" else "highest")
        assert graphs.key(state.z, s, C_blk=None) != k
    finally:
        torch.set_float32_matmul_precision(was)


def test_key_refuses_an_unhashable_setting():
    with pytest.raises(TypeError):
        graphs.key(torch.zeros(2), [1, {"a": [2]}], {"b": {3}})


def test_calls_come_apart_and_back_together():
    """Named tuples, lists, dicts and None survive the trip through the
    helper's leaves, in order."""
    state, params, q = _problem(2)
    tree = ((sqp.SolverState(*state), params, None, [q, 3.0]),
            {"d_blk": None, "C_blk": q})
    leaves = []
    spec = graphs._flatten(tree, leaves)
    assert len(leaves) == 2 + len(params) + 3 + 2
    back = graphs._unflatten(spec, iter(leaves))
    assert type(back[0][0]) is sqp.SolverState
    assert type(back[0][1]) is type(params)
    assert back[0][2] is None and back[0][3][1] == 3.0
    assert back[0][3][0] is q and back[1]["C_blk"] is q
    for a, b in zip(back[0][1], params):
        assert a is b


def test_the_cpu_and_spans_never_capture():
    assert not graphs.active("cpu")
    with spans.recording():
        assert not graphs.active("cuda")
        assert not graphs.active(torch.device("cuda", 0))


@pytest.mark.parametrize("soft_q", [False, True])
def test_cpu_route_is_the_eager_route_and_captures_nothing(soft_q):
    """On the CPU the stages run as functions: the solve's answer equals
    the op-by-op route's bit for bit, with and without a soft_q, and
    nothing is captured or replayed."""
    state, params, q = _problem(3, t=262)
    q = q if soft_q else None
    c0 = dict(graphs.COUNTS)
    new, info = sqp.solve_mpc(state, params, CFG, q)
    ref_new, ref_info = sqp._solve_mpc_condip_eager(state, params, CFG, q)
    for a, b in zip((*new, *info), (*ref_new, *ref_info)):
        assert torch.equal(a, b)
    assert graphs.COUNTS == c0
    # the answer is the caller's: the input state is untouched
    assert not torch.equal(new.z, state.z)


def test_admm_never_reaches_a_graph(monkeypatch):
    """The ADMM configuration does not go through the graphed stages: with
    the helper told it is on a card, the solve still runs (no capture is
    tried on the CPU) and gives the same bits."""
    cfg = dataclasses.replace(CFG, mpc_solver="admm", admm_iters=5,
                              sqp_iters=1)
    state, params, _ = _problem(2)
    want, want_info = sqp.solve_mpc(state, params, cfg)
    c0 = dict(graphs.COUNTS)
    monkeypatch.setattr(graphs, "active", lambda device: True)
    got, got_info = sqp.solve_mpc(state, params, cfg)
    assert graphs.COUNTS == c0
    for a, b in zip((*got, *got_info), (*want, *want_info)):
        assert torch.equal(a, b)


def test_counters_list_the_graph_counts():
    c = spans.counters()
    assert c["graphs.captures"] == graphs.COUNTS["captures"]
    assert c["graphs.replays"] == graphs.COUNTS["replays"]
    spans.reset()
    assert spans.counters()["graphs.replays"] == graphs.COUNTS["replays"]


def test_the_solve_calls_the_interior_point_through_sqp(monkeypatch):
    """Each SQP iteration calls ``sqp.pdip_solve`` as the module holds it
    at the solve's start, so that a wrapper set there (the benchmark's
    timing spans) sees every call; the graph of the interior point keeps
    ``pdip.pdip_solve``'s name."""
    state, params, q = _problem(2)
    calls = []
    inner = sqp.pdip_solve

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(sqp, "pdip_solve", counted)
    sqp.solve_mpc(state, params, CFG, q)
    assert len(calls) == CFG.sqp_iters
    assert inner.__name__ == "pdip_solve" and inner.fn is pdip.pdip_solve
