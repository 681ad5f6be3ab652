"""The traffic generator's copies give the program's own generators' inputs
at the same seed."""

import numpy as np
import torch

from portbench import traffic

MIX = "recorded-ticks-b2048"


def _walk():
    import json
    import os
    from portbench.core import ROOT
    with open(os.path.join(ROOT, "portbench/configs/hrp4-centroidal.json")) \
            as f:
        return json.load(f)["walk_config"]


def _small(**kw):
    return dict(traffic.load_mix(MIX), batch=16, warm_chain=2, **kw)


def test_recorded_ticks_walk_the_nominal_scenario():
    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    got = traffic.generate(_small(), 123, _walk())["scenario"]
    want = nominal_scenario(WalkConfig(), device="cpu")
    for name, value in zip(want._fields, want):
        np.testing.assert_array_equal(got[name], value.numpy(), err_msg=name)


def test_recorded_ticks_from_the_seed():
    mix = traffic.load_mix(MIX)
    walk = _walk()
    a = traffic.generate(mix, 2**31 + 5, walk)
    b = traffic.generate(mix, 2**31 + 5, walk)
    c = traffic.generate(mix, 2**31 + 6, walk)
    t = a["ticks"]
    assert len(t) == 2048 and np.all(np.diff(t) >= 0)
    assert t.min() >= 120 and t.max() <= 799
    np.testing.assert_array_equal(t, b["ticks"])
    assert not np.array_equal(t, c["ticks"])
    assert len(a["params"]) == mix["warm_chain"] + 1
    for pa, pb in zip(a["params"], b["params"]):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    distinct = traffic.generate(_small(repeats=False), 9, walk)["ticks"]
    assert len(np.unique(distinct)) == 16


def test_params_and_start_are_the_programs():
    """The planner's copy and the cold start give what the program's own
    planner, ``gather_params`` and ``init_solver_state`` give at the same
    ticks (the copy plans in float64, the program here in float32)."""
    from cmpc_tpu_torch.config import Scenario, WalkConfig
    from cmpc_tpu_torch.ocp import assemble
    from cmpc_tpu_torch.ops import sqp
    from cmpc_tpu_torch.plan import com_ref as crm
    from cmpc_tpu_torch.plan import footsteps
    from cmpc_tpu_torch.plan import timing as tm
    walk = _walk()
    got = traffic.generate(_small(), 77, walk)
    fields = dict(walk, stance_box=tuple(walk["stance_box"]))
    cfg = WalkConfig(**fields)
    sc = Scenario(**{k: torch.as_tensor(v) for k, v in
                     got["scenario"].items()})
    timing = tm.build_timing(cfg)
    plan = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, cfg, timing, sc.foot_y)

    def rep(x):
        return x.expand(16, *x.shape[1:])
    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    for k, arrays in enumerate(got["params"]):
        tk = torch.as_tensor(got["ticks"] - 2 + k)
        want = assemble.gather_params(
            tk, torch.as_tensor(got["x0"])[tk], refs, timing, cfg,
            rep(sc.k1), rep(sc.k2), rep(sc.mpc_mass))
        for name, value in want._asdict().items():
            np.testing.assert_allclose(arrays[name], value.numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=name)
    p0 = got["params"][0]
    cold = sqp.init_solver_state(cfg, torch.as_tensor(p0["x0"]),
                                 mass=torch.as_tensor(p0["mass"]))
    np.testing.assert_array_equal(got["start"][0], cold.z.numpy())
    np.testing.assert_array_equal(got["start"][1], cold.y.numpy())
