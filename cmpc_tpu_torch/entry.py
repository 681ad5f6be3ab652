"""Validation entry points (port of ``__graft_entry__``).

entry(device)      -> (step, (states, params)): one batched centroidal MPC
                      solve, a batch of 8 at tick 250.
dryrun_one_device  -> a tiny sweep on one device held to the two criteria of
                      the JAX package's ``dryrun_multichip`` that exist
                      without a mesh: lane independence and the device
                      reductions.  Its third criterion compares a sharded
                      with an unsharded program and has no counterpart on
                      one card.
"""

from __future__ import annotations

import numpy as np
import torch

from cmpc_tpu_torch.config import (WalkConfig, nominal_scenario,
                                   resolve_device)


def _example(batch: int, device, dtype):
    from cmpc_tpu_torch.models import centroidal as cm
    from cmpc_tpu_torch.ocp import assemble
    from cmpc_tpu_torch.ops import sqp
    from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm

    cfg = WalkConfig(sqp_iters=2, admm_iters=15)
    timing = tm.build_timing(cfg)
    sc = nominal_scenario(cfg, device=device, dtype=dtype).repeat(batch)

    plan = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, cfg, timing, sc.foot_y)
    refs = assemble.RefArrays(com=cref, pose_ref_l=pl, pose_ref_r=pr)
    x0 = sc.init_com.new_zeros(batch, 20)
    x0[:, cm.P_COM] = sc.init_com
    x0[:, cm.POS_L] = plan.pos[:, 1]
    x0[:, cm.POS_R] = plan.pos[:, 0]
    params = assemble.gather_params(250, x0, refs, timing, cfg, sc.k1, sc.k2,
                                    sc.mpc_mass)
    states = sqp.init_solver_state(cfg, x0, mass=sc.mpc_mass)

    def step(states, params):
        new_states, infos = sqp.solve_mpc(states, params, cfg)
        return new_states.z, infos.r_prim

    return step, (states, params)


def entry(device="cuda", dtype=torch.float32):
    """Forward step: a batch of 8 MPC solves.  Returns
    (step, (states, params)) with step(states, params) -> (z, r_prim)."""
    return _example(8, resolve_device(device), dtype)


def dryrun_one_device(device="cuda", dtype=torch.float32,
                      lane_tol: float = 0.0) -> None:
    """Run a tiny heterogeneous sweep and check, raising AssertionError:

    1. Lane independence: permuting the batch must not change any
       scenario's result — rows of a batch never mix.  With lane_tol == 0
       the results must be equal bitwise (they are on the CPU); on a card
       a row sum over rows of odd length rounds differently with the row's
       position in the batch (the reduce kernel's vectorized loads split a
       row at a 16-byte boundary), so there lane_tol bounds the absolute
       difference.
    2. Reduction correctness (tight): the device-side SweepStats equal a
       host-side reduction of the per-scenario outputs of the SAME run
       (only the summation order differs).
    """
    from cmpc_tpu_torch.parallel import mesh as pmesh

    device = resolve_device(device)
    cfg = WalkConfig(sqp_iters=2, admm_iters=5, num_steps=4,
                     ss_duration=7, ds_duration=3)
    n, T = 8, 4
    batch = pmesh.make_batch(cfg, n=n, seed=0, device=device, dtype=dtype)
    per_dev = pmesh.sweep_per_scenario(batch, cfg, T)
    stats = pmesh.reduce_stats(per_dev)
    per = {k: v.cpu().numpy() for k, v in per_dev._asdict().items()}
    if not np.isfinite(float(stats.com_rmse_xy)) or int(stats.n) != n:
        raise AssertionError(f"sweep statistics malformed: {stats}")

    perm = np.roll(np.arange(n), n // 2 + 1)
    idx = torch.as_tensor(perm, device=device)
    batch_p = type(batch)(*(v[idx] for v in batch))
    per_p = pmesh.sweep_per_scenario(batch_p, cfg, T)
    inv = np.argsort(perm)
    for name, a in per.items():
        np.testing.assert_allclose(
            getattr(per_p, name).cpu().numpy()[inv], a, rtol=0,
            atol=lane_tol, err_msg=f"batch position changed result: {name}")

    for got, want, name in (
            (stats.com_rmse_xy, np.mean(per["rmse"]), "rmse"),
            (stats.max_tilt, np.max(per["max_err"]), "max_tilt"),
            (stats.mean_lyap_violation, np.mean(per["lyap"]), "lyap"),
            (stats.mean_r_prim, np.mean(per["r_prim"]), "r_prim"),
            (stats.fall_rate, np.mean(per["max_err"] > pmesh.FALL_ERR),
             "fall_rate")):
        np.testing.assert_allclose(
            float(got), float(want), rtol=1e-5, atol=1e-12,
            err_msg=f"device reduction of {name} != host reduction")
