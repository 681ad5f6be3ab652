"""Validation entry points (port of ``__graft_entry__``).

entry(device)      -> (step, (states, params)): one batched centroidal MPC
                      solve, a batch of 8 at tick 250.
dryrun_one_device  -> a tiny sweep on one device held to the two criteria of
                      the JAX package's ``dryrun_multichip`` that exist
                      without a mesh: lane independence and the device
                      reductions.
dryrun_multichip   -> the same tiny sweep sharded over the ranks of a
                      process group, held to all three criteria; called in
                      every rank.
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


def dryrun_multichip(device="cuda", backend: str | None = None,
                     dtype=torch.float32, lane_tol: float = 0.0) -> dict:
    """Shard a tiny sweep over the ranks of the process group (2 scenarios
    per rank, 4 ticks of the small gait) and check, raising AssertionError,
    the three criteria of ``__graft_entry__.dryrun_multichip``:

    1. Placement invariance: a derangement that moves scenarios across
       ranks and lanes, undone, leaves every result unchanged — bitwise
       with lane_tol == 0 (the CPU), within lane_tol on a card (see
       :func:`dryrun_one_device`).
    2. Collectives against the host: the all-reduced SweepStats equal a
       reduction of the all-gathered rows (rtol 1e-5; only the summation
       order differs).
    3. Sharded against unsharded: each rank's rows equal a one-process run
       of the same shard at the same width (bitwise with lane_tol == 0),
       and the rows of the whole batch run in one process, which differs
       in width only (within lane_tol: bitwise on the CPU, where lanes are
       independent).  The JAX package bounds this loosely (3e-4 m) because
       XLA compiles another program per width; eager torch runs the same
       kernels.

    Every rank builds the mesh (:func:`parallel.mesh.make_mesh`) on
    `device` and `backend` and returns the same figures: the ranks, the
    scenario count and, per criterion, the largest deviation found."""
    from cmpc_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh(device, backend)
    cfg = WalkConfig(sqp_iters=2, admm_iters=5, num_steps=4,
                     ss_duration=7, ds_duration=3)
    n, T = 2 * m.world_size, 4
    batch = pmesh.make_batch(cfg, n=n, seed=0, device="cpu", dtype=dtype)
    shard = pmesh.shard_scenarios(batch, m)

    def rows(per):
        return {k: v.cpu().numpy() for k, v in per._asdict().items()}

    def worst(a, b):
        return max(float(np.abs(a[k] - b[k]).max()) for k in a)

    stats = pmesh.sweep(shard, cfg, T, mesh=m)
    if not np.isfinite(float(stats.com_rmse_xy)) or int(stats.n) != n:
        raise AssertionError(f"sweep statistics malformed: {stats}")
    local = pmesh.sweep_per_scenario(shard, cfg, T, mesh=m)
    per = rows(pmesh.gather_per_scenario(local, m))

    # 1. placement invariance
    perm = np.roll(np.arange(n), n // 2 + 1)
    batch_p = type(batch)(*(v[torch.as_tensor(perm)] for v in batch))
    per_p = rows(pmesh.gather_per_scenario(pmesh.sweep_per_scenario(
        pmesh.shard_scenarios(batch_p, m), cfg, T, mesh=m), m))
    inv = np.argsort(perm)
    per_p = {k: v[inv] for k, v in per_p.items()}
    for name, a in per.items():
        np.testing.assert_allclose(
            per_p[name], a, rtol=0, atol=lane_tol,
            err_msg=f"placement across ranks changed result: {name}")

    # 2. collectives against the host
    for got, want, name in (
            (stats.com_rmse_xy, np.mean(per["rmse"]), "rmse"),
            (stats.max_tilt, np.max(per["max_err"]), "max_tilt"),
            (stats.mean_lyap_violation, np.mean(per["lyap"]), "lyap"),
            (stats.mean_r_prim, np.mean(per["r_prim"]), "r_prim"),
            (stats.fall_rate, np.mean(per["max_err"] > pmesh.FALL_ERR),
             "fall_rate")):
        np.testing.assert_allclose(
            float(got), float(want), rtol=1e-5, atol=1e-12,
            err_msg=f"all-reduced {name} != host reduction")

    # 3. sharded against unsharded: the same shard alone, and the whole
    # batch at its own width, each in this process
    mine = rows(local)
    alone = rows(pmesh.sweep_per_scenario(shard, cfg, T))
    whole = rows(pmesh.sweep_per_scenario(batch.to(m.device), cfg, T))
    k = n // m.world_size
    whole = {name: v[m.rank * k:(m.rank + 1) * k]
             for name, v in whole.items()}
    for ref, what in ((alone, "the shard alone"), (whole, "the whole batch")):
        for name, a in mine.items():
            np.testing.assert_allclose(
                a, ref[name], rtol=0, atol=lane_tol,
                err_msg=f"rank {m.rank}'s rows != {what}: {name}")
    return {"rank": m.rank, "world_size": m.world_size,
            "backend": m.backend, "device": str(m.device), "n": n,
            "placement_dev": worst(per_p, per),
            "shard_alone_dev": worst(mine, alone),
            "whole_batch_dev": worst(mine, whole)}
