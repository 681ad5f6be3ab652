#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cmpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before the last
line):
  1. device check — needs torch.cuda; prints the card's name and power
     limit as nvidia-smi reports them;
  2. kernel build — compiles csrc/chol_inv_tile.cu with nvcc (sm_90a);
  3. kernel vs plain — the tile Cholesky+inverse kernel against its plain
     torch version on random SPD tiles (f32 at rtol=atol=2e-5, f64 against
     numpy at 1e-12, exact zeros above the diagonal), the blocked
     spd_inverse on an ill-conditioned 320x320 case (rel < 1e-4), and both
     versions' time at (256, 64, 64);
  4. production-state solve — 256 recorded walk states
     (assets/walk_x0.npz) replayed as bench.py does: 12-solve warm chain,
     then one timed batched solve, held to bench.py's accuracy gate;
  5. closed-loop walk — 500 ticks of the nominal walk (B=1, f32), held to
     the tracking/solver envelopes of tests/test_closed_loop.py;
  6. one JSON line of kernel results, then the final status line.

The kernel launch counter is reset just before phase 4 and read after
phase 5: every launch counted there came from the port's main path.
Needs no JAX and no network; uses one card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's self-calibrated accuracy gate (bench.py:79-82, 215-222)
GATE_RATIO = 2.5
R_PRIM_FLOOR_P50 = 5e-3
R_PRIM_FLOOR_P95 = 1e-1
LYAP_FLOOR_P50 = 1e-2
N_WARM = 12
B_SOLVE = 256
T_WALK = 500


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def random_spd_tiles(rng, B, nb=64):
    A = rng.normal(size=(B, nb, nb)) * 0.3
    return A @ np.swapaxes(A, 1, 2) + 5.0 * np.eye(nb)


def check_kernel(bc, dev):
    """Phase 3.  Returns (max abs err over the f32 checks, kernel ms, plain
    ms) at (256, 64, 64)."""
    import torch
    rng = np.random.default_rng(0)
    max_err = 0.0
    for B in (1, 7, 256, 1280):
        M = random_spd_tiles(rng, B)
        M32 = torch.tensor(M, dtype=torch.float32, device=dev)
        L, X = bc.chol_inv_tile(M32)
        Lr, Xr = bc.chol_inv_tile_ref(M32)
        torch.cuda.synchronize()
        for name, a, b in (("L", L, Lr), ("X", X, Xr)):
            if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
                fail(f"kernel f32 {name} disagrees at B={B}: max abs err "
                     f"{(a - b).abs().max().item():.3e}")
            max_err = max(max_err, (a - b).abs().max().item())
            if torch.triu(a, 1).abs().max().item() != 0.0:
                fail(f"kernel f32 {name} has nonzero upper triangle, B={B}")
        M64 = torch.tensor(M, dtype=torch.float64, device=dev)
        L64, X64 = bc.chol_inv_tile(M64)
        Lnp = np.linalg.cholesky(M)
        Xnp = np.linalg.inv(Lnp)
        e64 = max(np.abs(L64.cpu().numpy() - Lnp).max(),
                  np.abs(X64.cpu().numpy() - Xnp).max())
        if not e64 < 1e-12:
            fail(f"kernel f64 disagrees with numpy at B={B}: {e64:.3e}")
        if (torch.triu(L64, 1).abs().max().item() != 0.0
                or torch.triu(X64, 1).abs().max().item() != 0.0):
            fail(f"kernel f64 has nonzero upper triangle, B={B}")
        phase(f"  B={B}: f32 max|err| vs plain {max_err:.3e}, f64 max|err| "
              f"vs numpy {e64:.3e}")

    # the ill-conditioned Newton-matrix case of tests/test_batched_chol.py
    rng = np.random.default_rng(3)
    n = 320
    A = rng.normal(size=(2, n, n)).astype(np.float32) * 0.1
    d = (10.0 ** rng.uniform(-1, 5, size=(2, n))).astype(np.float32)
    M = A @ np.swapaxes(A, 1, 2) + np.einsum("bi,ij->bij", d,
                                             np.eye(n, dtype=np.float32))
    Minv = bc.spd_inverse(torch.tensor(M, device=dev), nb=64)
    ref = np.linalg.inv(M.astype(np.float64))
    rel = np.abs(Minv.cpu().numpy().astype(np.float64) - ref).max() \
        / np.abs(ref).max()
    if not rel < 1e-4:
        fail(f"spd_inverse ill-conditioned rel err {rel:.3e} >= 1e-4")
    phase(f"  spd_inverse ill-conditioned 320x320: rel err {rel:.3e}")

    M = torch.tensor(random_spd_tiles(np.random.default_rng(1), 256),
                     dtype=torch.float32, device=dev)
    plain_ms = cuda_ms(lambda: bc.chol_inv_tile_ref(M), reps=20)
    kernel_ms = cuda_ms(lambda: bc.chol_inv_tile(M), reps=200)
    plain_ms2 = cuda_ms(lambda: bc.chol_inv_tile_ref(M), reps=20)
    kernel_ms2 = cuda_ms(lambda: bc.chol_inv_tile(M), reps=200)
    phase(f"  (256,64,64) f32: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms2:.4f} ms")
    return max_err, min(kernel_ms, kernel_ms2), min(plain_ms, plain_ms2)


def production_solve(dev, bc, card):
    """Phase 4: bench.py's replay of 256 recorded production-walk ticks."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    from cmpc_tpu_torch.ocp import assemble
    from cmpc_tpu_torch.ops import sqp
    from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm

    cfg = WalkConfig()
    timing = tm.build_timing(cfg)
    f32 = torch.float32
    sc = nominal_scenario(cfg, device=dev, dtype=f32)
    rec = np.load(os.path.join(HERE, "assets", "walk_x0.npz"))
    x0_rec = torch.tensor(rec["x0"], dtype=f32, device=dev)
    T_rec = x0_rec.shape[0]
    plan = footsteps.plan_footsteps(sc.vref, cfg, timing, sc.foot_y,
                                    sc.step_y_offset)
    pl, pr = footsteps.contact_pose_refs(plan, timing)
    cref = crm.build_com_ref(plan, cfg, timing, sc.foot_y)
    B = B_SOLVE

    def rep(x):
        return x.expand(B, *x.shape[1:])

    refs = assemble.RefArrays(com=crm.ComRef(*(rep(x) for x in cref)),
                              pose_ref_l=rep(pl), pose_ref_r=rep(pr))
    k1, k2, mass = rep(sc.k1), rep(sc.k2), rep(sc.mpc_mass)
    T0 = 120
    ticks_np = T0 + (np.arange(B) * (T_rec - T0 - 1)) // max(B - 1, 1)
    ticks = torch.tensor(ticks_np, device=dev)

    def params_at(tk):
        return assemble.gather_params(tk, x0_rec[tk], refs, timing, cfg,
                                      k1, k2, mass)

    n0 = bc.LAUNCHES["chol_inv_tile"]
    t0 = time.perf_counter()
    state = sqp.init_solver_state(cfg, x0_rec[ticks - N_WARM], mass=mass)
    for k in range(N_WARM):
        state, _ = sqp.solve_mpc(state, params_at(ticks - N_WARM + k), cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    params = params_at(ticks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_state, info = sqp.solve_mpc(state, params, cfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = bc.LAUNCHES["chol_inv_tile"] - n0

    r_prim = info.r_prim.cpu().numpy().astype(np.float64)
    lyap = info.lyap_violation.cpu().numpy().astype(np.float64)
    if not (np.isfinite(new_state.z.cpu().numpy()).all()
            and np.isfinite(r_prim).all()):
        fail("production solve produced non-finite values")
    rp_rec = rec["r_prim"][ticks_np].astype(np.float64)
    lyap_rec = rec["lyap"][ticks_np].astype(np.float64)
    p50, p95 = np.percentile(r_prim, 50), np.percentile(r_prim, 95)
    l50 = np.percentile(lyap, 50)
    gate_p50 = max(GATE_RATIO * np.percentile(rp_rec, 50), R_PRIM_FLOOR_P50)
    gate_p95 = max(GATE_RATIO * np.percentile(rp_rec, 95), R_PRIM_FLOOR_P95)
    gate_l50 = max(GATE_RATIO * np.percentile(lyap_rec, 50), LYAP_FLOOR_P50)
    phase(f"  r_prim p50 {p50:.4e} (gate {gate_p50:.4e}), p95 {p95:.4e} "
          f"(gate {gate_p95:.4e}), lyap p50 {l50:.4e} (gate {gate_l50:.4e})")
    if not (p50 < gate_p50 and p95 < gate_p95 and l50 < gate_l50):
        fail("production solve fails bench.py's accuracy gate")
    per_solve = 5 * cfg.pdip_iters * cfg.sqp_iters
    if launches != per_solve * (N_WARM + 1):
        fail(f"kernel launches {launches} != {per_solve} x {N_WARM + 1}")
    phase(f"  kernel launches {launches} = {per_solve} x {N_WARM + 1} "
          f"batched solves; warm chain {warm_s:.3f} s")
    phase(f"  {B / solve_s:.1f} solves/s at B={B} ({solve_s * 1e3:.2f} ms "
          f"per batched solve) on {card}")
    return B / solve_s


def closed_loop_walk(dev, card):
    """Phase 5: the 500-tick nominal walk, B=1, f32."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    from cmpc_tpu_torch.sim import closed_loop

    cfg = WalkConfig()
    sc = nominal_scenario(cfg, push=(0.0, 0.0, 0.0), push_window=(0, 0),
                          device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tr = closed_loop.rollout(sc, cfg, T_sim=T_WALK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    com = tr.com_pos[0].cpu().numpy().astype(np.float64)
    ref = tr.com_ref[0].cpu().numpy().astype(np.float64)
    r_prim = tr.r_prim[0].cpu().numpy().astype(np.float64)
    adapted = np.nonzero(tr.adapted[0].cpu().numpy())[0].tolist()
    if com.shape != (T_WALK, 3) or not np.isfinite(com).all():
        fail(f"walk trace malformed: shape {com.shape}")
    err_xy = np.abs(com[:, :2] - ref[:, :2]).max()
    dz = np.abs(com[:, 2] - cfg.h).max()
    phase(f"  max|com_xy - ref_xy| {err_xy:.4f} m, max|com_z - h| {dz:.4f} "
          f"m, r_prim median {np.median(r_prim):.3e} max {r_prim.max():.3e}"
          f", adaptation ticks {adapted}")
    if not (err_xy < 0.05 and dz < 0.03 and np.median(r_prim) < 1e-2
            and r_prim.max() < 1.0 and adapted == [261, 361, 461]):
        fail("closed-loop walk leaves the test_closed_loop envelopes")
    phase(f"  {T_WALK / wall:.2f} ticks/s at B=1 ({wall:.1f} s) on {card}")
    return T_WALK / wall


def main():
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    try:
        from cmpc_tpu_torch.ops import batched_chol as bc
        from cmpc_tpu_torch.ops import cuda_build
    except ImportError as e:
        fail(f"cannot import the port: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    phase(f"phase 1 device: {card}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    cuda_build.load_library("chol_inv_tile")
    build_s = time.perf_counter() - t0
    phase(f"phase 2 kernel build: chol_inv_tile.cu in {build_s:.2f} s "
          f"(nvcc {cuda_build.BUILD_SECONDS['chol_inv_tile']:.2f} s)")

    # phase 3: kernel vs plain
    phase("phase 3 kernel vs plain")
    max_err, kernel_ms, plain_ms = check_kernel(bc, dev)

    # phases 4-5: the main path, counted
    bc.LAUNCHES["chol_inv_tile"] = 0
    phase("phase 4 production-state solve")
    solves_per_s = production_solve(dev, bc, card)
    phase("phase 5 closed-loop walk")
    ticks_per_s = closed_loop_walk(dev, card)
    launches = bc.LAUNCHES["chol_inv_tile"]
    if launches == 0:
        fail("the main path never launched the chol_inv_tile kernel")

    print(json.dumps({"kernels": [{
        "name": "chol_inv_tile", "route": "cuda",
        "source": "cmpc_tpu_torch/csrc/chol_inv_tile.cu",
        "replaces": "cmpc_tpu/ops/batched_chol.py:141",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}],
        "build_s": build_s, "solves_per_s_b256": solves_per_s,
        "walk_ticks_per_s_b1": ticks_per_s}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
