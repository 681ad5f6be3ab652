#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cmpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero before the last
line, and no phase carries on on the CPU):
  1. device check — needs torch.cuda; prints the card's name and power
     limit as nvidia-smi reports them;
  2. kernel build — compiles csrc/chol_inv_tile.cu and csrc/chol_tile.cu
     (both include csrc/chol_tile_common.cuh) with nvcc (sm_90a), both at
     once, and reads ptxas' report, which is kept beside each library:
     registers per kernel, no spills;
  3. kernel vs plain — the tile Cholesky+inverse kernel (chol_inv_tile)
     and the factor-only kernel (chol_tile) against their plain torch
     versions on random SPD tiles (f32 at rtol=atol=2e-5, f64 against
     numpy at 1e-12, exact zeros above the diagonal), the two kernels' L
     against each other bit for bit, the strided in-place entry (a
     diagonal block of a (B, 320, 320) tensor written into L and Dinv)
     against the contiguous call bit for bit, the blocked spd_inverse on
     an ill-conditioned 320x320 case (rel < 1e-4), and each kernel's time
     at 1, 256, 1024 and 1280 tiles (f32) beside its bound, with its plain
     version's and the library calls' at 256 (torch.linalg.cholesky; with
     solve_triangular for the fused kernel);
  4. production-state solve — 256 recorded walk states
     (assets/walk_x0.npz) replayed as bench.py does: 12-solve warm chain,
     then one timed batched solve, held to bench.py's accuracy gate;
  5. closed-loop walk — 500 ticks of the nominal walk (B=1, f32), held to
     the tracking/solver envelopes of tests/test_closed_loop.py;
  6. sweep — 256 differing scenarios (parallel/mesh.make_batch, seed 7)
     for 700 ticks in chunks of 100 through the chunked runner, f32: pushes
     from tick 300, payloads from tick 0, adaptation at 261 ... 661;
  7. IS-MPC baseline — 500 ticks at B=1, held to the envelopes of
     tests/test_ismpc.py; it launches no hand-written kernel;
  8. whole-body walk — 300 ticks of the nominal walk through the full
     pipeline on HRP-4 (MPC -> ID QP on the ADMM solver -> 10 impulse-
     contact substeps), B=1, f32, through the function `walk-wb` calls,
     held to the envelope of tests/test_wholebody_walk.py; 120 launches of
     chol_inv_tile per tick;
  9. the ADMM configuration of the solve (mpc_solver="admm", block-
     tridiagonal branch) at B=256, f32: (a) the standing double-support
     problem of tests/test_ocp_solver.py with seeded noise, held to that
     test's bounds per scenario; (b) the recorded states of phase 4:
     finite, residual percentiles and ms per solve printed, not gated.  It
     launches no hand-written kernel;
 10. sweep across ranks — parallel/mesh on torch.distributed, each rank a
     child process of this script (``--rank-worker``) started with
     torchrun's variables: (a) entry.dryrun_multichip at 2 ranks, f64, its
     three criteria at a lane tolerance of 1e-10; (b) phase 6's batch for
     200 ticks, once on one rank of an NCCL group and once on two ranks of
     128 started together (the ranks of (a), after it), both n = 256 and
     finite, fall rate and mean RMSE within 3e-4 of each other, 120
     kernel-1 launches per tick per rank.  With one card both ranks share
     it (gloo), with more each has its own (nccl);
 11. past the end of the gait tables — closed_loop.rollout and
     wholebody_loop.rollout (WalkConfig(), f32, B=1), each from its initial
     carry, stepped over ticks pad_ticks - 2 ... pad_ticks + 1: every trace
     field finite, com_ref at the ticks past the end equal to the tables'
     last row, 120 launches of chol_inv_tile per tick;
 12. the script's total time, one JSON line of kernel results, then the
     final status line.

Each path of phases 4, 5, 6, 8, 9, 10 and 11 is driven with the kernel launch
counters set to 0 just before it and read just after (in phase 10 by each
rank, in its own process): every launch counted there came from that
path.  The factor-only kernel has no caller on any path
(nor has the Pallas kernel it replaces in the JAX package); its count is
that of phase 3.  Needs no JAX and no network; uses one card (or, in
phase 10, two where there are).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
N_SWEEP, T_SWEEP, CHUNK_SWEEP = 256, 700, 100
T_ISMPC = 500
T_WB = 300
T_END = 4                       # phase 11: ticks pad_ticks - 2 ... + 1
N_ADMM_TIMED = 5
N_RANKS, T_RANKS = 256, 200     # phase 10(b): phase 6's batch, 200 ticks
RANKS_LANE_TOL = 1e-10          # phase 10(a), f64: test_cuda_lanes_do_not_mix
RANKS_AGREE = 3e-4              # __graft_entry__.py:137, criterion 3
RANK_TIMEOUT = 400

# one NVIDIA H100 SXM (NVIDIA's data sheet): device memory rate and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


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


def graph_ms(fn, launches=50, reps=20):
    """Device time of one call of `fn` (kernel launches into preallocated
    tensors): `launches` calls captured into one CUDA graph, so that no host
    work lies between them, replayed `reps` times."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def random_spd_tiles(rng, B, nb=64):
    A = rng.normal(size=(B, nb, nb)) * 0.3
    return A @ np.swapaxes(A, 1, 2) + 5.0 * np.eye(nb)


def bound(tiles, nb, n_out, flop_per_tile):
    """(ms, "bytes" | "operations"): the least time the card could take for
    a tile kernel on (tiles, nb, nb) f32 input — the larger of its bytes
    over the memory rate and its operations over the f32 rate.  The bytes
    the function must move: of the symmetric input only the lower triangle,
    nb (nb + 1) / 2 elements, read once (the factor needs no more and the
    kernels read no more), and each of the n_out outputs written whole once
    (the zeros above the diagonal are part of the result)."""
    elems = nb * (nb + 1) // 2 + n_out * nb * nb
    t_bytes = tiles * elems * 4 / PEAK_BYTES_PER_S
    t_ops = tiles * flop_per_tile / PEAK_F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


TIMED_TILES = (1, 256, 1024, 1280)


def check_strided_entry(bc, dev):
    """The in-place entry on a diagonal block of a (B, 320, 320) tensor:
    L and the tile inverse written where blocked_cholesky wants them, into
    buffers that were not zero, equal bit for bit to the contiguous call,
    and nothing outside the block touched."""
    import torch
    for dtype in (torch.float32, torch.float64):
        B, n, r0 = 37, 320, 128
        g = torch.Generator(device="cpu").manual_seed(11)
        G = torch.randn(B, n, n, generator=g, dtype=torch.float64)
        M = (G @ G.transpose(1, 2) / n
             + 5.0 * torch.eye(n, dtype=torch.float64)).to(dev, dtype)
        blk = M[:, r0:r0 + 64, r0:r0 + 64]
        Lc, Xc = bc.chol_inv_tile(blk.contiguous())
        Lbig = torch.full_like(M, 3.0)
        Dinv = torch.full((B, n // 64, 64, 64), 3.0, dtype=dtype, device=dev)
        L2big = torch.full_like(M, 3.0)
        bc.chol_inv_tile_into(blk, Lbig[:, r0:r0 + 64, r0:r0 + 64],
                              Dinv[:, r0 // 64])
        bc.chol_tile_into(blk, L2big[:, r0:r0 + 64, r0:r0 + 64])
        torch.cuda.synchronize()
        if not (torch.equal(Lbig[:, r0:r0 + 64, r0:r0 + 64], Lc)
                and torch.equal(Dinv[:, r0 // 64], Xc)
                and torch.equal(L2big, Lbig)):
            fail(f"strided in-place entry differs from the contiguous call "
                 f"({dtype})")
        Lbig[:, r0:r0 + 64, r0:r0 + 64] = 3.0
        Dinv[:, r0 // 64] = 3.0
        if not (bool((Lbig == 3.0).all()) and bool((Dinv == 3.0).all())):
            fail(f"strided in-place entry wrote outside its block ({dtype})")
    phase("  strided in-place entry (block 2 of (37,320,320) into L and "
          "Dinv, f32 and f64): bit-identical to the contiguous call, "
          "nothing outside the block written")


def check_kernels(bc, dev):
    """Phase 3.  Returns per kernel a dict of max_abs_err over the f32
    checks, the times at (256, 64, 64) f32 and, under "by_tiles", the
    kernel's time and bound at each of TIMED_TILES."""
    import torch
    rng = np.random.default_rng(0)
    err1 = err2 = 0.0
    for B in (1, 7, 256, 1280):
        M = random_spd_tiles(rng, B)
        M32 = torch.tensor(M, dtype=torch.float32, device=dev)
        L, X = bc.chol_inv_tile(M32)
        L2 = bc.chol_tile(M32)
        Lr, Xr = bc.chol_inv_tile_ref(M32)
        L2r = bc.chol_tile_ref(M32)
        torch.cuda.synchronize()
        for name, a, b in (("chol_inv_tile L", L, Lr),
                           ("chol_inv_tile X", X, Xr),
                           ("chol_tile L", L2, L2r)):
            if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
                fail(f"kernel f32 {name} disagrees at B={B}: max abs err "
                     f"{(a - b).abs().max().item():.3e}")
            if torch.triu(a, 1).abs().max().item() != 0.0:
                fail(f"kernel f32 {name} has nonzero upper triangle, B={B}")
        err1 = max(err1, (L - Lr).abs().max().item(),
                   (X - Xr).abs().max().item())
        err2 = max(err2, (L2 - L2r).abs().max().item())
        M64 = torch.tensor(M, dtype=torch.float64, device=dev)
        L64, X64 = bc.chol_inv_tile(M64)
        L264 = bc.chol_tile(M64)
        if not (torch.equal(L2, L) and torch.equal(L264, L64)):
            fail(f"chol_tile's L is not bit-identical to chol_inv_tile's "
                 f"at B={B}")
        Lnp = np.linalg.cholesky(M)
        Xnp = np.linalg.inv(Lnp)
        e64 = max(np.abs(L64.cpu().numpy() - Lnp).max(),
                  np.abs(X64.cpu().numpy() - Xnp).max())
        if not e64 < 1e-12:
            fail(f"kernel f64 disagrees with numpy at B={B}: {e64:.3e}")
        if (torch.triu(L64, 1).abs().max().item() != 0.0
                or torch.triu(X64, 1).abs().max().item() != 0.0):
            fail(f"kernel f64 has nonzero upper triangle, B={B}")
        phase(f"  B={B}: f32 max|err| vs plain {err1:.3e} (chol_inv_tile) "
              f"{err2:.3e} (chol_tile), f64 max|err| vs numpy {e64:.3e}, "
              f"L bit-identical")

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

    check_strided_entry(bc, dev)

    # Times.  "ms" is the kernel's device time at the sweep's and the
    # production solve's launch shape, (256, 64, 64) f32: launches into
    # preallocated outputs, captured into a CUDA graph so that the host's
    # dispatch (which now takes longer than the kernel) lies outside the
    # measurement; the replays launch the kernel without the wrapper, so
    # LAUNCHES counts the captured calls only.  "eager_ms" is the public
    # wrapper called in a loop, the way this script timed the kernels while
    # they took longer than the host's dispatch.  The plain
    # versions and the library calls (a yardstick only: the port never
    # calls them) run eagerly.
    method = ("device time of one launch into preallocated outputs: the "
              "least of two CUDA-graph replays (20 each) of 50 captured "
              "launches; eager_ms is the public wrapper in a host loop")
    out = {"chol_inv_tile": {"max_abs_err": err1, "ms_method": method,
                             "by_tiles": {}},
           "chol_tile": {"max_abs_err": err2, "ms_method": method,
                         "by_tiles": {}}}
    for T in TIMED_TILES:
        A = torch.tensor(random_spd_tiles(np.random.default_rng(1), T),
                         dtype=torch.float32, device=dev)
        L, X = torch.empty_like(A), torch.empty_like(A)
        runs = (("chol_inv_tile", lambda: bc.chol_inv_tile_into(A, L, X)),
                ("chol_tile", lambda: bc.chol_tile_into(A, L)))
        for order in (runs, runs[::-1]):      # each twice, in turns
            for kern, fn in order:
                t = graph_ms(fn)
                row = out[kern]["by_tiles"].setdefault(str(T), {})
                row["ms"] = min(t, row.get("ms", t))
        # nb^3/3 operations for the factor, as many again for the inverse
        # of the triangle
        for kern, n_out in (("chol_inv_tile", 2), ("chol_tile", 1)):
            row = out[kern]["by_tiles"][str(T)]
            row["bound_ms"], row["bound_by"] = bound(T, 64, n_out,
                                                     n_out * 64 ** 3 / 3.0)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]

    M = torch.tensor(random_spd_tiles(np.random.default_rng(1), 256),
                     dtype=torch.float32, device=dev)
    eye = torch.eye(64, device=dev).expand(256, 64, 64).contiguous()

    def lib_chol_inv():
        return torch.linalg.solve_triangular(torch.linalg.cholesky(M), eye,
                                             upper=False)

    runs = (("chol_inv_tile", "eager_ms", lambda: bc.chol_inv_tile(M), 200),
            ("chol_inv_tile", "plain_ms", lambda: bc.chol_inv_tile_ref(M),
             20),
            ("chol_inv_tile", "library_ms", lib_chol_inv, 50),
            ("chol_tile", "eager_ms", lambda: bc.chol_tile(M), 200),
            ("chol_tile", "plain_ms", lambda: bc.chol_tile_ref(M), 20),
            ("chol_tile", "library_ms", lambda: torch.linalg.cholesky(M),
             50))
    for order in (runs, runs[::-1]):          # each twice, in turns
        for kern, key, fn, reps in order:
            t = cuda_ms(fn, reps)
            out[kern][key] = min(t, out[kern].get(key, t))
    for kern in ("chol_inv_tile", "chol_tile"):
        r = out[kern]
        r.update({k: r["by_tiles"]["256"][k]
                  for k in ("ms", "bound_ms", "bound_by")})
        phase(f"  {kern} (256,64,64) f32: kernel {r['ms']:.4f} ms (eager "
              f"wrapper loop {r['eager_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}")
        phase("    by tiles: " + "; ".join(
            f"T={T}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} "
            f"({100 * row['share_of_bound']:.1f}%)"
            for T, row in r["by_tiles"].items()))
        if not (r["ms"] < r["library_ms"] and r["ms"] < r["plain_ms"]):
            fail(f"{kern} is not faster than its plain version and the "
                 f"library call")
    return out


def production_problem(dev, cfg=None):
    """The replay of bench.py: 256 recorded production-walk ticks spread
    over the walking phase, for WalkConfig() or the given configuration.
    Returns (cfg, rec, ticks_np, state, params_at)
    with `state` the solver state N_WARM ticks before the timed ticks and
    params_at(k) the MPC parameters k ticks into the warm chain (k = N_WARM:
    the timed ticks)."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    from cmpc_tpu_torch.ocp import assemble
    from cmpc_tpu_torch.ops import sqp
    from cmpc_tpu_torch.plan import com_ref as crm, footsteps, timing as tm

    cfg = WalkConfig() if cfg is None else cfg
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

    def params_at(k):
        tk = ticks - N_WARM + k
        return assemble.gather_params(tk, x0_rec[tk], refs, timing, cfg,
                                      k1, k2, mass)

    state = sqp.init_solver_state(cfg, x0_rec[ticks - N_WARM], mass=mass)
    return cfg, rec, ticks_np, state, params_at


def production_solve(dev, bc, card):
    """Phase 4: bench.py's replay of 256 recorded production-walk ticks."""
    import torch
    from cmpc_tpu_torch.ops import sqp

    B = B_SOLVE
    cfg, rec, ticks_np, state, params_at = production_problem(dev)
    t0 = time.perf_counter()
    for k in range(N_WARM):
        state, _ = sqp.solve_mpc(state, params_at(k), cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    params = params_at(N_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_state, info = sqp.solve_mpc(state, params, cfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = bc.LAUNCHES["chol_inv_tile"]

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
    # the rest of test_closed_loop.py's checks on its 500-tick walk
    fz = tr.forces[0].cpu().numpy().astype(np.float64).reshape(
        T_WALK, 8, 3)[..., 2].sum(-1)
    fz_gap = abs(fz[50:].mean() - 40.05 * 9.81)
    hw = np.linalg.norm(tr.hw[0].cpu().numpy().astype(np.float64), axis=1)
    phase(f"  |mean fz from tick 50 - m g| {fz_gap:.3f} N (< 30), final "
          f"com_x {com[-1, 0]:.4f} m (> 0.1), max|hw| {hw.max():.4f} (< 4.0),"
          f" over 200-269 {hw[200:270].max():.4f} (> 0.3), min from 480 "
          f"{hw[480:].min():.4f} (< {hw[200:480].max():.4f})")
    if not (fz_gap < 30.0 and com[-1, 0] > 0.1 and hw.max() < 4.0
            and hw[200:270].max() > 0.3
            and hw[480:].min() < hw[200:480].max()):
        fail("closed-loop walk leaves the test_closed_loop envelopes (force, "
             "progress or hw)")
    phase(f"  {T_WALK / wall:.2f} ticks/s at B=1 ({wall:.1f} s) on {card}")
    return T_WALK / wall


def sweep_phase(dev, bc, card):
    """Phase 6: 256 differing scenarios, 700 ticks in chunks of 100, f32,
    through the chunked runner of parallel/mesh."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.parallel import mesh as pm

    cfg = WalkConfig()
    sc = pm.make_batch(cfg, N_SWEEP, seed=7, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, acc, ticks = pm.sweep_chunked(
        sc, cfg, T_SWEEP, CHUNK_SWEEP,
        lambda k, n, _: phase(f"  chunk {k + 1}/{n} done "
                           f"({time.perf_counter() - t0:.0f} s)"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ticks != T_SWEEP or host.shape != (N_SWEEP, 4):
        fail(f"sweep malformed: {ticks} ticks, statistics {host.shape}")
    if not np.isfinite(host).all():
        fail("sweep statistics are not all finite")

    # the device-side reductions against numpy on the per-scenario arrays
    stats = pm.reduce_stats(pm.per_scenario_from_sums(acc, ticks))
    per = pm.per_scenario_from_sums(host, ticks)
    fall_rate = float(np.mean(per.max_err > pm.FALL_ERR))
    for name, got, want in (
            ("com_rmse_xy", stats.com_rmse_xy, per.rmse.mean()),
            ("max_tilt", stats.max_tilt, per.max_err.max()),
            ("fall_rate", stats.fall_rate, fall_rate),
            ("mean_lyap_violation", stats.mean_lyap_violation,
             per.lyap.mean()),
            ("mean_r_prim", stats.mean_r_prim, per.r_prim.mean())):
        if not np.isclose(float(got), want, rtol=1e-5, atol=1e-12):
            fail(f"device-side {name} {float(got):.6e} != numpy reduction "
                 f"{want:.6e}")
    if int(stats.n) != N_SWEEP:
        fail(f"device-side n {int(stats.n)} != {N_SWEEP}")
    alive = per.max_err <= pm.FALL_ERR
    if not alive.any():
        fail("every scenario of the sweep fell")
    rmse_alive = float(per.rmse[alive].mean())
    phase(f"  fall rate {fall_rate:.4f}, survivors' RMSE {rmse_alive:.4f} m, "
          f"max err p50 {np.percentile(per.max_err, 50):.4f} p95 "
          f"{np.percentile(per.max_err, 95):.4f} m, r_prim mean (survivors) "
          f"{float(per.r_prim[alive].mean()):.3e}")
    if not (rmse_alive < 0.05 and fall_rate <= 0.15):
        fail("sweep leaves its envelope (survivors' RMSE < 0.05 m, fall "
             "rate <= 0.15)")
    launches = bc.LAUNCHES["chol_inv_tile"]
    per_solve = 5 * cfg.pdip_iters * cfg.sqp_iters
    if launches != per_solve * T_SWEEP:
        fail(f"kernel launches {launches} != {per_solve} x {T_SWEEP}")
    rate = N_SWEEP * ticks / wall
    phase(f"  kernel launches {launches} = {per_solve} x {T_SWEEP} ticks of "
          f"{N_SWEEP} tiles each")
    phase(f"  {rate:.1f} scenario-ticks/s at B={N_SWEEP} ({wall:.1f} s, "
          f"{wall / ticks * 1e3:.1f} ms per tick) on {card}")
    return rate, fall_rate, rmse_alive


def ismpc_phase(dev, card):
    """Phase 7: the IS-MPC baseline, 500 ticks at B=1, f32.  It runs no
    hand-written kernel."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.sim import ismpc_loop

    cfg = WalkConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tr = ismpc_loop.run(T_sim=T_ISMPC, cfg=cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    com = tr.com_pos[0].cpu().numpy().astype(np.float64)
    zmp = tr.zmp_pos[0].cpu().numpy().astype(np.float64)
    if com.shape != (T_ISMPC, 3) or not np.isfinite(com).all():
        fail(f"IS-MPC trace malformed: shape {com.shape}")
    gap = np.abs(com[:, :2] - zmp[:, :2]).max()
    dz = np.abs(com[:, 2] - cfg.h).max()
    phase(f"  final com_x {com[-1, 0]:.4f} m, max|com_y| "
          f"{np.abs(com[:, 1]).max():.4f} m, max|com - zmp| {gap:.4f} m, "
          f"max|com_z - h| {dz:.2e} m")
    if not (com[-1, 0] > 0.05 and np.abs(com[:, 1]).max() < 0.15
            and gap < 0.2 and dz < 0.02):
        fail("IS-MPC walk leaves the test_ismpc envelopes")
    phase(f"  {T_ISMPC / wall:.1f} ticks/s at B=1 ({wall:.1f} s) on {card}; "
          f"no hand-written kernel on this path")
    return T_ISMPC / wall


def wholebody_walk(dev, bc, card, smi_line):
    """Phase 8: 300 whole-body ticks at B=1, f32, through the function the
    walk-wb command calls, inside the envelope that
    tests/test_wholebody_walk.py pins for the JAX package."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    from cmpc_tpu_torch.rbd.urdf import load_hrp4
    from cmpc_tpu_torch.sim import wholebody_loop

    def say(msg):
        phase(f"{msg} [{smi_line}]")

    cfg = WalkConfig()
    model = load_hrp4(payload=False)
    sc = nominal_scenario(cfg, push=(0.0, 0.0, 0.0), push_window=(0, 0),
                          device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tr = wholebody_loop.rollout(model, sc, cfg, T_sim=T_WB)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def row(x):
        return x[0].cpu().numpy().astype(np.float64)

    com, ref = row(tr.com_pos), row(tr.com_ref)
    zr, zl = row(tr.pose_r)[:, 5], row(tr.pose_l)[:, 5]
    tau, r_id = row(tr.tau), row(tr.r_prim_id)
    if com.shape != (T_WB, 3) or tau.shape != (T_WB, model.nj):
        fail(f"whole-body trace malformed: com {com.shape}, tau {tau.shape}")
    for name in tr._fields:
        if not bool(torch.isfinite(getattr(tr, name).float()).all()):
            fail(f"whole-body trace field {name} is not finite")
    err_xy = np.linalg.norm(com[:, :2] - ref[:, :2], axis=-1)
    dz = np.abs(com[:, 2] - cfg.h).max()
    apex = zr[200:270].max()
    progress = com[-1, 0] - com[150, 0]
    say(f"  err_xy max over ticks 0-270 {err_xy[:271].max():.4f} m (< 0.03), "
          f"over all {err_xy.max():.4f} m (< 0.09), max|com_z - h| {dz:.4f} m "
          f"(< 0.03)")
    say(f"  right-sole apex over ticks 200-269 {apex:.4f} m (0.012 .. "
          f"0.035), max|z| from tick 285 {abs(zr[285:].max()):.4f} m (< 0.01), "
          f"left sole max over 200-269 {zl[200:270].max():.4f} m (< 0.01), "
          f"forward progress from tick 150 {progress:.4f} m (> 0.01)")
    say(f"  r_prim_id median {np.median(r_id):.3e} max {r_id.max():.3e}, "
          f"r_prim_mpc median {np.median(row(tr.r_prim_mpc)):.3e}, max|tau| "
          f"{np.abs(tau).max():.1f} N m")
    if not (err_xy[:271].max() < 0.03 and err_xy.max() < 0.09 and dz < 0.03
            and 0.012 < apex < 0.035 and abs(zr[285:].max()) < 0.01
            and zl[200:270].max() < 0.01 and progress > 0.01):
        fail("whole-body walk leaves the test_wholebody_walk envelope")
    # test_wholebody_walk.py::test_centroidal_plant_hw_cross_validation:
    # the articulated |hw| against the recorded centroidal walk's
    spec = importlib.util.spec_from_file_location(
        "wholebody_envelope_torch",
        os.path.join(HERE, "tools", "wholebody_envelope_torch.py"))
    envelope = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(envelope)
    hw = envelope.hw_figures(row(tr.hw))
    peak_wb, ratio = hw["hw_peak_200_284"], hw["hw_peak_over_recorded_peak"]
    say(f"  hw cross-validation: articulated peak over 200-284 {peak_wb:.4f}"
        f" (0.5 .. 3.0; ratio to the recorded centroidal peak {ratio:.3f}, "
        f"within 1/2.5 .. 2.5), |hw| at 295 {hw['hw_295']:.4f} "
        f"({hw['hw_295_over_peak']:.3f} x peak, < 0.6), recorded at 299 "
        f"{hw['recorded_hw_299_over_peak']:.3f} x its peak (< 0.6)")
    if not (0.5 < peak_wb < 3.0 and 1 / 2.5 < ratio < 2.5
            and hw["hw_295_over_peak"] < 0.6
            and hw["recorded_hw_299_over_peak"] < 0.6):
        fail("whole-body walk fails test_wholebody_walk's hw "
             "cross-validation")
    launches = bc.LAUNCHES["chol_inv_tile"]
    per_solve = 5 * cfg.pdip_iters * cfg.sqp_iters
    if launches != per_solve * T_WB:
        fail(f"kernel launches {launches} != {per_solve} x {T_WB}")
    say(f"  kernel launches {launches} = {per_solve} x {T_WB} ticks")
    say(f"  {T_WB / wall:.3f} whole-body ticks/s at B=1 ({wall:.1f} s, "
          f"{wall / T_WB * 1e3:.1f} ms per tick)")
    return T_WB / wall


def table_end_phase(dev, bc):
    """Phase 11: both loops stepped across the end of the gait tables, where
    every table read takes the last row, as the JAX package's gathers do."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    from cmpc_tpu_torch.rbd.urdf import load_hrp4
    from cmpc_tpu_torch.sim import closed_loop, wholebody_loop

    cfg = WalkConfig()
    P = cfg.pad_ticks
    per_solve = 5 * cfg.pdip_iters * cfg.sqp_iters
    sc = nominal_scenario(cfg, device=dev, dtype=torch.float32)
    model = load_hrp4(payload=False)
    loops = (("closed_loop", lambda **kw: closed_loop.rollout(sc, cfg, **kw)),
             ("wholebody_loop",
              lambda **kw: wholebody_loop.rollout(model, sc, cfg, **kw)))
    t_phase = time.perf_counter()
    for name, roll in loops:
        carry, _ = roll(return_tick=True)
        n0 = bc.LAUNCHES["chol_inv_tile"]
        t0 = time.perf_counter()
        _, tr = roll(T_sim=T_END, t0=P - 2, carry_in=carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for field in tr._fields:
            if not bool(torch.isfinite(getattr(tr, field).float()).all()):
                fail(f"phase 11: {name} trace field {field} is not finite "
                     f"past tick {P - 1}")
        # column 1 is tick P - 1, the tables' last row read in range
        ref = tr.com_ref[0]
        if not (torch.equal(ref[2], ref[1]) and torch.equal(ref[3], ref[1])):
            fail(f"phase 11: {name} com_ref past the end is not the tables' "
                 f"last row")
        launches = bc.LAUNCHES["chol_inv_tile"] - n0
        if launches != per_solve * T_END:
            fail(f"phase 11: {name} kernel launches {launches} != "
                 f"{per_solve} x {T_END}")
        phase(f"  {name}: ticks {P - 2}..{P + T_END - 3} of tables {P} long, "
              f"trace finite, com_ref past the end = last row "
              f"{[round(float(x), 4) for x in ref[1]]}, kernel launches "
              f"{launches} = {per_solve} x {T_END} ({wall:.2f} s)")
    wall = time.perf_counter() - t_phase
    phase(f"  phase 11 {wall:.1f} s")
    return wall


def standing_problem(cfg, B, seed, dev):
    """B copies of the standing double-support problem of
    tests/test_ocp_solver.py::test_mpc_solve_standing (CoM at height h over
    the feet at y = +-0.1, both feet in contact over the horizon), f32;
    copy 0 exact, the others with N(0, 1e-3) noise on the CoM position and
    velocity, drawn with numpy from `seed`."""
    import torch
    from cmpc_tpu_torch.models import centroidal as cm
    from cmpc_tpu_torch.ocp.problem import MPCParams

    rng = np.random.default_rng(seed)
    N = cfg.N
    x0 = np.zeros((B, 20))
    x0[:, cm.P_COM] = [0.0, 0.0, cfg.h]
    x0[:, cm.POS_L] = [0.0, 0.1, 0.0]
    x0[:, cm.POS_R] = [0.0, -0.1, 0.0]
    x0[1:, :6] += 1e-3 * rng.normal(size=(B - 1, 6))
    com_ref = np.zeros((B, N, 9))
    com_ref[:, :, 2] = cfg.h

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return MPCParams(
        x0=t(x0), com_ref=t(com_ref),
        pos_ref_l=t(np.tile([0.0, 0.1, 0.0], (B, N, 1))),
        pos_ref_r=t(np.tile([0.0, -0.1, 0.0], (B, N, 1))),
        yaw_ref_l=t(np.zeros((B, N))), yaw_ref_r=t(np.zeros((B, N))),
        gamma_l=t(np.ones((B, N + 1))), gamma_r=t(np.ones((B, N + 1))),
        k1=t(np.full(B, 4.0)), k2=t(np.full(B, 0.1)),
        mass=t(np.full(B, 40.05)))


def admm_phase(dev, smi_line):
    """Phase 9: solve_mpc in its ADMM configuration at B=256, f32."""
    import torch
    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.ocp import problem
    from cmpc_tpu_torch.ops import sqp

    def say(msg):
        phase(f"{msg} [{smi_line}]")

    B = B_SOLVE
    cfg = WalkConfig(sqp_iters=3, admm_iters=20, admm_rho=0.1,
                     mpc_solver="admm")
    torch.cuda.reset_peak_memory_stats()

    # (a) the standing problem, gated per scenario
    p = standing_problem(cfg, B, seed=0, dev=dev)
    state = sqp.init_solver_state(cfg, p.x0, mass=p.mass)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, info = sqp.solve_mpc(state, p, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    X, U = problem.split_z(state.z, cfg)
    X = X.cpu().numpy().astype(np.float64)
    U = U.cpu().numpy().astype(np.float64)
    r_prim = info.r_prim.cpu().numpy().astype(np.float64)
    lyap = info.lyap_violation.cpu().numpy().astype(np.float64)
    if not (np.isfinite(X).all() and np.isfinite(U).all()
            and np.isfinite(r_prim).all() and r_prim.shape == (B,)):
        fail("ADMM standing solve produced non-finite values")
    weight = 40.05 * 9.81
    fz = U[:, 0, 0:24].reshape(B, 8, 3)[:, :, 2].sum(1)
    f = U[:, :, 0:24].reshape(-1, 3)
    fz_err = np.abs(fz - weight).max() / weight
    com_xy = np.abs(X[:, :, 0:2]).max()
    com_z = np.abs(X[:, :, 2] - cfg.h).max()
    cone = (np.abs(f[:, :2]).max(1) - 0.5 * f[:, 2]).max()
    say(f"  (a) standing x {B}: r_prim max {r_prim.max():.3e} (< 1e-2), "
          f"sum fz off m g by at most {100 * fz_err:.2f}% (< 5%), max|com_xy| "
          f"{com_xy:.4f} m max|com_z - h| {com_z:.4f} m (< 0.02), max(|f_xy| "
          f"- mu f_z) {cone:.3f} N (<= 1), min f_z {f[:, 2].min():.3f} N "
          f"(>= -1), lyap max {lyap.max():.3e} (< 1e-2); first solve "
          f"{first_s * 1e3:.1f} ms")
    if not (r_prim.max() < 1e-2 and fz_err < 0.05 and com_xy < 0.02
            and com_z < 0.02 and cone <= 1.0 and f[:, 2].min() >= -1.0
            and lyap.max() < 1e-2):
        fail("ADMM standing solve leaves test_mpc_solve_standing's bounds")

    # (b) the recorded production states of phase 4: printed, not gated
    cfg, _, _, state, params_at = production_problem(dev, cfg)
    for k in range(N_WARM):
        state, _ = sqp.solve_mpc(state, params_at(k), cfg)
    params = params_at(N_WARM)
    times = []
    for _ in range(N_ADMM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_state, info = sqp.solve_mpc(state, params, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    r_prim = info.r_prim.cpu().numpy().astype(np.float64)
    lyap = info.lyap_violation.cpu().numpy().astype(np.float64)
    if not (bool(torch.isfinite(new_state.z).all())
            and bool(torch.isfinite(new_state.y).all())
            and np.isfinite(r_prim).all() and np.isfinite(lyap).all()
            and bool(torch.isfinite(info.cost).all())):
        fail("ADMM production solve produced non-finite values")
    ms = float(np.median(times))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"  (b) recorded states x {B} after a {N_WARM}-solve warm chain "
          f"(not gated): r_prim p50 {np.percentile(r_prim, 50):.4e} p95 "
          f"{np.percentile(r_prim, 95):.4e}, lyap p50 "
          f"{np.percentile(lyap, 50):.4e}")
    say(f"  {ms:.2f} ms per batched solve, median of "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ({B / ms * 1e3:.1f} solves/s at B={B}), peak device memory "
          f"{peak_gib:.2f} GiB; no hand-written kernel on this path")
    return ms


def rank_worker(steps, device, backend):
    """One rank of phase 10, started by ranks_phase with torchrun's
    variables; runs the comma-separated `steps` in one process group and
    prints one JSON line.  "dryrun": entry.dryrun_multichip in f64.
    "sweep": this rank's share of make_batch(WalkConfig(), N_RANKS, seed=7)
    for T_RANKS ticks, the statistics all-reduced and the rows gathered.
    The launch counts are set to 0 just before each step (for the sweep,
    after a 2-tick warm-up and a barrier) and read just after it."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from cmpc_tpu_torch import entry
    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.ops import batched_chol as bc
    from cmpc_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def zero():
        for k in bc.LAUNCHES:
            bc.LAUNCHES[k] = 0

    def counts():
        return {"launches": bc.LAUNCHES["chol_inv_tile"],
                "chol_tile_launches": bc.LAUNCHES["chol_tile"]}

    m = pm.make_mesh(device, backend)
    out = {"ok": True, "rank": m.rank, "world_size": m.world_size,
           "backend": m.backend, "device": str(m.device),
           "card": torch.cuda.get_device_name(m.device)}
    try:
        if "dryrun" in steps.split(","):
            zero()
            res = entry.dryrun_multichip(device, backend, torch.float64,
                                         lane_tol=RANKS_LANE_TOL)
            out["dryrun"] = {**res, **counts()}
        if "sweep" in steps.split(","):
            cfg = WalkConfig()
            batch = pm.make_batch(cfg, N_RANKS, seed=7, device="cpu",
                                  dtype=torch.float32)
            shard = pm.shard_scenarios(batch, m)
            pm.sweep_per_scenario(shard, cfg, 2)
            torch.cuda.synchronize(m.device)
            dist.barrier()
            zero()
            t0 = time.perf_counter()
            per = pm.sweep_per_scenario(shard, cfg, T_RANKS, mesh=m)
            stats = pm.reduce_stats(per, m)
            rows = pm.gather_per_scenario(per, m)
            torch.cuda.synchronize(m.device)
            wall = time.perf_counter() - t0
            sw = {"shard": int(shard.init_com.shape[0]), "wall_s": wall,
                  **counts(),
                  "stats": {k: float(v) for k, v in stats._asdict().items()}}
            if m.rank == 0:
                sw["rows"] = {k: getattr(rows, k).double().cpu().tolist()
                              for k in ("rmse", "max_err")}
            out["sweep"] = sw
    finally:
        m.close()
    print(json.dumps(out), flush=True)


def launch_ranks(steps, world, device, backend, logdir):
    """Run `world` ranks of rank_worker(steps) as child processes with
    torchrun's variables (rendezvous on a free local port); returns their
    JSON lines in rank order and the wall time, processes' start included.
    Fails if a rank exits non-zero, prints no JSON or outlives
    RANK_TIMEOUT; every child is ended before this returns."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            base = os.path.join(logdir, f"{world}-{r}")
            out, err = open(base + ".out", "w+"), open(base + ".err", "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 steps, device, backend], cwd=HERE, stdout=out, stderr=err,
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
                     "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                     "OMP_NUM_THREADS": env.get("OMP_NUM_THREADS", "1")}))
        deadline = time.monotonic() + RANK_TIMEOUT
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                fail(f"phase 10: rank {r} of {world} still running after "
                     f"{RANK_TIMEOUT} s")
        wall = time.perf_counter() - t0
        lines = []
        for r, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            text = out.read().strip().splitlines()
            try:
                line = json.loads(text[-1]) if text else {}
            except json.JSONDecodeError:
                line = {}
            if p.returncode != 0 or not line.get("ok"):
                fail(f"phase 10: rank {r} of {world} exited {p.returncode}; "
                     f"its stderr ends:\n" + err.read()[-3000:])
            lines.append(line)
        return lines, wall
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            for x in f:
                x.close()


def ranks_phase(smi_line):
    """Phase 10: the sweep across ranks (parallel/mesh on torch.distributed).
    (b) phase 6's batch for T_RANKS ticks on one rank of an NCCL group;
    then, in one group of two ranks started together, (a)
    entry.dryrun_multichip in f64 and (b) the same batch as two ranks of
    128.  With one card both ranks share it (gloo), with more each takes
    its own (nccl)."""
    import tempfile

    import torch

    def say(msg):
        phase(f"{msg} [{smi_line}]")

    n_cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    if n_cards >= 2:
        device2, backend2 = "cuda", "nccl"
    else:
        device2, backend2 = "cuda:0", "gloo"
    per_tick = 5 * 8 * 3          # WalkConfig(): 5 tiles x pdip 8 x sqp 3
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as logdir:
        runs = [(1, "nccl", *launch_ranks("sweep", 1, "cuda", "nccl",
                                          logdir)),
                (2, backend2, *launch_ranks("dryrun,sweep", 2, device2,
                                            backend2, logdir))]

    dry = [o["dryrun"] for o in runs[1][2]]
    for r, out in enumerate(dry):
        if (out["rank"], out["world_size"], out["n"]) != (r, 2, 4):
            fail(f"phase 10(a): rank {r} reports {out}")
    n_dry = sum(o["launches"] for o in dry)
    if n_dry == 0:
        fail("phase 10(a): dryrun_multichip never launched chol_inv_tile")
    say(f"  (a) dryrun_multichip, 2 ranks on {device2} ({backend2}), f64: "
        f"deviation placement {max(o['placement_dev'] for o in dry):.3e}, "
        f"shard alone {max(o['shard_alone_dev'] for o in dry):.3e}, whole "
        f"batch {max(o['whole_batch_dev'] for o in dry):.3e} (lane tol "
        f"{RANKS_LANE_TOL:g}); {n_dry} kernel-1 launches")

    res = []
    for world, backend, lines, proc_s in runs:
        sw = [o["sweep"] for o in lines]
        st = sw[0]["stats"]
        if any(o["stats"] != st for o in sw):
            fail(f"phase 10(b): the {world} ranks hold different statistics")
        if int(st["n"]) != N_RANKS or not all(np.isfinite(list(st.values()))):
            fail(f"phase 10(b), {world} rank(s): statistics malformed: {st}")
        launches = sum(o["launches"] for o in sw)
        if any(o["launches"] != per_tick * T_RANKS for o in sw) or any(
                o["chol_tile_launches"] for o in sw):
            fail(f"phase 10(b), {world} rank(s): kernel-1 launches "
                 f"{[o['launches'] for o in sw]}, not {per_tick} x "
                 f"{T_RANKS} per rank, or chol_tile launched")
        # host reduction of the gathered rows against the all-reduce
        rows = {k: np.asarray(v) for k, v in sw[0]["rows"].items()}
        for name, want in (("com_rmse_xy", rows["rmse"].mean()),
                           ("max_tilt", rows["max_err"].max())):
            if not np.isclose(st[name], want, rtol=1e-5, atol=1e-12):
                fail(f"phase 10(b): all-reduced {name} {st[name]:.6e} != "
                     f"the gathered rows' {want:.6e}")
        wall = max(o["wall_s"] for o in sw)
        rate = N_RANKS * T_RANKS / wall
        devices = "; ".join(sorted({o["device"] for o in lines}))
        res.append({"world_size": world, "backend": backend,
                    "devices": devices, "launches": launches,
                    "wall_s": wall, "processes_s": proc_s,
                    "scenario_ticks_per_s": rate, "stats": st, "rows": rows})
        say(f"  (b) {world} rank(s) of {N_RANKS // world} on {devices} "
            f"({backend}): n {int(st['n'])}, fall rate "
            f"{st['fall_rate']:.4f}, mean RMSE {st['com_rmse_xy']:.6f} m, "
            f"max err {st['max_tilt']:.4f} m; kernel-1 launches {launches} "
            f"= {per_tick} x {T_RANKS} x {world}; {rate:.1f} "
            f"scenario-ticks/s ({wall:.1f} s for {T_RANKS} ticks; "
            f"{proc_s:.1f} s for the processes)")
    a, b = res
    d_fall = abs(a["stats"]["fall_rate"] - b["stats"]["fall_rate"])
    d_rmse = abs(a["stats"]["com_rmse_xy"] - b["stats"]["com_rmse_xy"])
    d_rows = float(np.abs(a["rows"]["rmse"] - b["rows"]["rmse"]).max())
    say(f"  1 rank vs 2: |d fall rate| {d_fall:.3e}, |d mean RMSE| "
        f"{d_rmse:.3e} m (bound {RANKS_AGREE:g}), per-scenario RMSE max "
        f"|d| {d_rows:.3e} m; 2 ranks / 1 rank throughput "
        f"{b['scenario_ticks_per_s'] / a['scenario_ticks_per_s']:.3f}; "
        f"{n_cards} card(s); phase 10 {time.perf_counter() - t_phase:.1f} s")
    if not (d_fall <= RANKS_AGREE and d_rmse <= RANKS_AGREE):
        fail("phase 10(b): the 1-rank and 2-rank sweeps disagree beyond "
             f"{RANKS_AGREE:g}")
    for r in res:
        del r["rows"]
    return {"cards": n_cards, "dryrun_launches": n_dry, "dryrun": dry,
            "runs": res, "d_fall_rate": d_fall, "d_mean_rmse": d_rmse,
            "d_rows_rmse": d_rows,
            "phase_s": time.perf_counter() - t_phase}


def main():
    t_script = time.perf_counter()
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
    smi_line = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    phase(f"phase 1 device: {card}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi_line, flush=True)

    # phase 2: build, one nvcc per source, all started together
    kernels = ("chol_inv_tile", "chol_tile")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(cuda_build.load_library, kernels))
    build_s = time.perf_counter() - t0
    phase(f"phase 2 kernel build: {len(kernels)} sources in {build_s:.2f} s ("
          + ", ".join(f"{k}.cu nvcc {cuda_build.BUILD_SECONDS[k]:.2f} s"
                      for k in kernels) + ")")
    resources = {}
    for k in kernels:
        usage = cuda_build.resource_usage(k)
        if not usage:
            fail(f"{k}: no ptxas report beside the library, so its spills "
                 f"cannot be checked")
        for u in usage:
            # the mangled name carries the element type: If = float
            dtype = "f32" if "IfLb" in u["entry"] else "f64"
            resources[f"{k}_{dtype}"] = {
                "registers": u["registers"], "spill_bytes": u["spill_bytes"],
                "stack_bytes": u["stack_bytes"]}
            phase(f"  {k} {dtype}: {u['registers']} registers, "
                  f"{u['spill_bytes']} bytes spilled, {u['stack_bytes']} "
                  f"bytes stack")
            if u["spill_bytes"] or u["stack_bytes"]:
                fail(f"{k} {dtype} spills registers")

    # phase 3: kernels vs plain
    phase("phase 3 kernels vs plain")
    for k in kernels:
        bc.LAUNCHES[k] = 0
    kres = check_kernels(bc, dev)
    phase3_chol_tile = bc.LAUNCHES["chol_tile"]

    # phases 4-6 and 8: the main paths, each counted on its own
    def counted(title, run):
        for k in kernels:
            bc.LAUNCHES[k] = 0
        phase(title)
        out = run()
        n = bc.LAUNCHES["chol_inv_tile"]
        if n == 0:
            fail(f"{title}: the path never launched the chol_inv_tile "
                 f"kernel")
        if bc.LAUNCHES["chol_tile"] != 0:
            fail(f"{title}: chol_tile was launched on a path")
        return out, n

    solves_per_s, n_solve = counted(
        "phase 4 production-state solve",
        lambda: production_solve(dev, bc, card))
    ticks_per_s, n_walk = counted("phase 5 closed-loop walk",
                                  lambda: closed_loop_walk(dev, card))
    (sweep_rate, fall_rate, rmse_alive), n_sweep = counted(
        "phase 6 sweep", lambda: sweep_phase(dev, bc, card))

    # phase 7: the baseline
    phase("phase 7 IS-MPC baseline")
    ismpc_ticks_per_s = ismpc_phase(dev, card)

    # phase 8: the whole-body walk; phase 9: the solve's ADMM configuration,
    # which runs no hand-written kernel
    wb_ticks_per_s, n_wb = counted(
        "phase 8 whole-body walk",
        lambda: wholebody_walk(dev, bc, card, smi_line))
    for k in kernels:
        bc.LAUNCHES[k] = 0
    phase("phase 9 ADMM configuration of the solve")
    admm_ms = admm_phase(dev, smi_line)
    if any(bc.LAUNCHES[k] for k in kernels):
        fail("phase 9: the ADMM configuration launched a tile kernel")

    # phase 10: the sweep across ranks, in child processes that count their
    # own launches (this process's counts stay 0)
    for k in kernels:
        bc.LAUNCHES[k] = 0
    phase("phase 10 sweep across ranks")
    ranks = ranks_phase(smi_line)
    if any(bc.LAUNCHES[k] for k in kernels):
        fail("phase 10: the parent process launched a tile kernel")
    n_ranks = sum(r["launches"] for r in ranks["runs"])

    # phase 11: both loops past the end of the gait tables
    end_s, n_end = counted("phase 11 past the end of the tables",
                           lambda: table_end_phase(dev, bc))

    total_s = time.perf_counter() - t_script
    phase(f"chip_smoke.py total {total_s:.1f} s (limit 1200 s) [{smi_line}]")
    print(json.dumps({"kernels": [
        {"name": "chol_inv_tile", "route": "cuda",
         "source": "cmpc_tpu_torch/csrc/chol_inv_tile.cu",
         "replaces": "cmpc_tpu/ops/batched_chol.py:141",
         "launches": (n_solve + n_walk + n_sweep + n_wb
                      + ranks["dryrun_launches"] + n_ranks + n_end),
         "launches_by_path": {"production_solve": n_solve,
                              "walk": n_walk, "sweep": n_sweep,
                              "wholebody_walk": n_wb, "admm_solve": 0,
                              "dryrun_multichip": ranks["dryrun_launches"],
                              "sweep_across_ranks": n_ranks,
                              "past_table_end": n_end},
         **kres["chol_inv_tile"], "library_calls": 2},
        {"name": "chol_tile", "route": "cuda",
         "source": "cmpc_tpu_torch/csrc/chol_tile.cu",
         "replaces": "cmpc_tpu/ops/batched_chol.py:49",
         "launches": phase3_chol_tile, "on_path": False,
         "note": "no path calls it, as in the JAX package (its dispatcher "
                 "has no caller); launches are the wrapper's calls in phase "
                 "3, where a call captured into a CUDA graph counts once "
                 "and the graph's replays are not counted",
         **kres["chol_tile"], "library_calls": 1}],
        "card": smi_line, "build_s": build_s, "resources": resources,
        "solves_per_s_b256": solves_per_s,
        "walk_ticks_per_s_b1": ticks_per_s,
        "sweep_scenario_ticks_per_s_b256": sweep_rate,
        "sweep_fall_rate": fall_rate, "sweep_rmse_survivors": rmse_alive,
        "ismpc_ticks_per_s_b1": ismpc_ticks_per_s,
        "wholebody_ticks_per_s_b1": wb_ticks_per_s,
        "admm_solve_ms_b256": admm_ms, "sweep_across_ranks": ranks,
        "past_table_end_s": end_s, "total_s": total_s}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(*sys.argv[2:5])
    else:
        main()
