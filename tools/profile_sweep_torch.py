"""Where a tick of the PyTorch/CUDA port's scenario sweep spends its time.

Runs the randomized batch of tools/run_sweep_torch.py (make_batch, seed 7)
closed loop to tick T0 unmeasured, then measures the following ticks three
ways and prints one JSON object:

  * ms per tick: host clock around TICKS ticks ending in a synchronize;
  * the share of the MPC solve: the same ticks again with a synchronize
    before and after every sqp.solve_mpc call (serialized, so the tick is
    a little slower than above);
  * the device's side: torch.profiler over PROFILED ticks — device-busy ms
    per tick, kernel launches per tick and the kernels that take most of
    the device time.

Run from the repository root, on the GPU:
    python tools/profile_sweep_torch.py [n_scenarios] [T0] [TICKS] [PROFILED]
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    t_start = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    ticks = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    profiled = int(sys.argv[4]) if len(sys.argv) > 4 else 3

    from cmpc_tpu_torch.config import WalkConfig, resolve_device
    from cmpc_tpu_torch.ops import batched_chol as bc, sqp
    from cmpc_tpu_torch.parallel import mesh as pm
    from cmpc_tpu_torch.sim import closed_loop

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = WalkConfig()
    sc = pm.make_batch(cfg, n, seed=7, device=dev)
    carry, _ = closed_loop.rollout(sc, cfg, return_tick=True)
    if t_start:
        carry, _ = closed_loop.rollout(sc, cfg, t_start, carry_in=carry)
    torch.cuda.synchronize()

    def run(t0, T):
        t = time.perf_counter()
        c, _ = closed_loop.rollout(sc, cfg, T, t0=t0, carry_in=carry)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / T * 1e3

    run(t_start, 2)                                   # warm the allocator
    n0 = bc.LAUNCHES["chol_inv_tile"]
    tick_ms = run(t_start, ticks)
    tile_launches = (bc.LAUNCHES["chol_inv_tile"] - n0) / ticks

    # the solve's share, serialized
    solve_s = [0.0]
    plain_solve = sqp.solve_mpc

    def timed_solve(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_solve(*a, **k)
        torch.cuda.synchronize()
        solve_s[0] += time.perf_counter() - t
        return out

    sqp.solve_mpc = timed_solve
    try:
        tick_sync_ms = run(t_start, ticks)
    finally:
        sqp.solve_mpc = plain_solve
    solve_ms = solve_s[0] / ticks * 1e3

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tick_prof_ms = run(t_start, profiled)
    evs = prof.key_averages()
    dev_us = {e.key: e.device_time_total for e in evs
              if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    counts = {e.key: e.count for e in evs}
    busy_ms = sum(dev_us.values()) / 1e3 / profiled
    launches = sum(c for k, c in counts.items()
                   if k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                            "cuLaunchKernel", "cuLaunchKernelEx"))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({
        "card": smi.stdout.strip(), "n_scenarios": n, "t0": t_start,
        "ticks": ticks, "tick_ms": tick_ms,
        "scenario_ticks_per_s": n / tick_ms * 1e3,
        "tick_ms_with_solve_synchronized": tick_sync_ms,
        "solve_ms": solve_ms, "rest_of_tick_ms": tick_sync_ms - solve_ms,
        "chol_inv_tile_launches_per_tick": tile_launches,
        "profiled_ticks": profiled, "tick_ms_under_profiler": tick_prof_ms,
        "device_busy_ms_per_tick": busy_ms,
        "device_idle_share_vs_unprofiled_tick": 1.0 - busy_ms / tick_ms,
        "kernel_launches_per_tick": launches / profiled,
        "top_kernels_ms_per_tick": [
            {"name": k[:90], "ms": us / 1e3 / profiled,
             "calls": counts[k] / profiled} for k, us in top],
    }, indent=1), flush=True)


if __name__ == "__main__":
    main()
