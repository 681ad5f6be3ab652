"""Where one batched production solve of the PyTorch/CUDA port spends its
time, and how many kernels it launches.

Replays the 256 recorded production-walk states of chip_smoke.py's solve
phase (assets/walk_x0.npz, the 12-solve warm chain), then measures the solve
at the timed ticks and prints one JSON object:

  * ms per batched solve: host clock around REPS solves, each from the same
    warm state and ending in a synchronize (median and quartiles);
  * the device's side: torch.profiler over one solve — kernel launches,
    device-busy ms and the kernels that take most of the device time;
  * launches of the hand-written tile kernel per solve.

Run from the repository root, on the GPU:
    python tools/profile_solve_torch.py [REPS]
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 15

    import chip_smoke
    from cmpc_tpu_torch.config import resolve_device
    from cmpc_tpu_torch.ops import batched_chol as bc, sqp

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, _, _, state, params_at = chip_smoke.production_problem(dev)
    for k in range(chip_smoke.N_WARM):
        state, _ = sqp.solve_mpc(state, params_at(k), cfg)
    params = params_at(chip_smoke.N_WARM)
    torch.cuda.synchronize()

    def solve():
        t = time.perf_counter()
        sqp.solve_mpc(state, params, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    solve()                                           # warm the allocator
    n0 = bc.LAUNCHES["chol_inv_tile"]
    ms = np.array([solve() for _ in range(reps)])
    tile_launches = (bc.LAUNCHES["chol_inv_tile"] - n0) / reps

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms_prof = solve()
    evs = prof.key_averages()
    dev_us = {e.key: e.device_time_total for e in evs
              if e.device_time_total > 0 and e.device_type.name == "CUDA"}
    counts = {e.key: e.count for e in evs}
    launches = sum(c for k, c in counts.items()
                   if k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                            "cuLaunchKernel", "cuLaunchKernelEx"))
    copies = sum(c for k, c in counts.items() if k.startswith("cudaMemcpy"))
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(json.dumps({
        "card": smi.stdout.strip(), "batch": chip_smoke.B_SOLVE, "reps": reps,
        "solve_ms_median": med, "solve_ms_q1": q1, "solve_ms_q3": q3,
        "solves_per_s": chip_smoke.B_SOLVE / med * 1e3,
        "chol_inv_tile_launches_per_solve": tile_launches,
        "solve_ms_under_profiler": ms_prof,
        "kernel_launches_per_solve": launches,
        "memcpy_calls_per_solve": copies,
        "device_busy_ms_per_solve": busy_ms,
        "device_idle_share_vs_unprofiled_solve": 1.0 - busy_ms / med,
        "top_kernels_ms_per_solve": [
            {"name": k[:90], "ms": us / 1e3, "calls": counts[k]}
            for k, us in top],
    }, indent=1), flush=True)


if __name__ == "__main__":
    main()
