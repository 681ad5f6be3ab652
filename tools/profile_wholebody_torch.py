"""Where a tick of the PyTorch/CUDA port's whole-body loop spends its time.

Runs sim/wholebody_loop.rollout (MPC -> ID QP on the ADMM solver -> 10
impulse-contact substeps on HRP-4) to tick T0 unmeasured, then steps the
loop's tick function by hand over the following ticks (so the planner's
set-up is outside every measurement) and measures them three ways, for each
batch size; prints one JSON object per batch size:

  * ms per tick: host clock around TICKS ticks ending in a synchronize;
  * the split into MPC / ID QP / plant: the same ticks again with a
    synchronize before and after sqp.solve_mpc, wholebody.joint_torques and
    wholebody.wb_plant_step (serialized, so the tick is a little slower
    than above);
  * the device's side: torch.profiler over PROFILED ticks with the
    program's spans recording (runtime/spans.py) — device-busy ms per tick,
    kernel launches per tick, split by the part whose span (sqp.solve_mpc,
    wholebody.joint_torques, wholebody.plant_step) held the launch call,
    and the kernels that take most of the device time;
  * the plant's projected Gauss-Seidel (15 sweeps of 24 sequential rows
    in each of 10 substeps): the plant's serialized ms and launches again
    with pgs_iters = 0, and the difference.

B = 1 is the nominal scenario; B > 1 is parallel/mesh.make_batch (seed 7).

Run from the repository root, on the GPU:
    python tools/profile_wholebody_torch.py [batches] [T0] [TICKS] [PROFILED]
with batches a comma-separated list (default 1,64).
"""

import bisect
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
PARTS = ("mpc", "id_qp", "plant")
# the program's span of each part of the tick
PART_SPANS = {"sqp.solve_mpc": "mpc", "wholebody.joint_torques": "id_qp",
              "wholebody.plant_step": "plant"}


def profile_batch(n, t_start, ticks, profiled, dev, card):
    from torch.profiler import ProfilerActivity, profile

    from cmpc_tpu_torch.config import WalkConfig, nominal_scenario
    from cmpc_tpu_torch.ops import batched_chol as bc
    from cmpc_tpu_torch.parallel import mesh as pm
    from cmpc_tpu_torch.rbd.urdf import load_hrp4
    from cmpc_tpu_torch.runtime import spans
    from cmpc_tpu_torch.sim import wholebody_loop as wbl

    cfg = WalkConfig()
    model = load_hrp4()
    if n == 1:
        sc = nominal_scenario(cfg, push=(0.0, 0.0, 0.0), push_window=(0, 0),
                              device=dev)
    else:
        sc = pm.make_batch(cfg, n, seed=7, device=dev)
    carry, _ = wbl.rollout(model, sc, cfg, return_tick=True)
    if t_start:
        carry, _ = wbl.rollout(model, sc, cfg, t_start)
    torch.cuda.synchronize()

    def stepper(**kw):
        """run(T) -> ms per tick over T ticks from tick T0, for the loop
        built with the rollout options kw."""
        _, tick = wbl.rollout(model, sc, cfg, return_tick=True, **kw)

        def run(T):
            torch.cuda.synchronize()
            c = carry
            t = time.perf_counter()
            for k in range(T):
                c, _ = tick(c, t_start + k)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / T * 1e3
        return run

    run = stepper()
    run_no_gs = stepper(contact=wbl.wbplant.ContactParams(pgs_iters=0))
    run(2)                                            # warm the allocator
    n0 = bc.LAUNCHES["chol_inv_tile"]
    tick_ms = run(ticks)
    tile_launches = (bc.LAUNCHES["chol_inv_tile"] - n0) / ticks

    # the three parts of the tick, as the loop's module names them
    targets = {"mpc": (wbl.sqp, "solve_mpc"),
               "id_qp": (wbl.wbid, "joint_torques"),
               "plant": (wbl.wbplant, "wb_plant_step")}
    plain = {k: getattr(mod, name) for k, (mod, name) in targets.items()}

    def patched(wrap):
        for k, (mod, name) in targets.items():
            setattr(mod, name, wrap(k, plain[k]))

    def restore():
        for k, (mod, name) in targets.items():
            setattr(mod, name, plain[k])

    def serialized(run):
        """(tick ms, ms per part) with a synchronize around each part."""
        part_s = dict.fromkeys(PARTS, 0.0)

        def timed(part, fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                part_s[part] += time.perf_counter() - t
                return out
            return call

        patched(timed)
        try:
            tick = run(ticks)
        finally:
            restore()
        return tick, {k: v / ticks * 1e3 for k, v in part_s.items()}

    def profiled_run(run):
        """(profiler, tick ms, launches per tick by part): each launch goes
        to the part whose span holds its start."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                spans.recording():
            tick = run(profiled)
        parts = sorted((e.time_range.start, e.time_range.end,
                        PART_SPANS[e.name]) for e in prof.events()
                       if e.name in PART_SPANS
                       and e.device_type.name == "CPU")
        starts = [s[0] for s in parts]
        by_part = dict.fromkeys(PARTS + ("rest",), 0)
        for e in prof.events():
            if e.name in LAUNCH_NAMES:
                i = bisect.bisect_right(starts, e.time_range.start) - 1
                inside = i >= 0 and e.time_range.start <= parts[i][1]
                by_part[parts[i][2] if inside else "rest"] += 1
        return prof, tick, {k: v / profiled for k, v in by_part.items()}

    tick_sync_ms, part_ms = serialized(run)
    prof, tick_prof_ms, by_part = profiled_run(run)
    _, part_ms_no_gs = serialized(run_no_gs)
    _, _, by_part_no_gs = profiled_run(run_no_gs)
    evs = prof.key_averages()
    # the program's spans are mirrored on the device's timeline: not kernels
    span_names = {e.key for e in evs if e.is_user_annotation}
    dev_us = {e.key: e.device_time_total for e in evs
              if e.device_time_total > 0 and e.device_type.name == "CUDA"
              and e.key not in span_names}
    counts = {e.key: e.count for e in evs}
    busy_ms = sum(dev_us.values()) / 1e3 / profiled
    launches = sum(c for k, c in counts.items() if k in LAUNCH_NAMES)

    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return {
        "card": card, "batch": n, "t0": t_start, "ticks": ticks,
        "tick_ms": tick_ms, "ticks_per_s": 1e3 / tick_ms,
        "scenario_ticks_per_s": n / tick_ms * 1e3,
        "tick_ms_with_parts_synchronized": tick_sync_ms,
        "part_ms": part_ms,
        "rest_of_tick_ms": tick_sync_ms - sum(part_ms.values()),
        "chol_inv_tile_launches_per_tick": tile_launches,
        "profiled_ticks": profiled, "tick_ms_under_profiler": tick_prof_ms,
        "device_busy_ms_per_tick": busy_ms,
        "device_idle_share_vs_unprofiled_tick": 1.0 - busy_ms / tick_ms,
        "kernel_launches_per_tick": launches / profiled,
        "kernel_launches_per_tick_by_part": by_part,
        "gauss_seidel": {
            "plant_ms_without": part_ms_no_gs["plant"],
            "ms_per_tick": part_ms["plant"] - part_ms_no_gs["plant"],
            "plant_launches_without": by_part_no_gs["plant"],
            "launches_per_tick": by_part["plant"] - by_part_no_gs["plant"]},
        "top_kernels_ms_per_tick": [
            {"name": k[:90], "ms": us / 1e3 / profiled,
             "calls": counts[k] / profiled} for k, us in top],
    }


def main():
    batches = [int(b) for b in (sys.argv[1] if len(sys.argv) > 1
                                else "1,64").split(",")]
    t_start = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    ticks = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    profiled = int(sys.argv[4]) if len(sys.argv) > 4 else 2

    from cmpc_tpu_torch.config import resolve_device

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    for n in batches:
        print(json.dumps(profile_batch(n, t_start, ticks, profiled, dev,
                                       smi.stdout.strip()), indent=1),
              flush=True)


if __name__ == "__main__":
    main()
