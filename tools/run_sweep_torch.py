"""Large-scale Monte-Carlo robustness sweep of the PyTorch/CUDA port: a
randomized batch of full-length walks (parallel/mesh.make_batch, seed 7)
on one GPU, with the statistics reduced on the device; under torchrun
sharded over its ranks (one per card), rank 0 writing the JSON with the
per-scenario rows gathered in global order.

The walk runs as CHUNKED rollouts (closed_loop.rollout t0/carry_in): the
LoopCarry (plant + live plan + solver warm start) flows between chunks and
only each chunk's reduced (n, 4) statistics are kept, so the trace of a
wide batch over thousands of ticks is never held.

Writes the JSON to --out (default runs/sweep_torch.json) and prints it.
Run from the repository root:
    python tools/run_sweep_torch.py [n_scenarios] [T_ticks] [chunk]
                                    [--device cuda] [--out PATH]
    torchrun --nproc-per-node=K tools/run_sweep_torch.py ...
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

SEED = 7


def survivor_stats(acc: np.ndarray, ticks: int) -> dict:
    """The "stats" block from (n, 4) accumulated chunk statistics.  A
    fallen scenario's post-fall trajectory is unbounded (finite but
    meaningless), so the failure RATE and the survivors' tracking quality
    are reported separately, plus whole-batch percentiles.  The survivors'
    figures are None when every scenario fell."""
    max_err = acc[:, 1]
    alive = max_err <= 0.3

    def over_survivors(x, reduce=np.mean):
        return float(reduce(x[alive])) if alive.any() else None

    return {
        "fall_rate": float(np.mean(~alive)),
        "rmse_xy_survivors": over_survivors(np.sqrt(acc[:, 0] / ticks)),
        "max_err_survivors": over_survivors(max_err, np.max),
        "r_prim_mean_survivors": over_survivors(acc[:, 3] / ticks),
        "lyap_mean_survivors": over_survivors(acc[:, 2] / ticks),
        "err_p50": float(np.percentile(max_err, 50)),
        "err_p95": float(np.percentile(max_err, 95)),
    }


def run(n: int, T: int | None, chunk: int, device="cuda",
        dtype=torch.float32, cfg=None, mesh=None) -> dict:
    """Run the sweep; returns the JSON payload.  With a mesh (from
    parallel/mesh.make_mesh) each rank runs its share of the n scenarios and
    every rank returns the payload of the whole batch."""
    from cmpc_tpu_torch.config import WalkConfig, resolve_device
    from cmpc_tpu_torch.parallel import mesh as pm
    from cmpc_tpu_torch.plan import timing as tm

    device = resolve_device(device) if mesh is None else mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = cfg or WalkConfig()
    if T is None:
        T = tm.build_timing(cfg).total_ticks
    scenarios = pm.make_batch(cfg, n, seed=SEED, device=device, dtype=dtype)
    if mesh is not None:
        scenarios = pm.shard_scenarios(scenarios, mesh)
    on_cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    ranks = 1 if mesh is None else mesh.world_size
    rank = 0 if mesh is None else mesh.rank
    print(f"[sweep] n={n} T={T} chunk={chunk} device={name} rank={rank} "
          f"of {ranks}", file=sys.stderr, flush=True)

    t0_wall = time.perf_counter()

    def on_chunk(k, n_chunks):
        print(f"[sweep] rank {rank}: chunk {k + 1}/{n_chunks} done "
              f"({time.perf_counter() - t0_wall:.0f}s)",
              file=sys.stderr, flush=True)

    acc, _, ticks = pm.sweep_chunked(scenarios, cfg, T, chunk, on_chunk,
                                     mesh=mesh)
    if on_cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0_wall

    out = {
        "n_scenarios": n,
        "ticks": ticks,
        "solves": n * ticks,
        "wall_s": round(wall, 1),
        "solves_per_s": round(n * ticks / wall, 1),
        "device": name,
        "chunk": chunk,
        "stats": survivor_stats(acc, ticks),
        "note": ("randomized pushes (sigma 10 N), payloads (0-3 kg) and "
                 "gain variations over full-length walks "
                 "(parallel/mesh.make_batch); fall = tracking blowup "
                 "> 0.3 m; wall time includes planner set-up; chunked "
                 "rollouts (see module docstring)"),
    }
    if mesh is not None:
        out.update(ranks=ranks, backend=mesh.backend)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1024,
                    help="scenario count")
    ap.add_argument("T", type=int, nargs="?", default=None,
                    help="ticks (default: the full walk)")
    ap.add_argument("chunk", type=int, nargs="?", default=300,
                    help="ticks per chunked rollout")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--backend", default=None,
                    help="under torchrun: the process group's backend "
                         "(default nccl on cards, gloo on the CPU)")
    ap.add_argument("--out", default=os.path.join("runs", "sweep_torch.json"))
    args = ap.parse_args(argv)
    from cmpc_tpu_torch.parallel import mesh as pm

    if pm.under_torchrun():
        mesh = pm.make_mesh(args.device, args.backend)
        try:
            payload = run(args.n, args.T, args.chunk, mesh=mesh)
        finally:
            mesh.close()
        if mesh.rank:
            return
    else:
        payload = run(args.n, args.T, args.chunk, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
