"""Command-line runner: ``python -m cmpc_tpu_torch <command>``.

  walk     the closed-loop walk on the centroidal plant -> trace + summary
           (the flat-ground walk, or --payload for the payload variant),
           batched over --batch identical scenarios.
  walk-wb  the same scenario through the full whole-body pipeline
           (MPC -> ID QP -> articulated impulse-contact plant) on HRP-4.
  sweep    a randomized Monte-Carlo robustness sweep: on one device, or
           under torchrun sharded over its ranks, one per card
           (``torchrun --nproc-per-node=K -m cmpc_tpu_torch sweep``).
  ismpc    the legacy IS-MPC/LIP baseline closed loop.

Every command takes --device (default cuda) and raises where that device
is missing: none falls back to the CPU.  ``walk`` and ``walk-wb`` take
--plots (needs matplotlib).
"""

from __future__ import annotations

import argparse
import json
import time

def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")


def _walk_args(p):
    p.add_argument("--out", default="runs/latest",
                   help="output directory for trace and summary")
    p.add_argument("--ticks", type=int, default=None,
                   help="simulation ticks (default: full walk)")
    p.add_argument("--steps", type=int, default=20, help="footstep count")
    p.add_argument("--payload", action="store_true",
                   help="payload scenario (2 kg box, gains k1=7 k2=1)")
    p.add_argument("--push", type=float, nargs=3, default=None,
                   metavar=("FX", "FY", "FZ"),
                   help="external push force N (default: [0,3,0] for t in "
                        "(800,900))")
    _device_arg(p)
    p.add_argument("--batch", type=int, default=1,
                   help="number of identical scenarios run as one batch")
    p.add_argument("--plots", action="store_true",
                   help="render scenario 0's four dashboards into --out "
                        "(needs matplotlib)")


def _walk(args, device):
    import torch

    from cmpc_tpu_torch.config import (WalkConfig, nominal_scenario,
                                       payload_scenario)
    from cmpc_tpu_torch.runtime import trace as rtrace
    from cmpc_tpu_torch.sim import closed_loop

    cfg = WalkConfig(num_steps=args.steps)
    kw = dict(device=device, dtype=torch.float32)
    if args.payload:
        sc = payload_scenario(cfg, **kw)
        if args.push is not None:
            sc = sc._replace(
                push_force=torch.tensor([args.push], **kw),
                push_start=torch.tensor([801], device=device),
                push_end=torch.tensor([899], device=device))
    elif args.push is not None:
        sc = nominal_scenario(cfg, push=tuple(args.push), **kw)
    else:
        sc = nominal_scenario(cfg, **kw)
    sc = sc.repeat(args.batch)

    t0 = time.perf_counter()
    if args.cmd == "walk":
        _, tr = closed_loop.rollout(sc, cfg, T_sim=args.ticks)
    else:
        from cmpc_tpu_torch.rbd.urdf import load_hrp4
        from cmpc_tpu_torch.sim import wholebody_loop

        _, tr = wholebody_loop.rollout(load_hrp4(payload=False), sc, cfg,
                                       T_sim=args.ticks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    row0 = {k: v[0] for k, v in tr._asdict().items()}
    summary = rtrace.summarize(row0)
    meta = {"cmd": args.cmd, "cfg": str(cfg), "device": str(device),
            "batch": args.batch, "wall_s": wall,
            "ticks_per_s": summary.ticks / wall,
            "summary": summary._asdict()}
    if device.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(device)
    rtrace.save(f"{args.out}/trace.npz", tr, meta=meta)
    if args.plots:
        from cmpc_tpu_torch.runtime import plots as rplots
        rplots.plot_all(row0, args.out)
    print(json.dumps({**summary._asdict(), "device": str(device),
                      "batch": args.batch, "wall_s": wall}))


def _sweep(args, device):
    """The sweep on `device`; under torchrun's environment sharded over the
    ranks of its process group (each on its own card unless --device names
    one, --backend as make_mesh takes it), rank 0 printing the JSON."""
    import torch

    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.parallel import mesh as pmesh

    t0 = time.time()
    cfg = WalkConfig(sqp_iters=2, admm_iters=15)
    kw = dict(seed=args.seed, dtype=torch.float32)
    if not pmesh.under_torchrun():
        batch = pmesh.make_batch(cfg, n=max(args.n, 1), device=device, **kw)
        stats = pmesh.sweep(batch, cfg, T_sim=args.ticks)
        out = {k: float(v) for k, v in stats._asdict().items()}
        rank = 0
    else:
        m = pmesh.make_mesh(args.device, args.backend)
        try:
            W = m.world_size
            n = max(args.n, W)
            n -= n % W
            batch = pmesh.make_batch(cfg, n=n, device="cpu", **kw)
            stats = pmesh.sweep(pmesh.shard_scenarios(batch, m), cfg,
                                T_sim=args.ticks, mesh=m)
            # read before the group is torn down (NCCL reduces
            # asynchronously on the card)
            out = {k: float(v) for k, v in stats._asdict().items()}
        finally:
            m.close()
        rank = m.rank
    out["wall_s"] = time.time() - t0
    if rank == 0:
        print(json.dumps(out))


def _ismpc(args, device):
    from cmpc_tpu_torch.sim import ismpc_loop

    t0 = time.time()
    _, tr = ismpc_loop.run(T_sim=args.ticks, device=device)
    com = tr.com_pos[0].cpu().numpy()
    zmp = tr.zmp_pos[0].cpu().numpy()
    print(json.dumps({
        "ticks": int(com.shape[0]),
        "final_com": com[-1].tolist(),
        "zmp_span_y": float(zmp[:, 1].max() - zmp[:, 1].min()),
        "wall_s": time.time() - t0}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cmpc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("walk", "walk-wb"):
        _walk_args(sub.add_parser(name))
    sp = sub.add_parser("sweep")
    sp.add_argument("--out", default="runs/sweep")
    sp.add_argument("--n", type=int, default=64, help="scenario count")
    sp.add_argument("--ticks", type=int, default=400)
    sp.add_argument("--seed", type=int, default=0)
    _device_arg(sp)
    sp.add_argument("--backend", default=None,
                    help="under torchrun: the process group's backend "
                         "(default nccl on cards, gloo on the CPU; ranks "
                         "sharing one card pass gloo)")
    ip = sub.add_parser("ismpc")
    ip.add_argument("--out", default="runs/ismpc")
    ip.add_argument("--ticks", type=int, default=500)
    _device_arg(ip)
    args = ap.parse_args(argv)

    import torch

    from cmpc_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    # full-f32 matmuls: the JAX package pins Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    {"walk": _walk, "walk-wb": _walk, "sweep": _sweep,
     "ismpc": _ismpc}[args.cmd](
        args, device)


if __name__ == "__main__":
    main()
