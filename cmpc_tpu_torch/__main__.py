"""Command-line runner: ``python -m cmpc_tpu_torch walk``.

  walk     the closed-loop walk on the centroidal plant -> trace + summary
           (the flat-ground walk, or --payload for the payload variant),
           batched over --batch identical scenarios on --device.

walk-wb, sweep and ismpc belong to the JAX package and are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

_NOT_PORTED = ("walk-wb", "sweep", "ismpc")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cmpc_tpu_torch")
    ap.add_argument("cmd", choices=("walk",) + _NOT_PORTED)
    ap.add_argument("--out", default="runs/latest",
                    help="output directory for trace and summary")
    ap.add_argument("--ticks", type=int, default=None,
                    help="simulation ticks (default: full walk)")
    ap.add_argument("--steps", type=int, default=20, help="footstep count")
    ap.add_argument("--payload", action="store_true",
                    help="payload scenario (2 kg box, gains k1=7 k2=1)")
    ap.add_argument("--push", type=float, nargs=3, default=None,
                    metavar=("FX", "FY", "FZ"),
                    help="external push force N (default: [0,3,0] for t in "
                         "(800,900))")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--batch", type=int, default=1,
                    help="number of identical scenarios run as one batch")
    args = ap.parse_args(argv)
    if args.cmd in _NOT_PORTED:
        raise NotImplementedError(f"{args.cmd}: not yet ported to "
                                  f"cmpc_tpu_torch (see ROADMAP.md)")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available")
    # full-f32 matmuls: the JAX package pins Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

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
    _, tr = closed_loop.rollout(sc, cfg, T_sim=args.ticks)
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
    print(json.dumps({**summary._asdict(), "device": str(device),
                      "batch": args.batch, "wall_s": wall}))


if __name__ == "__main__":
    main()
