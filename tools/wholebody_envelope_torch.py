"""The first-step figures of a whole-body walk: the quantities that
tests/test_wholebody_walk.py bounds (and chip_smoke.py's whole-body phase
holds the card to), printed as one JSON object.

Either runs the port's nominal whole-body walk (sim/wholebody_loop.rollout
on HRP-4, no push, B = 1) on the given device in the given precision:
    python tools/wholebody_envelope_torch.py --device cpu --dtype f64
or reads a trace that a `walk-wb` command of either package saved (the
default push of both commands starts at tick 801, after these ticks):
    python -m cmpc_tpu walk-wb --ticks 300 --out runs/wb_jax
    python tools/wholebody_envelope_torch.py --trace runs/wb_jax/trace.npz

The walk is sensitive to rounding (PERF.md): compare runs by these figures
against their bounds, not with each other.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BOUNDS = {"err_xy_to_tick_270": "< 0.03", "err_xy_max": "< 0.09",
          "com_z_dev_max": "< 0.03", "right_sole_apex_200_269":
          "0.012 .. 0.035", "right_sole_z_from_285": "< 0.01",
          "left_sole_max_200_269": "< 0.01", "progress_from_150": "> 0.01"}


def figures(tr: dict, h: float) -> dict:
    """tr: one scenario's trace, arrays (T, ...) with T >= 300."""
    com, ref = tr["com_pos"], tr["com_ref"]
    err = np.linalg.norm(com[:, :2] - ref[:, :2], axis=-1)
    zr, zl = tr["pose_r"][:, 5], tr["pose_l"][:, 5]
    return {"err_xy_to_tick_270": float(err[:271].max()),
            "err_xy_max": float(err.max()),
            "com_z_dev_max": float(np.abs(com[:, 2] - h).max()),
            "right_sole_apex_200_269": float(zr[200:270].max()),
            "right_sole_z_from_285": float(abs(zr[285:].max())),
            "left_sole_max_200_269": float(zl[200:270].max()),
            "progress_from_150": float(com[-1, 0] - com[150, 0]),
            "r_prim_id_median": float(np.median(tr["r_prim_id"]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--trace", default=None,
                    help="read this trace.npz instead of running the port")
    args = ap.parse_args()

    from cmpc_tpu_torch.config import WalkConfig

    cfg = WalkConfig()
    if args.trace:
        with np.load(args.trace) as z:
            tr = {k: z[k].astype(np.float64) for k in z.files}
        if tr["com_pos"].ndim == 3:        # the port's traces are (B, T, ...)
            tr = {k: v[0] for k, v in tr.items()}
        out = {"trace": args.trace, "ticks": int(tr["com_pos"].shape[0])}
    else:
        import torch

        from cmpc_tpu_torch.config import nominal_scenario, resolve_device
        from cmpc_tpu_torch.rbd.urdf import load_hrp4
        from cmpc_tpu_torch.sim import wholebody_loop

        dev = resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
        sc = nominal_scenario(cfg, push=(0.0, 0.0, 0.0), push_window=(0, 0),
                              device=dev, dtype=dtype)
        t0 = time.perf_counter()
        _, trace = wholebody_loop.rollout(load_hrp4(), sc, cfg,
                                          T_sim=args.ticks)
        tr = {k: v[0].double().cpu().numpy()
              for k, v in trace._asdict().items()}
        out = {"device": str(dev), "dtype": args.dtype, "ticks": args.ticks,
               "wall_s": time.perf_counter() - t0}
        if dev.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(dev)
    print(json.dumps({**out, **figures(tr, cfg.h), "bounds": BOUNDS}))


if __name__ == "__main__":
    main()
