"""The figures of the full-length centroidal walks that
tests/test_full_walk.py bounds, and those of its first 500 ticks that
tests/test_closed_loop.py bounds, printed as one JSON object beside the
bounds (tests/test_torch_envelopes.py holds the port to the same figures).

Either runs the port's two walks as one B = 2 rollout (row 0 the nominal
walk with its 3 N push over ticks 801-899, row 1 the payload walk) on the
given device in the given precision, counting the tile kernel's launches:
    python tools/walk_envelope_torch.py --device cuda --dtype f64
or reads the traces that the `walk` command of either package saved, or
tools/step_parity_jax.py (the JAX package's walks in either working type):
    python -m cmpc_tpu walk --out runs/walk_jax
    python -m cmpc_tpu walk --payload --out runs/walk_payload_jax
    python tools/walk_envelope_torch.py --trace runs/walk_jax/trace.npz \\
        --payload-trace runs/walk_payload_jax/trace.npz

--replicates R runs R rounding replicates of each walk as one B = 2R
rollout (rows 0..R-1 the nominal walk, R..2R-1 the payload walk; replicate
k has its starting CoM height k ulps up, parallel/mesh.replicate), and
writes under "replicates" each one's figures with the bounds it fails,
and how many replicates of each walk pass every bound:
    python tools/walk_envelope_torch.py --device cuda --replicates 8

--save FILE writes the per-tick xy tracking error and |hw| of each walk
(replicate 0).
The closed loop amplifies last-bit differences (PERF.md): compare runs by
these figures against their bounds, not with each other.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H = 0.72                  # WalkConfig().h
M_G = 40.05 * 9.81        # the weight test_closed_loop.py compares with
TAIL = 200                # the stopping phase the walking bounds leave out

NOMINAL_BOUNDS = {
    "com_pos_finite": "true", "err_xy_to_T_minus_200": "< 0.035",
    "err_xy_max": "< 0.12", "com_z_dev_max": "< 0.03", "final_com_x": "> 1.8",
    "r_prim_median": "< 1e-2", "hw_to_T_minus_200": "< 3.2",
    "hw_max": "< 5.5", "push_post_1200_1399": "< max(2 x pre, 0.03)",
    "fz_mean_gap_50_499": "< 30", "com_x_499": "> 0.1",
    "hw_max_0_499": "< 4.0", "hw_max_200_269": "> 0.3",
    "hw_min_480_499": "< hw_max_200_479"}
PAYLOAD_BOUNDS = {
    "err_xy_to_T_minus_200": "< 0.08", "err_xy_max": "< 0.15",
    "final_com_x": "> 1.8", "hw_to_T_minus_200": "< 4.5",
    "hw_max": "< 8.0"}


def _series(tr: dict):
    err = np.linalg.norm(tr["com_pos"][:, :2] - tr["com_ref"][:, :2],
                         axis=-1)
    return err, np.linalg.norm(tr["hw"], axis=1)


def _first_over(x, bound):
    over = np.nonzero(x > bound)[0]
    return int(over[0]) if len(over) else None


def payload_figures(tr: dict) -> dict:
    """One walk's trace, arrays (T, ...) in float64: the figures of
    test_full_payload_walk_completes."""
    err, hw = _series(tr)
    T = len(err)
    return {"ticks": T,
            "err_xy_to_T_minus_200": float(err[:T - TAIL].max()),
            "err_xy_max": float(err.max()),
            "err_xy_argmax_tick": int(err.argmax()),
            "final_com_x": float(tr["com_pos"][-1, 0]),
            "hw_to_T_minus_200": float(hw[:T - TAIL].max()),
            "hw_max": float(hw.max()),
            "hw_argmax_tick": int(hw.argmax())}


def nominal_figures(tr: dict, event_ticks) -> dict:
    """The figures of test_full_walk.py's nominal tests and of
    test_closed_loop.py's on the first 500 ticks; `event_ticks` are the
    gait's adaptation ticks."""
    err, hw = _series(tr)
    T = len(err)
    err_y = np.abs(tr["com_pos"][:, 1] - tr["com_ref"][:, 1])
    fz = tr["forces"][:500].reshape(500, 8, 3)[..., 2].sum(-1)
    adapted = np.nonzero(tr["adapted"])[0]
    return {"ticks": T,
            "com_pos_finite": bool(np.isfinite(tr["com_pos"]).all()),
            "err_xy_to_T_minus_200": float(err[:T - TAIL].max()),
            "err_xy_max": float(err.max()),
            "err_xy_argmax_tick": int(err.argmax()),
            "err_xy_first_tick_over_0.035": _first_over(err, 0.035),
            "com_z_dev_max": float(np.abs(tr["com_pos"][:, 2] - H).max()),
            "final_com_x": float(tr["com_pos"][-1, 0]),
            "r_prim_median": float(np.median(tr["r_prim"])),
            "hw_to_T_minus_200": float(hw[:T - TAIL].max()),
            "hw_max": float(hw.max()),
            "hw_argmax_tick": int(hw.argmax()),
            "adaptation_at_event_ticks": bool(np.array_equal(
                adapted, np.asarray(event_ticks))),
            "push_pre_600_799": float(err_y[600:800].max()),
            "push_post_1200_1399": float(err_y[1200:1400].max()),
            "fz_mean_gap_50_499": float(abs(fz[50:].mean() - M_G)),
            "com_x_499": float(tr["com_pos"][499, 0]),
            "hw_max_0_499": float(hw[:500].max()),
            "hw_max_200_269": float(hw[200:270].max()),
            "hw_min_480_499": float(hw[480:500].min()),
            "hw_max_200_479": float(hw[200:480].max())}


def failed_bounds(figs: dict, bounds: dict) -> list:
    """The keys of `bounds` whose figure in `figs` misses its bound: a
    number ("< 0.035"), another figure ("< hw_max_200_479"), "true", or
    the push test's "< max(2 x pre, 0.03)" (pre: push_pre_600_799)."""
    failed = []
    for key, bound in bounds.items():
        x = figs[key]
        if bound == "true":
            ok = x is True
        else:
            op, rhs = bound.split(" ", 1)
            if rhs == "max(2 x pre, 0.03)":
                lim = max(2.0 * figs["push_pre_600_799"], 0.03)
            else:
                lim = figs[rhs] if rhs in figs else float(rhs)
            ok = x < lim if op == "<" else x > lim
        if not ok:
            failed.append(key)
    return failed


def _load(path):
    with np.load(path) as z:
        tr = {k: z[k].astype(np.float64) for k in z.files}
    if tr["com_pos"].ndim == 3:        # the port's traces are (B, T, ...)
        tr = {k: v[0] for k, v in tr.items()}
    return tr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--trace", default=None,
                    help="the nominal walk's trace.npz instead of a run")
    ap.add_argument("--payload-trace", default=None,
                    help="the payload walk's trace.npz, with --trace")
    ap.add_argument("--replicates", type=int, default=1,
                    help="rounding replicates of each walk (a run only)")
    ap.add_argument("--save", default=None,
                    help="write the per-tick err_xy and |hw| here (.npz)")
    args = ap.parse_args()

    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.plan import timing as tm

    cfg = WalkConfig()
    timing = tm.build_timing(cfg)
    R = args.replicates
    if args.trace:
        if R != 1:
            ap.error("--replicates runs the walks; a trace is one walk")
        rows = [_load(args.trace)]
        if args.payload_trace:
            rows.append(_load(args.payload_trace))
        out = {"trace": args.trace, "payload_trace": args.payload_trace}
    else:
        import torch

        from cmpc_tpu_torch.config import (Scenario, nominal_scenario,
                                           payload_scenario, resolve_device)
        from cmpc_tpu_torch.ops import batched_chol as bc
        from cmpc_tpu_torch.parallel.mesh import replicate
        from cmpc_tpu_torch.sim import closed_loop

        dev = resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
        T = timing.total_ticks
        nom = nominal_scenario(cfg, device=dev, dtype=dtype)
        pay = payload_scenario(cfg, device=dev, dtype=dtype)
        walks = [replicate(w, k) for w in (nom, pay) for k in range(R)]
        sc = Scenario(*(torch.cat(f) for f in zip(*walks)))
        bc.LAUNCHES["chol_inv_tile"] = 0
        t0 = time.perf_counter()
        _, trace = closed_loop.rollout(sc, cfg, T_sim=T)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        rows = [{k: v[b].double().cpu().numpy()
                 for k, v in trace._asdict().items()} for b in range(2 * R)]
        out = {"device": str(dev), "dtype": args.dtype, "ticks": T,
               "wall_s": wall, "chol_inv_tile_launches":
               bc.LAUNCHES["chol_inv_tile"]}
        if dev.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(dev)
    events = np.nonzero(timing.update_event[:len(rows[0]["com_pos"])])[0]
    out["nominal"] = nominal_figures(rows[0], events)
    out["nominal_bounds"] = NOMINAL_BOUNDS
    if len(rows) > 1:
        out["payload"] = payload_figures(rows[R])
        out["payload_bounds"] = PAYLOAD_BOUNDS
    if R > 1:
        reps = []
        for k in range(R):
            nom_k = out["nominal"] if k == 0 else nominal_figures(rows[k],
                                                                  events)
            pay_k = out["payload"] if k == 0 else payload_figures(
                rows[R + k])
            reps.append({"nudge": k, "nominal": nom_k, "payload": pay_k,
                         "nominal_failed": failed_bounds(nom_k,
                                                         NOMINAL_BOUNDS),
                         "payload_failed": failed_bounds(pay_k,
                                                         PAYLOAD_BOUNDS)})
        out["replicates"] = reps
        out["nominal_pass"] = sum(not r["nominal_failed"] for r in reps)
        out["payload_pass"] = sum(not r["payload_failed"] for r in reps)
    if args.save:
        os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
        np.savez(args.save, **{f"{name}_{k}": s for name, tr in
                               zip(("nominal", "payload"), rows[::R])
                               for k, s in zip(("err_xy", "hw"),
                                               _series(tr))})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
