"""Step the PyTorch port's closed-loop tick from the JAX package's recorded
states (tools/step_parity_jax.py's carries.npz) on any device, and report
how far each tick lands from JAX's own.

At every recorded tick t the port starts from JAX's carry before t, in the
recorded working type, as tests/test_torch_closed_loop.py does; its next
plant state (com_pos, com_vel, hw), live footstep plan and solver residual
are compared with JAX's.  In float64 a difference above TOL at some tick is
a fault of one tick's computation; none means that two free-running walks
part only through the loop's amplification of last-bit differences.  In
float32 the differences are rounding's, and runs compare by their spread:
the card with its kernel, the card with the kernel's plain version in its
place (--plain-tile), and the CPU.

    python tools/step_parity_torch.py runs/jax_f32/carries.npz \\
        [--device cuda] [--plain-tile] [--out PATH]

--decisions (carries recorded with step_parity_jax.py --decisions) also
counts the solver's discrete decisions of both packages at the recorded
ticks: the merit line search's chosen step length (per candidate), the
interior-point iterations frozen by a non-finite Newton direction, and
the footstep adaptations (with the ticks and rows where the two packages
decide otherwise), under "decisions".

Prints one JSON object: per row the largest difference of each quantity,
the tick of the largest, the first tick over TOL (or null), percentiles
of the per-tick largest difference, and every 100 ticks the largest
difference and the JAX walk's xy tracking error; the tile kernel's
launches.  Imports no JAX.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np
import torch

TOL = 1e-6              # tests/test_torch_closed_loop.py's, in float64
WINDOW = 100
QUANTITIES = ("r_prim", "plan_pos", "com_pos", "com_vel", "hw")


def carry_dict(z, prefix: str, k: int) -> dict:
    """The k-th recorded carry under `prefix` in the nested form of
    cmpc_tpu_torch.convert.loop_carry_from_numpy."""
    d = {"plant": {}, "solver": {}}
    for key in z.files:
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        if len(parts) == 3:
            d[parts[1]][parts[2]] = z[key][k]
        else:
            d[parts[1]] = z[key][k]
    return d


class _Decisions:
    """Wraps the port's ``torch`` in ops/sqp (the line search's argmin) and
    ops/pdip (nan_to_num of dv, dw, dlam, in this order: the guarded
    update) to count the solver's discrete decisions per scenario."""

    def __init__(self, n_alphas: int):
        self.alpha = np.zeros(n_alphas, np.int64)
        self.frozen = 0
        self.pdip = 0

    def wrap(self, kind: str):
        rec, pending = self, []

        class Proxy:
            def __getattr__(self, name):
                return getattr(torch, name)

            def argmin(self, x, *a, **k):
                r = torch.argmin(x, *a, **k)
                if kind == "sqp":
                    np.add.at(rec.alpha, r.cpu().numpy().ravel(), 1)
                return r

            def nan_to_num(self, x, *a, **k):
                if kind == "pdip":
                    pending.append(x)
                    if len(pending) == 3:         # dv, dw, dlam of one step
                        ok = torch.stack([torch.isfinite(v).all(1)
                                          for v in pending]).all(0)
                        pending.clear()
                        rec.frozen += int((~ok).sum())
                        rec.pdip += ok.numel()
                return torch.nan_to_num(x, *a, **k)

        return Proxy()


def _decision_summary(alpha, frozen, pdip, adapted) -> dict:
    alpha = np.asarray(alpha).sum(0)
    return {"alpha_counts": alpha.tolist(),
            "rejected_share": float(alpha[-1] / max(alpha.sum(), 1)),
            "frozen": int(np.sum(frozen)), "pdip_steps": int(np.sum(pdip)),
            "frozen_share": float(np.sum(frozen) / max(np.sum(pdip), 1)),
            "adaptations": int(np.sum(adapted))}


def run(path: str, device="cuda", plain=False, decisions=False) -> dict:
    from cmpc_tpu_torch import convert
    from cmpc_tpu_torch.config import WalkConfig, resolve_device
    from cmpc_tpu_torch.ops import batched_chol as bc
    from cmpc_tpu_torch.sim import closed_loop
    from run_sweep_torch import plain_tile

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if plain:
        plain_tile()
    z = np.load(path)
    dtype = getattr(torch, str(z["dtype"]))
    names = [str(r) for r in z["rows"]]
    ticks = z["ticks"].tolist()
    sc = convert.scenario_from_numpy(
        {k.split("/", 1)[1]: z[k] for k in z.files
         if k.startswith("scenario/")}, device, dtype)
    _, tick = closed_loop.rollout(sc, WalkConfig(), return_tick=True)
    dec = None
    if decisions:
        from cmpc_tpu_torch.ops import pdip, sqp
        if "decisions/alpha" not in z.files:
            raise ValueError(f"{path} holds no decisions: record it with "
                             f"step_parity_jax.py --decisions")
        dec = _Decisions(z["decisions/alpha"].shape[1])
        saved = sqp.torch, pdip.torch
        sqp.torch, pdip.torch = dec.wrap("sqp"), dec.wrap("pdip")
        port = {"alpha": [], "frozen": [], "pdip": [], "adapted": []}

    diffs = {q: np.zeros((len(ticks), len(names))) for q in QUANTITIES}
    bc.LAUNCHES["chol_inv_tile"] = 0
    t_wall = time.perf_counter()
    try:
        for k, t in enumerate(ticks):
            carry = convert.loop_carry_from_numpy(carry_dict(z, "before", k),
                                                  device, dtype)
            if dec is not None:
                dec.alpha[:] = 0
                dec.frozen = dec.pdip = 0
            got_carry, got_tr = tick(carry, t)
            if dec is not None:
                port["alpha"].append(dec.alpha.copy())
                port["frozen"].append(dec.frozen)
                port["pdip"].append(dec.pdip)
                port["adapted"].append(
                    got_tr.adapted.reshape(-1).cpu().numpy())
            want = carry_dict(z, "after", k)
            got = {"r_prim": got_tr.r_prim, "plan_pos": got_carry.plan_pos,
                   **got_carry.plant._asdict()}
            want = {"r_prim": z["r_prim"][k], "plan_pos": want["plan_pos"],
                    **want["plant"]}
            for q in QUANTITIES:
                d = np.abs(got[q].double().cpu().numpy() - want[q])
                diffs[q][k] = d.reshape(len(names), -1).max(axis=1)
    finally:
        if dec is not None:
            sqp.torch, pdip.torch = saved
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_wall
    if dec is not None:
        jax_adapted = z["decisions/adapted"].astype(bool)
        port_adapted = np.stack(port["adapted"]).astype(bool)
        differ = np.argwhere(jax_adapted != port_adapted)
        dec_out = {"jax": _decision_summary(
                       z["decisions/alpha"], z["decisions/frozen"],
                       z["decisions/pdip"], jax_adapted),
                   "port": _decision_summary(port["alpha"], port["frozen"],
                                             port["pdip"], port_adapted),
                   "adaptation_differs": [[ticks[k], names[b]]
                                          for k, b in differ]}

    rows = []
    for b, name in enumerate(names):
        per_tick = np.max([diffs[q][:, b] for q in QUANTITIES], axis=0)
        over = np.nonzero(per_tick > TOL)[0]
        first = (None if not len(over) else
                 {"tick": ticks[over[0]],
                  **{q: float(diffs[q][over[0], b]) for q in QUANTITIES}})
        windows = []
        for w0 in range(0, ticks[-1] + 1, WINDOW):
            sel = [k for k, t in enumerate(ticks) if w0 <= t < w0 + WINDOW]
            if sel:
                windows.append({"ticks": [ticks[sel[0]], ticks[sel[-1]]],
                                "max_diff": float(per_tick[sel].max()),
                                "jax_err_xy_at_end":
                                    float(z["err_xy"][sel[-1], b])})
        rows.append({"row": name,
                     "max_diff": {q: float(diffs[q][:, b].max())
                                  for q in QUANTITIES},
                     "worst_tick": ticks[int(np.argmax(per_tick))],
                     "first_over_tol": first,
                     "p50": float(np.percentile(per_tick, 50)),
                     "p90": float(np.percentile(per_tick, 90)),
                     "by_100_ticks": windows})
    return {"file": os.path.basename(os.path.dirname(os.path.abspath(path))),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "dtype": str(z["dtype"]), "plain_tile": plain, "tol": TOL,
            "ticks_stepped": len(ticks), "first_tick": ticks[0],
            "last_tick": ticks[-1],
            "launches": bc.LAUNCHES["chol_inv_tile"],
            "wall_s": round(wall, 1), "rows": rows,
            **({"decisions": dec_out} if dec is not None else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("carries", help="carries.npz of tools/step_parity_jax.py")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--plain-tile", action="store_true",
                    help="the tile kernel's plain torch version in its place")
    ap.add_argument("--decisions", action="store_true",
                    help="count both packages' discrete solver decisions")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    out = run(args.carries, args.device, args.plain_tile, args.decisions)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
