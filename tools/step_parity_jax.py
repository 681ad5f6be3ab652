"""Record the JAX package's closed loop on the CPU tick by tick, for
tools/step_parity_torch.py to step the PyTorch port from its states.

ROWS is a comma-separated list of `nominal` (nominal_scenario(WalkConfig()),
its 3 N push over ticks 801-899), `payload` (payload_scenario(WalkConfig()))
and indices of the sweep's batch (parallel/mesh.make_batch, 256 scenarios
at tools/run_sweep_torch.py's seed).  The rows run as one vmapped batch in
float32 or float64 (float64 switches on jax_enable_x64 and casts the
scenarios' floats, which hold float32 values), one jitted tick at a time
from the loop's own carry: the free-running walk.

Writes to --out:
  carries.npz  the carry before and after every --every-th tick (fields
               "before/plant/com_pos", ... stacked (K, B, ...)), the tick's
               r_prim and xy tracking error, the ticks, the rows' scenario
               fields, the row names and the working type;
  ROW.npz      each row's whole trace, as tools/walk_envelope_torch.py
               reads it with --trace.

    python tools/step_parity_jax.py nominal,payload --dtype float64 \\
        --out runs/jax_f64
    python tools/step_parity_jax.py nominal,1,6 --every 5 --out runs/jax_f32
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np

N_SWEEP = 256           # the sweep's batch, as PERF.md runs it


def flatten(carry, prefix: str) -> dict:
    """A LoopCarry as flat numpy arrays keyed "prefix/plant/com_pos"."""
    out = {f"{prefix}/plan_pos": np.asarray(carry.plan_pos),
           f"{prefix}/theta_hat": np.asarray(carry.theta_hat)}
    for part in ("plant", "solver"):
        for k, v in getattr(carry, part)._asdict().items():
            out[f"{prefix}/{part}/{k}"] = np.asarray(v)
    return out


def scenario_rows(names: list, cfg) -> dict:
    """The rows' scenario fields as numpy arrays (B, ...), float32 values."""
    from cmpc_tpu.config import nominal_scenario, payload_scenario
    from cmpc_tpu.parallel import mesh as jmesh
    from run_sweep_torch import SEED

    batch = {k: np.asarray(v) for k, v in
             jmesh.make_batch(cfg, N_SWEEP, seed=SEED)._asdict().items()}
    fixed = {"nominal": nominal_scenario(cfg), "payload": payload_scenario(cfg)}
    rows = []
    for name in names:
        if name in fixed:
            rows.append({k: np.asarray(v)
                         for k, v in fixed[name]._asdict().items()})
        else:
            rows.append({k: v[int(name)] for k, v in batch.items()})
    return {k: np.stack([r[k] for r in rows]).astype(batch[k].dtype)
            for k in batch}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", help="nominal, payload or sweep indices, "
                                 "comma-separated")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--ticks", type=int, default=None,
                    help="default: the whole walk")
    ap.add_argument("--every", type=int, default=1,
                    help="record the carries of every k-th tick")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cmpc_tpu.config import Scenario, WalkConfig
    from cmpc_tpu.plan import timing as tm
    from cmpc_tpu.sim import closed_loop

    cfg = WalkConfig()
    T = args.ticks or tm.build_timing(cfg).total_ticks
    names = args.rows.split(",")
    rows = scenario_rows(names, cfg)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
        rows = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                for k, v in rows.items()}
    sc = Scenario(**{k: jnp.asarray(v) for k, v in rows.items()})
    carry = jax.vmap(
        lambda s: closed_loop.rollout(s, cfg, return_tick=True)[0])(sc)
    step = jax.jit(jax.vmap(
        lambda s, c, t0: closed_loop.rollout(s, cfg, T_sim=1, t0=t0,
                                             carry_in=c),
        in_axes=(0, 0, None)))

    rec, ticks, traces = {}, [], []
    t_wall = time.perf_counter()
    for t in range(T):
        keep = t % args.every == 0
        if keep:
            for k, v in flatten(carry, "before").items():
                rec.setdefault(k, []).append(v)
        carry, tr = step(sc, carry, t)
        tr = {k: np.asarray(v)[:, 0] for k, v in tr._asdict().items()}
        traces.append(tr)
        if keep:
            ticks.append(t)
            for k, v in flatten(carry, "after").items():
                rec.setdefault(k, []).append(v)
            rec.setdefault("r_prim", []).append(tr["r_prim"])
            rec.setdefault("err_xy", []).append(np.linalg.norm(
                tr["com_pos"][:, :2] - tr["com_ref"][:, :2], axis=-1))
        if (t + 1) % 100 == 0:
            print(f"[record] tick {t + 1}/{T} "
                  f"({time.perf_counter() - t_wall:.0f} s)", file=sys.stderr,
                  flush=True)

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "carries.npz"),
             **{k: np.stack(v) for k, v in rec.items()},
             ticks=np.asarray(ticks), rows=np.asarray(names),
             dtype=np.asarray(args.dtype),
             **{f"scenario/{k}": v for k, v in rows.items()})
    for b, name in enumerate(names):
        np.savez(os.path.join(args.out, f"{name}.npz"),
                 **{k: np.stack([tr[k][b] for tr in traces])
                    for k in traces[0]})
    print(f"{args.dtype}: {T} ticks of {names}, {len(ticks)} recorded, in "
          f"{time.perf_counter() - t_wall:.1f} s -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
