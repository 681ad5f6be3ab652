"""Rerun chosen scenarios of a sweep through the JAX package on the CPU,
for comparison with the PyTorch port's per-scenario rows.

Reads two JSON files written by tools/run_sweep_torch.py on the same batch
(the same n, seed and chunk, which it takes from them; typically one run
in float32 and one in float64),
picks the scenarios that fell (max_err > 0.3) in either, which include
those whose outcome differs (at most --max of them, lowest indices first),
and runs them through cmpc_tpu.sim.closed_loop.rollout, vmapped and
chunked as tools/run_sweep.py runs the sweep, in the given working type.
It stops after the latest chunk in which any chosen scenario fell in
either file, so every fall the port recorded lies inside the run.

Prints one JSON object and writes it to --out: per chosen scenario its
global index, the two port rows' fall_chunk and max_err and the JAX run's,
in the order of the indices.

    python tools/sweep_rows_jax.py PORT_F32.json PORT_F64.json \\
        --dtype float64 [--max 32] [--out PATH]

--scenarios I,J,... runs the given indices of the batch instead, for as
many ticks as the one port file given runs, on its batch (its n, seed and
chunk); their rows then hold the JAX run's figures alone.  Several such
runs over parts of one list split the work across processes:

    python tools/sweep_rows_jax.py PORT_F32.json --scenarios 1,6,14 \\
        --dtype float32 --out runs/jax_rows_0.json

--nudge K runs the rounding replicate K, as the port's
parallel/mesh.replicate makes it: every starting CoM height K ulps of
the working type up.

JAX runs on the CPU; float64 switches on jax_enable_x64 and casts the
batch's floats (all float32 values, as make_batch draws them) to float64.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FALL_ERR = 0.3


def choose(rows_a: list, rows_b: list, limit: int) -> list:
    """Indices of the scenarios that fell in either row list (those whose
    outcome differs among them), ascending, at most `limit`."""
    if len(rows_a) != len(rows_b):
        raise ValueError(f"row counts differ: {len(rows_a)} and "
                         f"{len(rows_b)}")
    fell_a = [r["max_err"] > FALL_ERR for r in rows_a]
    fell_b = [r["max_err"] > FALL_ERR for r in rows_b]
    return [i for i, (a, b) in enumerate(zip(fell_a, fell_b)) if a or b
            ][:limit]


def nudge_heights(init_com: np.ndarray, k: int) -> np.ndarray:
    """init_com (n, 3) with every height (column 2) k ulps of its type up:
    the port's parallel/mesh.replicate on numpy arrays."""
    com = init_com.copy()
    for _ in range(k):
        com[:, 2] = np.nextafter(com[:, 2], np.asarray(np.inf, com.dtype))
    return com


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ports", nargs="+",
                    help="two run_sweep_torch.py JSONs (e.g. float32, "
                         "float64); one with --scenarios")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--max", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated indices: run these on the one "
                         "port file's batch")
    ap.add_argument("--nudge", type=int, default=0,
                    help="rounding replicate: the CoM height K ulps up")
    args = ap.parse_args(argv)
    if len(args.ports) != (1 if args.scenarios else 2):
        ap.error("give two port files, or --scenarios and one")

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cmpc_tpu.config import Scenario, WalkConfig
    from cmpc_tpu.parallel import mesh as pm
    from cmpc_tpu.sim import closed_loop

    runs = []
    for path in args.ports:
        with open(path) as f:
            runs.append(json.load(f))
    batch = ("n_scenarios", "seed", "chunk")
    if args.scenarios:
        a = b = None
        n, seed, chunk = (runs[0][k] for k in batch)
        idx = [int(i) for i in args.scenarios.split(",")]
        n_chunks = runs[0]["ticks"] // chunk
    else:
        a, b = runs
        if [a[k] for k in batch] != [b[k] for k in batch] \
                or "scenarios" in a or "scenarios" in b:
            raise ValueError("the two runs are not of the same whole batch")
        n, seed, chunk = (a[k] for k in batch)
        idx = choose(a["rows"], b["rows"], args.max)
        n_chunks = 1 + max((run["rows"][i]["fall_chunk"] for run in (a, b)
                            for i in idx
                            if run["rows"][i]["fall_chunk"] is not None),
                           default=-1)
    print(f"[rows] {len(idx)} scenarios {idx}, {n_chunks} chunks of "
          f"{chunk}, {args.dtype}", file=sys.stderr, flush=True)

    cfg = WalkConfig()
    # the batch's values are float32 whatever the working type
    batch = {k: np.asarray(v)[idx]
             for k, v in pm.make_batch(cfg, n, seed=seed)._asdict()
             .items()}
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
        batch = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
                 for k, v in batch.items()}
    batch["init_com"] = nudge_heights(batch["init_com"], args.nudge)
    sc = Scenario(**{k: jnp.asarray(v) for k, v in batch.items()})

    carry = jax.jit(jax.vmap(
        lambda s: closed_loop.rollout(s, cfg, T_sim=0)[0]))(sc)

    @jax.jit
    def chunk_step(scen, carry, t0):
        def one(s, c):
            carry, tr = closed_loop.rollout(s, cfg, chunk, t0=t0,
                                            carry_in=c)
            err = jnp.linalg.norm(tr.com_pos[:, :2] - tr.com_ref[:, :2],
                                  axis=-1)
            return carry, jnp.max(err)
        return jax.vmap(one)(scen, carry)

    max_err = np.zeros(len(idx))
    fall_chunk = np.full(len(idx), -1)
    t_wall = time.perf_counter()
    for k in range(n_chunks):
        carry, m = chunk_step(sc, carry, jnp.asarray(k * chunk))
        max_err = np.maximum(max_err, np.asarray(m, np.float64))
        fall_chunk[(fall_chunk < 0) & (max_err > FALL_ERR)] = k
        print(f"[rows] chunk {k + 1}/{n_chunks} "
              f"({time.perf_counter() - t_wall:.0f} s)", file=sys.stderr,
              flush=True)

    def fc(k):
        return None if k is None or k < 0 else int(k)

    def port_row(run, i):
        return {"fall_chunk": run["rows"][i]["fall_chunk"],
                "max_err": run["rows"][i]["max_err"]}

    out = {"dtype": args.dtype, "seed": seed, "n_scenarios": n,
           "nudge": args.nudge,
           "chunk": chunk, "ticks": n_chunks * chunk,
           "wall_s": round(time.perf_counter() - t_wall, 1),
           "rows": [{"index": i,
                     "jax": {"fall_chunk": fc(fall_chunk[j]),
                             "max_err": float(max_err[j])}}
                    for j, i in enumerate(idx)]}
    if a is not None:
        for key, run, path in (("port_a", a, args.ports[0]),
                               ("port_b", b, args.ports[1])):
            out[key] = {"file": os.path.basename(path),
                        "dtype": run.get("dtype")}
            for j, i in enumerate(idx):
                out["rows"][j][key] = port_row(run, i)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
