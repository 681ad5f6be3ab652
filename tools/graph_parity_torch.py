"""The benchmark's cells run twice in one process: with the condip solve
replayed from CUDA graphs (the program as it runs), then dispatched op by
op (``ops/sqp._solve_mpc_condip_eager``); every kept answer of the two runs
compared bit for bit.

* ``centroidal-solve-b2048``: each step of the 12-solve warm chain (the
  start it solved from and its z) and the window's first solve;
* ``centroidal-sweep-b2048``: the warm chain, then the carry after each of
  the ticks 261 (footstep adaptation) and 270 (the late tick) and its
  packed x0, the loop run from its start tick as the window runs it.

Prints one JSON line (and writes it to ``--out``): per cell the number of
tensors compared, those that differ and the largest difference among them.

    python tools/graph_parity_torch.py --seed 1601 --out chiprun_out/graph_parity.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import core  # noqa: E402
from portbench.loads import common  # noqa: E402

CELLS = ("centroidal-solve-b2048", "centroidal-sweep-b2048")
SWEEP_TICKS = (261, 270)


def _leaves(tree, prefix=""):
    """(name, tensor) of every tensor of a nested tuple."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for i, x in enumerate(tree):
        out += _leaves(x, f"{prefix}.{i}" if prefix else str(i))
    return out


def kept(workload: str, seed: int) -> list:
    """(name, float64 host tensor) of what one run of the cell keeps."""
    plan = core.cell_plan(core.load_benchmark(), workload)
    load = core.make_load(plan, seed, "cuda",
                          core.SetupClock(time.perf_counter()))
    load.prepare()
    out = _leaves(load.chain, "chain")
    if workload == "centroidal-solve-b2048":
        out += _leaves(common.to_host(load.step()[1]), "window")
    else:
        while load.t <= max(SWEEP_TICKS):
            t, _, after, x0 = load.step()[1]
            if t in SWEEP_TICKS:
                out += _leaves(common.to_host(
                    (after.plant, after.plan_pos, after.theta_hat,
                     after.solver, x0)), f"tick{t}")
    del load
    torch.cuda.empty_cache()
    return out


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def compare(a: list, b: list) -> dict:
    differ = [(na, (x - y).abs().nan_to_num(float("inf")).max().item())
              for (na, x), (_, y) in zip(a, b)
              if not torch.equal(_bits(x), _bits(y))]
    return {"compared": len(a), "differ": len(differ),
            "largest": max((d for _, d in differ), default=0.0),
            "first": differ[0][0] if differ else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1601)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("graph_parity_torch: needs a CUDA device")
    sqp = common.module("ops.sqp")
    graphs = common.module("runtime.graphs")
    result = {"device": torch.cuda.get_device_name(0), "seed": args.seed}
    for workload in CELLS:
        c0 = dict(graphs.COUNTS)
        replayed = kept(workload, args.seed)
        counts = {k: graphs.COUNTS[k] - c0[k] for k in c0}
        graphed = sqp._solve_mpc_condip
        sqp._solve_mpc_condip = sqp._solve_mpc_condip_eager
        try:
            eager = kept(workload, args.seed)
        finally:
            sqp._solve_mpc_condip = graphed
        result[workload] = dict(compare(replayed, eager), graphs=counts)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
