"""Large-scale Monte-Carlo robustness sweep of the PyTorch/CUDA port: a
randomized batch of full-length walks (parallel/mesh.make_batch, seed 7)
on one GPU, with the statistics reduced on the device; under torchrun
sharded over its ranks (one per card), rank 0 writing the JSON with the
per-scenario rows gathered in global order.

Beside the JAX runner's keys the JSON holds ``dtype`` and ``rows``: one
entry per scenario in global order with its ``rmse``, ``max_err``,
``lyap`` and ``r_prim`` and its ``fall_chunk``, the first chunk after
which its max_err had passed 0.3 (null if it never did).  Two runs in
float32 and float64 tell which scenarios' outcomes turn on rounding.
--scenarios runs only the given scenarios of the batch (the rows then
follow that list, written under ``scenarios``), and --plain-tile puts the
tile kernel's plain torch version in its place (written as
``plain_tile``): a subset's rows are the whole batch's up to rounding
(the batch's width changes the order of some sums), and the plain tile
tells the kernel's share of a card run from the rest of the card's
arithmetic.

--nudge K runs the rounding replicate K of the batch
(parallel/mesh.replicate: every starting CoM height K ulps of the working
type up), written as ``nudge``; --nudge 0 is the batch as it is, bit for
bit.  Replicates K = 0, 1, 2, ... differ only in their rounding
histories, so their spread is the spread that rounding alone gives.

The walk runs as CHUNKED rollouts (closed_loop.rollout t0/carry_in): the
LoopCarry (plant + live plan + solver warm start) flows between chunks and
only each chunk's reduced (n, 4) statistics are kept, so the trace of a
wide batch over thousands of ticks is never held.  With --ckpt, --resume
or --stop-after the state after every chunk (carry, statistics, fall
chunks, wall time so far) is written to --ckpt (runtime/checkpoint;
default runs/<stem of --out>.ckpt.npz); --stop-after S ends the process
after the first chunk that finishes past S seconds, with no JSON, and
--resume goes on from the checkpoint of the same
run (same n, T, chunk, dtype, nudge, scenarios and tile) to the results
of the unsplit run, bit for bit.  So a sweep longer than one process may
run is split:

    python tools/run_sweep_torch.py 256 2100 100 --plain-tile \\
        --ckpt runs/sp.ckpt.npz --stop-after 1300 [--resume]

Writes the JSON to --out (default runs/sweep_torch.json) and prints it.
Run from the repository root:
    python tools/run_sweep_torch.py [n_scenarios] [T_ticks] [chunk]
                                    [--device cuda] [--dtype float32]
                                    [--scenarios I,J,...] [--plain-tile]
                                    [--nudge K] [--ckpt PATH] [--resume]
                                    [--stop-after S] [--out PATH]
    torchrun --nproc-per-node=K tools/run_sweep_torch.py ...
(under torchrun no checkpoint is written and none is resumed)
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


def scenario_rows(acc: np.ndarray, ticks: int, fall_chunk) -> list:
    """The "rows" block: per scenario, in the order of `acc`'s rows, the
    statistics of parallel/mesh.per_scenario_from_sums and the chunk in
    which it fell (-1 in `fall_chunk` for none, written as null)."""
    from cmpc_tpu_torch.parallel import mesh as pm

    per = pm.per_scenario_from_sums(acc, ticks)
    return [{"rmse": float(per.rmse[i]), "max_err": float(per.max_err[i]),
             "lyap": float(per.lyap[i]), "r_prim": float(per.r_prim[i]),
             "fall_chunk": int(fall_chunk[i]) if fall_chunk[i] >= 0
             else None}
            for i in range(len(acc))]


def plain_tile():
    """Put chol_inv_tile_ref in the tile kernel's place on every path (the
    tile step of ops/batched_chol.blocked_cholesky), for the rest of the
    process.  No kernel is launched after it, on any device.  The plain
    step waits on the device (its clamp check), which no CUDA graph can
    hold, so the solve runs op by op from then on."""
    from cmpc_tpu_torch.ops import batched_chol as bc, sqp

    def into(A, L, X):
        Lk, Xk = bc.chol_inv_tile_ref(A.contiguous())
        L.copy_(Lk)
        X.copy_(Xk)

    bc.chol_inv_tile_into = into
    sqp._solve_mpc_condip = sqp._solve_mpc_condip_eager


def _save_state(path: str, state, fall_chunk, wall: float, ident: dict):
    """The sweep's state after a chunk, as runtime/checkpoint writes it."""
    from cmpc_tpu_torch.runtime import checkpoint

    checkpoint.save(path, {"carry": state.carry, "host": state.host,
                           "dev": state.dev, "fall_chunk": fall_chunk},
                    step=state.chunks, meta=dict(ident, wall_s=wall))


def _load_state(path: str, like, ident: dict, device):
    """(state, fall_chunk, wall so far) from the checkpoint of this run, as
    :func:`_save_state` wrote it; raises where it is another run's."""
    from cmpc_tpu_torch.parallel import mesh as pm
    from cmpc_tpu_torch.runtime import checkpoint

    with open(path + ".json") as f:
        meta = json.load(f)
    wall = meta.pop("wall_s")
    if meta != json.loads(json.dumps(ident)):
        raise ValueError(f"checkpoint {path} is of another run: {meta}, "
                         f"this run is {ident}")
    tree, k = checkpoint.restore(path, {
        "carry": like.carry, "host": like.host, "dev": like.dev,
        "fall_chunk": np.zeros(0)}, device=device)
    state = pm.SweepState(k, tree["carry"], tree["host"].cpu().numpy(),
                          tree["dev"])
    return state, tree["fall_chunk"].cpu().numpy(), wall


def run(n: int, T: int | None, chunk: int, device="cuda",
        dtype=torch.float32, cfg=None, mesh=None, scenarios=None,
        plain=False, nudge_ulps: int = 0, ckpt: str | None = None,
        resume: bool = False, stop_after: float | None = None
        ) -> dict | None:
    """Run the sweep; returns the JSON payload.  With a mesh (from
    parallel/mesh.make_mesh) each rank runs its share of the n scenarios and
    every rank returns the payload of the whole batch, rows included.
    `scenarios` (indices into the n) runs those alone; `plain` runs the
    tile step through its plain version (:func:`plain_tile`); `nudge_ulps`
    runs the rounding replicate of that number (``mesh.replicate``).  With
    `ckpt` (no mesh) the state is written there after every chunk;
    `resume` goes on from it, and `stop_after` (seconds) stops after the
    first chunk past it and returns None."""
    from cmpc_tpu_torch.config import WalkConfig, resolve_device
    from cmpc_tpu_torch.parallel import mesh as pm
    from cmpc_tpu_torch.plan import timing as tm

    if mesh is not None and (ckpt or resume or stop_after is not None):
        raise ValueError("a sweep across ranks writes no checkpoint")
    if (resume or stop_after is not None) and not ckpt:
        raise ValueError("resume and stop_after need a checkpoint path")

    device = resolve_device(device) if mesh is None else mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = cfg or WalkConfig()
    if T is None:
        T = tm.build_timing(cfg).total_ticks
    if plain:
        plain_tile()
    batch = pm.make_batch(cfg, n, seed=SEED, device=device, dtype=dtype)
    if scenarios is not None:
        batch = type(batch)(*(f[list(scenarios)] for f in batch))
    batch = pm.replicate(batch, nudge_ulps)
    if mesh is not None:
        batch = pm.shard_scenarios(batch, mesh)
    on_cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    ranks = 1 if mesh is None else mesh.world_size
    rank = 0 if mesh is None else mesh.rank
    print(f"[sweep] n={n} T={T} chunk={chunk} device={name} rank={rank} "
          f"of {ranks}", file=sys.stderr, flush=True)

    t0_wall = time.perf_counter()
    # this rank's rows: the first chunk after which max_err passed FALL_ERR
    fall_chunk = np.full(batch.init_com.shape[0], -1, dtype=np.int64)
    ident = {"n": n, "T": T, "chunk": chunk, "seed": SEED,
             "dtype": str(dtype), "nudge": nudge_ulps, "plain_tile": plain,
             "scenarios": None if scenarios is None
             else [int(i) for i in scenarios]}
    state, wall_before = None, 0.0
    if resume and os.path.exists(ckpt):
        state, fall_chunk, wall_before = _load_state(
            ckpt, pm.sweep_start(batch, cfg), ident, device)
        print(f"[sweep] resumed after chunk {state.chunks} of {ckpt}",
              file=sys.stderr, flush=True)

    def on_chunk(st, n_chunks):
        fall_chunk[(fall_chunk < 0) & (st.host[:, 1] > pm.FALL_ERR)] = \
            st.chunks - 1
        elapsed = time.perf_counter() - t0_wall
        print(f"[sweep] rank {rank}: chunk {st.chunks}/{n_chunks} done "
              f"({elapsed:.0f}s)", file=sys.stderr, flush=True)
        if ckpt:
            _save_state(ckpt, st, fall_chunk, wall_before + elapsed, ident)
        return stop_after is not None and elapsed > stop_after

    acc, _, ticks = pm.sweep_chunked(batch, cfg, T, chunk, on_chunk,
                                     mesh=mesh, state=state)
    if ticks < -(-T // chunk) * chunk:
        print(f"[sweep] stopped after chunk {ticks // chunk}; the state is "
              f"in {ckpt}: go on with --resume", file=sys.stderr, flush=True)
        return None
    if mesh is not None:
        fall_chunk = pm.gather_rows(fall_chunk, mesh)
    if on_cuda:
        torch.cuda.synchronize(device)
    wall = wall_before + time.perf_counter() - t0_wall

    out = {
        "n_scenarios": n,
        "seed": SEED,
        "ticks": ticks,
        "solves": n * ticks,
        "wall_s": round(wall, 1),
        "solves_per_s": round(n * ticks / wall, 1),
        "device": name,
        "dtype": str(dtype).removeprefix("torch."),
        "chunk": chunk,
        "stats": survivor_stats(acc, ticks),
        "rows": scenario_rows(acc, ticks, fall_chunk),
        "note": ("randomized pushes (sigma 10 N), payloads (0-3 kg) and "
                 "gain variations over full-length walks "
                 "(parallel/mesh.make_batch); fall = tracking blowup "
                 "> 0.3 m; wall time includes planner set-up; chunked "
                 "rollouts (see module docstring)"),
    }
    if scenarios is not None:
        out["scenarios"] = [int(i) for i in scenarios]
    if plain:
        out["plain_tile"] = True
    if nudge_ulps:
        out["nudge"] = nudge_ulps
    if state is not None:
        out["resumed_after_chunk"] = state.chunks
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
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"),
                    help="working type of the batch (default float32)")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated indices: run only these")
    ap.add_argument("--plain-tile", action="store_true",
                    help="the tile kernel's plain torch version in its place")
    ap.add_argument("--nudge", type=int, default=0,
                    help="rounding replicate: the CoM height K ulps up")
    ap.add_argument("--ckpt", default=None,
                    help="write the state after every chunk here (with "
                         "--resume or --stop-after by default "
                         "runs/<stem of --out>.ckpt.npz)")
    ap.add_argument("--resume", action="store_true",
                    help="go on from --ckpt where it exists")
    ap.add_argument("--stop-after", type=float, default=None,
                    help="stop after the first chunk past S seconds")
    ap.add_argument("--out", default=os.path.join("runs", "sweep_torch.json"))
    args = ap.parse_args(argv)
    ckpt = args.ckpt
    if ckpt is None and (args.resume or args.stop_after is not None):
        ckpt = os.path.join("runs", os.path.splitext(
            os.path.basename(args.out))[0] + ".ckpt.npz")
    only = (None if args.scenarios is None
            else [int(i) for i in args.scenarios.split(",")])
    from cmpc_tpu_torch.parallel import mesh as pm

    dtype = getattr(torch, args.dtype)
    if pm.under_torchrun():
        if args.ckpt or args.resume or args.stop_after is not None:
            ap.error("under torchrun no checkpoint is written or resumed")
        mesh = pm.make_mesh(args.device, args.backend)
        try:
            payload = run(args.n, args.T, args.chunk, dtype=dtype, mesh=mesh,
                          scenarios=only, plain=args.plain_tile,
                          nudge_ulps=args.nudge)
        finally:
            mesh.close()
        if mesh.rank:
            return
    else:
        payload = run(args.n, args.T, args.chunk, device=args.device,
                      dtype=dtype, scenarios=only, plain=args.plain_tile,
                      nudge_ulps=args.nudge, ckpt=ckpt, resume=args.resume,
                      stop_after=args.stop_after)
        if payload is None:
            return
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
