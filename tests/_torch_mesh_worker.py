"""One rank of a process group for tests/test_torch_mesh.py and
tests/test_torch_cuda.py, placed by torchrun's variables (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), which :func:`run_ranks` sets.

    python tests/_torch_mesh_worker.py sweep
    python tests/_torch_mesh_worker.py dryrun [DEVICE BACKEND DTYPE LANE_TOL]
    python tests/_torch_mesh_worker.py mesh DEVICE BACKEND

``sweep``: the small gait of ``__graft_entry__.dryrun_multichip``, n = 8
scenarios (make_batch, seed 0, f64) over the ranks on the CPU (gloo), 4
ticks: the all-reduced statistics, this rank's rows, the gathered rows, and
the gathered rows of the chunked runner.  ``dryrun``:
``entry.dryrun_multichip`` (default: the CPU, gloo, f32, bitwise).
``mesh``: make_mesh alone.  Prints one JSON line.  Imports no JAX.
"""

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(sqp_iters=2, admm_iters=5, num_steps=4, ss_duration=7,
             ds_duration=3)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argv, world=2, timeout=300):
    """Run `python argv` as `world` ranks of one process group (torchrun's
    variables, the rendezvous on a free local port); returns each rank's
    (returncode, stdout, stderr).  Every process is ended before it
    returns."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "OMP_NUM_THREADS": "1"})
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _rows(per):
    return {k: v.tolist() for k, v in per._asdict().items()}


def sweep():
    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh("cpu")
    try:
        cfg = WalkConfig(**SMALL)
        batch = pmesh.make_batch(cfg, 8, seed=0, device="cpu",
                                 dtype=torch.float64)
        shard = pmesh.shard_scenarios(batch, m)
        stats = pmesh.sweep(shard, cfg, 4, mesh=m)
        local = pmesh.sweep_per_scenario(shard, cfg, 4, mesh=m)
        gathered = pmesh.gather_per_scenario(local, m)
        host, dev, ticks = pmesh.sweep_chunked(shard, cfg, 4, 2, mesh=m)
        return {"rank": m.rank, "world_size": m.world_size,
                "backend": m.backend,
                "stats": {k: float(v) for k, v in stats._asdict().items()},
                "local": _rows(local), "gathered": _rows(gathered),
                "chunked_host": host.tolist(), "chunked_dev": dev.tolist(),
                "ticks": ticks}
    finally:
        m.close()


def dryrun(device="cpu", backend="gloo", dtype="float32", lane_tol="0"):
    import torch.distributed as dist

    from cmpc_tpu_torch import entry

    try:
        return entry.dryrun_multichip(device, backend,
                                      dtype=getattr(torch, dtype),
                                      lane_tol=float(lane_tol))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh(device, backend):
    from cmpc_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh(device, backend)
    m.close()
    return {"rank": m.rank, "device": str(m.device), "backend": m.backend}


if __name__ == "__main__":
    mode = {"sweep": sweep, "dryrun": dryrun, "mesh": mesh}[sys.argv[1]]
    print(json.dumps(mode(*sys.argv[2:])), flush=True)
