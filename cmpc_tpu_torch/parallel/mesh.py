"""Scenario sweeps on one device or across processes (port of
``cmpc_tpu.parallel.mesh``).

A sweep runs a batch of differing scenarios closed loop and reduces the
per-scenario tracking statistics.  The JAX package shards the batch over a
device mesh with ``shard_map`` and reduces with ``psum``/``pmax``.  The port
runs one process per card, joined by ``torch.distributed`` — what
``torchrun`` starts, on one host or several: every process builds the same
batch from its seed, keeps its contiguous share of the rows
(:func:`shard_scenarios`) on its card, runs it, and the statistics are
reduced with ``all_reduce`` (SUM, MAX) or gathered in global order
(``all_gather``).  Without a mesh the whole batch lives on one device and
the same reductions run over the batch axis.

    torchrun --nproc-per-node=K -m cmpc_tpu_torch sweep --n 1024
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cmpc_tpu_torch.config import (DEFAULT_FOOT_Y, Scenario, WalkConfig,
                                   default_vref, resolve_device)
from cmpc_tpu_torch.sim import closed_loop

FALL_ERR = 0.3       # a walk whose xy tracking error passes this has fallen

# the variables torchrun (or any launcher of the same contract) sets
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh(NamedTuple):
    """This process's place in a process group and the device it runs on.
    One process per card (backend "nccl"), or several processes sharing a
    card on purpose (an explicit device such as "cuda:0" and backend
    "gloo", which stages the few reduced numbers through host memory)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object            # the torch.distributed process group

    def close(self) -> None:
        """Tear the process group down: once, at the end of the run."""
        if dist.is_initialized():
            dist.destroy_process_group()


def under_torchrun() -> bool:
    """Whether the environment names a process group (torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def shared_cards(idents) -> list:
    """The pairs of ranks (i, j), i < j, whose card identities are equal."""
    first, pairs = {}, []
    for r, ident in enumerate(idents):
        if ident in first:
            pairs.append((first[ident], r))
        else:
            first[ident] = r
    return pairs


def _card_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def make_mesh(device="cuda", backend: str | None = None) -> Mesh:
    """Join (or start) the default process group and place this rank.

    The group: the one already up, else the one torchrun's environment
    names (``env://``), else a group of one rank in this process.  The
    device: "cuda" is ``cuda:LOCAL_RANK``, and raises if this host has no
    card of that number, so that two ranks never quietly share one; an
    explicit "cuda:i" may be shared on purpose.  The backend: "nccl" for a
    card and "gloo" for the CPU unless given; NCCL raises if this torch
    lacks it, if the device is not a card, or if two ranks hold the same
    card (NCCL refuses that).  Nothing falls back."""
    env = os.environ
    joined = dist.is_initialized()
    if joined:
        rank, world = dist.get_rank(), dist.get_world_size()
    elif under_torchrun():
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        rank, world = 0, 1
    local_rank = int(env.get("LOCAL_RANK", 0))

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards:
            raise RuntimeError(
                f"make_mesh: LOCAL_RANK {local_rank} has no card of its own "
                f"({n_cards} visible); to share one card pass an explicit "
                f"device such as 'cuda:0' with backend='gloo'")
        dev = torch.device("cuda", local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("make_mesh: backend 'nccl' requested but this "
                               "torch build has no NCCL")
        if dev.type != "cuda":
            raise ValueError(f"make_mesh: backend 'nccl' needs a CUDA "
                             f"device, not {str(dev)!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    if joined:
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"make_mesh: the process group is up on backend "
                f"{dist.get_backend()!r}, not {backend!r}")
    elif under_torchrun():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)

    if backend == "nccl" and world > 1:
        # before NCCL's first collective, which would fail on a shared card
        side = dist.new_group(backend="gloo")
        idents = [None] * world
        dist.all_gather_object(idents, _card_identity(dev), group=side)
        dist.destroy_process_group(side)
        pairs = shared_cards(idents)
        if pairs:
            if not joined:
                dist.destroy_process_group()
            raise RuntimeError(
                f"make_mesh: ranks {pairs} hold the same card, which NCCL "
                f"refuses; ranks that share a card pass backend='gloo'")
    return Mesh(rank=rank, world_size=world, device=dev, backend=backend,
                group=dist.group.WORLD)


def shard_scenarios(scenarios: Scenario, mesh: Mesh) -> Scenario:
    """This rank's contiguous rows [rank n/W, (rank+1) n/W) of a batch that
    every rank built alike (make_batch is deterministic from its seed), on
    the rank's device: the order of the JAX package's P(axis)."""
    n = scenarios.init_com.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"shard_scenarios: {n} scenarios do not split "
                         f"evenly over {mesh.world_size} ranks")
    k = n // mesh.world_size
    lo = mesh.rank * k
    return Scenario(*(v[lo:lo + k].to(mesh.device, copy=True)
                      for v in scenarios))


def _comm(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of x where the backend reduces: the card for NCCL, host
    memory for gloo."""
    where = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return x.to(where, copy=True)


def _all_reduce(x: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    y = _comm(x, mesh)
    dist.all_reduce(y, op=op, group=mesh.group)
    return y.to(x.device)


def gather_rows(x, mesh: Mesh):
    """Every rank's rows of x (a tensor or numpy array, leading axis = this
    rank's scenarios, the same count on every rank), concatenated in global
    order on every rank."""
    if isinstance(x, np.ndarray):
        return gather_rows(torch.from_numpy(x), mesh).numpy()
    y = _comm(x.contiguous(), mesh)
    parts = [torch.empty_like(y) for _ in range(mesh.world_size)]
    dist.all_gather(parts, y, group=mesh.group)
    return torch.cat(parts, dim=0).to(x.device)


class SweepStats(NamedTuple):
    """Summary over a scenario sweep, reduced on the device."""

    n: torch.Tensor                 # scenario count
    com_rmse_xy: torch.Tensor       # mean RMSE of CoM xy tracking
    max_tilt: torch.Tensor          # max |com_xy - ref_xy| over the sweep
    fall_rate: torch.Tensor         # fraction with tracking blowup (> 0.3 m)
    mean_lyap_violation: torch.Tensor
    mean_r_prim: torch.Tensor


class PerScenarioStats(NamedTuple):
    """Un-reduced per-scenario summary (leading axis = scenario)."""

    rmse: torch.Tensor       # (B,) CoM xy tracking RMSE
    max_err: torch.Tensor    # (B,) max CoM xy tracking error
    lyap: torch.Tensor       # (B,) mean Lyapunov violation
    r_prim: torch.Tensor     # (B,) mean primal residual


def chunk_stats(tr: closed_loop.Trace) -> torch.Tensor:
    """The (B, 4) running statistics of a trace with fields (B, T, ...):
    sum of squared xy tracking error, its maximum, and the sums of the
    Lyapunov violation and the primal residual over the T ticks.  Chunks of
    one walk combine by adding columns 0, 2, 3 and taking the maximum of
    column 1."""
    err = torch.linalg.vector_norm(tr.com_pos[..., :2] - tr.com_ref[..., :2],
                                   dim=-1)                        # (B, T)
    return torch.stack([(err ** 2).sum(1), err.amax(1),
                        tr.lyap_violation.sum(1), tr.r_prim.sum(1)], dim=1)


def _summarize(tr: closed_loop.Trace) -> PerScenarioStats:
    return per_scenario_from_sums(chunk_stats(tr), tr.r_prim.shape[1])


def reduce_stats(per: PerScenarioStats, mesh: Mesh | None = None
                 ) -> SweepStats:
    """The batch-axis reductions of :func:`sweep` (where the JAX package
    has psum / pmax).  With a mesh, `per` is this rank's rows and one
    vector [n, sum rmse, sum fell, sum lyap, sum r_prim] is all-reduced
    (SUM) with the maximum error (MAX): every rank holds the same stats."""
    fell = (per.max_err > FALL_ERR).to(per.rmse.dtype)
    sums = torch.stack([per.rmse.new_tensor(float(per.rmse.shape[0])),
                        per.rmse.sum(), fell.sum(), per.lyap.sum(),
                        per.r_prim.sum()])
    max_err = per.max_err.amax()
    if mesh is not None:
        sums = _all_reduce(sums, dist.ReduceOp.SUM, mesh)
        max_err = _all_reduce(max_err, dist.ReduceOp.MAX, mesh)
    n = sums[0]
    return SweepStats(
        n=n, com_rmse_xy=sums[1] / n, max_tilt=max_err,
        fall_rate=sums[2] / n, mean_lyap_violation=sums[3] / n,
        mean_r_prim=sums[4] / n)


def _check_shard(scenarios: Scenario, mesh: Mesh | None) -> None:
    if mesh is not None and scenarios.init_com.device != mesh.device:
        raise ValueError(f"the shard lies on {scenarios.init_com.device}, "
                         f"the mesh's rank on {mesh.device}")


def sweep_per_scenario(scenarios: Scenario, cfg: WalkConfig, T_sim: int,
                       mesh: Mesh | None = None) -> PerScenarioStats:
    """Run the batch closed loop for T_sim ticks; per-scenario statistics,
    on the scenarios' device.  With a mesh, `scenarios` is this rank's
    shard and the statistics are its rows (:func:`gather_per_scenario`
    collects all of them)."""
    _check_shard(scenarios, mesh)
    _, tr = closed_loop.rollout(scenarios, cfg, T_sim)
    return _summarize(tr)


def gather_per_scenario(per: PerScenarioStats, mesh: Mesh
                        ) -> PerScenarioStats:
    """Every rank's per-scenario rows, (n,) each in global order, on every
    rank: one all_gather."""
    return PerScenarioStats(*gather_rows(torch.stack(list(per), 1), mesh)
                            .unbind(1))


def sweep(scenarios: Scenario, cfg: WalkConfig, T_sim: int,
          mesh: Mesh | None = None) -> SweepStats:
    """Run a batched scenario sweep; returns the statistics reduced over
    the batch, and with a mesh over every rank's shard."""
    return reduce_stats(sweep_per_scenario(scenarios, cfg, T_sim, mesh),
                        mesh)


def make_batch(cfg: WalkConfig, n: int, seed: int = 0,
               push_scale: float = 10.0, payload_max: float = 3.0, *,
               device="cuda", dtype=torch.float32) -> Scenario:
    """A randomized robustness batch: lateral/sagittal pushes, payload
    masses, gain variations and a gait-geometry sweep.  numpy's
    ``default_rng(seed)`` is drawn in the JAX package's order and floats
    pass through float32 as there, so both packages get the same batch
    from the same seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    push = rng.normal(size=(n, 3)) * np.array([push_scale, push_scale, 0.0])
    start = rng.integers(300, 1200, size=n)
    dur = rng.integers(50, 150, size=n)
    payload = rng.uniform(0.0, payload_max, size=n)
    onset = rng.integers(0, 800, size=n)
    k1 = np.where(payload > 1.0, 7.0, 4.0)
    k2 = np.where(payload > 1.0, 1.0, 0.1)
    vel_scale = rng.uniform(0.7, 1.2, size=(n, 1, 1))
    step_y = rng.uniform(0.085, 0.115, size=n)
    base_vref = default_vref(cfg.num_steps).astype(np.float32)

    def f(x, shape=None):
        a = np.asarray(x, np.float64).astype(np.float32)
        if shape is not None:
            a = np.broadcast_to(a, shape)
        return torch.as_tensor(np.ascontiguousarray(a), device=device
                               ).to(dtype)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return Scenario(
        k1=f(k1), k2=f(k2),
        mpc_mass=f(40.05, (n,)), plant_mass=f(40.05, (n,)),
        push_force=f(push), push_torque=f(0.0, (n, 3)),
        push_start=i(start), push_end=i(start + dur),
        vref=f(base_vref.astype(np.float64) * vel_scale),
        init_com=f([0.0, 0.0, cfg.h], (n, 3)), init_vel=f(0.0, (n, 3)),
        foot_y=f(DEFAULT_FOOT_Y, (n,)),
        payload_mass=f(payload), payload_onset=i(onset),
        payload_impact_vel=f(float(np.sqrt(2 * 9.81 * 0.1)), (n,)),
        step_y_offset=f(step_y),
    )


def replicate(scenarios: Scenario, k: int) -> Scenario:
    """The rounding replicate `k` of a batch: every scenario's starting CoM
    height (``init_com[:, 2]``) moved up by `k` ulps of its type
    (``torch.nextafter``; one ulp of 0.72 m is 5.96e-8 m in float32);
    k = 0 returns the batch as it is.  The height, not x: x starts at 0,
    where one ulp is a subnormal (1.4e-45 m) that the loop's first sums
    absorb.  Replicates of one batch differ only in their rounding
    histories."""
    if k < 0:
        raise ValueError(f"replicate takes k >= 0, got {k}")
    if k == 0:
        return scenarios
    com = scenarios.init_com.clone()
    z, up = com[:, 2], torch.full_like(com[:, 2], float("inf"))
    for _ in range(k):
        z = torch.nextafter(z, up)
    com[:, 2] = z
    return scenarios._replace(init_com=com)


class SweepState(NamedTuple):
    """A chunked sweep between two chunks: what :func:`sweep_chunked` needs
    to go on from there."""
    chunks: int                    # chunks done
    carry: closed_loop.LoopCarry   # the loop's carry after them
    host: np.ndarray               # (B, 4) float64 statistics so far
    dev: torch.Tensor              # (B, 4) the same on the device


def sweep_start(scenarios: Scenario, cfg: WalkConfig) -> SweepState:
    """The state of a sweep before its first chunk: the loop's initial
    carry (the planner's set-up) and zero statistics."""
    carry, _ = closed_loop.rollout(scenarios, cfg, return_tick=True)
    B = scenarios.init_com.shape[0]
    return SweepState(0, carry, np.zeros((B, 4)),
                      scenarios.init_com.new_zeros(B, 4))


def sweep_chunked(scenarios: Scenario, cfg: WalkConfig, T_sim: int,
                  chunk: int, on_chunk=None, mesh: Mesh | None = None,
                  state: SweepState | None = None):
    """The sweep as ceil(T_sim / chunk) chunked rollouts chained through
    the loop carry (``rollout(t0=, carry_in=)``), keeping only the reduced
    statistics of each chunk: a full-length trace of a wide batch is never
    held.  Each chunk's (B, 4) statistics (:func:`chunk_stats`) are reduced
    on the device and fetched as one array.

    Returns ``(host, dev, ticks)``: the statistics accumulated on the host
    in float64 from the per-chunk fetches ((B, 4) numpy), the same
    accumulated on the device in the working type ((B, 4) tensor), and the
    ticks run (a whole number of chunks).  ``on_chunk(state, n_chunks)``
    is called after each chunk with the :class:`SweepState` there (this
    rank's rows; read its host array, do not keep it); where it returns
    True the sweep stops after that chunk and returns what it has, with
    the ticks run so far.  With a mesh, `scenarios` is
    this rank's shard, the accumulators stay per rank through the chunks,
    and at the end both are gathered: every rank returns the (n, 4) rows
    in global order, whose :func:`reduce_stats` is the sweep's.  A last
    chunk that runs past the gait tables' end reads their last row, as the
    JAX package's chunked runner does.

    `state` (from :func:`sweep_start` or an earlier run's ``on_chunk``)
    goes on from where it was taken, to the same results bit for bit."""
    _check_shard(scenarios, mesh)
    n_chunks = (T_sim + chunk - 1) // chunk
    if state is None:
        state = sweep_start(scenarios, cfg)
    k0, carry, host, dev = state
    host = host.copy()
    done = n_chunks
    for k in range(k0, n_chunks):
        carry, tr = closed_loop.rollout(scenarios, cfg, chunk, t0=k * chunk,
                                        carry_in=carry)
        s = chunk_stats(tr)
        del tr
        dev = torch.stack([dev[:, 0] + s[:, 0],
                           torch.maximum(dev[:, 1], s[:, 1]),
                           dev[:, 2] + s[:, 2], dev[:, 3] + s[:, 3]], dim=1)
        s = s.cpu().numpy().astype(np.float64)     # (B, 4): one small fetch
        host[:, [0, 2, 3]] += s[:, [0, 2, 3]]
        host[:, 1] = np.maximum(host[:, 1], s[:, 1])
        if on_chunk is not None and on_chunk(
                SweepState(k + 1, carry, host, dev), n_chunks) \
                and k + 1 < n_chunks:
            done = k + 1
            break
    if mesh is not None:
        host, dev = gather_rows(host, mesh), gather_rows(dev, mesh)
    return host, dev, done * chunk


def per_scenario_from_sums(acc, ticks: int) -> PerScenarioStats:
    """PerScenarioStats from (B, 4) accumulated :func:`chunk_stats` (a
    tensor or a numpy array) over `ticks` ticks."""
    return PerScenarioStats(rmse=(acc[:, 0] / ticks) ** 0.5,
                            max_err=acc[:, 1], lyap=acc[:, 2] / ticks,
                            r_prim=acc[:, 3] / ticks)
