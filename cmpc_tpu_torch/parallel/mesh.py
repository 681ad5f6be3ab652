"""Scenario sweeps on one device (port of ``cmpc_tpu.parallel.mesh``).

A sweep runs a batch of differing scenarios closed loop and reduces the
per-scenario tracking statistics.  The JAX package shards the batch over a
device mesh and reduces with ``psum``/``pmax``; here the whole batch lives
on one device and the same reductions run over the batch axis.
``make_mesh``, ``shard_scenarios`` and the ``shard_map`` placement have no
counterpart on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmpc_tpu_torch.config import (DEFAULT_FOOT_Y, Scenario, WalkConfig,
                                   default_vref, resolve_device)
from cmpc_tpu_torch.sim import closed_loop

FALL_ERR = 0.3       # a walk whose xy tracking error passes this has fallen


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


def reduce_stats(per: PerScenarioStats) -> SweepStats:
    """The batch-axis reductions of :func:`sweep` (where the JAX package
    has psum / pmax)."""
    n = per.rmse.new_tensor(float(per.rmse.shape[0]))
    fell = (per.max_err > FALL_ERR).to(per.rmse.dtype)
    return SweepStats(
        n=n, com_rmse_xy=per.rmse.sum() / n, max_tilt=per.max_err.amax(),
        fall_rate=fell.sum() / n, mean_lyap_violation=per.lyap.sum() / n,
        mean_r_prim=per.r_prim.sum() / n)


def sweep_per_scenario(scenarios: Scenario, cfg: WalkConfig,
                       T_sim: int) -> PerScenarioStats:
    """Run the batch closed loop for T_sim ticks; per-scenario statistics,
    on the scenarios' device."""
    _, tr = closed_loop.rollout(scenarios, cfg, T_sim)
    return _summarize(tr)


def sweep(scenarios: Scenario, cfg: WalkConfig, T_sim: int) -> SweepStats:
    """Run a batched scenario sweep; returns the statistics reduced over
    the batch."""
    return reduce_stats(sweep_per_scenario(scenarios, cfg, T_sim))


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


def sweep_chunked(scenarios: Scenario, cfg: WalkConfig, T_sim: int,
                  chunk: int, on_chunk=None):
    """The sweep as ceil(T_sim / chunk) chunked rollouts chained through
    the loop carry (``rollout(t0=, carry_in=)``), keeping only the reduced
    statistics of each chunk: a full-length trace of a wide batch is never
    held.  Each chunk's (B, 4) statistics (:func:`chunk_stats`) are reduced
    on the device and fetched as one array.

    Returns ``(host, dev, ticks)``: the statistics accumulated on the host
    in float64 from the per-chunk fetches ((B, 4) numpy), the same
    accumulated on the device in the working type ((B, 4) tensor), and the
    ticks run (a whole number of chunks).  ``on_chunk(k, n_chunks)`` is
    called after each chunk."""
    n_chunks = (T_sim + chunk - 1) // chunk
    carry, _ = closed_loop.rollout(scenarios, cfg, return_tick=True)
    B = scenarios.init_com.shape[0]
    host = np.zeros((B, 4))
    dev = scenarios.init_com.new_zeros(B, 4)
    for k in range(n_chunks):
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
        if on_chunk is not None:
            on_chunk(k, n_chunks)
    return host, dev, n_chunks * chunk


def per_scenario_from_sums(acc, ticks: int) -> PerScenarioStats:
    """PerScenarioStats from (B, 4) accumulated :func:`chunk_stats` (a
    tensor or a numpy array) over `ticks` ticks."""
    return PerScenarioStats(rmse=(acc[:, 0] / ticks) ** 0.5,
                            max_err=acc[:, 1], lyap=acc[:, 2] / ticks,
                            r_prim=acc[:, 3] / ticks)
