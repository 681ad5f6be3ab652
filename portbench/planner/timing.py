"""Static gait timing tables (numpy copy of ``cmpc_tpu.plan.timing``).

Step durations are fixed by construction, so the whole time structure of
the walk is precomputed once into flat index tables of length
``cfg.pad_ticks``.  ``tests/test_torch_config.py`` pins every table to the
JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.planner.config import WalkConfig


@dataclasses.dataclass(frozen=True)
class GaitTiming:
    """Immutable numpy tables. Fields of length S index footsteps; fields of
    length P = cfg.pad_ticks index control ticks."""

    ss: np.ndarray
    ds: np.ndarray
    start: np.ndarray
    foot_is_left: np.ndarray
    step_idx: np.ndarray
    t_in_step: np.ndarray
    is_ds: np.ndarray
    gamma_l: np.ndarray
    gamma_r: np.ndarray
    left_ref_idx: np.ndarray
    right_ref_idx: np.ndarray
    stance_left_idx: np.ndarray
    stance_right_idx: np.ndarray
    update_event: np.ndarray
    adapt_target: np.ndarray
    stance_from_table: np.ndarray
    total_ticks: int

    @property
    def num_steps(self) -> int:
        return len(self.ss)


def clamp_index(i, n: int):
    """Index ``i`` (a Python int, or a numpy or torch integer array) clamped
    to ``n - 1``: the row that JAX's gather reads for an index past the end
    of a table of ``n`` rows.  The loops run on past the padded tables'
    last tick, as the JAX package's do."""
    if isinstance(i, (int, np.integer)):
        return min(int(i), n - 1)
    return i.clip(max=n - 1)


def at(table, i):
    """``table[i]`` along the leading axis, ``i`` clamped by
    :func:`clamp_index`."""
    return table[clamp_index(i, len(table))]


def _parity_pair(idx: np.ndarray, first_swing: str):
    """Contact-reference plan indices for (left, right) at step `idx`
    (footstep_planner_vertices.py:106-147)."""
    a = idx + (idx - 1) % 2
    b = idx + idx % 2
    if first_swing == "rfoot":
        return a, b
    return b, a


def build_timing(cfg: WalkConfig) -> GaitTiming:
    S = cfg.num_steps
    scale = cfg.ss_duration + cfg.ds_duration
    ss = np.full(S, cfg.ss_duration, dtype=np.int32)
    ds = np.full(S, cfg.ds_duration, dtype=np.int32)
    ss[0] = 0
    ds[0] = 2 * scale
    dur = ss + ds
    start = np.concatenate([[0], np.cumsum(dur)[:-1]]).astype(np.int32)
    total = int(dur.sum())

    P = cfg.pad_ticks
    t = np.arange(P)
    step_idx = np.minimum(np.searchsorted(np.cumsum(dur), t, side="right"),
                          S - 1).astype(np.int32)
    t_in_step = (t - start[step_idx]).astype(np.int32)
    is_ds = t_in_step >= ss[step_idx]

    idx = np.arange(S)
    foot_is_left = ((idx % 2 == 0) == (cfg.first_swing == "lfoot"))

    support_is_left = foot_is_left[step_idx]
    gamma_l = (is_ds | support_is_left).astype(np.float64)
    gamma_r = (is_ds | ~support_is_left).astype(np.float64)

    lref, rref = _parity_pair(step_idx, cfg.first_swing)
    lref = np.minimum(lref, S - 1).astype(np.int32)
    rref = np.minimum(rref, S - 1).astype(np.int32)

    cutoff = int(dur[0])
    stance_from_table = t < cutoff
    lag_idx = np.minimum(
        np.searchsorted(np.cumsum(dur), np.maximum(t - cfg.ss_duration, 0),
                        side="right"), S - 1).astype(np.int32)
    sl, sr = _parity_pair(lag_idx, cfg.first_swing)
    stance_left_idx = np.minimum(sl, S - 1).astype(np.int32)
    stance_right_idx = np.minimum(sr, S - 1).astype(np.int32)

    look = np.minimum(t + cfg.N * cfg.mpc_rate - 1, P - 1)
    cond = (~is_ds) & is_ds[look]
    update_event = np.zeros(P, dtype=bool)
    for j in range(S):
        lo, hi = int(start[j]), int(min(start[j] + dur[j], P))
        w = np.nonzero(cond[lo:hi])[0]
        if len(w):
            update_event[lo + w[0]] = True
    adapt_target = np.minimum(step_idx + 1, S - 1).astype(np.int32)

    return GaitTiming(
        ss=ss, ds=ds, start=start, foot_is_left=foot_is_left,
        step_idx=step_idx, t_in_step=t_in_step, is_ds=is_ds,
        gamma_l=gamma_l, gamma_r=gamma_r,
        left_ref_idx=lref, right_ref_idx=rref,
        stance_left_idx=stance_left_idx, stance_right_idx=stance_right_idx,
        update_event=update_event, adapt_target=adapt_target,
        stance_from_table=stance_from_table, total_ticks=total,
    )
