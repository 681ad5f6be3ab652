"""Trace persistence and summary metrics (port of
``cmpc_tpu.runtime.trace``): one compressed .npz per run with the field
names preserved, read back by :func:`load` (files of either package), and
the walk's health metrics."""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flatten(tr: Any, prefix: str = "") -> dict:
    if hasattr(tr, "_asdict"):
        items = tr._asdict().items()
    elif isinstance(tr, dict):
        items = tr.items()
    else:
        return {prefix.rstrip("/"): _np(tr)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def save(path: str, trace: Any, meta: dict | None = None) -> None:
    """Persist a trace (NamedTuple/dict of tensors or arrays) to .npz, with
    an optional .json sidecar of run metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_flatten(trace))
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load(path: str) -> dict:
    """A saved trace as {field: np.ndarray} (nested names joined by '/'),
    whichever package saved it."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class TraceSummary(NamedTuple):
    ticks: int
    com_rmse_xy: float
    com_max_err_xy: float
    com_z_drift: float
    hw_rms: float
    r_prim_p50: float
    r_prim_p99: float
    adaptation_ticks: tuple
    fell: bool


def summarize(trace: Any, fall_threshold: float = 0.3) -> TraceSummary:
    """Health metrics of ONE scenario's trace (fields shaped (T, ...)), of
    either loop: the solver residual is `r_prim`, or the whole-body
    trace's `r_prim_mpc`."""
    tr = trace._asdict() if hasattr(trace, "_asdict") else dict(trace)
    com = _np(tr["com_pos"])
    ref = _np(tr["com_ref"])
    err = np.linalg.norm(com[:, :2] - ref[:, :2], axis=-1)
    hw = _np(tr["hw"])
    if "r_prim" in tr:
        r_prim = _np(tr["r_prim"])
    elif "r_prim_mpc" in tr:
        r_prim = _np(tr["r_prim_mpc"])
    else:
        raise KeyError(
            "trace has neither 'r_prim' nor 'r_prim_mpc'; summarize() "
            "needs solver residuals to report accuracy percentiles")
    adapted = _np(tr.get("adapted", np.zeros(len(com), bool)))
    return TraceSummary(
        ticks=int(com.shape[0]),
        com_rmse_xy=float(np.sqrt(np.mean(err ** 2))),
        com_max_err_xy=float(err.max()),
        com_z_drift=float(np.abs(com[:, 2] - com[0, 2]).max()),
        hw_rms=float(np.sqrt(np.mean(np.sum(hw ** 2, axis=-1)))),
        r_prim_p50=float(np.percentile(r_prim, 50)),
        r_prim_p99=float(np.percentile(r_prim, 99)),
        adaptation_ticks=tuple(np.nonzero(adapted)[0].tolist()),
        fell=bool(err.max() > fall_threshold),
    )
