"""Offline plots of the reference's four live dashboards (port of
``cmpc_tpu.runtime.plots``), rendered once from a finished trace:

* :func:`plot_com`      — desired vs reference CoM xyz (Logger).
* :func:`plot_footsteps`— top-down footprint map: planned rectangles, MPC
  desired feet, actual feet (Logger2).
* :func:`plot_momentum` — MPC-predicted vs measured h_w (Logger3).
* :func:`plot_theta`    — adaptive estimate theta_hat (Logger_theta).

Each takes a {field: array} dict of ONE scenario (``runtime.trace.load``'s
output, or a trace's row 0); tensors on any device are copied to the host.
matplotlib is imported when a plot is drawn, with the Agg backend, so runs
that never plot never need it.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _get(tr, *names):
    for n in names:
        if n in tr:
            return _np(tr[n])
    raise KeyError(names)


def plot_com(tr: dict, path: str | None = None):
    plt = _plt()
    com = _get(tr, "com_pos")
    des = _get(tr, "com_pos_des")
    ref = _get(tr, "com_ref")
    t = np.arange(com.shape[0])
    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for i, lbl in enumerate("xyz"):
        axes[i].plot(t, ref[:, i], "k--", label="reference")
        axes[i].plot(t, des[:, i], "tab:blue", label="MPC desired")
        axes[i].plot(t, com[:, i], "tab:orange", label="measured")
        axes[i].set_ylabel(f"CoM {lbl} [m]")
    axes[0].legend(loc="upper left")
    axes[-1].set_xlabel("tick")
    fig.suptitle("CoM tracking (Logger view)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_footsteps(tr: dict, plan_pos=None, path: str | None = None,
                   foot_length: float = 0.25, foot_width: float = 0.13):
    plt = _plt()
    from matplotlib.patches import Rectangle
    fig, ax = plt.subplots(figsize=(10, 5))
    if plan_pos is not None:
        plan_pos = _np(plan_pos)
        for p in plan_pos:
            ax.add_patch(Rectangle(
                (p[0] - foot_length / 2, p[1] - foot_width / 2),
                foot_length, foot_width, fill=False, ec="gray"))
    pl = _get(tr, "pose_l")
    pr = _get(tr, "pose_r")
    ax.plot(pl[:, 3], pl[:, 4], "tab:blue", lw=0.8, label="left foot")
    ax.plot(pr[:, 3], pr[:, 4], "tab:red", lw=0.8, label="right foot")
    if "mpc_contact_l" in tr:
        ml = _get(tr, "mpc_contact_l")
        mr = _get(tr, "mpc_contact_r")
        ax.plot(ml[:, 0], ml[:, 1], "c.", ms=1, label="MPC left")
        ax.plot(mr[:, 0], mr[:, 1], "m.", ms=1, label="MPC right")
    com = _get(tr, "com_pos")
    ax.plot(com[:, 0], com[:, 1], "k", lw=1.2, label="CoM")
    ax.set_aspect("equal")
    ax.legend(loc="upper left", fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.suptitle("Footsteps, top-down (Logger2 view)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_momentum(tr: dict, path: str | None = None):
    plt = _plt()
    hw = _get(tr, "hw")
    hw_des = _get(tr, "hw_des")
    t = np.arange(hw.shape[0])
    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for i, lbl in enumerate("xyz"):
        axes[i].plot(t, hw_des[:, i], "tab:blue", label="MPC predicted")
        axes[i].plot(t, hw[:, i], "tab:orange", label="measured")
        axes[i].set_ylabel(f"h_w {lbl}")
    axes[0].legend(loc="upper left")
    axes[-1].set_xlabel("tick")
    fig.suptitle("Angular momentum (Logger3 view)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_theta(tr: dict, path: str | None = None):
    plt = _plt()
    th = _get(tr, "theta_hat")
    t = np.arange(th.shape[0])
    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for i, lbl in enumerate("xyz"):
        axes[i].plot(t, th[:, i], "tab:green")
        axes[i].set_ylabel(f"theta_hat {lbl}")
    axes[-1].set_xlabel("tick")
    fig.suptitle("Adaptive disturbance estimate (Logger_theta view)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_all(tr: dict, out_dir: str, plan_pos=None) -> list:
    """Render all four dashboards into out_dir (each figure closed once
    saved); returns file paths."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, fn in (("com", plot_com), ("momentum", plot_momentum),
                     ("theta", plot_theta),
                     ("footsteps", lambda tr, path: plot_footsteps(
                         tr, plan_pos=plan_pos, path=path))):
        p = os.path.join(out_dir, f"{name}.png")
        plt.close(fn(tr, path=p))
        paths.append(p)
    return paths
