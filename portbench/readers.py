"""What several metric readers share.  A reader takes the run record that
``core.run_cell`` builds and returns a number, or None where the run has
nothing for it to read."""

from __future__ import annotations


def idle_share(run) -> float | None:
    """Percent of the profiled stretch in which the device ran nothing."""
    p = run.get("profile")
    if not p or run["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / run["window_s"])


def launches_per_step(run) -> float | None:
    """Kernel launches the host made per step of the profiled stretch
    (the device's kernel count where the trace shows no launch call)."""
    p = run.get("profile")
    if not p or not run["steps"]:
        return None
    n = p["launches"] or sum(k["launches"] for name, k in p["kernels"].items()
                             if not name.lower().startswith("memcpy")
                             and not name.lower().startswith("memset"))
    return n / len(run["steps"]) if n else None
