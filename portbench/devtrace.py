"""Reduction of a ``torch.profiler`` trace of a stretch of the window to the
numbers the per-layer metrics read: the device's busy time (the union of its
kernel, copy and set intervals), the host's kernel launches, each kernel's
launches and device time by name, the device operations that took most
time, and the idle gaps of the device named by what the host was doing in
them."""

from __future__ import annotations

import bisect
from collections import defaultdict

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
TOP = 10


def _is_device(e) -> bool:
    return e.device_type().name in ("CUDA", "PrivateUse1")


def _is_sync(name: str) -> bool:
    """A synchronization record of the trace, which is no device work."""
    return "sync" in name.lower()


def _union(intervals):
    """Merged (start, end) pairs of `intervals`, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_at(starts, events, t):
    """The innermost host event running at time `t` (ns), or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 64, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def summarize(events) -> dict:
    """Numbers of the kineto events of one profiled stretch
    (``prof.profiler.kineto_results.events()``)."""
    dev = [e for e in events if _is_device(e) and not _is_sync(e.name())]
    busy = _union([(e.start_ns(), e.end_ns()) for e in dev])
    busy_ns = sum(e - s for s, e in busy)

    by_name = defaultdict(lambda: [0, 0])
    for e in dev:
        row = by_name[e.name()]
        row[0] += 1
        row[1] += e.end_ns() - e.start_ns()

    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if not _is_device(e))
    launches = sum(1 for h in host if h[2] in LAUNCH_NAMES)
    starts = [h[0] for h in host]
    gaps = defaultdict(int)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        name = _host_at(starts, host, (a + b) // 2) or "host, between ops"
        gaps[name] += b - a

    def top(d, key):
        rows = sorted(d.items(), key=lambda kv: -key(kv[1]))[:TOP]
        return [[name, key(v) / 1e9] for name, v in rows]

    return {
        "busy_s": busy_ns / 1e9,
        "launches": launches,
        "kernels": {k: {"launches": v[0], "seconds": v[1] / 1e9}
                    for k, v in by_name.items()},
        "device_ops": top(by_name, lambda v: v[1]),
        "idle_gaps": top(gaps, lambda v: v),
        "non_kernel_ops": sorted({e.name() for e in dev
                                  if "mem" in e.name().lower()})[:TOP],
    }
