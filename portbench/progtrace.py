"""The program's own spans in a profiled stretch: per span of
``cmpc_tpu_torch/runtime/spans.py``, the device seconds, kernel launches,
synchronizing runtime calls, host-to-device copies and idle seconds, read
from the kineto events of a profiler that recorded the host and the device.

Every kernel, copy and set goes to the innermost program span that held its
launch's runtime call (matched by correlation id) when the host made that
call; a span's numbers hold its children's.  Busy time is the union of the
device's kernel, copy and set intervals (the device side of the spans, the
user annotations, is no work).  Each gap between busy intervals goes to the
innermost span that holds its midpoint and is named ``<span>/<op>`` after
the innermost host operation running there, or ``<span>/between ops`` where
none ran; a gap outside every span keeps the name ``devtrace`` gives it.

Run one stretch of a cell with the spans recording:

    python3 -m portbench.progtrace --workload centroidal-solve-b2048 --seed N

prints one JSON line: ``program`` (the reduction below), ``counters``
(``spans.counters()``) and ``metrics`` (:func:`metrics`).
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import time
from collections import defaultdict

from torch.profiler import ProfilerActivity, profile

from portbench import core, devtrace
from portbench.loads import common

# runtime calls after which the host waits for the device
SYNC_CALL = re.compile(r"^cu(da)?\w*Synchronize$|^cu(da)?Memcpy(2D)?$")
BETWEEN = "between ops"
OUTSIDE = "(no span)"


def _kind(e) -> str:
    f = getattr(e, "activity_type", None)
    return f() if f else ""


def _annotation(e) -> bool:
    """A program span's record, on the host or mirrored on the device."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f and f()) or _kind(e).endswith("user_annotation")


def _runtime(e) -> bool:
    """A call of the CUDA runtime or driver on the host."""
    kind = _kind(e)
    return kind.endswith(("_runtime", "_driver")) if kind \
        else e.name().startswith("cu")


def _is_h2d(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


class _Spans:
    """The host's program spans of a trace (a nested family of intervals),
    each with its ancestors' names."""

    def __init__(self, events):
        rows = sorted((e.start_ns(), -e.end_ns(), e.name()) for e in events)
        self.starts = [r[0] for r in rows]
        self.ends = [-r[1] for r in rows]
        self.names = [r[2] for r in rows]
        self.parent = []
        for k, s in enumerate(self.starts):
            self.parent.append(self.at(s, k))

    def at(self, t, before=None):
        """The index of the innermost span holding time `t` (among the
        first `before`), or None."""
        i = bisect.bisect_right(self.starts, t, 0, before)
        for j in range(i - 1, -1, -1):
            if self.ends[j] >= t:
                return j
        return None

    def name(self, k):
        return OUTSIDE if k is None else self.names[k]

    def chain(self, k):
        """The names of span `k` and of every span that holds it, once
        each (OUTSIDE for no span)."""
        if k is None:
            return [OUTSIDE]
        names = []
        while k is not None:
            if self.names[k] not in names:
                names.append(self.names[k])
            k = self.parent[k]
        return names


def _host_op(starts, ops, t, outermost=False, lo=0, reach=64):
    """The innermost host operation running at `t` among the `reach`
    that started last before it, or the outermost one that started at or
    after `lo`."""
    i = bisect.bisect_right(starts, t)
    found = None
    for j in range(i - 1, max(i - reach, -1), -1):
        s, e, name = ops[j]
        if s < lo:
            break
        if e >= t:
            if not outermost:
                return name
            found = name
    return found


def summarize(events) -> dict:
    """Numbers of the kineto events of one profiled stretch
    (``prof.profiler.kineto_results.events()``), per program span."""
    events = list(events)
    host = [e for e in events if not devtrace._is_device(e)]
    marks = [e for e in host if _annotation(e)]
    span_names = {e.name() for e in marks}
    sp = _Spans(marks)
    ops = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                 if not _annotation(e))
    op_starts = [o[0] for o in ops]
    work = [e for e in events if devtrace._is_device(e)
            and not devtrace._is_sync(e.name()) and not _annotation(e)
            and e.name() not in span_names]
    runtime = [e for e in host if not _annotation(e) and _runtime(e)]
    calls = {e.correlation_id(): e for e in runtime}

    rows = defaultdict(lambda: dict.fromkeys(
        ("count", "device_s", "self_device_s", "launches", "syncs",
         "h2d_copies", "idle_s"), 0))
    for name in sp.names:
        rows[name]["count"] += 1

    def credit(k, key, v, own=None):
        for name in sp.chain(k):
            rows[name][key] += v
        if own:
            rows[sp.name(k)][own] += v

    stretch = dict.fromkeys(("device_s", "launches", "syncs", "h2d_copies",
                             "unattributed_device_s"), 0)
    for e in work:
        s = (e.end_ns() - e.start_ns()) / 1e9
        stretch["device_s"] += s
        call = calls.get(e.correlation_id())
        if call is None:
            stretch["unattributed_device_s"] += s
            continue
        k = sp.at(call.start_ns())
        credit(k, "device_s", s, own="self_device_s")
        if _is_h2d(e.name()):
            stretch["h2d_copies"] += 1
            credit(k, "h2d_copies", 1)

    sync_sites = defaultdict(int)
    for e in runtime:
        name = e.name()
        k = sp.at(e.start_ns())
        if name in devtrace.LAUNCH_NAMES:
            stretch["launches"] += 1
            credit(k, "launches", 1)
        elif SYNC_CALL.match(name):
            stretch["syncs"] += 1
            credit(k, "syncs", 1)
            # the program's call that waited: the outermost operation in
            # the span (within 4096 operations outside every span)
            op = _host_op(op_starts, ops, e.start_ns(), outermost=True,
                          lo=sp.starts[k] if k is not None else 0,
                          reach=len(ops) if k is not None else 4096)
            sync_sites[f"{sp.name(k)}/{op}"] += 1

    busy = devtrace._union([(e.start_ns(), e.end_ns()) for e in work])
    gaps = defaultdict(int)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        k = sp.at(mid)
        op = _host_op(op_starts, ops, mid)
        name = op or "host, between ops" if k is None \
            else f"{sp.name(k)}/{op or BETWEEN}"
        credit(k, "idle_s", (b - a) / 1e9)
        gaps[name] += b - a

    return {
        "stretch": dict(stretch, busy_s=sum(e - s for s, e in busy) / 1e9,
                        idle_s=sum(gaps.values()) / 1e9),
        "spans": {k: dict(v) for k, v in rows.items()},
        "sync_sites": dict(sync_sites),
        "idle_gaps": [[k, v / 1e9] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:devtrace.TOP]],
    }


def metrics(program: dict, counters: dict, solves: int) -> dict:
    """The per-layer numbers of the solve's spans and counters (None where
    the stretch has nothing to read): the device shares of condensing, the
    interior point and the line search in the solve's device seconds (%),
    the synchronizing calls per solve, and the shares of rejected line
    searches and of guarded interior-point steps (%)."""
    spans = program.get("spans", {}) if program else {}
    solve = spans.get("sqp.solve_mpc", {}).get("device_s", 0)

    def share(name):
        if solve <= 0 or name not in spans:
            return None
        return 100.0 * spans[name]["device_s"] / solve

    def ratio(num, den):
        n, d = counters.get(num), counters.get(den)
        return 100.0 * n / d if n is not None and d else None

    return {
        "condense.device_share": share("condense.build"),
        "pdip.device_share": share("pdip.pdip_solve"),
        "line_search.device_share": share("sqp.line_search"),
        "solve.host_syncs": (spans["sqp.solve_mpc"]["syncs"] / solves
                             if solve > 0 and solves else None),
        "line_search.rejected_share": ratio("line_search.rejected",
                                            "line_search.rows"),
        "pdip.guarded_share": ratio("pdip.guarded", "pdip.steps"),
    }


def _program_spans():
    """The program's span module, or None where the program has none."""
    try:
        return common.module("runtime.spans")
    except ImportError:
        return None


def run(workload: str, seed: int, steps: int, device="cuda",
        mix_overrides: dict | None = None) -> dict:
    """Set up the cell as ``core.run_cell`` does, then profile `steps`
    solves with the spans recording."""
    plan = core.cell_plan(core.load_benchmark(), workload)
    clock = core.SetupClock(time.perf_counter())
    load = core.make_load(plan, seed, device, clock, mix_overrides)
    load.prepare()
    out = {"workload": workload, "seed": seed, "batch": load.batch,
           "steps": steps, "device": core.device_info(device,
                                                      plan["cell"]["chips"])}
    spans = _program_spans()
    if spans is None:
        return dict(out, program=None, counters=None, metrics=None)
    cuda = str(load.device).startswith("cuda")
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof, \
            spans.recording():
        common.sync(load.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            load.step()
        common.sync(load.device)
        window_s = time.perf_counter() - t0
    counters = spans.counters()
    program = summarize(prof.profiler.kineto_results.events())
    program["stretch"]["window_s"] = window_s
    return dict(out, program=program, counters=counters,
                metrics=metrics(program, counters, steps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.steps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
