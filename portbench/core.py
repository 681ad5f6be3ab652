"""One run of one cell: set-up, the measured window (or, with tracing, the
traced stretches), the no-JAX guard, the comparison that decides
``correct``, and the result line.

Everything that belongs to one configuration, traffic mix, load or metric
is found by name: ``configs/<file>``, ``traffic/<mix>.json``,
``loads/<kind>.py``, ``metrics/<metric>.py`` and ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time


from portbench.loads import common

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "cmpc_tpu")


class Failure(Exception):
    """A run that must end without a result line."""


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (default: the modules
    loaded in this process), compared whole: ``cmpc_tpu_torch`` is not
    ``cmpc_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise Failure(f"no BENCHMARK.json in {ROOT}")
    with open(path) as f:
        return json.load(f)


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell `workload`, its configuration entry and the metrics it
    reports: the end-to-end ones without tracing, the per-layer ones with
    it (a metric without ``workloads`` is reported in every cell)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise Failure(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]
    return {"cell": cell, "config": config,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


class SetupClock:
    """The parts of a run's set-up, each the time since the last mark."""

    def __init__(self, t_start: float):
        self.t_start = self.t_last = t_start
        self.parts: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.t_last
        self.t_last = now

    def total(self) -> float:
        return self.t_last - self.t_start


class Ends:
    """The first and the last of the outputs added."""

    def __init__(self):
        self.items = []

    def add(self, item) -> None:
        self.items[1 if self.items else 0:] = [item]


def run_window(load, seconds: float, keep: Ends) -> dict:
    """Steps of the load back to back for `seconds`; the window ends when
    the device has finished the last of them."""
    steps = []
    common.sync(load.device)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        ts = time.perf_counter()
        units, sample = load.step()
        te = time.perf_counter()
        steps.append((te - ts, units))
        keep.add(sample)
        if te >= t_end:
            break
    common.sync(load.device)
    return {"window_s": time.perf_counter() - t0, "steps": steps}


class Spans:
    """Host-clock spans around module attributes, with a synchronize at
    both ends of each, installed for the span stretch only."""

    def __init__(self, device):
        self.device, self.seconds, self._undo = device, {}, []

    def install(self, targets) -> None:
        for mod_name, attr, span in targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._undo.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, span))

    def _wrap(self, fn, span):
        def timed(*args, **kwargs):
            common.sync(self.device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            common.sync(self.device)
            self.seconds.setdefault(span, []).append(
                time.perf_counter() - t)
            return out
        return timed

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()


def run_traced(load, keep: Ends, span_steps: int,
               profiled_steps: int) -> dict:
    """The traced run: `span_steps` steps with the load's spans installed;
    `profiled_steps` steps under the profiler recording the device alone
    (its busy time, kernels and the launches); and as many again recording
    the host's operations too, which only name the device's idle gaps (the
    host's records slow the host, and so would the busy share)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace

    spans = Spans(load.device)
    spans.install(load.spans)
    try:
        for _ in range(span_steps):
            keep.add(load.step()[1])
    finally:
        spans.remove()
    cuda = str(load.device).startswith("cuda")

    def stretch(activities):
        steps = []
        with profile(activities=activities) as prof:
            common.sync(load.device)
            t0 = time.perf_counter()
            for _ in range(profiled_steps):
                ts = time.perf_counter()
                units, sample = load.step()
                steps.append((time.perf_counter() - ts, units))
                keep.add(sample)
            common.sync(load.device)
            window_s = time.perf_counter() - t0
        return (devtrace.summarize(prof.profiler.kineto_results.events()),
                window_s, steps)

    summary, window_s, steps = stretch(
        [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
    named = stretch([ProfilerActivity.CPU]
                    + ([ProfilerActivity.CUDA] if cuda else []))[0]
    summary["idle_gaps"] = named["idle_gaps"]
    return {"spans": spans.seconds, "span_steps": span_steps,
            "profile": summary, "window_s": window_s, "steps": steps}


def read_metric(name: str, run: dict):
    """The value of metric `name` read by ``metrics/<name>.py``, or None
    where its reader finds nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def device_info(device, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit_w": _power_limit_w()}


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def judge(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit; a number passes when it is
    finite and at most its limit."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        v = None if v is None else _finite(float(v))
        out[name] = {"value": v, "limit": limit,
                     "ok": v is not None and v <= limit}
    return out


def load_limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def make_load(plan: dict, seed: int, device, clock: SetupClock,
              mix_overrides: dict | None = None):
    from portbench import traffic
    with open(os.path.join(ROOT, plan["config"]["file"])) as f:
        config = json.load(f)
    mix = dict(traffic.load_mix(plan["cell"]["traffic"]),
               **(mix_overrides or {}))
    kind = importlib.import_module(f"portbench.loads.{mix['load']}")
    return kind.Load(config, mix, seed, device, clock)


def _guard() -> None:
    found = forbidden_modules()
    if found:
        raise Failure("forbidden modules loaded in the run's process: "
                      + ", ".join(found))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", require_chip: bool = True,
             mix_overrides: dict | None = None) -> dict:
    """One run of the cell; returns the result line as a dict.  Raises
    :class:`Failure` where the run must print no result.  The tests run
    it on the CPU at a small size (``require_chip=False``,
    ``mix_overrides``)."""
    plan = cell_plan(load_benchmark(), workload)
    chips = plan["cell"]["chips"]
    clock = SetupClock(t_start)
    import torch
    clock.mark("imports")
    if require_chip:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise Failure(f"the cell needs {chips} cards, "
                          f"{torch.cuda.device_count()} visible")
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    clock.mark("cuda_context")

    load = make_load(plan, seed, device, clock, mix_overrides)
    load.prepare()                    # marks inputs, nvcc and warm_up
    setup_s = clock.total()
    keep = Ends()
    if trace:
        run = run_traced(load, keep, load.mix["trace_span_steps"],
                         load.mix["trace_profiled_steps"])
    else:
        run = run_window(load, seconds, keep)
    dev_info = device_info(device, chips)
    _guard()

    run.update(setup_s=setup_s, setup_parts=dict(clock.parts),
               batch=load.batch, config=load.config)
    metrics = {}
    for m in (plan["per_layer"] if trace else plan["end_to_end"]):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    attempted = sum(u for _, u in run["steps"])
    t_ref = time.perf_counter()
    load.release()
    try:
        numbers, failed = load.check(keep.items)
        error = None
    except Exception as exc:          # a reference that crashes fails
        numbers, failed, error = {}, len(keep.items), repr(exc)
    ref_s = time.perf_counter() - t_ref
    checks = judge(numbers, load_limits(workload))
    correct = error is None and all(c["ok"] for c in checks.values())
    _guard()

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        p = run["profile"]
        result["device"].update(busy_s=p["busy_s"],
                                window_s=run["window_s"])
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    result["diagnostics"] = {
        "setup_parts_s": run["setup_parts"],
        "compiled": any(v > 0 for v in load.build_seconds().values()),
        "reference_s": ref_s, "numbers": numbers, "error": error}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def print_result(result: dict) -> None:
    """Set-up in parts, then each number compared beside its limit as the
    last lines of standard error; the result as the last line of standard
    output."""
    d = result["diagnostics"]
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in d["setup_parts_s"].items())
    print(f"setup parts: {parts}; reference (after the window) "
          f"{d['reference_s']:.3f} s; "
          f"{'compiling run' if d['compiled'] else 'nothing compiled'}",
          file=sys.stderr)
    if d["error"]:
        print(f"reference failed: {d['error']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
