"""Named spans and counters inside the port's solve, off by default.

A span is a host range on ``torch.profiler``'s own timeline
(``torch.profiler.record_function``): under a profiler that records the
host, each span lies on the same clock as the kernel, copy and runtime
records it holds, and nests inside the span that was open when it began.
Off, :func:`span` returns one shared null context (one flag check, no
allocation) and the program skips its counter updates.

A counter adds Python ints, or 0-d device tensors that are added on the
device and read once, by :func:`counters`, which synchronizes: nothing is
read back to the host inside a solve.

    from torch.profiler import ProfilerActivity, profile
    from cmpc_tpu_torch.runtime import spans

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \\
            as prof, spans.recording():
        sqp.solve_mpc(state, params, cfg)
    prof.export_chrome_trace("solve.json")
    print(spans.counters())
"""

from __future__ import annotations

import contextlib
import functools

import torch

_ON = False
_NULL = contextlib.nullcontext()
_HOST: dict[str, int] = {}
_DEVICE: dict[str, torch.Tensor] = {}


def enabled() -> bool:
    """Whether spans and counters are recorded."""
    return _ON


def enable(on: bool) -> None:
    """Switch spans and counters on or off."""
    global _ON
    _ON = bool(on)


@contextlib.contextmanager
def recording():
    """Spans and counters on inside the block; the switch as it was after."""
    was = _ON
    enable(True)
    try:
        yield
    finally:
        enable(was)


def span(name: str):
    """A context manager: the host range `name` while recording, else the
    shared null context."""
    if not _ON:
        return _NULL
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function inside :func:`span` `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def add(name: str, n) -> None:
    """Add `n` to counter `name`: a Python int on the host, or a 0-d tensor
    on its device (the tensor is kept, not copied, until the next add)."""
    if isinstance(n, torch.Tensor):
        acc = _DEVICE.get(name)
        _DEVICE[name] = n if acc is None else acc + n
    else:
        _HOST[name] = _HOST.get(name, 0) + n


def reset() -> None:
    """Zero the counters of this module (the kernel launch, build and graph
    counters keep their own)."""
    _HOST.clear()
    _DEVICE.clear()


def counters() -> dict:
    """Every counter's total (device counters read here, which
    synchronizes), with the port's kernel launches
    (``batched_chol.LAUNCHES``), nvcc seconds
    (``cuda_build.BUILD_SECONDS``) and CUDA graph captures and replays
    (``graphs.COUNTS``) under those names."""
    from cmpc_tpu_torch.ops import batched_chol, cuda_build
    from cmpc_tpu_torch.runtime import graphs

    out = dict(_HOST)
    for name, t in _DEVICE.items():
        out[name] = out.get(name, 0) + t.item()
    out["batched_chol.LAUNCHES"] = dict(batched_chol.LAUNCHES)
    out["cuda_build.BUILD_SECONDS"] = dict(cuda_build.BUILD_SECONDS)
    out["graphs.captures"] = graphs.COUNTS["captures"]
    out["graphs.replays"] = graphs.COUNTS["replays"]
    return out
