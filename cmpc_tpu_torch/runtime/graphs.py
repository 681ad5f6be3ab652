"""CUDA graphs of fixed-shape stages: each captured once per input
signature and replayed, so that the host starts a stage of hundreds of
kernels with one call.

:class:`Graphed` wraps a function of tensors (in tuples, named tuples,
lists and keyword arguments) and hashable settings.  On a CUDA device, with
the spans off (``runtime/spans``) and no capture under way, a call

* keys on what it can observe of its arguments (:func:`key`): their
  structure, each tensor's shape, dtype and device, the value of every
  other argument (a ``WalkConfig``, a settings tuple), and the float32
  matmul precision;
* the first time for a key, runs the function once on a side stream (what
  it sets up lazily: built kernels, cached constants, library handles),
  then captures it into a CUDA graph with a memory pool of its own, and
  replays it;
* on later calls, copies each tensor argument into the graph's input
  buffer, unless it already is that buffer, and replays.

An argument that is an output of another graph when this one is captured
is read where it lies: that output is this graph's input buffer, and a
later call that passes it again costs no copy.  A call that passes another
tensor in its place copies into it, that is into the other graph's output.

The outputs are the graph's own tensors, which its next replay overwrites;
``fresh=True`` returns copies instead, for outputs that callers keep.

Anywhere else (the CPU, the spans on, inside another capture) a call runs
the function.  ``COUNTS`` counts captures and replays.  The kernel launches
of ``ops/batched_chol.LAUNCHES`` count, at each replay, what the captured
call launched; the warm-up's launches are not counted.
"""

from __future__ import annotations

import functools

import torch

from cmpc_tpu_torch.runtime import spans

# captures made and replays launched, process-wide
COUNTS = {"captures": 0, "replays": 0}

# every graph's output tensors by id; each is kept by its graph for good
_OUTPUTS: dict[int, torch.Tensor] = {}


def active(device) -> bool:
    """Whether a call on `device` captures or replays."""
    return (torch.device(device).type == "cuda" and not spans.enabled()
            and not torch.cuda.is_current_stream_capturing())


def _flatten(tree, leaves: list):
    """Append the leaves of `tree` to `leaves`; return its structure."""
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_flatten(x, leaves) for x in tree)
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return dict, keys, tuple(_flatten(tree[k], leaves) for k in keys)
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """The tree of structure `spec` holding the next items of the iterator
    `leaves`."""
    if spec is None:
        return next(leaves)
    if spec[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    kind, subs = spec
    items = [_unflatten(s, leaves) for s in subs]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _key(spec, leaves) -> tuple:
    k = (spec, tuple((tuple(x.shape), x.dtype, x.device)
                     if isinstance(x, torch.Tensor) else x for x in leaves),
         torch.get_float32_matmul_precision(),
         torch.backends.cuda.matmul.allow_tf32)
    hash(k)               # an unhashable setting fails here, not in a dict
    return k


def key(*args, **kwargs) -> tuple:
    """The key of a call with these arguments: what a captured graph
    depends on besides the values in its tensors."""
    leaves: list = []
    return _key(_flatten((args, kwargs), leaves), leaves)


class _Graph:
    """One captured call: its input buffers, the graph, its outputs and the
    kernel launches it holds."""

    def __init__(self, fn, spec, leaves, device):
        from cmpc_tpu_torch.ops.batched_chol import LAUNCHES

        self.inputs = [x if not isinstance(x, torch.Tensor)
                       or id(x) in _OUTPUTS else x.clone() for x in leaves]
        args, kwargs = _unflatten(spec, iter(self.inputs))
        before = dict(LAUNCHES)
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn(*args, **kwargs)
            warm = dict(LAUNCHES)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                out = fn(*args, **kwargs)
            self.launches = {k: n - warm[k] for k, n in LAUNCHES.items()}
        finally:
            LAUNCHES.update(before)
        self.outputs: list = []
        self.out_spec = _flatten(out, self.outputs)
        for t in self.outputs:
            if isinstance(t, torch.Tensor):
                _OUTPUTS[id(t)] = t
        COUNTS["captures"] += 1

    def load(self, leaves) -> None:
        """Copy the call's tensors into the input buffers they are not."""
        for buf, x in zip(self.inputs, leaves):
            if isinstance(x, torch.Tensor) and x is not buf:
                buf.copy_(x)

    def replay(self, fresh: bool):
        from cmpc_tpu_torch.ops.batched_chol import LAUNCHES

        self.graph.replay()
        COUNTS["replays"] += 1
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        outs = self.outputs
        if fresh:
            outs = [t.clone() if isinstance(t, torch.Tensor) else t
                    for t in outs]
        return _unflatten(self.out_spec, iter(outs))


class Graphed:
    """`fn` replayed as a CUDA graph where :func:`active` says so, else
    called; one graph per :func:`key`.  ``fresh``: return copies of the
    outputs."""

    def __init__(self, fn, fresh: bool = False):
        functools.update_wrapper(self, fn)
        self.fn, self.fresh = fn, fresh
        self.graphs: dict = {}

    def __call__(self, *args, **kwargs):
        leaves: list = []
        spec = _flatten((args, kwargs), leaves)
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor)), None)
        if device is None or not active(device):
            return self.fn(*args, **kwargs)
        k = _key(spec, leaves)
        with torch.cuda.device(device):
            g = self.graphs.get(k)
            if g is None:
                g = self.graphs[k] = _Graph(self.fn, spec, leaves, device)
            else:
                g.load(leaves)
            return g.replay(self.fresh)
