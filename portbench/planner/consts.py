"""Constant tensors built once per (key, device, dtype).

A host array copied to a CUDA device from pageable memory synchronizes the
stream, so a constant rebuilt on every call would stall the host on the
device several times per solve.  Cached tensors are shared: callers must
not write into them.
"""

from __future__ import annotations

import torch

_CACHE: dict = {}


def const(key, make, device, dtype=None) -> torch.Tensor:
    """The tensor of ``make()`` (array-like) on `device` as `dtype` (None
    keeps the array's own type), built on first use of `key`."""
    k = (key, str(torch.device(device or "cpu")), dtype)
    t = _CACHE.get(k)
    if t is None:
        t = torch.as_tensor(make(), dtype=dtype, device=device)
        _CACHE[k] = t
    return t
