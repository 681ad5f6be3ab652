"""Checkpoint / resume for long-running sweeps (port of
``cmpc_tpu.runtime.checkpoint``).

A tree of nested NamedTuples, dicts, lists and tuples of tensors is
flattened to ``path -> array`` with the JAX package's key-path strings
(field name, dict key or sequence index, joined by ``/``) and written as
one ``.npz``, so a checkpoint written by either package restores in the
other.  Writes are atomic (tmp file + rename): a killed run never leaves a
torn checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: tuple = ()) -> list:
    """[(path parts, leaf)] in a fixed order."""
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, prefix + (str(k),)))
    return out


def _unflatten(like: Any, leaves: dict, prefix: tuple = ()) -> Any:
    def sub(k, v):
        return _unflatten(v, leaves, prefix + (str(k),))

    if _is_namedtuple(like):
        return type(like)(*(sub(k, v) for k, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: sub(k, v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(sub(k, v) for k, v in enumerate(like))
    return leaves["/".join(prefix)]


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save(path: str, tree: Any, step: int | None = None,
         meta: dict | None = None) -> None:
    """Atomically write a checkpoint of `tree`."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    arrays = {"/".join(p): _to_numpy(v) for p, v in _flatten(tree)}
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def restore(path: str, like: Any, device="cuda") -> tuple[Any, int]:
    """Restore a checkpoint into the structure of `like`, its leaves as
    tensors on `device`.  Where the leaf of `like` is a tensor the restored
    one takes its dtype (so a checkpoint written in another precision, or
    by the JAX package, lands in the caller's working type).

    Returns (tree, step); step is -1 if the checkpoint carries none.
    """
    from cmpc_tpu_torch.config import resolve_device

    device = resolve_device(device)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    step = int(data.pop("__step__", -1))
    flat_like = _flatten(like)
    paths = ["/".join(p) for p, _ in flat_like]
    missing = [p for p in paths if p not in data]
    if missing:
        raise KeyError(f"checkpoint {path} missing leaves: {missing[:5]}")
    leaves = {}
    for p, (_, ref) in zip(paths, flat_like):
        a = data[p]
        if isinstance(ref, torch.Tensor):
            np_dtype = torch.empty(0, dtype=ref.dtype).numpy().dtype
            leaves[p] = torch.as_tensor(a.astype(np_dtype), device=device)
        else:
            leaves[p] = torch.as_tensor(a, device=device)
    return _unflatten(like, leaves), step


def latest(directory: str, prefix: str = "ckpt_") -> str | None:
    """Path of the highest-numbered checkpoint file, or None."""
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None

    def number(f):
        return int("".join(ch for ch in f if ch.isdigit()) or -1)

    return os.path.join(directory, max(cands, key=number))
