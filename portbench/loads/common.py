"""What the loads share: the program's modules, configuration and
precision from the benchmark's plain inputs."""

from __future__ import annotations

import importlib

import torch

PROGRAM = "cmpc_tpu_torch"

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def set_precision(tf32: bool) -> None:
    """Full-precision float32 products unless the configuration states
    TF32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def module(name: str):
    """The program's module `name` (such as ``ops.sqp``)."""
    return importlib.import_module(f"{PROGRAM}.{name}")


def walk_config(config: dict):
    """The program's ``WalkConfig`` of the configuration file."""
    WalkConfig = module("config").WalkConfig
    fields = dict(config["walk_config"])
    fields["stance_box"] = tuple(fields["stance_box"])
    return WalkConfig(**fields)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_seconds() -> dict:
    """Seconds each of the program's CUDA libraries took to compile in this
    process (0.0 where it was found built)."""
    return dict(module("ops.cuda_build").BUILD_SECONDS)


def split_nvcc(clock, part: str) -> None:
    """Move the nvcc builds out of the set-up's `part`, where the program's
    first solve built its kernels."""
    nvcc = sum(build_seconds().values())
    clock.parts["nvcc"] = nvcc
    clock.parts[part] -= nvcc


def to_host(x):
    """A float64 CPU copy of a tensor, or plain nested tuples of such copies
    of a (named) tuple or list: what the reference receives of the
    program's outputs and state."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64) if x.is_floating_point() \
            else x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return tuple(to_host(v) for v in x)
    return x
