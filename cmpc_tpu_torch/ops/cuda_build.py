"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``cmpc_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``cmpc_tpu_torch/_build/lib<name>-<hash>.so`` — the hash
covers the source, every header under ``csrc/`` and the flags, so an edit
to any of them rebuilds — and loaded with ``ctypes``.  ``ptxas`` reports
each kernel's registers, shared memory and spills (``-Xptxas -v``); the
report is written beside the library (``lib<name>-<hash>.log``), so
:func:`resource_usage` reads it whether this process built the library or
found it built.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# seconds each library took to compile in this process (0.0 if cached)
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (set CUDA_HOME or put nvcc on "
                       "PATH)")


def _digest(src: Path, flags: tuple[str, ...]) -> str:
    """Hash of everything the library is built from: its source, the
    headers beside it (any of them may be included) and the flags."""
    h = hashlib.sha256()
    for path in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}-{_digest(src, NVCC_FLAGS)}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    so = _library_path(name)
    BUILD_SECONDS[name] = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        # the report first, so that a library is never found without it
        so.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, so)          # atomic: concurrent builds agree
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(so))


def parse_resource_usage(log: str) -> list[dict]:
    """The kernels of a ``ptxas -v`` report: for each entry function its
    (mangled) name, registers per thread, static shared memory, stack frame
    and spill bytes."""
    out = []
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = {"entry": m.group(1)}
            out.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry["stack_bytes"] = int(m.group(1))
            entry["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


def resource_usage(name: str) -> list[dict]:
    """:func:`parse_resource_usage` of the report that was written when the
    library `name` (as its sources stand now) was built; an empty list if
    it has not been built."""
    log = _library_path(name).with_suffix(".log")
    return parse_resource_usage(log.read_text() if log.exists() else "")
