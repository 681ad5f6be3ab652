"""ctypes bindings for the native host library (port of ``cmpc_tpu.native``):
the C++ URDF parser (``native/src/urdf_parser.cpp``) and the binary trace
sink (``native/src/trace_sink.cpp``).

:func:`build` compiles those sources, as they are in the repository, with
``g++`` and the flags of ``native/Makefile`` into ``cmpc_tpu_torch/_build/``.
The library's name carries a hash of the sources and the flags, and it is
written under a temporary name and renamed, so concurrent builds (and the
JAX package's ``make -C native``, which writes elsewhere) never see a
half-written file.  :func:`available` says whether it is built; nothing
here builds it behind the caller's back.  The sink's file format
(``CMPCTRC1``) is the JAX package's, so each package reads the other's
files.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parent.parent
SOURCES = (_ROOT / "native" / "src" / "urdf_parser.cpp",
           _ROOT / "native" / "src" / "trace_sink.cpp")
# native/Makefile's CXXFLAGS and link flag
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lib = None


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libcmpc_host-{h.hexdigest()[:16]}.so"


def build(quiet: bool = True) -> bool:
    """Compile the library unless it is built; returns success."""
    out = library_path()
    if out.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp,
                        *map(str, SOURCES)], check=True,
                       capture_output=quiet)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.cmpc_parse_urdf.restype = ctypes.c_int
    lib.cmpc_parse_urdf.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_long]
    lib.ts_open.restype = ctypes.c_void_p
    lib.ts_open.argtypes = [ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint]
    lib.ts_append.restype = ctypes.c_int
    lib.ts_append.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_float), ctypes.c_uint]
    lib.ts_flush.restype = ctypes.c_int
    lib.ts_flush.argtypes = [ctypes.c_void_p]
    lib.ts_rows_written.restype = ctypes.c_long
    lib.ts_rows_written.argtypes = [ctypes.c_void_p]
    lib.ts_close.restype = ctypes.c_int
    lib.ts_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built "
                           "(cmpc_tpu_torch.native.build())")
    return lib


def parse_urdf_spec(path: str, cap: int = 1 << 22) -> dict:
    """Parse a URDF with the native parser -> robot spec dict (the format
    of rbd.urdf._read_urdf_xml)."""
    lib = _require()
    buf = ctypes.create_string_buffer(cap)
    n = lib.cmpc_parse_urdf(str(path).encode(), buf, cap)
    if n == -1:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(f"cmpc_parse_urdf failed with code {n}")
    return json.loads(buf.raw[:n].decode())


class TraceSink:
    """Streamed float32 row logger backed by the native buffered writer."""

    MAGIC = b"CMPCTRC1"

    def __init__(self, path: str, ncols: int, buf_rows: int = 4096):
        self._lib = _require()
        self._h = self._lib.ts_open(str(path).encode(), ncols, buf_rows)
        if not self._h:
            raise OSError(f"ts_open failed for {path}")
        self.ncols = ncols
        self.path = path

    def append(self, rows) -> None:
        """Append (r, ncols) or (ncols,) rows: a numpy array or a tensor on
        any device, written as float32."""
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().to("cpu", torch.float32).numpy()
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.ncols:
            raise ValueError(f"rows of shape {rows.shape}; the sink has "
                             f"{self.ncols} columns")
        rc = self._lib.ts_append(
            self._h, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.shape[0])
        if rc != 0:
            raise OSError(f"ts_append failed ({rc})")

    def rows_written(self) -> int:
        return int(self._lib.ts_rows_written(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.ts_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def read(path: str) -> np.ndarray:
        """Load a sink file -> (rows, ncols) float32 array."""
        with open(path, "rb") as f:
            if f.read(8) != TraceSink.MAGIC:
                raise ValueError(f"{path}: not a CMPCTRC1 file")
            ncols = int(np.frombuffer(f.read(8), np.uint32)[0])
            data = np.frombuffer(f.read(), np.float32)
        return data.reshape(-1, ncols)
