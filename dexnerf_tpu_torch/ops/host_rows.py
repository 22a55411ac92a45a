"""The ray cache's random row gather (``ops/csrc/host_rows.cc``), a host
library.

The source is compiled with the host's C++ compiler (``$CXX``, else
``g++``) at first use into
``build/dexnerf_tpu_torch/libdexnerf_host_rows.so`` under the repository
root, rebuilt when the source's hash changes, and loaded with ``ctypes``.
A failed build raises: no other generator takes its place, since the
shards must hold the rows the JAX package's cache holds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from dexnerf_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "host_rows.cc"
LIB_NAME = "libdexnerf_host_rows.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The gather's shared library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()
        if not (lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"host compiler failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
            stamp.write_text(digest)
        lib = ctypes.CDLL(str(lib_path))
        lib.dexnerf_gather_random_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,  # rows, n, width
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,  # seed, batch, out
        ]
        lib.dexnerf_gather_random_rows.restype = None
        _lib = lib
        return lib


def gather_random_rows(rows: np.ndarray, seed: int, batch: int) -> np.ndarray:
    """``batch`` rows of ``rows`` [n, width] drawn with replacement, the
    draws a function of ``seed`` alone."""
    lib = load_library()
    rows = np.ascontiguousarray(rows, np.float32)
    n, width = rows.shape
    out = np.empty((batch, width), np.float32)
    lib.dexnerf_gather_random_rows(rows.ctypes.data, n, width, int(seed), int(batch),
                                   out.ctypes.data)
    return out
