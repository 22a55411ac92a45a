"""The data path's host library (``ops/csrc/host_rows.cc``): the ray
cache's random row gather, the host-streamed store's gather of given rows
(``data/host_store.py``), and the counterparts of the JAX package's other
native host ops (``pack_rays``, ``searchsorted_right``,
``sample_pdf_interp``, ``sample_pdf_host``).

The source is compiled with the host's C++ compiler (``$CXX``, else
``g++``) at first use into
``build/dexnerf_tpu_torch/libdexnerf_host_rows.so`` under the repository
root, rebuilt when the source's hash changes, and loaded with ``ctypes``.
A failed build raises: no other generator takes its place, since the
shards must hold the rows the JAX package's cache holds. ctypes releases
the GIL for each call, so a loader thread's gather does not hold up the
thread that launches the step's kernels.
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
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        for name, args in (("dexnerf_gather_rows", [p, i64, p, i64, p]),
                           ("dexnerf_pack_rays", [p, p, p, i64, p]),
                           ("dexnerf_searchsorted_right", [p, p, i32, i32, i32, p]),
                           ("dexnerf_sample_pdf_interp", [p, p, p, p, i32, i32, i32, p])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, None
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


def gather_rows(src: np.ndarray, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``src[idx]`` for a C-contiguous ``src`` [n, ...] of any dtype (an
    ndarray or a ``numpy.memmap``) and int64 row numbers ``idx`` [batch],
    into ``out`` (a C-contiguous [batch, ...] of ``src``'s dtype, say the
    numpy view of a pinned tensor) when given. The rows are not checked
    against ``n``: the caller draws them in range."""
    lib = load_library()
    if not src.flags.c_contiguous:
        raise ValueError("gather_rows needs a C-contiguous source")
    idx = np.ascontiguousarray(idx, np.int64)
    shape = (idx.shape[0], *src.shape[1:])
    if out is None:
        out = np.empty(shape, src.dtype)
    elif out.shape != shape or out.dtype != src.dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous {shape} {src.dtype}, got {out.shape} "
                         f"{out.dtype}")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.dexnerf_gather_rows(src.ctypes.data, row_bytes, idx.ctypes.data, idx.shape[0],
                            out.ctypes.data)
    return out


def pack_rays(ro: np.ndarray, rd: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """[N, 12] store rows (origin, direction, viewdir, rgb) from ``ro``,
    ``rd`` and ``rgb`` ([..., 3] each), the viewdirs computed in C++ as the
    JAX package's ``pack_rays`` computes them."""
    lib = load_library()
    ro, rd, rgb = (np.ascontiguousarray(np.asarray(a, np.float32).reshape(-1, 3))
                   for a in (ro, rd, rgb))
    out = np.empty((ro.shape[0], 12), np.float32)
    lib.dexnerf_pack_rays(ro.ctypes.data, rd.ctypes.data, rgb.ctypes.data, ro.shape[0],
                          out.ctypes.data)
    return out


def searchsorted_right(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Batched ``searchsorted(cdf[b], u[b], side="right")``: ``cdf`` [B, M]
    ascending per row, ``u`` [B, N]; int32 [B, N]."""
    lib = load_library()
    cdf = np.ascontiguousarray(cdf, np.float32)
    u = np.ascontiguousarray(u, np.float32)
    (B, M), N = cdf.shape, u.shape[1]
    out = np.empty((B, N), np.int32)
    lib.dexnerf_searchsorted_right(cdf.ctypes.data, u.ctypes.data, B, M, N, out.ctypes.data)
    return out


def sample_pdf_interp(cdf: np.ndarray, bins: np.ndarray, u: np.ndarray,
                      inds: np.ndarray) -> np.ndarray:
    """The inverse-CDF lerp of sample_pdf given ``searchsorted_right``'s
    ``inds`` (below/above clamped to the row, a denominator under 1e-5
    taken as 1)."""
    lib = load_library()
    cdf, bins, u = (np.ascontiguousarray(a, np.float32) for a in (cdf, bins, u))
    inds = np.ascontiguousarray(inds, np.int32)
    (B, M), N = cdf.shape, u.shape[1]
    out = np.empty((B, N), np.float32)
    lib.dexnerf_sample_pdf_interp(cdf.ctypes.data, bins.ctypes.data, u.ctypes.data,
                                  inds.ctypes.data, B, M, N, out.ctypes.data)
    return out


def sample_pdf_host(bins: np.ndarray, weights: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The whole sample_pdf on the host (the reference's ``sample_pdf_2``):
    the CDF of ``weights + 1e-5`` in numpy, then the two native halves."""
    weights = np.asarray(weights, np.float32) + 1e-5
    pdf = weights / weights.sum(-1, keepdims=True)
    cdf = np.concatenate([np.zeros_like(pdf[:, :1]), np.cumsum(pdf, -1)],
                         axis=-1).astype(np.float32)
    return sample_pdf_interp(cdf, np.asarray(bins, np.float32), u, searchsorted_right(cdf, u))
