"""Build and load the package's CUDA kernels.

``ops/csrc/*.cu`` are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, ``build/dexnerf_tpu_torch/libdexnerf_kernels.so`` under
the repository root, loaded with ``ctypes``. The library is rebuilt
whenever the hash of the sources (``*.cu`` and the ``*.cuh`` they include)
changes. A failed build raises: nothing falls back to the plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dexnerf_tpu_torch"
LIB_NAME = "libdexnerf_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (ptxas register/shared-memory report)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _hashed_files():
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((cmd, obj, proc))
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + build_log)
    os.replace(tmp, lib_path)
    stamp.write_text(digest)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        digest = _source_hash()
        fresh = (
            lib_path.exists()
            and stamp.exists()
            and stamp.read_text().strip() == digest
        )
        if not fresh:
            _build(lib_path, stamp, digest)
        lib = ctypes.CDLL(str(lib_path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # both routes of kernel 1: the float32 (split-TF32) and the bf16 kernel;
        # the f32 one also takes its wide route's worker buffers
        for fn, n_out in ((lib.dexnerf_fused_render, 7), (lib.dexnerf_fused_render_bf16, 6)):
            fn.argtypes = (
                [vp] * 7             # 5 inputs, packed weights, f32 aux (device)
                + [vp] * n_out       # 6 outputs (device) (, worker buffers)
                + [ci] * 7           # n_rays, n_samples, hidden, num_trunk, skip_mask,
                                     # rays per unit, grid
                + [ci, ci, vp]       # fx, inc_x, bands_x (host)
                + [ci, ci, vp]       # fd, inc_d, bands_d (host)
                + [ci, vp]           # n_thr, thresholds (host)
                + [vp, ci, vp]       # aux offsets (host), white_bg, stream
            )
            fn.restype = ci
        # hidden, dx, dd, n_samples, rays per unit, num_trunk (, skip_mask for bf16);
        # CTAs per SM, shared bytes, ring stages (out)
        lib.dexnerf_fused_render_occupancy.argtypes = [ci] * 6 + [vp] * 3
        lib.dexnerf_fused_render_occupancy.restype = ci
        lib.dexnerf_fused_render_bf16_occupancy.argtypes = [ci] * 7 + [vp] * 3
        lib.dexnerf_fused_render_bf16_occupancy.restype = ci
        # the wide route: the same shape but skip_mask; + consumer warpgroups (out)
        lib.dexnerf_fused_render_bf16_wide_occupancy.argtypes = [ci] * 6 + [vp] * 4
        lib.dexnerf_fused_render_bf16_wide_occupancy.restype = ci
        # the f32 wide route: + consumer warpgroups, floats of a worker's buffer (out)
        lib.dexnerf_fused_render_wide_occupancy.argtypes = [ci] * 6 + [vp] * 5
        lib.dexnerf_fused_render_wide_occupancy.restype = ci
        lib.dexnerf_train_args_size.argtypes = []
        lib.dexnerf_train_args_size.restype = ci
        lib.dexnerf_train_rows.argtypes = [ci, ci, ci, vp, ci]  # dx, H, nt, rows, len
        lib.dexnerf_train_rows.restype = ci
        lib.dexnerf_train_pass.argtypes = [vp, vp]  # args block (host), stream
        lib.dexnerf_train_pass.restype = ci
        # kernels 2 and 3 at f32: args block (host), backward (0: kernel 2, 1: kernel 3), stream
        lib.dexnerf_field_tf32_pass.argtypes = [vp, ci, vp]
        lib.dexnerf_field_tf32_pass.restype = ci
        lib.dexnerf_train_tile_words.argtypes = [ci, ci]  # padded width, num_trunk
        lib.dexnerf_train_tile_words.restype = ci
        # padded width, num_trunk, encoding K-chunks; out (host, 8 ints)
        lib.dexnerf_train_tf32_occupancy.argtypes = [ci, ci, ci, vp]
        lib.dexnerf_train_tf32_occupancy.restype = ci
        # per-ray losses, rays, loss, stream
        lib.dexnerf_train_loss_sum.argtypes = [vp, ci, vp, vp]
        lib.dexnerf_train_loss_sum.restype = ci
        # the f32 routes' split-TF32 weight gradients (dw_tf32.cu)
        lib.dexnerf_dw_tf32_args_size.argtypes = []
        lib.dexnerf_dw_tf32_args_size.restype = ci
        lib.dexnerf_dw_tf32_smem.argtypes = [vp]  # plan (host)
        lib.dexnerf_dw_tf32_smem.restype = ci
        # out (host, 128 bytes), scratch (device), k, rows, rows of a box
        lib.dexnerf_dw_tf32_tensor_map.argtypes = [vp, vp, ctypes.c_longlong,
                                                   ctypes.c_longlong, ci]
        lib.dexnerf_dw_tf32_tensor_map.restype = ci
        lib.dexnerf_dw_tf32.argtypes = [vp, vp]  # plan and chunk (host), stream
        lib.dexnerf_dw_tf32.restype = ci
        lib.dexnerf_dw_tf32_reduce.argtypes = (
            [vp, ci, ci, ci, ci]     # plan's parts (host), parts, chunks, stages of a chunk,
                                     # of the last
            + [vp, ci, vp, vp, vp]   # viewdir entries, per chunk, map, grad, stream
        )
        lib.dexnerf_dw_tf32_reduce.restype = ci
        lib.dexnerf_dw_tf32_occupancy.argtypes = [ci, vp]  # shared bytes, CTAs per SM
        lib.dexnerf_dw_tf32_occupancy.restype = ci
        lib.dexnerf_train_bf16_size.argtypes = [ci] * 4  # which, hidden, num_trunk, dd
        lib.dexnerf_train_bf16_size.restype = ci
        # args, chain maps (host), rows, tiles, stream
        lib.dexnerf_train_bf16_pass.argtypes = [vp, vp, ci, ci, vp]
        lib.dexnerf_train_bf16_pass.restype = ci
        # dW plan (host), stages, chunk, stream
        lib.dexnerf_train_bf16_dw.argtypes = [vp, ci, ci, vp]
        lib.dexnerf_train_bf16_dw.restype = ci
        # out (host, 128 bytes), block (device), width, rows, rows of a box
        lib.dexnerf_train_bf16_tensor_map.argtypes = [vp, vp, ctypes.c_longlong,
                                                      ctypes.c_longlong, ci]
        lib.dexnerf_train_bf16_tensor_map.restype = ci
        # stages, unit start, unit cost, total cost, CTAs, CTA, out (host, 4 ints)
        lib.dexnerf_train_bf16_dw_span.argtypes = [ci] * 6 + [vp]
        lib.dexnerf_train_bf16_dw_span.restype = ci
        lib.dexnerf_train_bf16_dw_occupancy.argtypes = [ci, vp]  # shared bytes, CTAs per SM
        lib.dexnerf_train_bf16_dw_occupancy.restype = ci
        lib.dexnerf_train_bf16_reduce.argtypes = (
            [vp, ci, ci, ci, ci]     # dW plan's parts (host), parts, chunks, stages of a chunk,
                                     # of the last
            + [vp, ci, ci, vp, vp]   # chain slots, slots, slot length, map, grad
            + [vp, ci, vp, vp]       # per-ray losses, rays, loss (or null), stream
        )
        lib.dexnerf_train_bf16_reduce.restype = ci
        # args, chain maps (host; null for kernel 2), rows, tiles, backward (0: kernel 2,
        # 1: kernel 3), stream
        lib.dexnerf_field_bf16_pass.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.dexnerf_field_bf16_pass.restype = ci
        # hidden, dx, num_trunk, dd, skip_mask; out (host, 10 ints)
        lib.dexnerf_train_bf16_occupancy.argtypes = [ci] * 5 + [vp]
        lib.dexnerf_train_bf16_occupancy.restype = ci
        # the wide route's: the same shape; out (host, 12 ints)
        lib.dexnerf_train_bf16_wide_occupancy.argtypes = [ci] * 5 + [vp]
        lib.dexnerf_train_bf16_wide_occupancy.restype = ci
        lib.dexnerf_resample.argtypes = (
            [vp] * 6             # z_coarse, weights, u, dir_norms, z_out, d_out
            + [ci] * 3 + [vp]    # n_rays, sc, sf, stream
        )
        lib.dexnerf_resample.restype = ci
        lib.dexnerf_sample_pdf.argtypes = (
            [vp] * 4             # bins, weights, u, out
            + [ci] * 3 + [vp]    # n_rays, M, n, stream
        )
        lib.dexnerf_sample_pdf.restype = ci
        lib.dexnerf_cuda_error_string.argtypes = [ci]
        lib.dexnerf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.dexnerf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
