"""The host-streamed ray store: training data that does not fit device
memory.

Counterpart of ``dexnerf_tpu/data/host_store.py``. The resident store
(``data/pipeline.py::build_ray_store``) keeps every training ray on the
device; here the rays stay in host memory and a loader thread ships each
step's batch while the device runs the step before it. Two wires:

- rows (:class:`HostRayLoader`): the store's [N, 12] f32 rows
  (:func:`build_host_ray_rows`, bit for bit the resident store's rows),
  48 B a ray (52 with f32 depth; near and far are filled on the device);
- packed (:class:`HostPixelLoader`): an int32 global ray index and the u8
  rgb (:func:`images_to_u8`), 7 B a ray (11 with f32 depth); the step
  rebuilds the rays on the device from a per-image pose table
  (:func:`build_pose_tables`, :func:`make_ray_unpack`).

The draw contract is JAX's: ``numpy.random.default_rng(seed).integers(0,
N, batch)`` a batch, uniform with replacement, so a seed gives JAX's index
stream. A loader's thread draws the indices, gathers the rows of those
indices through the C++ of ``ops/host_rows.py`` (its ctypes calls release
the GIL, so the gather does not hold up the thread that launches the
step's kernels) into a pinned host buffer of a ring of ``prefetch + 1``,
and copies it to the device with ``non_blocking=True`` on a stream of its
own; the consumer's stream waits on the copy's event, the device tensors
are marked as used by that stream (``record_stream``), and a buffer is
filled again only after its copy's event has completed. Up to
``prefetch`` batches wait in the queue. On the CPU the batches are plain
host tensors, gathered by the same C++.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dexnerf_tpu_torch.core.rays import ndc_rays
from dexnerf_tpu_torch.data.pipeline import image_ray_rows
from dexnerf_tpu_torch.ops.host_rows import gather_rows
from dexnerf_tpu_torch.render.renderer import RayBatch

def build_host_ray_rows(
    images: np.ndarray,
    poses: np.ndarray,
    hwf,
    *,
    device,
    intrinsics: Optional[np.ndarray] = None,
    use_ndc: bool = False,
    depths: Optional[np.ndarray] = None,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Pack the rays of every image into host memory, one image at a time
    (the device holds one image's rays at once): ``(rows [N_img*H*W, 12]
    float32, depth [N] or None)``, the rows of ``build_ray_store`` on the
    same ``device`` bit for bit. ``out`` is the caller's [N_img*H*W, 12]
    float32 array (a ``numpy.memmap`` too) to fill."""
    H, W = int(hwf[0]), int(hwf[1])
    rows_per = H * W
    n = images.shape[0] * rows_per
    if out is None:
        out = np.empty((n, 12), np.float32)
    if out.shape != (n, 12):
        raise ValueError(f"out has shape {out.shape}, need {(n, 12)}")
    for i in range(images.shape[0]):
        block = image_ray_rows(images[i], poses[i], hwf, device=device, use_ndc=use_ndc,
                               intrinsic=None if intrinsics is None else intrinsics[i])
        out[i * rows_per:(i + 1) * rows_per] = block.cpu().numpy()
    depth = None
    if depths is not None:
        depth = np.asarray(depths, np.float32).reshape(-1)
        if depth.shape[0] != n:
            raise ValueError(f"depths cover {depth.shape[0]} rays, store has {n}")
    return out, depth


def images_to_u8(images: np.ndarray) -> np.ndarray:
    """[N, H, W, 3] float images in 0..1 to the packed wire's [N*H*W, 3] u8
    store (lossless for 8-bit pixels)."""
    return np.clip(np.round(np.asarray(images[..., :3], np.float32) * 255.0),
                   0.0, 255.0).astype(np.uint8).reshape(-1, 3)


def build_pose_tables(poses: np.ndarray, hwf, *, intrinsics: Optional[np.ndarray] = None,
                      use_ndc: bool = False) -> Dict:
    """The per-image tables :func:`make_ray_unpack` rebuilds rays from, as
    host numpy arrays: ``rot`` [N, 3, 3] camera-to-world rotations,
    ``origin`` [N, 3] camera centres and, for w2c poses with ``intrinsics``
    (messytable), ``fx``/``fy``/``cx``/``cy`` [N], ``fy`` = fx (the
    reference's fx for both axes, ``nerf_helpers.py:100-101``); the inverses
    in float64."""
    poses = np.asarray(poses, np.float32)
    common = {"hwf": [int(hwf[0]), int(hwf[1]), float(hwf[2])], "use_ndc": bool(use_ndc)}
    if intrinsics is None:
        return {"convention": "c2w", "rot": poses[:, :3, :3].astype(np.float32),
                "origin": poses[:, :3, -1].astype(np.float32), **common}
    c2w = np.linalg.inv(poses[:, :4, :4].astype(np.float64))
    K = np.asarray(intrinsics, np.float64)
    fx = K[:, 0, 0].astype(np.float32)
    return {"convention": "w2c",
            "rot": np.linalg.inv(poses[:, :3, :3].astype(np.float64)).astype(np.float32),
            "origin": c2w[:, :3, 3].astype(np.float32),
            "fx": fx, "fy": fx,  # the reference's fx for both axes
            "cx": K[:, 0, 2].astype(np.float32), "cy": K[:, 1, 2].astype(np.float32),
            **common}


def make_ray_unpack(tables: Dict, near: float, far: float):
    """``unpack(packed) -> (RayBatch, target[, depth_gt])``: the packed
    wire's ``{"idx": int32 global ray index, "rgb": u8 [B, 3][, "depth":
    f32 [B]]}`` to rays on their device, by elementwise ops on the pose
    table (moved to the device once): the pixel's direction as
    ``get_ray_bundle_c2w`` / ``get_ray_bundle_w2c`` compute it, rotated by
    the per-ray sum ``sum_c d[c] rot[r, c]`` (not a matmul), then NDC when
    the tables say so; the target ``rgb * (1 / 255)`` in f32."""
    H, W, focal = tables["hwf"]
    w2c = tables["convention"] == "w2c"
    keys = ("rot", "origin", *(("fx", "fy", "cx", "cy") if w2c else ()))
    on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def unpack(packed: Dict[str, torch.Tensor]):
        idx = packed["idx"].long()
        dev = idx.device
        if dev not in on_device:
            on_device[dev] = {k: torch.as_tensor(tables[k], device=dev) for k in keys}
        t = on_device[dev]
        img = idx // (H * W)
        pix = idx - img * (H * W)
        col = (pix % W).to(torch.float32)
        row = (pix // W).to(torch.float32)
        if w2c:
            dirs = torch.stack([(col - t["cx"][img]) / t["fx"][img],
                                (row - t["cy"][img]) / t["fy"][img], torch.ones_like(col)], -1)
        else:
            dirs = torch.stack([(col - W * 0.5) / focal, -(row - H * 0.5) / focal,
                                -torch.ones_like(col)], -1)
        rd = torch.sum(dirs[:, None, :] * t["rot"][img], dim=-1)
        ro = t["origin"][img]
        viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        if tables["use_ndc"]:
            ro, rd = ndc_rays(H, W, focal, 1.0, ro, rd)
        n = idx.shape[0]
        kw = dict(dtype=torch.float32, device=dev)
        rays = RayBatch(origins=ro, directions=rd, viewdirs=viewdirs,
                        near=torch.full((n,), float(near), **kw),
                        far=torch.full((n,), float(far), **kw))
        target = packed["rgb"].to(torch.float32) * (1.0 / 255.0)
        if "depth" in packed:
            return rays, target, packed["depth"]
        return rays, target

    return unpack


class _Slot:
    """One pinned host buffer per field of a batch, and the event of its
    last copy to the device."""

    def __init__(self, shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]):
        self.host = {k: torch.empty(s, dtype=d, pin_memory=True) for k, (s, d) in shapes.items()}
        self.copied: Optional[torch.cuda.Event] = None


class _HostLoader:
    """The thread, the draws, the gather and the copy both loaders share.
    A subclass gives :meth:`_sources` ({field: host array gathered by the
    batch's indices}) and :meth:`_emit` (the consumer's view of a batch's
    device tensors)."""

    name = "host loader"

    def __init__(self, num_rays: int, batch_size: int, seed: int, *, prefetch: int,
                 device, timing: bool = False):
        self._n = int(num_rays)
        self._batch = int(batch_size)
        self._rng = np.random.default_rng(seed)
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("device cuda: no CUDA card is visible to PyTorch")
        self._cuda = self._device.type == "cuda"
        depth = max(1, int(prefetch))
        self._timing = bool(timing)
        self._gather_ms: List[float] = []
        self._copies: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        if self._cuda:
            shapes = {k: ((self._batch, *a.shape[1:]), torch.from_numpy(a[:1]).dtype)
                      for k, a in self._sources().items()}
            self._ring = [_Slot(shapes) for _ in range(depth + 1)]
            self._stream = torch.cuda.Stream(device=self._device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    @property
    def num_rays(self) -> int:
        return self._n

    @property
    def bytes_per_ray(self) -> int:
        """The bytes a ray of this wire moves from the host to the device."""
        return sum(a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
                   for a in self._sources().values())

    def _sources(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _emit(self, t: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def _gather(self, idx: np.ndarray, out: Optional[Dict[str, np.ndarray]]):
        t0 = time.perf_counter()
        got = {}
        for k, src in self._sources().items():
            dst = None if out is None else out[k]
            if k != "idx":
                got[k] = gather_rows(src, idx, dst)
            elif dst is None:  # the packed wire's int32 indices themselves
                got[k] = idx.astype(np.int32)
            else:
                np.copyto(dst, idx, casting="unsafe")
                got[k] = dst
        if self._timing:
            self._gather_ms.append(1e3 * (time.perf_counter() - t0))
        return got

    def _make_batch(self, k: int):
        idx = self._rng.integers(0, self._n, self._batch)
        if not self._cuda:
            return {n: torch.from_numpy(a) for n, a in self._gather(idx, None).items()}, None
        slot = self._ring[k % len(self._ring)]
        if slot.copied is not None:
            slot.copied.synchronize()  # the buffer's last copy has left it
        self._gather(idx, {n: t.numpy() for n, t in slot.host.items()})
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            if self._timing:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
            dev = {n: t.to(self._device, non_blocking=True) for n, t in slot.host.items()}
            done = torch.cuda.Event(enable_timing=self._timing)
            done.record(self._stream)
            if self._timing:
                self._copies.append((start, done))
        slot.copied = done
        return dev, done

    def _work(self) -> None:
        k = 0
        try:
            while not self._stop.is_set():
                item = self._make_batch(k)
                k += 1
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # handed to the consumer by __next__
            self._error = e

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                dev, done = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(f"{self.name} worker died") from self._error
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in dev.values():
                t.record_stream(stream)
        return self._emit(dev)

    def timings(self) -> Dict[str, float]:
        """With ``timing``: the median host ms of a batch's gather and the
        median device ms of its copy to the card, over the batches so far."""
        if self._cuda:
            torch.cuda.synchronize(self._device)
        h2d = [s.elapsed_time(e) for s, e in list(self._copies)]
        return {"gather_ms": float(np.median(self._gather_ms)) if self._gather_ms else None,
                "h2d_ms": float(np.median(h2d)) if h2d else None,
                "batches": len(self._gather_ms)}

    def close(self) -> None:
        self._stop.set()
        try:  # drain, so that a blocked put sees the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HostRayLoader(_HostLoader):
    """The rows wire: yields ``(RayBatch, target rgb[, depth_gt])`` on
    ``device`` (the card unless the caller asks for the CPU), the batch's
    rows of ``rows`` [N, 12] (an ndarray or a ``numpy.memmap``) gathered on
    the host and copied as they lie, near and far the scene's scalars."""

    name = "HostRayLoader"

    def __init__(self, rows: np.ndarray, near: float, far: float, batch_size: int, seed: int,
                 *, depth: Optional[np.ndarray] = None, prefetch: int = 2, device="cuda",
                 timing: bool = False):
        if rows.ndim != 2 or rows.shape[1] != 12:
            raise ValueError(f"rows must be [N, 12], got {rows.shape}")
        self._rows = np.ascontiguousarray(rows, np.float32)  # a view where it already is
        self._depth = None if depth is None else np.ascontiguousarray(depth, np.float32)
        self._near, self._far = float(near), float(far)
        super().__init__(rows.shape[0], batch_size, seed, prefetch=prefetch, device=device,
                         timing=timing)

    def _sources(self):
        out = {"rows": self._rows}
        if self._depth is not None:
            out["depth"] = self._depth
        return out

    def _emit(self, t):
        rows = t["rows"]
        n = rows.shape[0]
        kw = dict(dtype=rows.dtype, device=rows.device)
        rays = RayBatch(origins=rows[:, 0:3], directions=rows[:, 3:6], viewdirs=rows[:, 6:9],
                        near=torch.full((n,), self._near, **kw),
                        far=torch.full((n,), self._far, **kw))
        if "depth" in t:
            return rays, rows[:, 9:12], t["depth"]
        return rays, rows[:, 9:12]


class HostPixelLoader(_HostLoader):
    """The packed wire: yields ``{"idx": int32 [B], "rgb": u8 [B, 3][,
    "depth": f32 [B]]}`` on ``device`` for :func:`make_ray_unpack`, from
    the u8 store ``rgb_u8`` [N, 3] (:func:`images_to_u8`). The same draw
    contract as :class:`HostRayLoader`: a seed gives the same indices."""

    name = "HostPixelLoader"

    def __init__(self, rgb_u8: np.ndarray, batch_size: int, seed: int, *,
                 depth: Optional[np.ndarray] = None, prefetch: int = 2, device="cuda",
                 timing: bool = False):
        if rgb_u8.ndim != 2 or rgb_u8.shape[1] != 3 or rgb_u8.dtype != np.uint8:
            raise ValueError(f"rgb_u8 must be [N, 3] uint8, got {rgb_u8.shape} {rgb_u8.dtype}")
        if rgb_u8.shape[0] > np.iinfo(np.int32).max:
            raise ValueError(f"{rgb_u8.shape[0]} rays: the packed wire's int32 index holds "
                             f"at most {np.iinfo(np.int32).max}")
        self._rgb = np.ascontiguousarray(rgb_u8)
        self._idx_src = np.empty((1,), np.int32)  # the index field's dtype and row shape
        self._depth = None if depth is None else np.ascontiguousarray(depth, np.float32)
        super().__init__(rgb_u8.shape[0], batch_size, seed, prefetch=prefetch, device=device,
                         timing=timing)

    def _sources(self):
        out = {"idx": self._idx_src, "rgb": self._rgb}
        if self._depth is not None:
            out["depth"] = self._depth
        return out

    def _emit(self, t):
        return dict(t)
