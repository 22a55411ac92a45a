#!/usr/bin/env python3
"""Where the host-streamed store's step spends its time beside the
resident step's, on one NVIDIA card: kernel 4's bf16 step of
``configs/lego-tpu.yml`` (8x128, 64 + 64 samples) at batch 8192 on 40 views
at 800x800 (25.6 M rays, 1.23 GB of f32 rows), seeded weights.

    python3 perf_tools/host_store_overhead.py [--batch 8192] [--steps 40]

From the repository root. Each variant's step on the host clock (mean of
``--steps`` warm steps to a synchronize), the variants in turns, forward
then backward:

- ``resident``: ``make_train_step`` on the store on the card;
- ``resident+idle_loader``: the same with a rows loader open whose queue
  is full (its thread waits);
- ``rows_direct`` / ``packed_direct``: ``make_batch_train_step`` on batches
  made on the card beforehand (the consumer's path without a loader);
- ``rows_loader`` / ``packed_loader``: the same steps fed by
  ``HostRayLoader`` / ``HostPixelLoader`` (prefetch 2);
- ``rows_drained``: ``HostRayLoader`` whose thread made every batch of the
  turn before it and stopped (the consumer's side of the loader alone);
- ``rows_cpu_thread``: ``rows_direct`` beside a thread that draws and
  gathers a batch into a pinned buffer each step, with no CUDA call (the
  loader's host work without its copy);
- ``rows_consumer_copy`` / ``packed_consumer_copy``: a variant loader whose
  thread draws and gathers only, the consumer enqueueing the next batch's
  copy on the copy stream as it takes a batch (no CUDA call off the
  launching thread);
- ``loader_alone``: batches a second each loader yields with no step.

Prints the card line and, as the last line, one JSON object with the
times. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VIEWS, HW, SEED = 40, 800, 0


def _consumer_copy(hs, base):
    """``base`` (a loader class) with its copy moved to the consumer: the
    thread draws and gathers into a ring of ``prefetch + 2`` pinned slots;
    ``__next__`` enqueues the next batch's copy on the copy stream and
    returns the batch whose copy it enqueued the call before. A slot is
    handed back to the thread once its copy is enqueued, and the thread
    waits for that copy's event before it writes the slot again."""
    import torch

    class ConsumerCopy(base):
        def __init__(self, *args, **kwargs):
            self._ahead = None
            self._free = None
            super().__init__(*args, **kwargs)

        def _make_batch(self, k):
            if self._free is None:  # the ring, two slots past the queue
                self._ring.append(hs._Slot({n: (tuple(t.shape), t.dtype)
                                            for n, t in self._ring[0].host.items()}))
                self._free = [threading.Event() for _ in self._ring]
                for e in self._free:
                    e.set()
            j = k % len(self._ring)
            idx = self._rng.integers(0, self._n, self._batch)
            while not self._free[j].wait(0.1):
                if self._stop.is_set():
                    raise RuntimeError("stopped")
            self._free[j].clear()
            slot = self._ring[j]
            if slot.copied is not None:
                slot.copied.synchronize()
            self._gather(idx, {n: t.numpy() for n, t in slot.host.items()})
            return j, None

        def _copy_next(self):
            while True:
                try:
                    j, _ = self._q.get(timeout=1.0)
                    break
                except Exception:
                    if not self._thread.is_alive():
                        raise RuntimeError("worker died") from self._error
            slot = self._ring[j]
            with torch.cuda.stream(self._stream):
                dev = {n: t.to(self._device, non_blocking=True) for n, t in slot.host.items()}
                done = torch.cuda.Event()
                done.record(self._stream)
            slot.copied = done
            self._free[j].set()
            return dev, done

        def __next__(self):
            if self._ahead is None:
                self._ahead = self._copy_next()
            (dev, done), self._ahead = self._ahead, self._copy_next()
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in dev.values():
                t.record_stream(stream)
            return self._emit(dev)

    return ConsumerCopy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=40)
    opts = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("host_store_overhead: no CUDA card visible to PyTorch")
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.data import host_store as hs
    from dexnerf_tpu_torch.data.blender import pose_spherical
    from dexnerf_tpu_torch.data.pipeline import RayStore
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.ops.host_rows import gather_rows
    from dexnerf_tpu_torch.train.loop import setup_models
    from dexnerf_tpu_torch.train.step import (
        init_train_state,
        make_batch_train_step,
        make_train_step,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cfg = load_config(os.path.join(ROOT, "configs", "lego-tpu.yml"))
    s_train = render_settings_from_cfg(cfg, "train")
    near, far, n = float(cfg.dataset.near), float(cfg.dataset.far), opts.batch
    rng = np.random.default_rng(SEED)
    images = (rng.integers(0, 256, (VIEWS, HW, HW, 3)).astype(np.float32) / 255.0)
    poses = np.stack([pose_spherical(a, -30.0, 4.0) for a in np.linspace(-180, 180, VIEWS,
                                                                          endpoint=False)])
    hwf = (HW, HW, 1111.11)
    rows, _ = hs.build_host_ray_rows(images, poses, hwf, device=dev)
    u8, tables = hs.images_to_u8(images), hs.build_pose_tables(poses, hwf)
    unpack = hs.make_ray_unpack(tables, near, far)
    store = RayStore(data=torch.as_tensor(rows, device=dev), near=near, far=far,
                     rays_per_image=HW * HW)
    coarse, fine = setup_models(cfg, SEED, dev)
    st = init_train_state(copy.deepcopy(coarse), copy.deepcopy(fine), float(cfg.optimizer.lr))
    fused = ftl.make_fused_train_loss(st.coarse, st.fine, s_train, compute_dtype=bf16,
                                      dw_dtype=bf16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    resident = make_train_step(s_train, n, fused_loss=fused)
    rows_step = make_batch_train_step(s_train, fused_loss=fused)
    packed_step = make_batch_train_step(s_train, fused_loss=fused, unpack=unpack)
    idx = [rng.integers(0, rows.shape[0], n) for _ in range(8)]
    made_rows = []
    for i in idx:
        b = torch.as_tensor(rows[i], device=dev)
        made_rows.append((hs.RayBatch(origins=b[:, 0:3], directions=b[:, 3:6],
                                      viewdirs=b[:, 6:9],
                                      near=torch.full((n,), near, device=dev),
                                      far=torch.full((n,), far, device=dev)), b[:, 9:12]))
    made_packed = [{"idx": torch.as_tensor(i.astype(np.int32), device=dev),
                    "rgb": torch.as_tensor(u8[i], device=dev)} for i in idx]
    k = [0]

    def cycle(items):
        k[0] += 1
        return items[k[0] % len(items)]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(opts.steps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / opts.steps

    def with_loader(kind, loaders=(hs.HostRayLoader, hs.HostPixelLoader)):
        if kind == "rows":
            with loaders[0](rows, near, far, n, SEED, device=dev) as loader:
                return timed(lambda: rows_step(st, *next(loader), gen))
        with loaders[1](u8, n, SEED, device=dev) as loader:
            return timed(lambda: packed_step(st, next(loader), gen))

    def with_idle_loader():
        with hs.HostRayLoader(rows, near, far, n, SEED, device=dev):
            time.sleep(0.5)  # its queue fills; its thread waits
            return timed(lambda: resident(st, store, gen))

    def with_drained_loader():
        with hs.HostRayLoader(rows, near, far, n, SEED, device=dev,
                              prefetch=opts.steps + 2) as loader:
            while not loader._q.full():
                time.sleep(0.01)
            loader._stop.set()  # the thread leaves its put and ends
            loader._thread.join()
            return timed(lambda: rows_step(st, *next(loader), gen))

    def with_cpu_thread():
        go, stop = threading.Semaphore(0), threading.Event()
        bufs = [torch.empty((n, 12), pin_memory=True).numpy() for _ in range(3)]
        draws = np.random.default_rng(SEED)

        def work():
            k = 0
            while not stop.is_set():
                if go.acquire(timeout=0.1):
                    gather_rows(rows, draws.integers(0, rows.shape[0], n), bufs[k % 3])
                    k += 1

        th = threading.Thread(target=work, daemon=True)
        th.start()

        def step():
            go.release()
            return rows_step(st, *cycle(made_rows), gen)

        try:
            return timed(step)
        finally:
            stop.set()
            th.join()

    consumer = (_consumer_copy(hs, hs.HostRayLoader), _consumer_copy(hs, hs.HostPixelLoader))
    variants = {
        "resident": lambda: timed(lambda: resident(st, store, gen)),
        "resident+idle_loader": with_idle_loader,
        "rows_direct": lambda: timed(lambda: rows_step(st, *cycle(made_rows), gen)),
        "rows_loader": lambda: with_loader("rows"),
        "rows_drained": with_drained_loader,
        "rows_cpu_thread": with_cpu_thread,
        "rows_consumer_copy": lambda: with_loader("rows", consumer),
        "packed_direct": lambda: timed(lambda: packed_step(st, cycle(made_packed), gen)),
        "packed_loader": lambda: with_loader("packed"),
        "packed_consumer_copy": lambda: with_loader("packed", consumer),
    }
    times = {name: [] for name in variants}
    for order in (list(variants), list(reversed(variants))):
        for name in order:
            times[name].append(round(variants[name](), 3))
    alone = {}
    for kind, make in (("rows", lambda: hs.HostRayLoader(rows, near, far, n, SEED, device=dev,
                                                           timing=True)),
                       ("packed", lambda: hs.HostPixelLoader(u8, n, SEED, device=dev,
                                                             timing=True)),
                       ("rows_consumer_copy", lambda: consumer[0](rows, near, far, n, SEED,
                                                                  device=dev)),
                       ("packed_consumer_copy", lambda: consumer[1](u8, n, SEED, device=dev))):
        with make() as loader:
            next(loader)
            t0 = time.perf_counter()
            for _ in range(50):
                next(loader)
            torch.cuda.synchronize()
            alone[kind] = {"batches_per_s": round(50 / (time.perf_counter() - t0), 1),
                           **loader.timings()}
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(f"host_store_overhead on {card}: ms a step (host clock, mean of {opts.steps}, "
          f"forward order then reversed) at {n} rays: {json.dumps(times)}; the loaders alone: "
          f"{json.dumps(alone)}")
    print(card)
    print(json.dumps({"batch": n, "step_ms": times, "loader_alone": alone}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
