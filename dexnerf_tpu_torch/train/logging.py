"""Experiment metrics as a JSON-lines stream, and depth PNGs.

Counterpart of ``dexnerf_tpu/train/logging.py``: ``MetricsLogger`` with
TensorBoard off (every scalar is one line ``{"tag", "value", "step",
"t"}`` of ``<logdir>/metrics.jsonl``; an image is recorded by its tag and
shape) and the millimeter depth PNGs of validation.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    """Appends scalars and image records to ``<logdir>/metrics.jsonl``;
    ``enabled=False`` (a data-parallel rank other than 0) writes nothing."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.logdir = logdir
        self._jsonl = None
        if enabled:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def _write(self, record: Dict) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({**record, "t": time.time()}) + "\n")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step)})

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        self._write({"tag": tag, "image_shape": list(np.shape(img)), "step": int(step)})

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_depth_png_mm(path: str, depth_m: np.ndarray) -> None:
    """Save a depth map (meters) as a 32-bit millimeter PNG (PIL mode "I"),
    the reference's validation artifact (``train_nerf_rgb.py:395-399``)."""
    from PIL import Image

    mm = (np.asarray(depth_m) * 1000.0).astype(np.uint32)
    Image.fromarray(mm.astype(np.int32)).save(path)


def load_depth_png_mm(path: str) -> np.ndarray:
    """Inverse of :func:`save_depth_png_mm`: meters, float32."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32) / 1000.0
