"""Experiment metrics as a JSON-lines stream.

Counterpart of ``dexnerf_tpu/train/logging.py::MetricsLogger`` with
TensorBoard off: every scalar is one line ``{"tag", "value", "step",
"t"}`` of ``<logdir>/metrics.jsonl``; an image is recorded by its tag and
shape.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    """Appends scalars and image records to ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def _write(self, record: Dict) -> None:
        self._jsonl.write(json.dumps({**record, "t": time.time()}) + "\n")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step)})

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        self._write({"tag": tag, "image_shape": list(np.shape(img)), "step": int(step)})

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
