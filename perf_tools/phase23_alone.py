#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 23 alone (the wide f32 route: FlexibleNeRF
8x256 at ``pallas_compute_dtype: float32`` through ``apps.train`` and
``apps.serve``, the widths 136, 320 and MAX_HIDDEN), for iterating on that
phase without the others: it writes its own scene.

    python3 perf_tools/phase23_alone.py

From the repository root, on a machine with an NVIDIA Hopper card. Prints
the card's name and power limit, the kernels' build time, phase 23's own
lines, its wall time and its kernels-line entries; exits non-zero if a
check fails.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dexnerf_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase23_alone: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        entries = cs.wide_f32_phase(torch, np, card, dev, tmp)
        print(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps(entries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
